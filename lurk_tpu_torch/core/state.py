"""Packages + reader state (reference: src/core/{package,state}.rs)."""

from __future__ import annotations

from typing import Dict, Optional

from .symbol import (Symbol, lurk_sym, builtin_sym, LURK_PACKAGE_NAME, BUILTIN_PACKAGE_NAME,
                     META_PACKAGE_NAME, USER_PACKAGE_NAME)

LURK_SYMBOLS = ("nil", "t", "&rest")

BUILTIN_SYMBOLS = (
    "atom", "apply", "begin", "car", "cdr", "char", "commit", "comm",
    "bignum", "cons", "empty-env", "current-env", "bind", "env", "emit",
    "eval", "eq", "eqq", "type-eq", "type-eqq", "hide", "if", "lambda",
    "let", "letrec", "u64", "open", "quote", "secret", "strcons", "list",
    "+", "-", "*", "/", "%", "=", "<", ">", "<=", ">=", "breakpoint", "fail",
)

META_SYMBOLS = (
    "def", "defq", "defrec", "update", "load", "assert", "assert-eq",
    "assert-emitted", "assert-error", "debug", "hide", "rand", "commit",
    "open", "clear", "set-env", "erase-from-env", "prove", "verify",
    "defpackage", "import", "in-package", "help", "call", "chain",
    "transition", "inspect", "dump-expr", "load-expr", "defprotocol",
    "prove-protocol", "verify-protocol", "microchain-start",
    "microchain-get-genesis", "microchain-get-state",
    "microchain-transition", "microchain-verify", "load-ocaml",
    "load-ocaml-expr",
)


class Package:
    def __init__(self, name: Symbol):
        self.name = name
        self.symbols: Dict[str, Symbol] = {}
        self.local: set = set()

    def resolve(self, symbol_name: str) -> Optional[Symbol]:
        return self.symbols.get(symbol_name)

    def intern(self, symbol_name: str) -> Symbol:
        sym = self.symbols.get(symbol_name)
        if sym is None:
            sym = self.name.direct_child(symbol_name)
            self.symbols[symbol_name] = sym
            self.local.add(sym)
        return sym

    def import_symbols(self, symbols):
        for sym in symbols:
            name = sym.name()
            existing = self.resolve(name)
            if existing is not None and existing != sym:
                raise ValueError(
                    f"{sym} conflicts with {existing}, which is already accessible")
        for sym in symbols:
            self.symbols[sym.name()] = sym

    def use_package(self, package: "Package"):
        self.import_symbols(sorted(package.local, key=lambda s: s.path))

    def fmt_to_string(self, symbol: Symbol) -> str:
        for name, sym in self.symbols.items():
            if sym == symbol:
                return Symbol.fmt_path_component_to_string(name)
        return symbol.fmt_to_string()


class State:
    def __init__(self, current_package: Package):
        self.current_package_name = current_package.name
        self.packages: Dict[Symbol, Package] = {
            current_package.name: current_package}

    def add_package(self, package: Package):
        self.packages[package.name] = package

    def get_current_package(self) -> Package:
        return self.packages[self.current_package_name]

    def set_current_package(self, name: Symbol):
        assert name in self.packages, f"Package {name} not found"
        self.current_package_name = name

    def intern(self, symbol_name: str) -> Symbol:
        return self.get_current_package().intern(symbol_name)

    def _intern_fold(self, init: Symbol, path, create_unknown: bool) -> Symbol:
        acc = init
        for s in path:
            package = self.packages.get(acc)
            if package is None:
                if not create_unknown:
                    raise ValueError(f"Package {acc} not found")
                package = Package(acc)
                self.add_package(package)
            acc = package.intern(s)
        return acc

    def intern_path(self, path, keyword: bool, create_unknown=True) -> Symbol:
        root = Symbol.root_key() if keyword else Symbol.root_sym()
        return self._intern_fold(root, path, create_unknown)

    def intern_relative_path(self, path, create_unknown=True) -> Symbol:
        return self._intern_fold(self.current_package_name, path, create_unknown)

    def fmt_to_string(self, symbol: Symbol) -> str:
        return self.get_current_package().fmt_to_string(symbol)

    @staticmethod
    def init_lurk_state() -> "State":
        root = Package(Symbol.root_sym())
        keyword_package = Package(Symbol.root_key())
        lurk_package = Package(root.intern(LURK_PACKAGE_NAME))
        for name in LURK_SYMBOLS:
            lurk_package.intern(name)
        builtin_package = Package(lurk_package.intern(BUILTIN_PACKAGE_NAME))
        for name in BUILTIN_SYMBOLS:
            builtin_package.intern(name)
        meta_package = Package(lurk_package.intern(META_PACKAGE_NAME))
        for name in META_SYMBOLS:
            meta_package.intern(name)
        user_package = Package(root.intern(USER_PACKAGE_NAME))
        user_package.use_package(lurk_package)
        user_package.use_package(builtin_package)
        state = State(user_package)
        state.add_package(root)
        state.add_package(keyword_package)
        state.add_package(lurk_package)
        state.add_package(builtin_package)
        state.add_package(meta_package)
        return state


def meta_package_symbol() -> Symbol:
    return lurk_sym(META_PACKAGE_NAME)
