"""Hierarchical symbols with package paths (reference: src/core/symbol.rs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

KEYWORD_MARKER = ":"
SYM_MARKER = "."
SYM_SEPARATOR = "."
ESCAPE_CHARS = "|(){}[],.:;'\\\""

# 27 unicode whitespace chars accepted by the reference (parser/mod.rs:13-18)
LURK_WHITESPACE = "\u0009\u000A\u000B\u000C\u000D\u0020\u0085\u200E\u200F\u2028\u2029\u20A0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006\u2007\u2008\u2009\u200A\u202F\u205F\u3000"


@dataclass(frozen=True)
class Symbol:
    path: Tuple[str, ...]
    keyword: bool = False

    @staticmethod
    def root_sym() -> "Symbol":
        return Symbol((), False)

    @staticmethod
    def root_key() -> "Symbol":
        return Symbol((), True)

    @staticmethod
    def sym(path) -> "Symbol":
        return Symbol(tuple(path), False)

    @staticmethod
    def key(path) -> "Symbol":
        return Symbol(tuple(path), True)

    def is_keyword(self) -> bool:
        return self.keyword

    def is_root(self) -> bool:
        return not self.path

    def direct_child(self, child: str) -> "Symbol":
        return Symbol((*self.path, child), self.keyword)

    def direct_parent(self):
        if not self.path:
            return None
        return Symbol(self.path[:-1], self.keyword)

    def name(self) -> str:
        assert self.path, "root symbol has no name"
        return self.path[-1]

    def extend(self, children) -> "Symbol":
        return Symbol((*self.path, *children), self.keyword)

    @staticmethod
    def fmt_path_component_to_string(x: str) -> str:
        if any(c in ESCAPE_CHARS or c in LURK_WHITESPACE for c in x) or not x:
            return f"|{x}|"
        return x

    def fmt_path_to_string(self) -> str:
        return SYM_SEPARATOR.join(
            self.fmt_path_component_to_string(c) for c in self.path)

    def fmt_to_string(self) -> str:
        if not self.path:
            return "~:()" if self.keyword else "~()"
        marker = KEYWORD_MARKER if self.keyword else SYM_MARKER
        return marker + self.fmt_path_to_string()

    def __repr__(self):
        return self.fmt_to_string()


LURK_PACKAGE_NAME = "lurk"
BUILTIN_PACKAGE_NAME = "builtin"
META_PACKAGE_NAME = "meta"
USER_PACKAGE_NAME = "lurk-user"


def lurk_sym(name: str) -> Symbol:
    return Symbol.sym([LURK_PACKAGE_NAME, name])


def builtin_sym(name: str) -> Symbol:
    return Symbol.sym([LURK_PACKAGE_NAME, BUILTIN_PACKAGE_NAME, name])


def meta_sym(name: str) -> Symbol:
    return Symbol.sym([LURK_PACKAGE_NAME, META_PACKAGE_NAME, name])


def user_sym(name: str) -> Symbol:
    return Symbol.sym([USER_PACKAGE_NAME, name])
