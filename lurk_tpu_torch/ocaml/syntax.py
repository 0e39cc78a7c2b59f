"""Lambda IR AST (reference: /root/reference/src/ocaml/syntax.rs).

One node class with a `kind` tag instead of fifteen dataclasses: the
grammar and transform dispatch on kind, and equality/printing come free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Tuple


@dataclass(frozen=True)
class LambdaSyntax:
    kind: str
    # payload by kind:
    #  ident: (name,)                     int: (neg, value)
    #  float: (value,)                    char: (c,)
    #  string: (s,)                       record: (tag, [children])
    #  setglobal: (ident, value)          seq: ([children],)
    #  makeblock: (tag, [children])       let/letrec: ([(var, val)], body)
    #  function: ([args], body)           apply: (func, [args])
    #  fallback_primitive: (head, [args]) fallback_literal: (text,)
    args: Tuple[Any, ...] = field(default_factory=tuple)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def ident(name: str):
        return LambdaSyntax("ident", (name,))

    @staticmethod
    def int(neg: bool, value: int):
        return LambdaSyntax("int", (neg, value))

    @staticmethod
    def float(value: float):
        return LambdaSyntax("float", (value,))

    @staticmethod
    def char(c: str):
        return LambdaSyntax("char", (c,))

    @staticmethod
    def string(s: str):
        return LambdaSyntax("string", (s,))

    @staticmethod
    def record(tag: int, children: List["LambdaSyntax"]):
        return LambdaSyntax("record", (tag, tuple(children)))

    @staticmethod
    def setglobal(ident: "LambdaSyntax", value: "LambdaSyntax"):
        return LambdaSyntax("setglobal", (ident, value))

    @staticmethod
    def seq(children: List["LambdaSyntax"]):
        return LambdaSyntax("seq", (tuple(children),))

    @staticmethod
    def makeblock(tag: int, children: List["LambdaSyntax"]):
        return LambdaSyntax("makeblock", (tag, tuple(children)))

    @staticmethod
    def let(bindings, body: "LambdaSyntax"):
        return LambdaSyntax("let", (tuple(bindings), body))

    @staticmethod
    def letrec(bindings, body: "LambdaSyntax"):
        return LambdaSyntax("letrec", (tuple(bindings), body))

    @staticmethod
    def function(args, body: "LambdaSyntax"):
        return LambdaSyntax("function", (tuple(args), body))

    @staticmethod
    def apply(func: "LambdaSyntax", args):
        return LambdaSyntax("apply", (func, tuple(args)))

    @staticmethod
    def fallback_primitive(head: str, args):
        return LambdaSyntax("fallback_primitive", (head, tuple(args)))

    @staticmethod
    def fallback_literal(text: str):
        return LambdaSyntax("fallback_literal", (text,))
