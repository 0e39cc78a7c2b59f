"""Loam value types: narrow/wide pointers and pointer-equality lattice.

Reference: /root/reference/src/loam/mod.rs:54-271. A Loam `Ptr` is a
(tag, addr) pair of BabyBear elements where addr is a *virtual* address
handed out by the Allocator; a `Wide` is an 8-felt digest; a `WidePtr`
pairs a widened tag with a digest (the content-addressed boundary form,
equal to a ZStore ZPtr).

Everything is plain ints/tuples so the values hash fast as relation keys.
"""

from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple, Tuple

from ..core.state import BUILTIN_SYMBOLS
from ..core.tag import Tag
from ..field import babybear as bb

P = bb.P

Wide = Tuple[int, ...]  # 8 felts


def widen(elt: int) -> Wide:
    return (elt, 0, 0, 0, 0, 0, 0, 0)


ZERO_WIDE = widen(0)


def lurk_sym_index(name: str) -> int:
    """Position of a builtin in BUILTIN_SYMBOLS (mod.rs:338-341)."""
    return BUILTIN_SYMBOLS.index(name)


_LEFT_FOLDABLE = {lurk_sym_index("+"), lurk_sym_index("*")}
_RIGHT_FOLDABLE = {lurk_sym_index("-"), lurk_sym_index("/")}
_RELATIONAL = {lurk_sym_index(op) for op in ("=", "<", ">", "<=", ">=")}


class PtrEq(IntEnum):
    """Lattice of pointer-equality knowledge (mod.rs:168-192).

    join = max: Unknown absorbs; Equal is bottom."""
    Equal = 0
    NotEqual = 1
    Unknown = 2


def ptr_eq_join(a: PtrEq, b: PtrEq) -> PtrEq:
    return a if a >= b else b


class Ptr(NamedTuple):
    tag: int
    addr: int

    # -- constructors (mod.rs:57-107) ----------------------------------
    @staticmethod
    def nil() -> "Ptr":
        return Ptr(Tag.Sym, 0)

    @staticmethod
    def t() -> "Ptr":
        return Ptr(Tag.Sym, 1)

    @staticmethod
    def builtin(name: str) -> "Ptr":
        return Ptr(Tag.Builtin, lurk_sym_index(name))

    @staticmethod
    def num(val: int) -> "Ptr":
        return Ptr(Tag.Num, val)

    @staticmethod
    def lurk_bool(b: bool) -> "Ptr":
        return Ptr.t() if b else Ptr.nil()

    # -- predicates ------------------------------------------------------
    def is_num(self):
        return self.tag == Tag.Num

    def is_cons(self):
        return self.tag == Tag.Cons

    def is_nil(self):
        return self == Ptr.nil()

    def is_sym(self):
        # nil/t are not treated as lookupable syms (mod.rs:117-121)
        return self.tag == Tag.Sym and self.addr not in (0, 1)

    def is_builtin(self):
        return self.tag == Tag.Builtin

    def is_fun(self):
        return self.tag == Tag.Fun

    def is_thunk(self):
        return self.tag == Tag.Fix

    def is_err(self):
        return self.tag == Tag.Err

    def is_built_in_named(self, name: str) -> bool:
        return self.is_builtin() and self.addr == lurk_sym_index(name)

    def is_built_in(self) -> bool:
        return self.is_builtin() and self.addr < len(BUILTIN_SYMBOLS)

    def built_in_name(self) -> str:
        # NOTE: the reference shifts indices >= 18 by one
        # (evaluation.rs:173-182) - a stale compensation for a historical
        # duplicate in BUILTIN_SYMBOLS; addresses here always come from
        # enumerate(BUILTIN_SYMBOLS), so the direct index is correct.
        assert self.is_built_in(), "not built_in"
        return BUILTIN_SYMBOLS[self.addr]

    # dispatch classes (evaluation.rs:39-114)
    def is_binding(self):
        return self.is_built_in_named("let")

    def is_recursive_binding(self):
        return self.is_built_in_named("letrec")

    def is_lambda(self):
        return self.is_built_in_named("lambda")

    def is_if(self):
        return self.is_built_in_named("if")

    def is_left_foldable(self):
        return self.is_builtin() and self.addr in _LEFT_FOLDABLE

    def is_right_foldable(self):
        return self.is_builtin() and self.addr in _RIGHT_FOLDABLE

    def is_relational(self):
        return self.is_builtin() and self.addr in _RELATIONAL

    def is_eq_op(self):
        return self.is_built_in_named("eq")

    def is_cons_op(self):
        return self.is_built_in_named("cons")

    def is_car(self):
        return self.is_built_in_named("car")

    def is_cdr(self):
        return self.is_built_in_named("cdr")

    def is_car_cdr(self):
        return self.is_car() or self.is_cdr()

    def is_atom_op(self):
        return self.is_built_in_named("atom")

    def is_quote(self):
        return self.is_built_in_named("quote")

    # -- numeric ops (evaluation.rs:116-163) ------------------------------
    def neutral_element(self) -> int:
        if self.is_built_in_named("+") or self.is_built_in_named("-"):
            return 0
        if self.is_built_in_named("*") or self.is_built_in_named("/"):
            return 1
        raise AssertionError("not a foldable op")

    def apply_op(self, a: int, b: int) -> int:
        name = self.built_in_name()
        if name == "+":
            return (a + b) % P
        if name == "-":
            return (a - b) % P
        if name == "*":
            return (a * b) % P
        if name == "/":
            return (a * pow(b, P - 2, P)) % P  # field division
        raise AssertionError(name)

    def apply_relop(self, a: int, b: int) -> "Ptr":
        name = self.built_in_name()
        res = {"=": a == b, "<": a < b, ">": a > b,
               "<=": a <= b, ">=": a >= b}[name]
        return Ptr.lurk_bool(res)

    # -- conversions -------------------------------------------------------
    def wide_tag(self) -> Wide:
        return widen(self.tag)

    def is_eq(self, other: "Ptr") -> PtrEq:
        """Shallow equality knowledge (mod.rs:144-166).

        Sym/Builtin addresses are hash-consed one-per-digest by the
        sym/builtin digest lattices, so address inequality IS content
        inequality - returning NotEqual here is sound and lets
        `(eq 'a 'b)` resolve. The reference leaves these Unknown and its
        eq coroutine never resolves them (mod.rs TODO)."""
        if self == other:
            return PtrEq.Equal
        if self.tag != other.tag:
            return PtrEq.NotEqual
        if self.tag in (Tag.Num, Tag.Err, Tag.Sym, Tag.Builtin):
            return PtrEq.Equal if self.addr == other.addr else PtrEq.NotEqual
        return PtrEq.Unknown


class WidePtr(NamedTuple):
    tag: Wide
    value: Wide

    @staticmethod
    def from_zptr(zptr) -> "WidePtr":
        return WidePtr(widen(int(zptr.tag)), tuple(int(x) for x in zptr.digest))

    def to_zptr(self):
        from ..core.zstore import ZPtr
        return ZPtr(Tag(self.tag[0]), self.value)

    def ptr_tag(self) -> int:
        return self.tag[0]


def tag_wide_relation():
    """(short-tag, wide-tag) rows for all 15 tags (mod.rs Tag::wide_relation)."""
    return [(int(t), widen(int(t))) for t in Tag]
