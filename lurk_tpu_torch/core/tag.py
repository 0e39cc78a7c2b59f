"""Lurk pointer tags + internal VM tags + evaluation errors.

Reference: src/core/tag.rs:23-39, src/core/ingress.rs:86-98,
src/core/error.rs:5-40.
"""

from __future__ import annotations

from enum import IntEnum


class Tag(IntEnum):
    U64 = 0
    Num = 1
    BigNum = 2
    Comm = 3
    Char = 4
    Str = 5
    Key = 6
    Fun = 7
    Builtin = 8
    Coroutine = 9
    Sym = 10
    Cons = 11
    Env = 12
    Fix = 13
    Err = 14


TAG_COUNT = 15


class InternalTag(IntEnum):
    """VM-internal tags, numbered after Tag (reference: ingress.rs:86-98)."""
    Nil = TAG_COUNT + 0
    T = TAG_COUNT + 1


class EvalErr(IntEnum):
    UnboundVar = 0
    InvalidForm = 1
    IllegalBindingVar = 2
    ApplyNonFunc = 3
    ParamsNotList = 4
    ParamNotSymbol = 5
    ParamInvalidRest = 6
    ArgsNotList = 7
    InvalidArg = 8
    DivByZero = 9
    NotEnv = 10
    NotChar = 11
    NotCons = 12
    NotString = 13
    NotU64 = 14
    NotBigNum = 15
    CantOpen = 16
    CantCastToChar = 17
    CantCastToU64 = 18
    CantCastToBigNum = 19
    CantCastToComm = 20
    Todo = 21
