"""The Lurk reader: recursive-descent port of the reference's nom parser.

Reference: src/core/parser/{syntax,string,base}.rs. Produces Syntax nodes:
numerics (u64 by default, `n` suffix for field Nums, i64 rejected at intern),
strings/chars with escapes, symbols with package paths and |...| escapes,
keywords, #0x big-nums, #c0x commitments, quote, meta !(...) forms,
proper/improper lists; comments with ';' and 27 unicode whitespace chars.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..field.babybear import P
from .state import State, meta_package_symbol
from .symbol import Symbol, ESCAPE_CHARS, LURK_WHITESPACE

DIGEST_SIZE = 8


class ParseErr(Exception):
    pass


# --- syntax nodes ----------------------------------------------------------

@dataclass(frozen=True)
class SynNum:
    value: int


@dataclass(frozen=True)
class SynU64:
    value: int


@dataclass(frozen=True)
class SynI64:
    neg: bool
    value: int


@dataclass(frozen=True)
class SynChar:
    value: str


@dataclass(frozen=True)
class SynString:
    value: str


@dataclass(frozen=True)
class SynSymbol:
    value: Symbol


@dataclass(frozen=True)
class SynBigNum:
    value: Tuple[int, ...]


@dataclass(frozen=True)
class SynComm:
    value: Tuple[int, ...]


@dataclass(frozen=True)
class SynList:
    items: Tuple


@dataclass(frozen=True)
class SynImproper:
    items: Tuple
    tail: object


@dataclass(frozen=True)
class SynQuote:
    inner: object


@dataclass(frozen=True)
class SynMeta:
    sym: Symbol
    args: Tuple


# --- cursor ----------------------------------------------------------------

class _Cursor:
    __slots__ = ("s", "i")

    def __init__(self, s: str, i: int = 0):
        self.s = s
        self.i = i

    def eof(self):
        return self.i >= len(self.s)

    def peek(self):
        return self.s[self.i] if self.i < len(self.s) else ""

    def startswith(self, t: str):
        return self.s.startswith(t, self.i)

    def take(self, t: str) -> bool:
        if self.startswith(t):
            self.i += len(t)
            return True
        return False

    def save(self):
        return self.i

    def restore(self, pos):
        self.i = pos


def _skip_space(c: _Cursor):
    while True:
        while not c.eof() and c.peek() in LURK_WHITESPACE:
            c.i += 1
        if c.take(";"):
            while not c.eof() and c.peek() != "\n":
                c.i += 1
            continue
        return


# --- string fragments ------------------------------------------------------

_ESCAPE_MAP = {"n": "\n", "r": "\r", "t": "\t", "b": "", "f": "",
               "\\": "\\", "/": "/", '"': '"', "'": "'"}


def _parse_escaped_char(c: _Cursor, delim: str, must_escape: str) -> str:
    assert c.take("\\")
    if c.take("u{"):
        j = c.i
        while j < len(c.s) and c.s[j] in "0123456789abcdefABCDEF" and j - c.i < 6:
            j += 1
        if j == c.i or not c.s.startswith("}", j):
            raise ParseErr("invalid unicode escape")
        code = int(c.s[c.i:j], 16)
        c.i = j + 1
        return chr(code)
    ch = c.peek()
    if ch in _ESCAPE_MAP:
        c.i += 1
        return _ESCAPE_MAP[ch]
    if ch == delim or ch in must_escape:
        c.i += 1
        return ch
    raise ParseErr(f"invalid escape \\{ch}")


def _parse_string_inner(c: _Cursor, delim: str, whitespace: bool,
                        must_escape: str, at_least_one: bool) -> str:
    out = []
    excluded = set(must_escape) | {delim, "\\"}
    if not whitespace:
        excluded |= set(LURK_WHITESPACE)
    got = False
    while not c.eof():
        ch = c.peek()
        if ch == "\\":
            save = c.save()
            nxt = c.s[c.i + 1] if c.i + 1 < len(c.s) else ""
            if whitespace and nxt in LURK_WHITESPACE:
                c.i += 1
                while not c.eof() and c.peek() in LURK_WHITESPACE:
                    c.i += 1
                got = True
                continue
            try:
                out.append(_parse_escaped_char(c, delim, must_escape))
                got = True
                continue
            except ParseErr:
                c.restore(save)
                break
        if ch in excluded:
            break
        out.append(ch)
        c.i += 1
        got = True
    if at_least_one and not got:
        raise ParseErr("expected string fragment")
    return "".join(out)


# --- symbols ---------------------------------------------------------------

def _parse_symbol_limb(c: _Cursor, escape: str) -> str:
    if c.peek() == "|":
        c.i += 1
        s = _parse_string_inner(c, "|", True, "|", True)
        if not c.take("|"):
            raise ParseErr("unterminated |symbol|")
        return s
    if c.startswith("."):
        return ""
    return _parse_string_inner(c, ".", False, escape, True)


def _parse_symbol_limbs(c: _Cursor) -> List[str]:
    path = [_parse_symbol_limb(c, ESCAPE_CHARS)]
    while True:
        save = c.save()
        if not c.take("."):
            break
        try:
            path.append(_parse_symbol_limb(c, ESCAPE_CHARS))
        except ParseErr:
            c.restore(save)
            c.take(".")  # opt trailing dot
            break
    return path


def _parse_symbol(c: _Cursor, state: State) -> Symbol:
    # relative
    save = c.save()
    ch = c.peek()
    if ch and ch not in ",~#(){}[]1234567890." and ch != ":" and ch != '"' \
            and ch != "'" and ch != ";" and ch not in LURK_WHITESPACE and ch != "!":
        try:
            path = _parse_symbol_limbs(c)
            return state.intern_relative_path(path)
        except ParseErr:
            c.restore(save)
    # absolute
    if c.take("."):
        path = _parse_symbol_limbs(c)
        return state.intern_path(path, keyword=False)
    if c.take(":"):
        path = _parse_symbol_limbs(c)
        return state.intern_path(path, keyword=True)
    # raw
    if c.take("~("):
        path = _raw_limbs(c)
        return state.intern_path(list(reversed(path)), keyword=False)
    if c.take("~:("):
        path = _raw_limbs(c)
        return state.intern_path(list(reversed(path)), keyword=True)
    raise ParseErr("not a symbol")


def _raw_limbs(c: _Cursor) -> List[str]:
    path = []
    while True:
        _skip_space(c)
        if c.take(")"):
            return path
        if c.peek() == "|":
            c.i += 1
            s = _parse_string_inner(c, "|", True, "|", True)
            if not c.take("|"):
                raise ParseErr("unterminated |symbol|")
            path.append(s)
        else:
            path.append(_parse_string_inner(c, " ", False, "|()", True))


# --- numerics --------------------------------------------------------------

_BASES = {"b": (2, "01"), "o": (8, "01234567"), "d": (10, "0123456789"),
          "x": (16, "0123456789abcdefABCDEF")}

_SUFFIXES = ("u128", "u16", "u32", "u64", "u8",
             "i128", "i16", "i32", "i64", "i8", "n")


def _parse_numeric(c: _Cursor):
    save = c.save()
    neg = c.take("-")
    radix, digits_set = 10, "0123456789"
    if c.peek() == "0" and c.i + 1 < len(c.s) and c.s[c.i + 1] in _BASES:
        c.i += 2
        radix, digits_set = _BASES[c.s[c.i - 1]]
    digits = []
    while not c.eof() and (c.peek() in digits_set or c.peek() == "_"):
        if c.peek() != "_":
            digits.append(c.peek())
        c.i += 1
    if not digits:
        c.restore(save)
        raise ParseErr("not a number")
    value = int("".join(digits), radix)
    suffix = None
    for s in _SUFFIXES:
        if c.startswith(s):
            c.i += len(s)
            suffix = s
            break
    if suffix == "n":
        f = value % P
        if neg:
            f = (-f) % P
        return SynNum(f)
    if suffix in ("u8", "u16", "u32", "u128", "i8", "i16", "i32", "i128"):
        raise ParseErr(f"Numeric suffix {suffix} not yet supported")
    if suffix == "i64" or (suffix is None and neg) :
        assert value < (1 << 64)
        return SynI64(neg, value)
    assert value < (1 << 64), "u64 literal too large"
    return SynU64(value)


def _parse_hex_digest(c: _Cursor) -> Tuple[int, ...]:
    digits = []
    while not c.eof() and c.peek() in "0123456789abcdefABCDEF":
        digits.append(c.peek())
        c.i += 1
    if not digits:
        raise ParseErr("expected hex digits")
    num = int("".join(digits), 16)
    res = []
    for _ in range(DIGEST_SIZE):
        res.append(num % P)
        num //= P
    if num != 0:
        raise ParseErr("digest literal too big")
    return tuple(res)


# --- chars and strings -----------------------------------------------------

def _parse_char(c: _Cursor):
    save = c.save()
    if not c.take("'"):
        raise ParseErr("not a char")
    try:
        s = _parse_string_inner(c, "'", True, "()'", True)
    except ParseErr:
        c.restore(save)
        raise
    if not c.take("'"):
        c.restore(save)
        raise ParseErr("not a char")
    if len(s) != 1:
        c.restore(save)
        raise ParseErr(f"invalid char {s!r}")
    return SynChar(s)


# --- main ------------------------------------------------------------------

def _parse_syntax(c: _Cursor, state: State):
    if c.take("("):
        items = []
        tail = None
        while True:
            _skip_space(c)
            if c.take(")"):
                break
            if c.peek() == "." and not _is_symbol_start_after_dot(c):
                c.take(".")
                _skip_space(c)
                tail = _parse_syntax(c, state)
                _skip_space(c)
                if not c.take(")"):
                    raise ParseErr("expected ) after improper tail")
                break
            items.append(_parse_syntax(c, state))
        if tail is not None:
            return SynImproper(tuple(items), tail)
        return SynList(tuple(items))

    if c.startswith("!("):
        c.take("!(")
        saved_pkg = state.current_package_name
        state.set_current_package(meta_package_symbol())
        _skip_space(c)
        sym = _parse_symbol(c, state)
        state.set_current_package(saved_pkg)
        args = []
        while True:
            _skip_space(c)
            if c.take(")"):
                break
            args.append(_parse_syntax(c, state))
        return SynMeta(sym, tuple(args))

    # numeric
    try:
        return _parse_numeric(c)
    except ParseErr:
        pass
    # comm / bignum
    if c.take("#c0x"):
        return SynComm(_parse_hex_digest(c))
    if c.take("#0x"):
        return SynBigNum(_parse_hex_digest(c))
    if c.startswith("#\\"):
        c.take("#\\")
        if c.startswith("u{"):
            c.take("u")  # reuse escape parser by faking a backslash? simpler:
            assert c.take("{")
            j = c.i
            while j < len(c.s) and c.s[j] in "0123456789abcdefABCDEF":
                j += 1
            code = int(c.s[c.i:j], 16)
            c.i = j
            assert c.take("}")
            return SynChar(chr(code))
        ch = c.peek()
        c.i += 1
        return SynChar(ch)
    # char or quote
    if c.peek() == "'":
        try:
            return _parse_char(c)
        except ParseErr:
            c.take("'")
            inner = _parse_syntax(c, state)
            return SynQuote(inner)
    # string
    if c.take('"'):
        s = _parse_string_inner(c, '"', True, "", False)
        if not c.take('"'):
            raise ParseErr("unterminated string")
        return SynString(s)
    # symbol
    return SynSymbol(_parse_symbol(c, state))


def _is_symbol_start_after_dot(c: _Cursor) -> bool:
    """Distinguish '(a . b)' improper-dot from '.absolute' symbols."""
    nxt = c.s[c.i + 1] if c.i + 1 < len(c.s) else ""
    return nxt not in LURK_WHITESPACE and nxt not in ")"


def parse(input_str: str, state: Optional[State] = None):
    """Parse one syntax form; returns (Syntax | None, rest-string)."""
    state = state or State.init_lurk_state()
    c = _Cursor(input_str)
    _skip_space(c)
    if c.eof():
        return None, ""
    syn = _parse_syntax(c, state)
    return syn, c.s[c.i:]


def parse_many(input_str: str, state: Optional[State] = None):
    state = state or State.init_lurk_state()
    out = []
    rest = input_str
    while True:
        syn, rest = parse(rest, state)
        if syn is None:
            return out
        out.append(syn)
