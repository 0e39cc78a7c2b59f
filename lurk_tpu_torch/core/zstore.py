"""Content-addressed DAG store for Lurk data (reference: src/core/zstore.rs).

ZPtr = (tag, digest[8]); atoms embed their payload in the digest (Num:
digest[0]; Char: 4 utf-8 bytes; U64: 8 LE bytes); compound nodes are hashed:
Tuple11 (2 children, both tags hashed; hash4 over 32 felts) and Tuple110
(3 children, 3rd tag dropped; hash5 over 40 felts).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..poseidon import ref as pref
from .symbol import Symbol, lurk_sym, builtin_sym
from .state import State, BUILTIN_SYMBOLS
from .tag import Tag, EvalErr

DIGEST_SIZE = 8
ZPTR_SIZE = 16
HASH3_SIZE = 24
HASH4_SIZE = 32
HASH5_SIZE = 40

Digest = Tuple[int, ...]


@dataclass(frozen=True)
class ZPtr:
    tag: int
    digest: Digest

    @staticmethod
    def null(tag) -> "ZPtr":
        return ZPtr(int(tag), (0,) * DIGEST_SIZE)

    @staticmethod
    def num(f: int) -> "ZPtr":
        return ZPtr(int(Tag.Num), (f % 2013265921,) + (0,) * 7)

    @staticmethod
    def char(c: str) -> "ZPtr":
        bs = c.encode("utf-8")
        assert len(bs) <= 4
        digest = tuple(bs) + (0,) * (DIGEST_SIZE - len(bs))
        return ZPtr(int(Tag.Char), digest)

    @staticmethod
    def u64(u: int) -> "ZPtr":
        return ZPtr(int(Tag.U64),
                    tuple((u >> (8 * i)) & 0xFF for i in range(8)))

    @staticmethod
    def err(e: EvalErr) -> "ZPtr":
        return ZPtr(int(Tag.Err), (int(e),) + (0,) * 7)

    @staticmethod
    def big_num(digest) -> "ZPtr":
        return ZPtr(int(Tag.BigNum), tuple(digest))

    @staticmethod
    def comm(digest) -> "ZPtr":
        return ZPtr(int(Tag.Comm), tuple(digest))

    @staticmethod
    def from_flat_data(data) -> "ZPtr":
        return ZPtr(int(data[0]), tuple(data[8:16]))

    def flatten(self):
        return (self.tag,) + (0,) * 7 + self.digest


def flatten_tuple11(a: ZPtr, b: ZPtr):
    return a.flatten() + b.flatten()


def flatten_tuple110(a: ZPtr, b: ZPtr, c: ZPtr):
    return a.flatten() + b.flatten() + c.digest


ATOM = 0
TUPLE11 = 1
TUPLE110 = 2


class ZStore:
    def __init__(self, lang_symbols=None):
        self.dag: Dict[ZPtr, tuple] = {}  # zptr -> (kind, children...)
        self.hashes3: Dict[tuple, Digest] = {}
        self.hashes4: Dict[tuple, Digest] = {}
        self.hashes5: Dict[tuple, Digest] = {}
        self.hashes3_diff: Dict[tuple, Digest] = {}
        self.hashes4_diff: Dict[tuple, Digest] = {}
        self.hashes5_diff: Dict[tuple, Digest] = {}
        self.str_cache: Dict[str, ZPtr] = {}
        self.sym_cache: Dict[Symbol, ZPtr] = {}
        self.syn_cache: Dict[object, ZPtr] = {}
        self.lang_symbols = set(lang_symbols or ())
        self.builtin_set = {builtin_sym(n) for n in BUILTIN_SYMBOLS}
        self.nil = self.intern_symbol(lurk_sym("nil"))
        self.t = self.intern_symbol(lurk_sym("t"))
        self.quote = self.intern_symbol(builtin_sym("quote"))

    # -- hashing ----------------------------------------------------------

    def _hash(self, preimg: tuple, cache: dict, diff: dict) -> Digest:
        img = cache.get(preimg)
        if img is not None:
            return img
        digest = tuple(pref.permute_s(list(preimg))[:DIGEST_SIZE])
        cache[preimg] = digest
        diff[preimg] = digest
        return digest

    def hash3(self, preimg) -> Digest:
        assert len(preimg) == HASH3_SIZE
        return self._hash(tuple(preimg), self.hashes3, self.hashes3_diff)

    def hash4(self, preimg) -> Digest:
        assert len(preimg) == HASH4_SIZE
        return self._hash(tuple(preimg), self.hashes4, self.hashes4_diff)

    def hash5(self, preimg) -> Digest:
        assert len(preimg) == HASH5_SIZE
        return self._hash(tuple(preimg), self.hashes5, self.hashes5_diff)

    # -- interning --------------------------------------------------------

    def intern_tuple11(self, tag, a: ZPtr, b: ZPtr) -> ZPtr:
        digest = self.hash4(flatten_tuple11(a, b))
        zptr = ZPtr(int(tag), digest)
        self.dag[zptr] = (TUPLE11, a, b)
        return zptr

    def intern_tuple110(self, tag, a: ZPtr, b: ZPtr, c: ZPtr) -> ZPtr:
        digest = self.hash5(flatten_tuple110(a, b, c))
        zptr = ZPtr(int(tag), digest)
        self.dag[zptr] = (TUPLE110, a, b, c)
        return zptr

    def _atom(self, zptr: ZPtr) -> ZPtr:
        self.dag[zptr] = (ATOM,)
        return zptr

    def intern_null(self, tag) -> ZPtr:
        return self._atom(ZPtr.null(tag))

    def intern_empty_env(self) -> ZPtr:
        return self.intern_null(Tag.Env)

    def intern_num(self, f: int) -> ZPtr:
        return self._atom(ZPtr.num(f))

    def intern_char(self, c: str) -> ZPtr:
        return self._atom(ZPtr.char(c))

    def intern_u64(self, u: int) -> ZPtr:
        return self._atom(ZPtr.u64(u))

    def intern_big_num(self, digest) -> ZPtr:
        return self._atom(ZPtr.big_num(digest))

    def intern_comm(self, digest) -> ZPtr:
        return self._atom(ZPtr.comm(digest))

    def intern_error(self, e: EvalErr) -> ZPtr:
        return self._atom(ZPtr.err(e))

    def intern_string(self, s: str) -> ZPtr:
        zptr = self.str_cache.get(s)
        if zptr is not None:
            return zptr
        zptr = self.intern_null(Tag.Str)
        for c in reversed(s):
            zptr = self.intern_tuple11(Tag.Str, self.intern_char(c), zptr)
        self.str_cache[s] = zptr
        return zptr

    def intern_symbol(self, sym: Symbol) -> ZPtr:
        zptr = self.sym_cache.get(sym)
        if zptr is not None:
            return zptr
        is_keyword = sym.is_keyword()
        if not sym.path:
            tag = Tag.Key if is_keyword else Tag.Sym
            zptr = self.intern_null(tag)
        else:
            zptr = self.intern_null(Tag.Sym)
            n = len(sym.path)
            for i, s in enumerate(sym.path):
                is_last = i == n - 1
                str_zptr = self.intern_string(s)
                if is_last:
                    if sym in self.builtin_set:
                        tag = Tag.Builtin
                    elif sym in self.lang_symbols:
                        tag = Tag.Coroutine
                    elif is_keyword:
                        tag = Tag.Key
                    else:
                        tag = Tag.Sym
                else:
                    tag = Tag.Sym
                zptr = self.intern_tuple11(tag, str_zptr, zptr)
        self.sym_cache[sym] = zptr
        return zptr

    def intern_list(self, xs, tail: Optional[ZPtr] = None) -> ZPtr:
        acc = tail if tail is not None else self.nil
        for x in reversed(list(xs)):
            acc = self.intern_tuple11(Tag.Cons, x, acc)
        return acc

    def intern_cons(self, car: ZPtr, cdr: ZPtr) -> ZPtr:
        return self.intern_tuple11(Tag.Cons, car, cdr)

    def intern_fun(self, args: ZPtr, body: ZPtr, env: ZPtr) -> ZPtr:
        return self.intern_tuple110(Tag.Fun, args, body, env)

    def intern_env(self, sym: ZPtr, val: ZPtr, env: ZPtr) -> ZPtr:
        return self.intern_tuple110(Tag.Env, sym, val, env)

    def intern_fix(self, body: ZPtr, binds: ZPtr, mutual_env: ZPtr) -> ZPtr:
        return self.intern_tuple110(Tag.Fix, body, binds, mutual_env)

    def intern_quoted(self, zptr: ZPtr) -> ZPtr:
        return self.intern_list([self.quote, zptr])

    def intern_syntax(self, syn) -> ZPtr:
        from .parser import (SynNum, SynChar, SynU64, SynBigNum, SynComm,
                             SynString, SynSymbol, SynList, SynImproper,
                             SynQuote)
        key = syn
        cached = self.syn_cache.get(key)
        if cached is not None:
            return cached
        if isinstance(syn, SynNum):
            z = self.intern_num(syn.value)
        elif isinstance(syn, SynChar):
            z = self.intern_char(syn.value)
        elif isinstance(syn, SynU64):
            z = self.intern_u64(syn.value)
        elif isinstance(syn, SynBigNum):
            z = self.intern_big_num(syn.value)
        elif isinstance(syn, SynComm):
            z = self.intern_comm(syn.value)
        elif isinstance(syn, SynString):
            z = self.intern_string(syn.value)
        elif isinstance(syn, SynSymbol):
            z = self.intern_symbol(syn.value)
        elif isinstance(syn, SynList):
            z = self.intern_list([self.intern_syntax(x) for x in syn.items])
        elif isinstance(syn, SynImproper):
            z = self.intern_list([self.intern_syntax(x) for x in syn.items],
                                 self.intern_syntax(syn.tail))
        elif isinstance(syn, SynQuote):
            z = self.intern_list([self.quote, self.intern_syntax(syn.inner)])
        else:
            raise TypeError(f"not supported: {syn}")
        self.syn_cache[key] = z
        return z

    def read(self, input_str: str, state: Optional[State] = None) -> ZPtr:
        from .parser import parse
        state = state or State.init_lurk_state()
        syn, _rest = parse(input_str, state)
        assert syn is not None, "no input"
        return self.intern_syntax(syn)

    # -- dag reconstruction (reference: zstore.rs:569-702) ----------------

    def memoize_dag(self, tag, digest, hashes4_inv, hashes5_inv):
        tag = int(tag)
        digest = tuple(digest)
        zptr = ZPtr(tag, digest)
        if zptr in self.dag:
            return
        zeros = (0,) * DIGEST_SIZE

        if tag == Tag.Str:
            while True:
                if digest == zeros:
                    self._atom(ZPtr(tag, zeros))
                    break
                preimg = hashes4_inv[digest]
                head, tail = preimg[:ZPTR_SIZE], preimg[ZPTR_SIZE:]
                head_digest = tuple(head[DIGEST_SIZE:])
                tail_digest = tuple(tail[DIGEST_SIZE:])
                self.dag[ZPtr(tag, digest)] = (
                    TUPLE11, ZPtr(int(Tag.Char), head_digest),
                    ZPtr(int(Tag.Str), tail_digest))
                digest = tail_digest
        elif tag == Tag.Cons:
            while True:
                preimg = hashes4_inv[digest]
                car, cdr = preimg[:ZPTR_SIZE], preimg[ZPTR_SIZE:]
                car_tag, car_digest = int(car[0]), tuple(car[DIGEST_SIZE:])
                cdr_tag, cdr_digest = int(cdr[0]), tuple(cdr[DIGEST_SIZE:])
                self.memoize_dag(car_tag, car_digest, hashes4_inv, hashes5_inv)
                self.dag[ZPtr(tag, digest)] = (
                    TUPLE11, ZPtr(car_tag, car_digest), ZPtr(cdr_tag, cdr_digest))
                if cdr_tag != Tag.Cons:
                    self.memoize_dag(cdr_tag, cdr_digest, hashes4_inv, hashes5_inv)
                    break
                digest = cdr_digest
        elif tag == Tag.Env:
            while True:
                if digest == zeros:
                    self._atom(ZPtr(tag, zeros))
                    break
                preimg = hashes5_inv[digest]
                var = preimg[:ZPTR_SIZE]
                val = preimg[ZPTR_SIZE:2 * ZPTR_SIZE]
                env_digest = tuple(preimg[2 * ZPTR_SIZE:])
                var_tag, var_digest = int(var[0]), tuple(var[DIGEST_SIZE:])
                val_tag, val_digest = int(val[0]), tuple(val[DIGEST_SIZE:])
                self.memoize_dag(var_tag, var_digest, hashes4_inv, hashes5_inv)
                self.memoize_dag(val_tag, val_digest, hashes4_inv, hashes5_inv)
                self.dag[ZPtr(tag, digest)] = (
                    TUPLE110, ZPtr(var_tag, var_digest),
                    ZPtr(val_tag, val_digest), ZPtr(int(Tag.Env), env_digest))
                digest = env_digest
        elif tag in (Tag.Fun, Tag.Fix):
            preimg = hashes5_inv[digest]
            args = preimg[:ZPTR_SIZE]
            body = preimg[ZPTR_SIZE:2 * ZPTR_SIZE]
            env_digest = tuple(preimg[2 * ZPTR_SIZE:])
            args_tag, args_digest = int(args[0]), tuple(args[DIGEST_SIZE:])
            body_tag, body_digest = int(body[0]), tuple(body[DIGEST_SIZE:])
            self.memoize_dag(args_tag, args_digest, hashes4_inv, hashes5_inv)
            self.memoize_dag(body_tag, body_digest, hashes4_inv, hashes5_inv)
            self.memoize_dag(int(Tag.Env), env_digest, hashes4_inv, hashes5_inv)
            self.dag[ZPtr(tag, digest)] = (
                TUPLE110, ZPtr(args_tag, args_digest),
                ZPtr(body_tag, body_digest), ZPtr(int(Tag.Env), env_digest))
        elif tag in (Tag.Sym, Tag.Key, Tag.Builtin, Tag.Coroutine):
            pass  # already memoized
        else:
            self._atom(ZPtr(tag, digest))

    # -- fetching ---------------------------------------------------------

    def fetch_tuple11(self, zptr: ZPtr):
        entry = self.dag.get(zptr)
        assert entry is not None and entry[0] == TUPLE11, \
            f"Tuple11 data not found on DAG: {zptr}"
        return entry[1], entry[2]

    def fetch_tuple110(self, zptr: ZPtr):
        entry = self.dag.get(zptr)
        assert entry is not None and entry[0] == TUPLE110, \
            f"Tuple110 data not found on DAG: {zptr}"
        return entry[1], entry[2], entry[3]

    def fetch_string(self, zptr: ZPtr) -> str:
        assert zptr.tag == Tag.Str
        out = []
        zeros = (0,) * DIGEST_SIZE
        while zptr.digest != zeros:
            car, cdr = self.fetch_tuple11(zptr)
            out.append(_get_char(car.digest))
            zptr = cdr
        return "".join(out)

    def fetch_symbol_path(self, zptr: ZPtr) -> List[str]:
        path = []
        zeros = (0,) * DIGEST_SIZE
        while zptr.digest != zeros:
            car, cdr = self.fetch_tuple11(zptr)
            path.append(self.fetch_string(car))
            zptr = cdr
        path.reverse()
        return path

    def fetch_symbol(self, zptr: ZPtr) -> Symbol:
        assert zptr.tag in (Tag.Sym, Tag.Builtin, Tag.Key, Tag.Coroutine)
        return Symbol(tuple(self.fetch_symbol_path(zptr)),
                      zptr.tag == Tag.Key)

    def fetch_list(self, zptr: ZPtr):
        assert zptr.tag == Tag.Cons or zptr == self.nil
        elts = []
        while zptr.tag == Tag.Cons:
            car, cdr = self.fetch_tuple11(zptr)
            elts.append(car)
            zptr = cdr
        if zptr == self.nil:
            return elts, None
        return elts, zptr

    def fetch_env(self, zptr: ZPtr):
        assert zptr.tag == Tag.Env
        out = []
        zeros = (0,) * DIGEST_SIZE
        while zptr.digest != zeros:
            var, val, tail = self.fetch_tuple110(zptr)
            out.append((var, val))
            zptr = tail
        return out

    # -- display ----------------------------------------------------------

    def fmt_with_state(self, state: State, zptr: ZPtr) -> str:
        tag = zptr.tag
        if tag == Tag.Num:
            return f"{zptr.digest[0]}n"
        if tag == Tag.U64:
            u = sum(b << (8 * i) for i, b in enumerate(zptr.digest))
            return str(u)
        if tag == Tag.Char:
            return f"'{_get_char(zptr.digest)}'"
        if tag == Tag.BigNum:
            return f"#{_digest_to_biguint_hex(zptr.digest)}"
        if tag == Tag.Comm:
            return f"#c{_digest_to_biguint_hex(zptr.digest)}"
        if tag == Tag.Str:
            return f'"{self.fetch_string(zptr)}"'
        if tag in (Tag.Builtin, Tag.Sym, Tag.Key, Tag.Coroutine):
            return state.fmt_to_string(self.fetch_symbol(zptr))
        if tag == Tag.Cons:
            elts, last = self.fetch_list(zptr)
            parts = " ".join(self.fmt_with_state(state, z) for z in elts)
            if last is not None:
                return f"({parts} . {self.fmt_with_state(state, last)})"
            return f"({parts})"
        if tag == Tag.Fun:
            args, body, _ = self.fetch_tuple110(zptr)
            if args == self.nil:
                return f"<Fun () {self.fmt_with_state(state, body)}>"
            return (f"<Fun {self.fmt_with_state(state, args)} "
                    f"{self.fmt_with_state(state, body)}>")
        if tag == Tag.Env:
            pairs = " ".join(
                f"({self.fmt_with_state(state, s)} . {self.fmt_with_state(state, v)})"
                for s, v in self.fetch_env(zptr))
            return f"<Env ({pairs})>"
        if tag == Tag.Fix:
            body, _, _ = self.fetch_tuple110(zptr)
            return f"<Fix {self.fmt_with_state(state, body)}>"
        if tag == Tag.Err:
            return f"<Err {EvalErr(zptr.digest[0]).name}>"
        raise ValueError(f"unknown tag {tag}")

    def fmt(self, zptr: ZPtr) -> str:
        return self.fmt_with_state(State.init_lurk_state(), zptr)


def _get_char(digest) -> str:
    bs = bytes(b for b in digest[:4])
    s = bs.decode("utf-8").rstrip("\0")
    assert all(b == 0 for b in digest[4:])
    return s[0] if s else "\0"


def _digest_to_biguint_hex(digest) -> str:
    p = 2013265921
    num = 0
    for d in reversed(digest):
        num = num * p + d
    return hex(num)


def lurk_zstore(lang_symbols=None) -> ZStore:
    return ZStore(lang_symbols)
