"""Symbol digest preallocation + ingress/egress Lair functions.

Faithful port of reference: src/core/ingress.rs. `ingress` converts
(tag_full[8], digest[8]) into compact (tag, ptr) VM pointers, unhashing
compounds via preimg(hash4/hash5); `egress` is the inverse, re-hashing via
call(hash4/hash5). `preallocate_symbols` stores all Lurk/builtin/lang symbol
digests at deterministic width-8 memory addresses (index+1).
"""

from __future__ import annotations

from typing import Dict

from ..lair.dsl import FuncBuilder
from .state import LURK_SYMBOLS, BUILTIN_SYMBOLS
from .symbol import Symbol, lurk_sym, builtin_sym
from .tag import Tag, InternalTag


class SymbolsDigests:
    """Symbol -> (digest, deterministic width-8 memory address)."""

    def __init__(self, zstore, lang_symbols=()):
        self.map: Dict[Symbol, tuple] = {}
        for name in LURK_SYMBOLS:
            sym = lurk_sym(name)
            zptr = zstore.intern_symbol(sym)
            assert zptr.tag == Tag.Sym
            self.map[sym] = zptr.digest
        for name in BUILTIN_SYMBOLS:
            sym = builtin_sym(name)
            zptr = zstore.intern_symbol(sym)
            assert zptr.tag == Tag.Builtin
            self.map[sym] = zptr.digest
        for sym in lang_symbols:
            zptr = zstore.intern_symbol(sym)
            assert zptr.tag == Tag.Coroutine
            assert sym not in self.map, \
                f"{sym} conflicts with Lurk's native symbols"
            self.map[sym] = zptr.digest
        self._index = {sym: i for i, sym in enumerate(self.map)}

    def symbol_ptr(self, sym: Symbol) -> int:
        # + 1 because available memory starts from 1 (0 is reserved)
        return self._index[sym] + 1

    def lurk_symbol_ptr(self, name: str) -> int:
        return self.symbol_ptr(lurk_sym(name))

    def builtin_symbol_ptr(self, name: str) -> int:
        return self.symbol_ptr(builtin_sym(name))

    def symbol_digest(self, sym: Symbol) -> tuple:
        return self.map[sym]

    def lurk_symbol_digest(self, name: str) -> tuple:
        return self.map[lurk_sym(name)]


def preallocate_symbols(digests: SymbolsDigests):
    b = FuncBuilder("preallocate_symbols", [], 0)
    for sym, digest in digests.map.items():
        arr = b.array(list(digest))
        ptr = b.store(arr)
        addr = b.const(digests.symbol_ptr(sym))
        b.assert_eq(ptr, addr)
    b.ret()
    return b.build()


def ingress(digests: SymbolsDigests):
    b = FuncBuilder("ingress", [("tag_full", 8), ("digest", 8)], 2)
    tag_full = b.input("tag_full")
    digest = b.input("digest")
    zeros = b.array([0] * 7)
    tag, rest = b.split([tag_full], [1, 7])
    b.assert_eq(rest, zeros)

    def case_num(bb):
        x, rest7 = bb.split([digest], [1, 7])
        bb.assert_eq(rest7, zeros)
        bb.ret(tag, x)

    def case_char(bb):
        bytes4, rest4 = bb.split([digest], [4, 4])
        bb.range_u8(bytes4)
        zeros4 = bb.array([0] * 4)
        bb.assert_eq(rest4, zeros4)
        ptr = bb.store(bytes4)
        bb.ret(tag, ptr)

    def case_u64(bb):
        bb.range_u8(digest)
        ptr = bb.store(digest)
        bb.ret(tag, ptr)

    def case_sym(bb):
        nil_digest = bb.array(list(digests.lurk_symbol_digest("nil")))
        not_nil = bb.sub(digest, nil_digest)

        def not_nil_cont(b2):
            t_digest = b2.array(list(digests.lurk_symbol_digest("t")))
            not_t = b2.sub(digest, t_digest)

            def not_t_cont(b3):
                ptr = b3.store(digest)
                b3.ret(tag, ptr)

            def is_t(b3):
                t_tag = b3.const(InternalTag.T)
                ptr = b3.const(digests.lurk_symbol_ptr("t"))
                b3.ret(t_tag, ptr)

            b2.if_(not_t, not_t_cont, is_t)

        def is_nil(b2):
            nil_tag = b2.const(InternalTag.Nil)
            ptr = b2.const(digests.lurk_symbol_ptr("nil"))
            b2.ret(nil_tag, ptr)

        bb.if_(not_nil, not_nil_cont, is_nil)

    def case_opaque(bb):
        ptr = bb.store(digest)
        bb.ret(tag, ptr)

    def case_str(bb):
        def nonzero(b2):
            outs = b2.preimg("hash4", digest, out_sizes=(8, 8, 8, 8))
            fst_tag_full, fst_digest, snd_tag_full, snd_digest = outs
            fst_tag, fst_ptr = b2.call("ingress", fst_tag_full, fst_digest,
                                       out_sizes=(1, 1))
            snd_tag, snd_ptr = b2.call("ingress", snd_tag_full, snd_digest,
                                       out_sizes=(1, 1))
            ptr = b2.store(fst_tag, fst_ptr, snd_tag, snd_ptr)
            b2.ret(tag, ptr)

        def zero(b2):
            z = b2.const(0)
            b2.ret(tag, z)

        bb.if_(digest, nonzero, zero)

    def case_cons(bb):
        outs = bb.preimg("hash4", digest, out_sizes=(8, 8, 8, 8))
        fst_tag_full, fst_digest, snd_tag_full, snd_digest = outs
        fst_tag, fst_ptr = bb.call("ingress", fst_tag_full, fst_digest,
                                   out_sizes=(1, 1))
        snd_tag, snd_ptr = bb.call("ingress", snd_tag_full, snd_digest,
                                   out_sizes=(1, 1))
        ptr = bb.store(fst_tag, fst_ptr, snd_tag, snd_ptr)
        bb.ret(tag, ptr)

    def case_fun_fix(bb):
        outs = bb.preimg("hash5", digest, out_sizes=(8, 8, 8, 8, 8))
        args_tag_full, args_digest, body_tag_full, body_digest, env_digest = outs
        env_tag = bb.const(Tag.Env)
        args_tag, args_ptr = bb.call("ingress", args_tag_full, args_digest,
                                     out_sizes=(1, 1))
        body_tag, body_ptr = bb.call("ingress", body_tag_full, body_digest,
                                     out_sizes=(1, 1))
        _env_tag, env_ptr = bb.call("ingress", env_tag, zeros, env_digest,
                                    out_sizes=(1, 1))
        ptr = bb.store(args_tag, args_ptr, body_tag, body_ptr, env_ptr)
        bb.ret(tag, ptr)

    def case_env(bb):
        def nonzero(b2):
            outs = b2.preimg("hash5", digest, out_sizes=(8, 8, 8, 8, 8))
            var_tag_full, var_digest, val_tag_full, val_digest, env_digest = outs
            var_tag, var_ptr = b2.call("ingress", var_tag_full, var_digest,
                                       out_sizes=(1, 1))
            val_tag, val_ptr = b2.call("ingress", val_tag_full, val_digest,
                                       out_sizes=(1, 1))
            _tag, env_ptr = b2.call("ingress", tag, zeros, env_digest,
                                    out_sizes=(1, 1))
            ptr = b2.store(var_tag, var_ptr, val_tag, val_ptr, env_ptr)
            b2.ret(tag, ptr)

        def zero(b2):
            z = b2.const(0)
            b2.ret(tag, z)

        bb.if_(digest, nonzero, zero)

    b.match(tag, [
        (int(Tag.Num), case_num),
        (int(Tag.Char), case_char),
        (int(Tag.U64), case_u64),
        (int(Tag.Sym), case_sym),
        ((int(Tag.Builtin), int(Tag.Coroutine), int(Tag.Key),
          int(Tag.BigNum), int(Tag.Comm)), case_opaque),
        (int(Tag.Str), case_str),
        (int(Tag.Cons), case_cons),
        ((int(Tag.Fun), int(Tag.Fix)), case_fun_fix),
        (int(Tag.Env), case_env),
    ])
    return b.build()


def egress(digests: SymbolsDigests):
    b = FuncBuilder("egress", ["tag", "val"], 9)
    tag = b.input("tag")
    val = b.input("val")

    def case_num_err(bb):
        padding = bb.array([0] * 7)
        digest, = bb.split([val, padding], [8])
        bb.ret(tag, digest)

    def case_char(bb):
        padding = bb.array([0] * 4)
        bytes4, = bb.load(val, [4])
        bb.ret(tag, bytes4, padding)

    def case_nil(bb):
        sym_tag = bb.const(Tag.Sym)
        digest = bb.array(list(digests.lurk_symbol_digest("nil")))
        bb.ret(sym_tag, digest)

    def case_t(bb):
        sym_tag = bb.const(Tag.Sym)
        digest = bb.array(list(digests.lurk_symbol_digest("t")))
        bb.ret(sym_tag, digest)

    def case_opaque(bb):
        digest, = bb.load(val, [8])
        bb.ret(tag, digest)

    def _compound2(bb):
        fst_tag, fst_ptr, snd_tag, snd_ptr = bb.load(val, [1, 1, 1, 1])
        fst_tag2, fst_digest = bb.call("egress", fst_tag, fst_ptr,
                                       out_sizes=(1, 8))
        snd_tag2, snd_digest = bb.call("egress", snd_tag, snd_ptr,
                                       out_sizes=(1, 8))
        padding = bb.array([0] * 7)
        fst_tag_full, = bb.split([fst_tag2, padding], [8])
        snd_tag_full, = bb.split([snd_tag2, padding], [8])
        digest, = bb.call("hash4", fst_tag_full, fst_digest, snd_tag_full,
                          snd_digest, out_sizes=(8,))
        bb.ret(tag, digest)

    def case_str(bb):
        def nonzero(b2):
            _compound2(b2)

        def zero(b2):
            digest = b2.array([0] * 8)
            b2.ret(tag, digest)

        bb.if_(val, nonzero, zero)

    def case_cons(bb):
        _compound2(bb)

    def case_fun_fix(bb):
        args_tag, args_ptr, body_tag, body_ptr, env_ptr = bb.load(
            val, [1, 1, 1, 1, 1])
        args_tag2, args_digest = bb.call("egress", args_tag, args_ptr,
                                         out_sizes=(1, 8))
        body_tag2, body_digest = bb.call("egress", body_tag, body_ptr,
                                         out_sizes=(1, 8))
        env_tag = bb.const(Tag.Env)
        _env_tag, env_digest = bb.call("egress", env_tag, env_ptr,
                                       out_sizes=(1, 8))
        padding = bb.array([0] * 7)
        args_tag_full, = bb.split([args_tag2, padding], [8])
        body_tag_full, = bb.split([body_tag2, padding], [8])
        digest, = bb.call("hash5", args_tag_full, args_digest, body_tag_full,
                          body_digest, env_digest, out_sizes=(8,))
        bb.ret(tag, digest)

    def case_env(bb):
        def nonzero(b2):
            var_tag, var_ptr, val_tag, val_ptr, env_ptr = b2.load(
                val, [1, 1, 1, 1, 1])
            var_tag2, var_digest = b2.call("egress", var_tag, var_ptr,
                                           out_sizes=(1, 8))
            val_tag2, val_digest = b2.call("egress", val_tag, val_ptr,
                                           out_sizes=(1, 8))
            _tag, env_digest = b2.call("egress", tag, env_ptr,
                                       out_sizes=(1, 8))
            padding = b2.array([0] * 7)
            var_tag_full, = b2.split([var_tag2, padding], [8])
            val_tag_full, = b2.split([val_tag2, padding], [8])
            digest, = b2.call("hash5", var_tag_full, var_digest, val_tag_full,
                              val_digest, env_digest, out_sizes=(8,))
            b2.ret(tag, digest)

        def zero(b2):
            digest = b2.array([0] * 8)
            b2.ret(tag, digest)

        bb.if_(val, nonzero, zero)

    b.match(tag, [
        ((int(Tag.Num), int(Tag.Err)), case_num_err),
        (int(Tag.Char), case_char),
        (int(InternalTag.Nil), case_nil),
        (int(InternalTag.T), case_t),
        ((int(Tag.Sym), int(Tag.Builtin), int(Tag.Coroutine), int(Tag.Key),
          int(Tag.U64), int(Tag.BigNum), int(Tag.Comm)), case_opaque),
        (int(Tag.Str), case_str),
        (int(Tag.Cons), case_cons),
        ((int(Tag.Fun), int(Tag.Fix)), case_fun_fix),
        (int(Tag.Env), case_env),
    ])
    return b.build()
