"""Hash and u64 wrapper Lair functions (reference: src/core/misc.rs)."""

from __future__ import annotations

from ..lair.dsl import FuncBuilder


def hash3():
    b = FuncBuilder("hash3", [("preimg", 24)], 8, invertible=True)
    img, = b.extern_call("hasher3", b.input("preimg"), out_sizes=(8,))
    b.ret(img)
    return b.build()


def hash4():
    b = FuncBuilder("hash4", [("preimg", 32)], 8, invertible=True)
    img, = b.extern_call("hasher4", b.input("preimg"), out_sizes=(8,))
    b.ret(img)
    return b.build()


def hash5():
    b = FuncBuilder("hash5", [("preimg", 40)], 8, invertible=True)
    img, = b.extern_call("hasher5", b.input("preimg"), out_sizes=(8,))
    b.ret(img)
    return b.build()


def _u64_binop(name: str):
    b = FuncBuilder(name, ["a", "bv"], 1)
    a, = b.load(b.input("a"), [8])
    bb_, = b.load(b.input("bv"), [8])
    c, = b.extern_call(name, a, bb_, out_sizes=(8,))
    c = b.store(c)
    b.ret(c)
    return b.build()


def u64_add():
    return _u64_binop("u64_add")


def u64_sub():
    return _u64_binop("u64_sub")


def u64_mul():
    return _u64_binop("u64_mul")


def u64_divrem():
    b = FuncBuilder("u64_divrem", ["a", "bv"], 2)
    a, = b.load(b.input("a"), [8])
    bb_, = b.load(b.input("bv"), [8])
    q, r = b.extern_call("u64_divrem", a, bb_, out_sizes=(8, 8))
    q = b.store(q)
    r = b.store(r)
    b.ret(q, r)
    return b.build()


def u64_lessthan():
    b = FuncBuilder("u64_lessthan", ["a", "bv"], 1)
    a, = b.load(b.input("a"), [8])
    bb_, = b.load(b.input("bv"), [8])
    c, = b.extern_call("u64_lessthan", a, bb_, out_sizes=(1,))
    b.ret(c)
    return b.build()


def u64_iszero():
    b = FuncBuilder("u64_iszero", ["a"], 1)
    a, = b.load(b.input("a"), [8])
    c, = b.extern_call("u64_iszero", a, out_sizes=(1,))
    b.ret(c)
    return b.build()


def digest_equal():
    b = FuncBuilder("digest_equal", ["a", "bv"], 1)
    a, = b.load(b.input("a"), [8])
    bb_, = b.load(b.input("bv"), [8])
    diff = b.sub(a, bb_)

    def nonzero(b2):
        zero = b2.const(0)
        b2.ret(zero)

    def zero(b2):
        one = b2.const(1)
        b2.ret(one)

    b.if_(diff, nonzero, zero)
    return b.build()


def big_num_lessthan():
    b = FuncBuilder("big_num_lessthan", ["a", "bv"], 1)
    a, = b.load(b.input("a"), [8])
    bb_, = b.load(b.input("bv"), [8])
    c, = b.extern_call("big_num_lessthan", a, bb_, out_sizes=(1,))
    b.ret(c)
    return b.build()
