"""Unsigned multi-limb arithmetic gadgets (u8-limb words).

Each gadget provides three faces (reference: src/gadgets/unsigned/):
  * execute(in..., byte_ctx)            - execution-side: computes the result
    while recording byte-table requires in the canonical order
  * populate_batch(inputs...)           - witness-side: vectorized numpy
    witness column generation for trace replay (DummyBytesRecord semantics)
  * eval(builder, ..., byte_events)     - AIR-side: constraints + byte events
    in the same order the requires were recorded

Witness layouts are bit-compatible with the reference (sizes asserted in
tests against the reference's expect-test snapshots).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..field.babybear import P, inv_s
from ..air.symbolic import Const

U = np.uint64
_P = U(P)

BYTE_TAG = 3
OP_RANGE_U8_PAIR = 1
OP_RANGE_U16 = 2
OP_LESS_THAN = 3


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def bytes_to_u64(limbs) -> int:
    out = 0
    for i, b in enumerate(limbs):
        out |= int(b) << (8 * i)
    return out


def u64_to_bytes(x: int, w: int = 8):
    return [(x >> (8 * i)) & 0xFF for i in range(w)]


def _np_bytes(vals: np.ndarray, w: int = 8) -> np.ndarray:
    """(n,) uint64 -> (n, w) LE bytes."""
    return np.stack([(vals >> U(8 * i)) & U(0xFF) for i in range(w)], axis=1)


def _np_u64(mat: np.ndarray) -> np.ndarray:
    """(n, 8) byte cols -> (n,) uint64."""
    out = np.zeros(mat.shape[0], U)
    for i in range(mat.shape[1]):
        out |= mat[:, i].astype(U) << U(8 * i)
    return out


def batch_inv_np(a: np.ndarray) -> np.ndarray:
    a = a.astype(U) % _P
    result = np.ones_like(a)
    base = a.copy()
    e = P - 2
    while e:
        if e & 1:
            result = (result * base) % _P
        base = (base * base) % _P
        e >>= 1
    return result


def _range_u8_events(byte_events, limbs, is_real):
    """AIR-side pairwise u8 range events for a list of limb exprs."""
    for i in range(0, len(limbs), 2):
        x2 = limbs[i + 1] if i + 1 < len(limbs) else Const(0)
        byte_events.append(([Const(BYTE_TAG), Const(OP_RANGE_U8_PAIR),
                             limbs[i], x2], is_real))


def _ms_diff_witness_vals(lhs: np.ndarray, rhs: np.ndarray):
    """Like _ms_diff_witness but over arbitrary field-element columns
    (used for big-num compare, where 'limbs' are full field elements)."""
    return _ms_diff_witness(lhs, rhs)


def _ms_diff_witness(lhs_b: np.ndarray, rhs_b: np.ndarray):
    """Most-significant differing limb: (is_comp (n,W), l_limb, r_limb, found)."""
    n, w = lhs_b.shape
    diff = lhs_b != rhs_b
    rev = diff[:, ::-1]
    found = rev.any(axis=1)
    ms = np.where(found, w - 1 - np.argmax(rev, axis=1), 0)
    is_comp = np.zeros((n, w), U)
    rows = np.arange(n)
    is_comp[rows[found], ms[found]] = 1
    l_limb = np.where(found, lhs_b[rows, ms], 0).astype(U)
    r_limb = np.where(found, rhs_b[rows, ms], 0).astype(U)
    return is_comp, l_limb, r_limb, found


# ---------------------------------------------------------------------------
# Sum / Diff (reference: src/gadgets/unsigned/add.rs)
# ---------------------------------------------------------------------------

class SumGadget:
    """result[W]; lhs + rhs mod 2^64 with carry-chain constraints."""
    W = 8
    witness_size = 8
    num_requires = 4

    @staticmethod
    def execute(a: int, b: int, byte_ctx) -> List[int]:
        out = (a + b) & ((1 << 64) - 1)
        limbs = u64_to_bytes(out)
        byte_ctx.range_check_u8_iter(limbs)
        return limbs

    @staticmethod
    def populate_batch(a: np.ndarray, b: np.ndarray):
        out = a + b  # uint64 wraps
        w = _np_bytes(out)
        return w, w

    @staticmethod
    def eval(builder, ins, witness, byte_events, is_real):
        lhs, rhs = ins[:8], ins[8:16]
        result = list(witness[:8])
        _range_u8_events(byte_events, result, is_real)
        _assert_add(builder, lhs, rhs, result, is_real)
        return result


def _assert_add(builder, lhs, rhs, out, is_real):
    base_inv = Const(inv_s(256))
    carry = Const(0)
    with builder.when(is_real):
        for o, i1, i2 in zip(out, lhs, rhs):
            s = i1 + i2 + carry
            carry = (s - o) * base_inv
            builder.assert_bool(carry)
    return carry


class DiffGadget:
    W = 8
    witness_size = 8
    num_requires = 4

    @staticmethod
    def execute(a: int, b: int, byte_ctx) -> List[int]:
        out = (a - b) & ((1 << 64) - 1)
        limbs = u64_to_bytes(out)
        byte_ctx.range_check_u8_iter(limbs)
        return limbs

    @staticmethod
    def populate_batch(a: np.ndarray, b: np.ndarray):
        out = a - b
        w = _np_bytes(out)
        return w, w

    @staticmethod
    def eval(builder, ins, witness, byte_events, is_real):
        lhs, rhs = ins[:8], ins[8:16]
        result = list(witness[:8])
        _range_u8_events(byte_events, result, is_real)
        # result + rhs = lhs
        _assert_add(builder, result, rhs, lhs, is_real)
        return result


# ---------------------------------------------------------------------------
# Product (reference: src/gadgets/unsigned/mul.rs)
# ---------------------------------------------------------------------------

class ProductGadget:
    """witness = carry[W] ++ result[W]; schoolbook mult with u16 carries."""
    W = 8
    witness_size = 16
    num_requires = 12  # 8 u16 carries + 4 u8 pairs

    @staticmethod
    def execute(a: int, b: int, byte_ctx) -> List[int]:
        la, lb = u64_to_bytes(a), u64_to_bytes(b)
        carries, result = ProductGadget._mul_core(la, lb)
        for c in carries:
            byte_ctx.range_check_u16(c)
        byte_ctx.range_check_u8_iter(result)
        return result

    @staticmethod
    def _mul_core(la, lb):
        w = 8
        products = [0] * w
        for i in range(w):
            for j in range(w):
                if i + j < w:
                    products[i + j] += la[i] * lb[j]
        carry = 0
        carries, result = [], []
        for k in range(w):
            out = products[k] + carry
            result.append(out & 0xFF)
            carry = out >> 8
            assert carry < (1 << 16)
            carries.append(carry)
        return carries, result

    @staticmethod
    def populate_batch(a: np.ndarray, b: np.ndarray):
        n = len(a)
        la = _np_bytes(a)
        lb = _np_bytes(b)
        w = 8
        products = np.zeros((n, w), U)
        for i in range(w):
            for j in range(w):
                if i + j < w:
                    products[:, i + j] += la[:, i] * lb[:, j]
        carries = np.zeros((n, w), U)
        result = np.zeros((n, w), U)
        carry = np.zeros(n, U)
        for k in range(w):
            out = products[:, k] + carry
            result[:, k] = out & U(0xFF)
            carry = out >> U(8)
            carries[:, k] = carry
        witness = np.concatenate([carries, result], axis=1)
        return witness, result

    @staticmethod
    def eval(builder, ins, witness, byte_events, is_real):
        lhs, rhs = ins[:8], ins[8:16]
        carries = list(witness[:8])
        result = list(witness[8:16])
        _eval_mul_witness(builder, lhs, rhs, result, carries, byte_events,
                          is_real)
        _range_u8_events(byte_events, result, is_real)
        return result


def _eval_mul_witness(builder, lhs, rhs, out, carries, byte_events, is_real):
    w = len(out)
    products = [Const(0)] * w
    for i in range(len(lhs)):
        for j in range(len(rhs)):
            if i + j < w:
                products[i + j] = products[i + j] + lhs[i] * rhs[j]
    carry_prev = Const(0)
    for product, carry, limb in zip(products, carries, out):
        byte_events.append(([Const(BYTE_TAG), Const(OP_RANGE_U16), carry],
                            is_real))
        with builder.when(is_real):
            builder.assert_eq(product + carry_prev, limb + carry * 256)
        carry_prev = carry


# ---------------------------------------------------------------------------
# LessThan / Compare (reference: less_than.rs, cmp.rs)
# ---------------------------------------------------------------------------

class LessThanGadget:
    """LessThanWitness: is_comp[W] ++ [lhs_comp, rhs_comp]; asserts lhs<rhs."""
    W = 8
    witness_size = 10
    num_requires = 1

    @staticmethod
    def populate_np(lhs_b, rhs_b):
        is_comp, l_limb, r_limb, found = _ms_diff_witness(lhs_b, rhs_b)
        assert found.all(), "LessThan: operands equal"
        return np.concatenate([is_comp, l_limb[:, None], r_limb[:, None]], axis=1)

    @staticmethod
    def eval(builder, lhs, rhs, witness, byte_events, is_real):
        w = len(lhs)
        is_comp = list(witness[:w])
        l_limb, r_limb = witness[w], witness[w + 1]
        with builder.when(is_real):
            is_equal = Const(0)
            for i in range(w):
                if i > 0:
                    with builder.when(is_equal):
                        builder.assert_eq(lhs[i], rhs[i])
                builder.assert_bool(is_comp[i])
                is_equal = is_equal + is_comp[i]
            builder.assert_one(is_equal)
            sl, sr = Const(0), Const(0)
            for i in range(w):
                sl = sl + lhs[i] * is_comp[i]
                sr = sr + rhs[i] * is_comp[i]
            builder.assert_eq(sl, l_limb)
            builder.assert_eq(sr, r_limb)
        byte_events.append(([Const(BYTE_TAG), Const(OP_LESS_THAN), l_limb,
                             r_limb, Const(1)], is_real))


class CompareGadget:
    """CompareWitness: is_comp[W], lhs_comp, rhs_comp, diff_inv, is_less."""
    W = 8
    witness_size = 12
    num_requires = 1

    @staticmethod
    def execute(a: int, b: int, byte_ctx) -> List[int]:
        la, lb = u64_to_bytes(a), u64_to_bytes(b)
        for i in reversed(range(8)):
            if la[i] != lb[i]:
                byte_ctx.less_than(la[i], lb[i])
                return [1 if la[i] < lb[i] else 0]
        byte_ctx.less_than(0, 0)
        return [0]

    @staticmethod
    def _populate_from_bytes(la: np.ndarray, lb: np.ndarray):
        is_comp, l_limb, r_limb, found = _ms_diff_witness(la, lb)
        diff = (l_limb + _P - r_limb) % _P
        diff_inv = batch_inv_np(diff)
        is_less = (l_limb < r_limb).astype(U)
        witness = np.concatenate(
            [is_comp, l_limb[:, None], r_limb[:, None], diff_inv[:, None],
             is_less[:, None]], axis=1)
        return witness, is_less[:, None]

    @staticmethod
    def populate_batch(a: np.ndarray, b: np.ndarray):
        return CompareGadget._populate_from_bytes(_np_bytes(a), _np_bytes(b))

    @staticmethod
    def populate_batch_u32(a: np.ndarray, b: np.ndarray):
        """CompareWitness<4> over u32 values (big-num compare inner step)."""
        return CompareGadget._populate_from_bytes(_np_bytes(a, 4),
                                                  _np_bytes(b, 4))

    @staticmethod
    def eval(builder, ins, witness, byte_events, is_real):
        lhs, rhs = ins[:8], ins[8:16]
        out = _eval_compare(builder, lhs, rhs, witness, byte_events, is_real)
        return [out["is_less_than"]]


def _eval_compare(builder, lhs, rhs, witness, byte_events, is_real):
    w = len(lhs)
    is_comp = list(witness[:w])
    l_limb, r_limb = witness[w], witness[w + 1]
    diff_inv, is_less = witness[w + 2], witness[w + 3]
    with builder.when(is_real):
        is_equal = Const(1)
        for i in reversed(range(w)):
            builder.assert_bool(is_comp[i])
            is_equal = is_equal - is_comp[i]
            with builder.when(is_equal):
                builder.assert_eq(lhs[i], rhs[i])
        builder.assert_bool(is_equal)
        sl, sr = Const(0), Const(0)
        for i in range(w):
            sl = sl + lhs[i] * is_comp[i]
            sr = sr + rhs[i] * is_comp[i]
        builder.assert_eq(sl, l_limb)
        builder.assert_eq(sr, r_limb)
        is_different = Const(1) - is_equal
        builder.assert_eq((l_limb - r_limb) * diff_inv, is_different)
    byte_events.append(([Const(BYTE_TAG), Const(OP_LESS_THAN), l_limb, r_limb,
                         is_less], is_real))
    return {"is_less_than": is_less, "is_equal": is_equal}


# ---------------------------------------------------------------------------
# IsZero (reference: is_zero.rs)
# ---------------------------------------------------------------------------

class IsZeroGadget:
    """IsZeroOrEqual: inverses[W] ++ result."""
    W = 8
    witness_size = 9
    num_requires = 0

    @staticmethod
    def execute(a: int, byte_ctx) -> List[int]:
        return [1 if a == 0 else 0]

    @staticmethod
    def populate_batch(a: np.ndarray):
        n = len(a)
        la = _np_bytes(a)
        inverses = np.zeros((n, 8), U)
        nz = la != 0
        found = nz.any(axis=1)
        first = np.argmax(nz, axis=1)
        rows = np.arange(n)
        vals = la[rows, first]
        inv = batch_inv_np(vals)
        inverses[rows[found], first[found]] = inv[found]
        result = (~found).astype(U)
        witness = np.concatenate([inverses, result[:, None]], axis=1)
        return witness, result[:, None]

    @staticmethod
    def eval(builder, ins, witness, byte_events, is_real):
        inp = ins[:8]
        inverses = list(witness[:8])
        is_zero = witness[8]
        with builder.when(is_real):
            builder.assert_bool(is_zero)
            lc = Const(0)
            for x, w_inv in zip(inp, inverses):
                with builder.when(is_zero):
                    builder.assert_zero(x)
                lc = lc + x * w_inv
            builder.assert_eq(lc, Const(1) - is_zero)
        return [is_zero]


# ---------------------------------------------------------------------------
# DivRem (reference: div_rem.rs)
# ---------------------------------------------------------------------------

class DivRemGadget:
    """b_nonzero.inverses[8] ++ q[8] ++ Product(qb:16) ++ r[8] ++
    LessThan(r<b:10) ++ Compare(qb<=a:12) = 62 cols."""
    W = 8
    witness_size = 62
    num_requires = 22  # 4(q) + 12(product) + 4(diff) + 1(lt) + 1(cmp)

    @staticmethod
    def execute(a: int, b: int, byte_ctx) -> List[int]:
        assert b != 0, "division by zero"
        q, r = a // b, a % b
        q_l = u64_to_bytes(q)
        byte_ctx.range_check_u8_iter(q_l)
        qb = (q * b) & ((1 << 64) - 1)
        carries, qb_l = ProductGadget._mul_core(q_l, u64_to_bytes(b))
        for c in carries:
            byte_ctx.range_check_u16(c)
        byte_ctx.range_check_u8_iter(qb_l)
        r_l = u64_to_bytes((a - qb) & ((1 << 64) - 1))
        byte_ctx.range_check_u8_iter(r_l)
        # r < b
        rb, bb = u64_to_bytes(r), u64_to_bytes(b)
        for i in reversed(range(8)):
            if rb[i] != bb[i]:
                byte_ctx.less_than(rb[i], bb[i])
                break
        else:
            raise AssertionError("r == b in divrem")
        # qb <= a
        qbb, ab = qb_l, u64_to_bytes(a)
        for i in reversed(range(8)):
            if qbb[i] != ab[i]:
                byte_ctx.less_than(qbb[i], ab[i])
                break
        else:
            byte_ctx.less_than(0, 0)
        return q_l + r_l

    @staticmethod
    def populate_batch(a: np.ndarray, b: np.ndarray):
        assert (b != 0).all(), "division by zero"
        q = a // b
        r = a % b
        qb = q * b  # wraps, but q*b <= a so no wrap
        nz_w, _ = IsZeroGadget.populate_batch(b)
        b_nonzero = nz_w[:, :8]  # inverses only... reference uses IsZeroWitness
        q_b = _np_bytes(q)
        qb_w, qb_l = ProductGadget.populate_batch(q, b)
        r_b = _np_bytes(r)
        lt_w = LessThanGadget.populate_np(_np_bytes(r), _np_bytes(b))
        cmp_w, _ = CompareGadget.populate_batch(qb, a)
        witness = np.concatenate([b_nonzero, q_b, qb_w, r_b, lt_w, cmp_w],
                                 axis=1)
        out = np.concatenate([q_b, r_b], axis=1)
        return witness, out

    @staticmethod
    def eval(builder, ins, witness, byte_events, is_real):
        a, b = ins[:8], ins[8:16]
        i = 0
        b_nz_inv = list(witness[i:i + 8]); i += 8
        q = list(witness[i:i + 8]); i += 8
        qb_carries = list(witness[i:i + 8]); i += 8
        qb = list(witness[i:i + 8]); i += 8
        r = list(witness[i:i + 8]); i += 8
        lt_w = list(witness[i:i + 10]); i += 10
        cmp_w = list(witness[i:i + 12]); i += 12
        assert i == DivRemGadget.witness_size
        # b != 0
        with builder.when(is_real):
            lc = Const(0)
            for x, w_inv in zip(b, b_nz_inv):
                lc = lc + x * w_inv
            builder.assert_one(lc)
        # q range checked
        _range_u8_events(byte_events, q, is_real)
        # qb = q * b (product witness includes result range checks)
        _eval_mul_witness(builder, q, b, qb, qb_carries, byte_events, is_real)
        _range_u8_events(byte_events, qb, is_real)
        # r = a - qb  (r + qb = a)
        _range_u8_events(byte_events, r, is_real)
        _assert_add(builder, r, qb, a, is_real)
        # r < b
        LessThanGadget.eval(builder, r, b, lt_w, byte_events, is_real)
        # qb <= a
        res = _eval_compare(builder, qb, a, cmp_w, byte_events, is_real)
        with builder.when(is_real):
            builder.assert_one(res["is_less_than"] + res["is_equal"])
        return q + r
