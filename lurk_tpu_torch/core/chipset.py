"""Lurk's extern chipset: Poseidon2 hashers, u64 arithmetic, big-num compare.

Reference: src/core/chipset.rs (chip map), src/core/poseidon.rs (hash
chipsets), src/core/u64.rs, src/core/big_num.rs, src/gadgets/big_num/cmp.rs.
"""

from __future__ import annotations


import numpy as np

from ..field.babybear import P
from ..air.symbolic import Const
from ..gadgets import unsigned as ug
from ..lair.execute import ByteRecordContext
from ..poseidon import witness as pwitness
from ..poseidon import ref as pref

U = np.uint64
_P = U(P)

BABYBEAR_MSB = 0x78


def _byte_require_all(builder, byte_events, nonce, requires):
    assert len(byte_events) == len(requires), (len(byte_events), len(requires))
    for (values, is_real), record in zip(byte_events, requires):
        builder.require(values, nonce, record, is_real)


class HasherChip:
    """PoseidonChipset: permute `width` felts, output the first 8."""

    def __init__(self, width: int):
        self.width = width
        self.input_size = width
        self.output_size = 8
        self.witness_size = 8 + pwitness.num_cols(width)
        self.require_size = 0

    def execute_simple(self, inp):
        return tuple(pref.permute_s(list(inp))[:8])

    def execute(self, inp, nonce, queries, requires):
        return self.execute_simple(inp)

    def populate_witness_batch(self, inp: np.ndarray):
        return pwitness.populate_batch(self.width, inp)

    def eval(self, builder, is_real, inp, witness, nonce, requires):
        assert not requires
        return pwitness.eval_sym(builder, self.width, inp, witness, is_real)


class U64Chip:
    """u64_{add,sub,mul,divrem,lessthan,iszero} (reference: src/core/u64.rs)."""

    GADGETS = {
        "add": ug.SumGadget,
        "sub": ug.DiffGadget,
        "mul": ug.ProductGadget,
        "divrem": ug.DivRemGadget,
        "lessthan": ug.CompareGadget,
        "iszero": ug.IsZeroGadget,
    }
    OUT_SIZES = {"add": 8, "sub": 8, "mul": 8, "divrem": 16, "lessthan": 1,
                 "iszero": 1}

    def __init__(self, op: str):
        self.op = op
        g = self.GADGETS[op]
        self.input_size = 8 if op == "iszero" else 16
        self.output_size = self.OUT_SIZES[op]
        self.witness_size = g.witness_size
        self.require_size = g.num_requires

    def execute(self, inp, nonce, queries, requires):
        a = ug.bytes_to_u64(inp[:8])
        ctx = ByteRecordContext(queries.bytes, nonce, requires)
        if self.op == "iszero":
            return tuple(ug.IsZeroGadget.execute(a, ctx))
        b = ug.bytes_to_u64(inp[8:16])
        return tuple(self.GADGETS[self.op].execute(a, b, ctx))

    def populate_witness_batch(self, inp: np.ndarray):
        a = ug._np_u64(inp[:, :8])
        if self.op == "iszero":
            return ug.IsZeroGadget.populate_batch(a)
        b = ug._np_u64(inp[:, 8:16])
        return self.GADGETS[self.op].populate_batch(a, b)

    def eval(self, builder, is_real, inp, witness, nonce, requires):
        byte_events = []
        out = self.GADGETS[self.op].eval(builder, inp, witness, byte_events,
                                         is_real)
        _byte_require_all(builder, byte_events, nonce, requires)
        return out


class BigNumChip:
    """big_num_lessthan over 8-field-element big numbers (reference:
    src/gadgets/big_num/cmp.rs). Witness: is_comp[8], lhs/rhs comp limbs,
    2x FieldToWord32 (1+4 each), CompareWitness<4> (8). 28 cols, 7 requires."""

    def __init__(self):
        self.input_size = 16
        self.output_size = 1
        self.witness_size = 28
        self.require_size = 7

    def execute(self, inp, nonce, queries, requires):
        ctx = ByteRecordContext(queries.bytes, nonce, requires)
        lhs, rhs = list(inp[:8]), list(inp[8:16])
        lv, rv = 0, 0
        for i in reversed(range(8)):
            if lhs[i] != rhs[i]:
                lv, rv = lhs[i], rhs[i]
                break
        self._word_lookups(lv, ctx)
        self._word_lookups(rv, ctx)
        # CompareWitness<4> on the u32 values
        la = [(lv >> (8 * i)) & 0xFF for i in range(4)]
        ra = [(rv >> (8 * i)) & 0xFF for i in range(4)]
        for i in reversed(range(4)):
            if la[i] != ra[i]:
                ctx.less_than(la[i], ra[i])
                return (1 if la[i] < ra[i] else 0,)
        ctx.less_than(0, 0)
        return (0,)

    @staticmethod
    def _word_lookups(v: int, ctx):
        bs = [(v >> (8 * i)) & 0xFF for i in range(4)]
        ctx.less_than(bs[3], BABYBEAR_MSB)
        ctx.range_check_u8_iter(bs)

    def populate_witness_batch(self, inp: np.ndarray):
        lhs = inp[:, :8].astype(U)
        rhs = inp[:, 8:16].astype(U)
        is_comp, lv, rv, found = ug._ms_diff_witness_vals(lhs, rhs)
        n = inp.shape[0]
        lw = self._field_to_word_batch(lv)
        rw = self._field_to_word_batch(rv)
        cmp_w, out = ug.CompareGadget.populate_batch_u32(lv, rv)
        witness = np.concatenate(
            [is_comp, lv[:, None], rv[:, None], lw, rw, cmp_w], axis=1)
        assert witness.shape[1] == self.witness_size
        return witness, out

    @staticmethod
    def _field_to_word_batch(v: np.ndarray):
        """FieldToWord32: [is_msb_less_than, bytes(4)]."""
        bs = np.stack([(v >> U(8 * i)) & U(0xFF) for i in range(4)], axis=1)
        is_lt = (bs[:, 3] < BABYBEAR_MSB).astype(U)
        return np.concatenate([is_lt[:, None], bs], axis=1)

    def eval(self, builder, is_real, inp, witness, nonce, requires):
        byte_events = []
        lhs, rhs = list(inp[:8]), list(inp[8:16])
        i = 0
        is_comp = list(witness[i:i + 8]); i += 8
        l_limb = witness[i]; i += 1
        r_limb = witness[i]; i += 1
        lw = list(witness[i:i + 5]); i += 5
        rw = list(witness[i:i + 5]); i += 5
        cmp_w = list(witness[i:i + 8]); i += 8
        with builder.when(is_real):
            is_equal = Const(1)
            for k in reversed(range(8)):
                builder.assert_bool(is_comp[k])
                is_equal = is_equal - is_comp[k]
                with builder.when(is_equal):
                    builder.assert_eq(lhs[k], rhs[k])
            builder.assert_bool(is_equal)
            sl, sr = Const(0), Const(0)
            for k in range(8):
                sl = sl + lhs[k] * is_comp[k]
                sr = sr + rhs[k] * is_comp[k]
            builder.assert_eq(sl, l_limb)
            builder.assert_eq(sr, r_limb)
        lhs_word = self._eval_field_to_word(builder, l_limb, lw, byte_events,
                                            is_real)
        rhs_word = self._eval_field_to_word(builder, r_limb, rw, byte_events,
                                            is_real)
        res = self._eval_compare4(builder, lhs_word, rhs_word, cmp_w,
                                  byte_events, is_real)
        with builder.when(is_real):
            builder.assert_eq(is_equal, res["is_equal"])
        _byte_require_all(builder, byte_events, nonce, requires)
        return [res["is_less_than"]]

    @staticmethod
    def _eval_field_to_word(builder, field, w, byte_events, is_real):
        is_msb_lt = w[0]
        word = list(w[1:5])
        with builder.when(is_real):
            builder.assert_bool(is_msb_lt)
            recomposed = Const(0)
            for i in reversed(range(4)):
                recomposed = recomposed * 256 + word[i]
            builder.assert_eq(field, recomposed)
        byte_events.append(([Const(ug.BYTE_TAG), Const(ug.OP_LESS_THAN),
                             word[3], Const(BABYBEAR_MSB), is_msb_lt], is_real))
        with builder.when(is_real * (Const(1) - is_msb_lt)):
            builder.assert_eq(word[3], Const(BABYBEAR_MSB))
            for i in range(3):
                builder.assert_zero(word[i])
        ug._range_u8_events(byte_events, word, is_real)
        return word

    @staticmethod
    def _eval_compare4(builder, lhs, rhs, witness, byte_events, is_real):
        is_comp = list(witness[:4])
        l_limb, r_limb = witness[4], witness[5]
        diff_inv, is_less = witness[6], witness[7]
        with builder.when(is_real):
            is_equal = Const(1)
            for i in reversed(range(4)):
                builder.assert_bool(is_comp[i])
                is_equal = is_equal - is_comp[i]
                with builder.when(is_equal):
                    builder.assert_eq(lhs[i], rhs[i])
            builder.assert_bool(is_equal)
            sl, sr = Const(0), Const(0)
            for i in range(4):
                sl = sl + lhs[i] * is_comp[i]
                sr = sr + rhs[i] * is_comp[i]
            builder.assert_eq(sl, l_limb)
            builder.assert_eq(sr, r_limb)
            is_different = Const(1) - is_equal
            builder.assert_eq((l_limb - r_limb) * diff_inv, is_different)
        byte_events.append(([Const(ug.BYTE_TAG), Const(ug.OP_LESS_THAN),
                             l_limb, r_limb, is_less], is_real))
        return {"is_less_than": is_less, "is_equal": is_equal}


def lurk_chip_map(lang_chips=None):
    """Ordered chip map (reference: src/core/chipset.rs:28-63)."""
    chips = {
        "hasher3": HasherChip(24),
        "hasher4": HasherChip(32),
        "hasher5": HasherChip(40),
        "u64_add": U64Chip("add"),
        "u64_sub": U64Chip("sub"),
        "u64_mul": U64Chip("mul"),
        "u64_divrem": U64Chip("divrem"),
        "u64_lessthan": U64Chip("lessthan"),
        "u64_iszero": U64Chip("iszero"),
        "big_num_lessthan": BigNumChip(),
    }
    for name, chip in (lang_chips or {}).items():
        assert name not in chips, f"Name conflict with native chip {name}"
        chips[name] = chip
    return chips
