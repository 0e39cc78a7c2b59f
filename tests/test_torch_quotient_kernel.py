"""The constraint-quotient and LogUp perm-trace kernels' argument packing
(stark/quotient_kernel.py), on the CPU.

A CUDA kernel cannot run here, so what the wrappers hand the kernels is
read back by a numpy interpreter of csrc/quotient.cu: one pass over the
packed structure, through its pointers, row strides, widths and counts,
doing what each block and thread does: the tile of T + stride rows (its
wrap at the end of the LDE) in Montgomery form, the compiled program with
its fold-on-write ops and per-chunk fold weights, the
staged plan records, Montgomery products, and the perm trace's inverses
grouped G at a time with constant and zero fingerprints. For every chip
of golden.LURK_PROGRAM's direct machine with an affine plan, on random LDE
slices of a wider matrix (an odd row stride) holding 0, 1, p - 1 and
values past 2^30:

- kernel A's packing, interpreted over every LDE row of a 256-row LDE (the
  last rows' next rows wrap to the first) and of 2-row LDEs, equals the
  plain version (_vm_eval + _pq_eval);
- kernel B's packing, interpreted over a 128-row trace, equals the batch
  contributions of device_perm_trace_plan's plain version.

The host compiler keeps every plan chip of both Lurk machines within a
block's 227 KB; a program that reads and rewrites its constraint registers
folds them once at the end; a tile too wide raises ValueError.

On three chips (LURK_TPU_CHIPS) the plain versions equal lurk_tpu's jitted
programs on JAX's CPU backend: _vm_fn + _pq_fn (canonical outputs;
lurk_tpu is Montgomery inside), and _generic_perm_fn's perm matrix and
cumulative sum. tests/test_torch_quotient_lurk_tpu.py and
tests/test_torch_perm_lurk_tpu.py hold the other plan chips (PLAN_CHIPS)
to them, in files of their own so that the suite's workers share the
compiles.

The header's field constants and the structures' field order are held to
the wrapper's. Tolerances are exact.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lurk_tpu.logup import affine as j_affine
from lurk_tpu.stark import device_prover as jdp
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.field import ext as ext_t
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark import quotient_kernel as qk
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

P = bb.P
U = np.uint64
CSRC = Path(qk.__file__).resolve().parents[1] / "csrc"
LOG_H = 7
SPECIAL = (0, 1, P - 1, 1 << 30, P - 2)
# the plan arrays in the order lurk_tpu's jitted programs take them
PLAN_KEYS = ("ti", "tw", "dconst", "mi", "mw", "mconst")


@functools.lru_cache(maxsize=None)
def _machine():
    machine, q, _ = golden.lurk_machine(golden.LURK_PROGRAM,
                                        FriConfig(1, 8, 2))
    return machine, len(q.expect_public_values())


def _plan_chips():
    machine, n_pv = _machine()
    out = []
    for chip in machine.chips:
        builder = machine.builder_for(chip)
        plan = dp.plan_for(builder)
        if plan is not None:
            out.append((chip.name, builder, plan))
    return out, n_pv


def _field(rng, rows, width):
    """(rows, width) canonical values with the special ones sprinkled in."""
    a = rng.integers(0, P, (rows, width)).astype(np.int64)
    if a.size:
        idx = rng.integers(0, a.size, min(a.size, 4 * len(SPECIAL)))
        a.reshape(-1)[idx] = np.resize(np.asarray(SPECIAL), len(idx))
    return a


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _slices(rng, rows, widths):
    """Column slices of one (rows, sum + 3) int32 matrix, an odd width."""
    total = sum(widths) + 3
    if total % 2 == 0:
        total += 1
    whole = torch.from_numpy(_field(rng, rows, total).astype(np.int32))
    out, off = [], 1
    for w in widths:
        out.append(None if w == 0 else whole[:, off:off + w])
        off += w
    return out


# ---------------------------------------------------------------------------
# a numpy interpreter of csrc/quotient.cu over the packed structures
# ---------------------------------------------------------------------------

R1 = bb.R_MOD_P                       # 2^32 mod p: Montgomery 1
RINV = pow(R1, P - 2, P)              # what a Montgomery reduction scales by
# interactions per batched inverse of the perm kernel
G = int(re.search(r"constexpr int G = (\d+);",
                  (CSRC / "quotient.cu").read_text()).group(1))


def _mem(ptr):
    """(the whole int32/int64 storage behind ptr, ptr's element index)."""
    t = ptr.tensor
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy(), t.storage_offset() + ptr.offset


def _read(ptr, idx):
    mem, base = _mem(ptr)
    v = mem[base + np.asarray(idx, np.int64)]
    return (v.view(np.uint32) if v.dtype == np.int32 else v).astype(U)


def _mul(a, b):
    return (np.asarray(a, U) * np.asarray(b, U)) % U(P)


def _mm(a, b):
    """A Montgomery product: a * b * 2^-32 mod p."""
    return _mul(_mul(a, b), RINV)


def _emul(a, b):
    c = [None] * 7
    for i in range(4):
        for j in range(4):
            v = _mul(a[..., i], b[..., j])
            c[i + j] = v if c[i + j] is None else (c[i + j] + v) % U(P)
    return np.stack([(c[0] + _mul(c[4], 11)) % U(P),
                     (c[1] + _mul(c[5], 11)) % U(P),
                     (c[2] + _mul(c[6], 11)) % U(P), c[3]], axis=-1)


def _inv(x):
    acc = np.ones_like(x)
    base, e = x.copy(), P - 2
    while e:
        if e & 1:
            acc = _mul(acc, base)
        base = _mul(base, base)
        e >>= 1
    return acc


def _einv(a):
    c = int(ext_t._FROB_C)
    fr = [np.array([pow(c, (i * k) % 4, P) for i in range(4)], U)
          for k in range(4)]
    b = _emul(_mul(a, fr[1]), _emul(_mul(a, fr[2]), _mul(a, fr[3])))
    norm = _emul(a, b)[..., 0]
    return _mul(b, _inv(norm)[..., None])


def _mac_w(acc, x, w8):
    """ext_mac_w: acc + x * w from a constant's 8 words (w0..w3, W w1, W
    w2, W w3), as the unreduced sums of products the kernel takes."""
    w, wy = w8[:4], w8[4:7]
    y = [[w[0], wy[2], wy[1], wy[0]], [w[1], w[0], wy[2], wy[1]],
         [w[2], w[1], w[0], wy[2]], [w[3], w[2], w[1], w[0]]]
    out = acc.copy()
    for k in range(4):
        for i in range(4):
            out[..., k] = (out[..., k] + _mul(x[..., i], y[k][i])) % U(P)
    return out


def _ext_at(ptr, k, n=4):
    return _read(ptr, n * k + np.arange(n))


def _columns(a, extras):
    def x(c, rows):
        if c < a["main_w"]:
            return _read(a["main"], rows * a["main_ld"] + c)
        c -= a["main_w"]
        if c < a["prep_w"]:
            return _read(a["prep"], rows * a["prep_ld"] + c)
        return extras(c - a["prep_w"], rows)
    return x


def _tile(a, x, n_cols, rows_of_tile):
    """The blocks' shared-memory tiles: (blocks, tile rows * ld) with the
    rows' X columns in Montgomery form (a row of -1: not loaded), the rest
    never written (the sentinel 2^32 - 1 is no field value)."""
    blocks, n_rows = rows_of_tile.shape
    ok = rows_of_tile >= 0
    rows = np.where(ok, rows_of_tile, 0).reshape(-1)
    tile = np.full((blocks, n_rows, a["ld"]), U(2**32 - 1))
    cols = np.stack([x(c, rows) for c in range(n_cols)], axis=-1)
    tile[..., :n_cols] = np.where(ok[..., None], _mul(
        cols.reshape(blocks, n_rows, n_cols), R1), U(2**32 - 1))
    return tile.reshape(blocks, -1)


def _records(a):
    """The staged records in order, each as its words."""
    g = 0
    while True:
        lo, hi = (int(v) for v in _read(a["rec_off"], [g, g + 1]))
        yield _read(a["recs"], np.arange(lo, hi))
        g += 1


class _Inter:
    """One interaction's record at word o, read as Inter reads it."""

    def __init__(self, rec, o):
        tc, mc = int(rec[o]), int(rec[o + 1])
        self.mconst, self.d = rec[o + 2], rec[o + 4:o + 8]
        self.tw = rec[o + 8:o + 8 + 4 * tc].reshape(tc, 4)
        self.tcol = rec[o + 8 + 4 * tc:o + 8 + 5 * tc]
        mt = o + 8 + 4 * tc + -(-tc // 4) * 4
        self.mt = rec[mt:mt + 2 * mc].reshape(mc, 2)
        self.t_cnt = tc
        self.words = 8 + 4 * tc + -(-tc // 4) * 4 + -(-2 * mc // 4) * 4

    def fingerprint(self, x):
        s = np.broadcast_to(self.d, x(0).shape + (4,)).copy()
        for col, w in zip(self.tcol, self.tw):
            s = (s + _mul(x(col)[..., None], w)) % U(P)
        return _mul(s, RINV)

    def multiplicity(self, x):
        s = np.full(x(0).shape, self.mconst, U)
        for col, w in self.mt:
            s = (s + _mul(x(col), w)) % U(P)
        return _mul(s, RINV)


def interpret_quotient(a):
    """What every thread of every block of quotient_kernel writes: the
    (big, 4) output read back from the packed `out` pointer."""
    big, T, ld, nc = 1 << a["log_big"], a["tile"], a["ld"], a["n_consts"]
    stride = a["stride"]
    wx = a["main_w"] + a["prep_w"] + 4
    sels = (a["first"], a["last"], a["trans"])
    x = _columns(a, lambda c, rows: _read(sels[c], rows) if c < 3
                 else np.ones(len(rows), U))
    blocks = big // T
    # tile rows r0 .. r0 + T + stride - 1, wrapping at the end of the LDE
    tile_rows = (np.arange(blocks)[:, None] * T
                 + np.arange(T + stride)[None, :]) & (big - 1)
    smem = np.concatenate([np.broadcast_to(
        _read(a["consts"], np.arange(nc)), (blocks, nc)),
        _tile(a, x, wx, tile_rows)], axis=1)
    base = nc + np.arange(T) * ld                  # each thread's tile row
    row = np.arange(blocks)[:, None] * T + np.arange(T)[None, :]
    nrow = (row + stride) & (big - 1)
    # staged two ops at a time: a zero op after an odd count
    ops = _read(a["ops"], np.arange(2 * (a["n_ops"] + a["n_ops"] % 2))) \
        .reshape(-1, 2)
    assert not ops[a["n_ops"]:].any() and a["op_chunk"] % 2 == 0
    acc = np.zeros((blocks, T, 4), U)
    chunk = a["op_chunk"]
    for i, (w0, w1) in enumerate(ops[:a["n_ops"]].tolist()):
        if i % chunk == 0:                  # the chunk's staged weights
            lo, hi = (int(v) for v in _read(a["fold_off"],
                                            [i // chunk, i // chunk + 1]))
            assert hi - lo <= a["max_folds"]
            sw = _read(a["wfold"], np.arange(4 * lo, 4 * hi)).reshape(-1, 4)
        fl, dst = w1 >> 24, w1 & 0xffffff
        assert fl < 32                          # no flags past FOLD
        va = smem[:, w0 & 0xffff][:, None] if fl & 4 \
            else smem[:, base + (w0 & 0xffff)]
        vb = smem[:, w0 >> 16][:, None] if fl & 8 \
            else smem[:, base + (w0 >> 16)]
        code = fl & 3
        v = _mm(va, vb) if code == 2 else (va + vb) % U(P) if code == 0 \
            else (va + U(P) - vb) % U(P) if code == 1 else va
        v = np.broadcast_to(v, (blocks, T))
        if fl & 16:
            acc = (acc + _mul(v[..., None], sw[dst])) % U(P)
        else:
            smem[:, base + dst] = v
    nb = a["nb"]
    xcol = lambda c: smem[:, base + int(c)]

    def perm(r, j):
        return _read(a["perm"], r[..., None] * a["perm_ld"] + j
                     + np.arange(4))

    tphi = np.zeros((blocks, T, 4), U)
    tphi_n = np.zeros((blocks, T, 4), U)
    records = _records(a)
    for b0 in range(0, nb, a["group"]):
        rec, o = next(records), 0
        assert len(rec) <= a["rec_words"]
        for b in range(b0, min(b0 + a["group"], nb)):
            phi = perm(row, 4 * b)
            tphi = (tphi + phi) % U(P)
            tphi_n = (tphi_n + perm(nrow, 4 * b)) % U(P)
            wb = rec[o:o + 8]
            i0 = _Inter(rec, o + 8)
            i1 = _Inter(rec, o + 8 + i0.words)
            o += 8 + i0.words + i1.words
            d0, d1 = i0.fingerprint(xcol), i1.fingerprint(xcol)
            m0, m1 = i0.multiplicity(xcol), i1.multiplicity(xcol)
            lhs = _mul(_emul(phi, _mul(_emul(d0, d1), RINV)), RINV)
            rhs = _mul(_mul(d1, m0[..., None]) + _mul(d0, m1[..., None]),
                       RINV)
            acc = _mac_w(acc, (lhs + U(P) - rhs) % U(P), wb)
        assert o == len(rec)
    s, s_n = perm(row, 4 * nb), perm(nrow, 4 * nb)
    cum = _ext_at(a["cum"], 0)
    sel = lambda c: smem[:, base + wx - 4 + c][..., None]     # Montgomery
    terms = ((s + U(P) - tphi) % U(P), sel(0)), \
        ((s_n + 2 * U(P) - s - tphi_n) % U(P), sel(2)), \
        ((s + U(P) - cum) % U(P), sel(1))
    for j, (v, m) in enumerate(terms):
        acc = _mac_w(acc, _mm(v, m), _ext_at(a["wsel"], j, 8))
    omem, obase = _mem(a["out"])
    omem[obase + 4 * row[..., None] + np.arange(4)] = \
        _mul(acc, RINV).astype(np.int64).astype(np.int32)
    return a["out"].tensor.numpy().astype(U)


def interpret_perm(a):
    """What perm_phi_kernel writes: every row's phi_b into `out`, the
    fingerprints inverted in groups of G with Montgomery's trick."""
    h, nb, T = a["h"], a["nb"], a["tile"]
    extras = lambda c, rows: ((rows == 0) if c == 0 else
                              (rows == h - 1) if c == 1 else
                              (rows < h - 1)).astype(U)
    x = _columns(a, extras)
    wx = a["main_w"] + a["prep_w"] + 3
    blocks = -(-h // T)
    row = np.arange(blocks)[:, None] * T + np.arange(T)[None, :]
    smem = _tile(a, x, wx, np.where(row < h, row, -1))
    base = np.arange(T) * a["ld"]
    xcol = lambda c: smem[:, base + int(c)]
    one = np.array([R1, 0, 0, 0], U)
    n = 2 * nb
    inv_of, m_of = {}, {}
    records = _records(a)
    for k0 in range(0, n, G):
        rec, o = next(records), 0
        assert len(rec) <= a["rec_words"]
        run, have, slots = None, False, []
        for k in range(k0, min(k0 + G, n)):
            it = _Inter(rec, o)
            o += it.words
            m_of[k] = it.multiplicity(xcol)
            if it.t_cnt == 0:                   # the wrapper's inverse
                inv_of[k] = np.broadcast_to(it.d, (blocks, T, 4))
                continue
            d = it.fingerprint(xcol)
            zero = (d == 0).all(axis=-1)
            d = np.where(zero[..., None], one, d)
            slots.append((k, d, zero, run if have else None))
            run = _mul(_emul(run, d), RINV) if have else d
            have = True
        assert o == len(rec)
        if have:
            # the kernel's Montgomery inverse: (1 / (run / R)) * R
            inv = _mul(_einv(_mul(run, RINV)), R1)
            for k, d, zero, before in reversed(slots):
                dk = inv if before is None else _mul(_emul(inv, before), RINV)
                if before is not None:
                    inv = _mul(_emul(inv, d), RINV)
                inv_of[k] = np.where(zero[..., None], U(0), dk)
    omem, obase = _mem(a["out"])
    ok = row < h
    for b in range(nb):
        phi = sum(_mm(inv_of[k], m_of[k][..., None]) for k in (2 * b,
                                                              2 * b + 1))
        idx = row[..., None] * a["out_ld"] + 4 * b + np.arange(4)
        omem[obase + idx[ok]] = (phi % U(P))[ok].astype(np.int64) \
            .astype(np.int32)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_header_constants_are_the_fields():
    src = (CSRC / "babybear.cuh").read_text()
    consts = {k: int(v, 0) for k, v in re.findall(
        r"constexpr uint32_t (\w+) = (0x[0-9a-f]+|\d+)u;", src)}
    c = ext_t._FROB_C
    assert consts == {"P": P, "MU": bb.P_INV_NEG, "R2": bb.R2_MOD_P % P,
                      "W": ext_t.W, "FROB1": c, "FROB2": c * c % P,
                      "FROB3": pow(c, 3, P), "ONE_M": R1,
                      "W_M": ext_t.W * R1 % P, "FROB1_M": c * R1 % P,
                      "FROB3_M": pow(c, 3, P) * R1 % P}
    assert c * c % P == P - 1
    assert G == qk.PERM_GROUP
    assert int(re.search(r"constexpr int SMEM_MAX = (\d+);", (
        CSRC / "quotient.cu").read_text()).group(1)) == qk.SMEM_BYTES
    # minv's addition chain: x^7, then 0111, then eight windows of 111
    e = 7 * 16 + 7
    for _ in range(8):
        e = e * 8 + 7
    assert e == P - 2


@pytest.mark.parametrize("name,fields", [("QuotientArgs", qk.QUOTIENT_FIELDS),
                                         ("PermArgs", qk.PERM_FIELDS)])
def test_structures_match_the_source(name, fields):
    """The ctypes structures list the C structures' fields in order, each
    an 8-byte integer or a pointer as in the source."""
    src = (CSRC / "quotient.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    assert tuple(n for _, n in decl) == fields
    for ctype, n in decl:
        assert (ctype == "long long") == (n in qk._INT_FIELDS), (n, ctype)
        assert ctype.endswith("*") == (n not in qk._INT_FIELDS), (n, ctype)


def _jax_quotient(qi, plan, pv, r, gamma, alpha, cum):
    """lurk_tpu's _vm_fn + _pq_fn over all `big` rows in one window."""
    prog = qi.prog
    big = int(qi.main.shape[0])
    stride = qi.stride
    nb = qi.nb
    Bp = plan.n_inter_padded // 2
    Wp = max(prog.width_padded, plan.width_padded)
    win = np.arange(big + stride) % big
    sels = {k: v.numpy() for k, v in qi.sels.items()}
    cols = [qi.main.numpy()] + ([qi.prep.numpy()] if qi.prep is not None
                                else []) + \
        [np.stack([sels["first"], sels["last"], sels["transition"],
                   np.ones(big, np.int64)], axis=1)]
    X = np.concatenate([c.astype(np.int64) for c in cols], axis=1)[win]
    X = np.pad(X, ((0, 0), (0, Wp - X.shape[1]))).astype(np.uint32)
    wbase = np.zeros((prog.regs_padded, 4), np.uint32)
    wbase[:len(qi.wbase)] = qi.wbase
    vm = jdp._vm_fn(big, prog.regs_padded, Wp, prog.consts_padded,
                    prog.ops_padded)
    folded = vm(jnp.asarray(X), jnp.asarray(prog.padded_ops(Wp)),
                jnp.asarray(prog.consts_mont(pv)),
                jnp.asarray(bb.np_to_mont(wbase)))
    arrs = j_affine.assemble(plan, pv, r, gamma, pad_d_one=True)
    perm = qi.perm.numpy().astype(np.int64)[win]
    phi = np.zeros((big + stride, 4 * Bp), np.uint32)
    phi[:, :4 * nb] = perm[:, :4 * nb]
    wb = np.zeros((Bp, 4), np.uint32)
    wb[:nb] = qi.wb
    pq = jdp._pq_fn(big, Wp, plan.n_inter_padded, plan.max_terms,
                    plan.max_mult_terms, Bp)
    folded_pq = pq(jnp.asarray(X), jnp.asarray(phi),
                   jnp.asarray(perm[:, 4 * nb:4 * nb + 4].astype(np.uint32)),
                   *(jnp.asarray(arrs[k]) for k in PLAN_KEYS),
                   jdp.ext_scalar_dev(cum), jnp.asarray(bb.np_to_mont(wb)),
                   jnp.asarray(bb.np_to_mont(qi.wsel.astype(np.uint32))),
                   *(jnp.asarray(sels[k].astype(np.uint32))
                     for k in ("first", "transition", "last")))
    return (np.asarray(folded, U) + np.asarray(folded_pq, U)) % U(P)


def _chip(name):
    chips, n_pv = _plan_chips()
    return next(c for c in chips if c[0] == name)[1:], n_pv


def _quotient_case(builder, n_pv, rng):
    pv = [int(v) for v in rng.integers(0, P, n_pv)]
    r, gamma, alpha, cum = (_ext(rng) for _ in range(4))
    nb = (len(builder.interactions) + 1) // 2
    main, prep, perm = _slices(rng, 2 << LOG_H, [builder.main_width,
                                                 builder.preprocessed_width,
                                                 4 * (nb + 1)])
    qi = dp.quotient_inputs(builder, main, prep, perm, pv, r, gamma, alpha,
                            cum, LOG_H)
    return qi, (pv, r, gamma, alpha, cum)


def _perm_case(builder, n_pv, rng):
    pv = [int(v) for v in rng.integers(0, P, n_pv)]
    r, gamma = _ext(rng), _ext(rng)
    main, prep = _slices(rng, 1 << LOG_H, [builder.main_width,
                                           builder.preprocessed_width])
    return main, prep, pv, r, gamma


def test_quotient_packing_matches_plain():
    chips, n_pv = _plan_chips()
    rng = np.random.default_rng(11)
    for name, builder, _ in chips:
        qi, _ = _quotient_case(builder, n_pv, rng)
        got = interpret_quotient(qk.quotient_args(qi))
        assert np.array_equal(got, qk.quotient_plain(qi).numpy().astype(U)), \
            name


@pytest.mark.parametrize("name", ("Func[eval]", "Bytes", "Mem[2-wide]"))
def test_quotient_packing_on_a_two_row_lde(name):
    """A one-row trace: the LDE has 2 rows, fewer than a row and its next
    row's stride past it, so every next row wraps."""
    (builder, _), n_pv = _chip(name)
    rng = np.random.default_rng(16)
    pv = [int(v) for v in rng.integers(0, P, n_pv)]
    nb = (len(builder.interactions) + 1) // 2
    main, prep, perm = _slices(rng, 2, [builder.main_width,
                                        builder.preprocessed_width,
                                        4 * (nb + 1)])
    qi = dp.quotient_inputs(builder, main, prep, perm, pv, *(
        _ext(rng) for _ in range(4)), 0)
    got = interpret_quotient(qk.quotient_args(qi))
    assert np.array_equal(got, qk.quotient_plain(qi).numpy().astype(U))


def test_perm_packing_matches_plain():
    chips, n_pv = _plan_chips()
    rng = np.random.default_rng(12)
    n = 0
    for name, builder, plan in chips:
        if not builder.interactions:
            continue
        n += 1
        nb = plan.n_batches
        main, prep, pv, r, gamma = _perm_case(builder, n_pv, rng)
        perm, _ = dp.device_perm_trace_plan(plan, main, prep, pv, r, gamma)
        a = dp._plan_arrays(plan, pv, r, gamma, pad_d_one=False,
                            n_keep=2 * nb)
        out = torch.full_like(perm, -1)
        interpret_perm(qk.perm_args(out, main, prep, a))
        assert torch.equal(out[:, :4 * nb], perm[:, :4 * nb]), name
        assert bool((out[:, 4 * nb:] == -1).all()), name
    assert n == len(chips)


# lurk_tpu's jitted programs compile for each shape bucket, seconds apiece
# on the CPU, so this file runs them on three chips: the largest VM
# program, the one chip with preprocessed columns and a two-interaction
# memory chip. The other plan chips run in two files of their own.
LURK_TPU_CHIPS = ("Func[eval_builtin_expr]", "Bytes", "Mem[2-wide]")

# Every chip of LURK_PROGRAM's direct machine with an affine plan, in the
# machine's order.
PLAN_CHIPS = (
    "Entrypoint[0]", "Func[lurk_main]", "Func[preallocate_symbols]",
    "Func[eval]", "Func[eval_builtin_expr]", "Func[eval_bind_builtin]",
    "Func[eval_env_builtin]", "Func[eval_apply_builtin]",
    "Func[eval_coroutine_expr]", "Func[eval_opening_unop]",
    "Func[eval_hide]", "Func[eval_unop]", "Func[eval_binop_num]",
    "Func[eval_binop_misc]", "Func[eval_begin]", "Func[eval_list]",
    "Func[coerce_if_sym]", "Func[open_comm]", "Func[equal]",
    "Func[equal_inner]", "Func[car_cdr]", "Func[eval_let]",
    "Func[eval_letrec]", "Func[extend_env_with_mutuals]",
    "Func[eval_letrec_bindings]", "Func[apply]", "Func[env_lookup]",
    "Func[ingress]", "Func[egress]", "Func[hash3]", "Func[hash4]",
    "Func[hash5]", "Func[u64_add]", "Func[u64_sub]", "Func[u64_mul]",
    "Func[u64_divrem]", "Func[u64_lessthan]", "Func[u64_iszero]",
    "Func[digest_equal]", "Func[big_num_lessthan]", "Mem[2-wide]",
    "Mem[3-wide]", "Mem[4-wide]", "Mem[5-wide]", "Mem[6-wide]",
    "Mem[8-wide]", "Bytes")
OTHER_PLAN_CHIPS = tuple(c for c in PLAN_CHIPS if c not in LURK_TPU_CHIPS)


def test_plan_chips_are_the_machines():
    """PLAN_CHIPS names every plan chip, each with interactions, so that
    the lurk_tpu comparisons cover them all."""
    chips, _ = _plan_chips()
    assert tuple(name for name, _, _ in chips) == PLAN_CHIPS
    assert all(builder.interactions for _, builder, _ in chips)


@pytest.mark.parametrize("name", LURK_TPU_CHIPS)
def test_quotient_plain_matches_lurk_tpu(name):
    (builder, plan), n_pv = _chip(name)
    qi, (pv, r, gamma, alpha, cum) = _quotient_case(
        builder, n_pv, np.random.default_rng(14))
    want = _jax_quotient(qi, plan, pv, r, gamma, alpha, cum)
    assert np.array_equal(qk.quotient_plain(qi).numpy().astype(U), want)


@pytest.mark.parametrize("name", LURK_TPU_CHIPS)
def test_perm_plain_matches_lurk_tpu(name):
    """device_perm_trace_plan's perm matrix and cumulative sum against
    lurk_tpu's _generic_perm_fn over the same rows."""
    (builder, plan), n_pv = _chip(name)
    main, prep, pv, r, gamma = _perm_case(builder, n_pv,
                                          np.random.default_rng(15))
    perm, cum = dp.device_perm_trace_plan(plan, main, prep, pv, r, gamma)
    h, nb = 1 << LOG_H, plan.n_batches
    cols = [main.numpy()] + ([prep.numpy()] if prep is not None else [])
    X = np.concatenate([c.astype(np.int64) for c in cols]
                       + [np.asarray(jdp._x_extras(h, plan.width_padded
                                                   - plan.x_width))],
                       axis=1).astype(np.uint32)
    arrs = j_affine.assemble(plan, pv, r, gamma)
    fn = jdp._generic_perm_fn(h, plan.width_padded, plan.n_inter_padded,
                              plan.max_terms, plan.max_mult_terms)
    phis, s, total = fn(jnp.asarray(X),
                        *(jnp.asarray(arrs[k]) for k in PLAN_KEYS))
    want = np.concatenate([np.asarray(phis, U)[:, :4 * nb],
                           np.asarray(s, U)], axis=1)
    assert np.array_equal(perm.numpy().astype(U), want)
    assert np.array_equal(cum.numpy().astype(U), np.asarray(total, U))


def test_packing_rejects_layouts_the_kernels_do_not_take():
    chips, n_pv = _plan_chips()
    name, builder, plan = next(c for c in chips
                               if c[1].interactions and
                               c[1].preprocessed_width == 0)
    rng = np.random.default_rng(13)
    big = 2 << LOG_H
    nb = plan.n_batches
    main, perm = _slices(rng, big, [builder.main_width, 4 * (nb + 1)])
    args = ([0] * n_pv, (1, 2, 3, 4), (5, 6, 7, 8), (9, 1, 2, 3),
            (4, 5, 6, 7), LOG_H)
    qk.quotient_args(dp.quotient_inputs(builder, main, None, perm, *args))
    for bad in (main.T.contiguous().T, main.to(torch.int64), main[:-1]):
        with pytest.raises(ValueError):
            qk.quotient_args(dp.quotient_inputs(builder, bad, None, perm,
                                                *args))
    a = dp._plan_arrays(plan, [0] * n_pv, (1, 2, 3, 4), (5, 6, 7, 8),
                        pad_d_one=False, n_keep=2 * nb)
    h_main = main[:big // 2]
    out = torch.empty((big // 2, 4 * (nb + 1)), dtype=torch.int32)
    qk.perm_args(out, h_main, None, a)
    for bad_out in (out.T.contiguous().T, out[:, :-1]):
        with pytest.raises(ValueError):
            qk.perm_args(bad_out, h_main, None, a)


@functools.lru_cache(maxsize=None)
def _compiled_machine():
    machine, _, _ = golden.lurk_machine(golden.LURK_PROGRAM,
                                        FriConfig(1, 8, 2), compiled=True)
    return machine


def test_host_compiler_fits_every_chip_of_both_machines():
    """Every plan chip of the direct and the compiled machine compiles,
    folds every constraint register on write (each is written once and
    never read), and takes a tile of at least a warp's rows within a
    block's shared memory in both kernels."""
    machines = (_machine()[0], _compiled_machine())
    n = 0
    for machine in machines:
        for chip in machine.chips:
            builder = machine.builder_for(chip)
            if dp.plan_for(builder) is None:
                continue
            n += 1
            prog = dp.vm_program_for(builder)
            cp = qk.compile_program(prog, 2)
            assert cp.folded_on_write == prog.n_cons, chip.name
            assert cp.n_scratch < prog.n_regs - prog.n_cons, chip.name
            assert cp.ld % 2 == 1 and cp.ld >= prog.x_width + cp.n_scratch
            assert cp.n_ops == len(prog.ops)
            pa = dp._plan_arrays(dp.plan_for(builder), [0] * 64,
                                 (1, 2, 3, 4), (5, 6, 7, 8), pad_d_one=True,
                                 n_keep=2 * ((len(builder.interactions) + 1)
                                             // 2))
            nb = pa["dconst"].shape[0] // 2
            lay, _ = qk._records(pa, qk.QUOTIENT_GROUP,
                                 wb=np.ones((nb, 4), np.int64))
            big = 1 << 22
            smem = lambda t: qk.quotient_smem_bytes(
                prog.consts_padded, t, 2, cp.ld, qk.OP_CHUNK, cp.max_folds,
                lay.rec_words)
            tile = qk.tile_rows(smem, big)
            assert tile >= 32 and smem(tile) <= qk.SMEM_BYTES, chip.name
            lay, _ = qk._records(pa, qk.PERM_GROUP)
            ld = (builder.main_width + builder.preprocessed_width + 3) | 1
            smem = lambda t: qk.perm_smem_bytes(t, ld, lay.rec_words)
            tile = qk.tile_rows(smem, big)
            assert tile >= 32 and smem(tile) <= qk.SMEM_BYTES, chip.name
    assert n == len(PLAN_CHIPS) + 43


def test_quotient_folds_read_and_rewritten_result_registers():
    """A program whose constraint register 0 is read by a later op and
    whose register 1 is written twice: both keep a scratch slot and fold
    once at the end, and the packing still equals the plain version."""
    from lurk_tpu_torch.stark.constraint_vm import OP_ADD, OP_MUL, \
        VMProgram
    (builder, _), n_pv = _chip("Func[env_lookup]")
    qi, _ = _quotient_case(builder, n_pv, np.random.default_rng(17))
    prog = qi.prog
    R = prog.n_regs
    ops = np.asarray(prog.ops, np.int64).copy()
    ops[:, 2:] += ops[:, 2:] >= R          # one more register: R
    extra = [(OP_MUL, R, 0, 0),            # reads constraint register 0
             (OP_ADD, 1, R, R + 1 + 0)]    # writes register 1 again
    hand = VMProgram(prog.main_width, prog.prep_width, prog.n_cons,
                     np.concatenate([ops, extra]).astype(np.int32),
                     list(prog.const_vals), list(prog.pub_slots), R + 1)
    qi = dataclasses.replace(qi, prog=hand)
    cp = qk.compile_program(hand, qi.stride)
    assert cp.folded_on_write == prog.n_cons - 2
    assert cp.n_ops == len(hand.ops) + 2   # the two late folds
    got = interpret_quotient(qk.quotient_args(qi))
    assert np.array_equal(got, qk.quotient_plain(qi).numpy().astype(U))


def _wide_program_inputs(main_w: int):
    """A one-constraint program over main_w columns (local column 0 plus
    next column 1) on a 2-row LDE, with one empty batch."""
    from lurk_tpu_torch.stark.constraint_vm import OP_ADD, VMProgram
    wx = main_w + 4
    prog = VMProgram(main_w, 0, 1, np.array([[OP_ADD, 0, 2, 2 + wx + 1]],
                                            np.int32), [0], [], 2)
    empty = lambda *shape: np.zeros(shape, np.int64)
    plan = dict(ti=empty(0, 2), tw=empty(0, 2, 4),
                dconst=np.array([[1, 0, 0, 0]] * 2), mi=empty(0, 2),
                mw=empty(0, 2), mconst=empty(2))
    return qk.QuotientInputs(
        prog=prog, consts=np.zeros(4, np.int64),
        main=torch.ones((2, main_w), dtype=torch.int32), prep=None,
        perm=torch.zeros((2, 8), dtype=torch.int32),
        sels=dp._coset_tables(0, torch.device("cpu"))["sels"], plan=plan,
        nb=1, wbase=np.array([[1, 2, 3, 4]]), wb=np.array([[5, 6, 7, 8]]),
        wsel=np.ones((3, 4), np.int64), cum=np.zeros(4, np.int64), stride=2)


def test_oversized_tile_raises():
    """A row too wide for one tile row (and its two next rows) in a
    block's 227 KB raises ValueError; one just inside runs in a tile of
    one row and equals the plain version."""
    with pytest.raises(ValueError, match="shared memory"):
        qk.quotient_args(_wide_program_inputs(20000))
    qi = _wide_program_inputs(19000)
    a = qk.quotient_args(qi)
    assert a["tile"] == 1
    assert qk.quotient_smem_bytes(a["n_consts"], 1, 2, a["ld"],
                                  a["op_chunk"], a["max_folds"],
                                  a["rec_words"]) <= qk.SMEM_BYTES
    got = interpret_quotient(a)
    assert np.array_equal(got, qk.quotient_plain(qi).numpy().astype(U))


def zero_and_constant_fingerprints(plan, a, main):
    """Plan arrays `a` (pad_d_one off) and trace `main` changed in place so
    that interaction 0 has a constant fingerprint, interaction 1 a constant
    zero one, and the first interaction after them whose terms read main
    columns only has a zero fingerprint on rows 3 and 5 (its constant
    zeroed, those rows' main columns zeroed) and nonzero ones elsewhere.
    Returns that interaction."""
    a["tw"][:, :2] = 0
    a["dconst"][1] = 0
    k = next(k for k in range(2, a["dconst"].shape[0])
             if (a["tw"][:, k] != 0).any() and
             (a["ti"][:, k][(a["tw"][:, k] != 0).any(axis=1)] <
              main.shape[1]).all())
    a["dconst"][k] = 0
    main[[3, 5]] = 0
    return k


def test_perm_packing_with_zero_and_constant_fingerprints():
    """Constant fingerprints (one of them 0) take the wrapper's inverse; a
    fingerprint that is 0 on some rows enters its group's product as 1 and
    contributes 0 there, and the rest of its group is unchanged."""
    (builder, plan), n_pv = _chip("Func[eval]")
    main, prep, pv, r, gamma = _perm_case(builder, n_pv,
                                          np.random.default_rng(18))
    nb = plan.n_batches
    a = dp._plan_arrays(plan, pv, r, gamma, pad_d_one=False, n_keep=2 * nb)
    k = zero_and_constant_fingerprints(plan, a, main)
    assert k < G                           # in the group of 0 and 1
    X = torch.cat([main, prep, dp._x_extras(main.shape[0], main.device)]
                  if prep is not None else
                  [main, dp._x_extras(main.shape[0], main.device)], dim=1)
    D, _ = qk._fingerprints(X.to(torch.int64), qk._on(a, main.device))
    zero = (D == 0).all(dim=2)
    assert zero[:, 1].all() and not zero[:, 0].any()
    assert zero[[3, 5], k].all() and int(zero[:, k].sum()) == 2
    want = torch.full((main.shape[0], 4 * (nb + 1)), -1, dtype=torch.int32)
    qk.perm_phi_plain(want, main, prep, a, plan.n_inter_padded)
    got = torch.full_like(want, -1)
    args = qk.perm_args(got, main, prep, a)
    rec = next(_records(args))
    first = _Inter(rec, 0)
    assert first.t_cnt == 0 and _Inter(rec, first.words).t_cnt == 0
    interpret_perm(args)
    assert torch.equal(got, want)
