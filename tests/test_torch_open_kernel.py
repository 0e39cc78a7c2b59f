"""The PCS-opening and FRI-fold kernels (stark/open_kernel.py) on the CPU.

A CUDA kernel cannot run here, so what the wrappers hand the kernels is
read back by a numpy interpreter of csrc/open.cu: one pass over the
packed structure, through its pointers, row strides, counts and words,
doing what each block and thread does: open_eval's row blocks and lanes,
the powers of z staged a tile at a time and stepped by z^EVAL_TILE, the
64-bit accumulators and the last block's reduction; open_reduce's rows
on the coset GENERATOR * <g_H>, the Montgomery weights and inverses, the
add into the reduced codeword; fri_fold's 1/(2x) from the inverse
generator. On slices of wider matrices (odd row strides) holding 0, 1,
p - 1 and values past 2^30, each interpretation equals the plain version
(the eager code that the CPU runs).

The plain versions equal lurk_tpu's jitted programs on JAX's CPU backend:
_ext_powers_fn + _eval_coeffs_fn, _inv_xz_fn + _reduce_fn and _fold_fn,
on the same numpy inputs, converted here to the Montgomery form lurk_tpu
takes. The header's constants and the structures' field order are held to
the wrapper's. Tolerances are exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lurk_tpu.stark import device_prover as jdp
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.field import ext as ext_t
from lurk_tpu_torch.field.ntt import GENERATOR
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import open_kernel as ok
from lurk_tpu_torch.stark.fri import layer_shift

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

P = bb.P
U = np.uint64
CSRC = Path(ok.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "open.cu").read_text()
SPECIAL = (0, 1, P - 1, 1 << 30, P - 2)
R1 = bb.R_MOD_P                       # 2^32 mod p: Montgomery 1
RINV = pow(R1, P - 2, P)              # what a Montgomery reduction scales by
CPU = torch.device("cpu")


def _const(name):
    return int(re.search(r"constexpr (?:int|uint32_t) %s = (\d+)u?;" % name,
                         SOURCE).group(1))


REDUCE_ROWS = _const("REDUCE_ROWS")


def _field(rng, rows, width):
    """(rows, width) canonical values with the special ones sprinkled in."""
    a = rng.integers(0, P, (rows, width)).astype(np.int64)
    idx = rng.integers(0, a.size, min(a.size, 4 * len(SPECIAL)))
    a.reshape(-1)[idx] = np.resize(np.asarray(SPECIAL), len(idx))
    return a


def _slice(rng, rows, width):
    """A (rows, width) column slice of a (rows, odd) int32 matrix."""
    total = width + 3 + (width % 2 == 0)
    whole = torch.from_numpy(_field(rng, rows, total).astype(np.int32))
    return whole[:, 1:1 + width]


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


# ---------------------------------------------------------------------------
# a numpy interpreter of csrc/open.cu over the packed structures
# ---------------------------------------------------------------------------

def _mem(ptr):
    """(the whole storage behind ptr, ptr's element index)."""
    t = ptr.tensor
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy(), t.storage_offset() + ptr.offset


def _read(ptr, idx):
    mem, base = _mem(ptr)
    v = mem[base + np.asarray(idx, np.int64)]
    return (v.view(np.uint32) if v.dtype == np.int32 else v).astype(U)


def _mul(a, b):
    return (np.asarray(a, U) * np.asarray(b, U)) % U(P)


def _emul(a, b):
    c = [None] * 7
    for i in range(4):
        for j in range(4):
            v = _mul(a[..., i], b[..., j])
            c[i + j] = v if c[i + j] is None else (c[i + j] + v) % U(P)
    return np.stack([(c[0] + _mul(c[4], 11)) % U(P),
                     (c[1] + _mul(c[5], 11)) % U(P),
                     (c[2] + _mul(c[6], 11)) % U(P), c[3]], axis=-1)


def _emm(a, b):
    """A Montgomery extension product: a * b * 2^-32."""
    return _mul(_emul(a, b), RINV)


def _mpow(x, e):
    """x^e for Montgomery x (elementwise over e), Montgomery."""
    acc = np.full(np.shape(e), R1, U)
    e = np.asarray(e, np.int64).copy()
    x = np.broadcast_to(np.asarray(x, U), acc.shape).copy()
    while e.any():
        acc = np.where(e & 1, _mul(_mul(acc, x), RINV), acc)
        x = _mul(_mul(x, x), RINV)
        e >>= 1
    return acc


def _ext_mpow(z, e):
    """z^e for a Montgomery ext z, over an array of exponents."""
    e = np.asarray(e, np.int64).copy()
    acc = np.zeros(e.shape + (4,), U)
    acc[..., 0] = R1
    x = np.broadcast_to(np.asarray(z, U), acc.shape).copy()
    while e.any():
        acc = np.where((e & 1)[..., None], _emm(acc, x), acc)
        x = _emm(x, x)
        e >>= 1
    return acc


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
    return _mul(b, _inv(_emul(a, b)[..., 0])[..., None])


def _words(a, name, n):
    return np.asarray(a[name][:4 * n], U).reshape(n, 4)


def interpret_eval(a):
    """What every block of open_eval_kernel does: its rows' powers a tile
    at a time, each lane's canonical sums, the block's sum over its lanes
    added into the 64-bit accumulators, the last block's reduction."""
    h, w, n, ld = a["h"], a["w"], a["n_points"], a["ld"]
    rpb, tx, ty, tile = a["rows_per_block"], a["tx"], a["ty"], ok.EVAL_TILE
    assert rpb % tile == 0 and rpb >= tile and tx * ty <= ok.EVAL_THREADS
    z = _words(a, "z", n)                                 # Montgomery
    zstep = z
    for _ in range(tile.bit_length() - 1):
        zstep = _emm(zstep, zstep)
    acc_mem, acc_base = _mem(a["acc"])
    tiles = -(-w // tx)
    acc = acc_mem[acc_base:acc_base + n * w * 4].view(U)
    assert not acc.any()
    cols = np.arange(w)
    for r0 in range(0, h, rpb):
        r1 = min(h, r0 + rpb)
        pw = _ext_mpow(z[None], np.broadcast_to(      # (T, n, 4)
            r0 + np.arange(tile)[:, None], (tile, n)))
        lanes = np.zeros((ty, n, w, 4), U)                # sums v * pw
        for base in range(r0, r1, tile):
            for j in range(min(tile, r1 - base)):
                v = _read(a["coeffs"], (base + j) * ld + cols)   # (w,)
                lanes[j % ty] = (lanes[j % ty] + _mul(
                    v[None, :, None], pw[j][:, None, :])) % U(P)
            pw = _emm(pw, zstep[None])
        block = _mul(lanes, RINV).sum(axis=0) % U(P)      # redc, lanes
        acc += block.reshape(-1)
    counter_mem, counter_base = _mem(a["counter"])
    assert not counter_mem[counter_base:counter_base + tiles].any()
    out_mem, out_base = _mem(a["out"])
    out_mem[out_base:out_base + n * w * 4] = (acc % U(P)).astype(np.int32)
    acc[:] = 0
    return a["out"].tensor


def interpret_reduce(a):
    """What every thread of open_reduce_kernel does for its LDE row x =
    GENERATOR * g^row: its points' weighted row sums, less y_alpha, times
    1/(x - z) (0 for 0), added into (or written to) the codeword."""
    big, ld, w, n = 1 << a["log_big"], a["ld"], a["w"], a["n_points"]
    rows = np.arange(big)
    assert -(-big // REDUCE_ROWS) * REDUCE_ROWS >= big
    lde = _read(a["lde"], rows[:, None] * ld + np.arange(w))   # (H, w)
    wts = _read(a["weights"], np.arange(n * w * 4)).reshape(n, w, 4)
    zm, ya = _words(a, "z", n), _words(a, "ya", n)
    xm = _mul(_mul(a["x0"], _mpow(a["g"], rows)), RINV)
    total = np.zeros((big, 4), U)
    for k in range(n):
        f = np.zeros((big, 4), U)
        for c in range(w):
            f = (f + _mul(lde[:, c:c + 1], wts[k, c])) % U(P)
        f = _mul(f, RINV)                                 # canonical
        d = (np.stack([xm, *(np.zeros(big, U),) * 3], -1) + U(P)
             - zm[k]) % U(P)                              # Montgomery
        inv = _mul(_einv(_mul(d, RINV)), R1)              # Montgomery
        num = (f + U(P) - ya[k]) % U(P)
        total = (total + _mul(_emul(num, inv), RINV)) % U(P)
    out_mem, out_base = _mem(a["out"])
    idx = out_base + rows[:, None] * 4 + np.arange(4)
    if a["accumulate"]:
        total = (total + out_mem[idx].astype(U)) % U(P)
    out_mem[idx] = total.astype(np.int32)
    return a["out"].tensor


def interpret_fold(a):
    """What every thread of fri_fold_kernel does for its row i < n/2."""
    half = 1 << (a["log_n"] - 1)
    i = np.arange(half)
    quad = i[:, None] * 4 + np.arange(4)
    fx = _read(a["cw"], quad)
    fm = _read(a["cw"], quad + 4 * half)
    two_inv_m = _const("TWO_INV_M")
    inv2x = _mul(_mul(a["inv_shift2"], _mpow(a["g_inv"], i)), RINV)
    s = _mul(_mul((fx + fm) % U(P), two_inv_m), RINV)
    d = _mul(_mul((fx + U(P) - fm) % U(P), inv2x[:, None]), RINV)
    beta = _words(a, "beta", 1)[0]
    o = (s + _emm(d, beta)) % U(P)
    if a["add"] is not None:
        o = (o + _read(a["add"], quad)) % U(P)
    out_mem, out_base = _mem(a["out"])
    out_mem[out_base + quad] = o.astype(np.int32)
    return a["out"].tensor


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_header_constants_are_the_wrappers():
    assert (_const("MAX_POINTS"), _const("EVAL_THREADS"),
            _const("EVAL_TILE")) == (ok.MAX_POINTS, ok.EVAL_THREADS,
                                     ok.EVAL_TILE)
    assert _const("TWO_INV_M") == (P + 1) // 2 * R1 % P
    assert ok.EVAL_TILE & (ok.EVAL_TILE - 1) == 0


@pytest.mark.parametrize("name,fields", [("EvalArgs", ok.EVAL_FIELDS),
                                         ("ReduceArgs", ok.REDUCE_FIELDS),
                                         ("FoldArgs", ok.FOLD_FIELDS)])
def test_structures_match_the_source(name, fields):
    """The ctypes structures list the C structures' fields in order, each
    an 8-byte integer (or an array of them) or a pointer as in the
    source."""
    body = re.search(r"struct %s \{(.*?)\};" % name, SOURCE, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+)(\[[^\]]+\])?;", body, re.M)
    assert tuple(n for _, n, _ in decl) == fields
    for ctype, n, arr in decl:
        assert (ctype == "long long") == (n in ok.INT_FIELDS), (n, ctype)
        assert ctype.endswith("*") == (n not in ok.INT_FIELDS), (n, ctype)
        if arr:
            assert eval(arr[1:-1], {"MAX_POINTS": ok.MAX_POINTS}) == \
                ok._ARRAYS[n]


@pytest.mark.parametrize("log_h,w,n_points,blocks", [
    (0, 1, 1, None), (1, 7, 2, None), (6, 33, 2, None), (8, 3, 2, 2),
    (7, 300, 1, 3), (5, 5, 1, None)])
def test_eval_packing_matches_plain(log_h, w, n_points, blocks, monkeypatch):
    """open_eval's packing, interpreted, equals the plain version; with
    `blocks` set, a block's rows span several power tiles."""
    if blocks is not None:
        monkeypatch.setattr(ok, "EVAL_BLOCKS", blocks)
    rng = np.random.default_rng(log_h * 7 + w)
    coeffs = _slice(rng, 1 << log_h, w)
    zs = [_ext(rng) for _ in range(n_points - 1)] + [(P - 1, 0, 1, 0)]
    a = ok.eval_args(coeffs, zs)
    if blocks is not None:
        assert a["rows_per_block"] > ok.EVAL_TILE
    got = interpret_eval(a)
    want = ok.eval_plain(coeffs, zs)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("log_big,w,n_points,add", [
    (1, 1, 1, False), (4, 7, 2, True), (7, 40, 2, False), (8, 3, 1, True)])
def test_reduce_packing_matches_plain(log_big, w, n_points, add):
    """open_reduce's packing, interpreted, equals the plain version; the
    last point is a row's x of the domain (x - z = 0 there)."""
    rng = np.random.default_rng(100 + log_big)
    lde = _slice(rng, 1 << log_big, w)
    x5 = GENERATOR * pow(bb.two_adic_generator_s(log_big), 5 % (1 << log_big),
                         P) % P
    zs = [_ext(rng) for _ in range(n_points - 1)] + [(x5, 0, 0, 0)]
    weights = np.stack([_field(rng, w, 4) for _ in zs])
    y_alpha = _field(rng, n_points, 4)
    ro = torch.from_numpy(_field(rng, 1 << log_big, 4).astype(np.int32)) \
        if add else None
    want = ok.reduce_plain(ro, lde, zs, weights, y_alpha)
    a = ok.reduce_args(None if ro is None else ro.clone(), lde, zs, weights,
                       y_alpha)
    got = interpret_reduce(a)
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.parametrize("log_n,add", [(1, False), (5, True), (8, False),
                                       (8, True)])
def test_fold_packing_matches_plain(log_n, add):
    rng = np.random.default_rng(200 + log_n)
    cw = torch.from_numpy(_field(rng, 1 << log_n, 4).astype(np.int32))
    extra = torch.from_numpy(_field(rng, 1 << (log_n - 1), 4)
                             .astype(np.int32)) if add else None
    shift = layer_shift(log_n + 2, 2)
    beta = _ext(rng)
    got = interpret_fold(ok.fold_args(cw, beta, shift, extra))
    want = ok.fold_plain(cw, beta, shift, extra)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_packing_rejects_layouts_the_kernels_do_not_take():
    rng = np.random.default_rng(5)
    coeffs = _slice(rng, 8, 4)
    z = [_ext(rng)]
    for bad in (coeffs.T.contiguous().T, coeffs.to(torch.int64)):
        with pytest.raises(ValueError):
            ok.eval_args(bad, z)
    with pytest.raises(ValueError):
        ok.eval_args(coeffs, z * (ok.MAX_POINTS + 1))
    lde = _slice(rng, 12, 4)                      # not a power of two rows
    with pytest.raises(ValueError):
        ok.reduce_args(None, lde, z, np.zeros((1, 4, 4)), np.zeros((1, 4)))
    lde = _slice(rng, 8, 4)
    with pytest.raises(ValueError):               # weights of another width
        ok.reduce_args(None, lde, z, np.zeros((1, 5, 4)), np.zeros((1, 4)))
    with pytest.raises(ValueError):               # a codeword of int64
        ok.reduce_args(torch.zeros((8, 4), dtype=torch.int64), lde, z,
                       np.zeros((1, 4, 4)), np.zeros((1, 4)))
    cw = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError):               # an add of the wrong height
        ok.fold_args(cw, z[0], GENERATOR,
                     torch.zeros((8, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ok.fold_args(cw[::2], z[0], GENERATOR)


# ---------------------------------------------------------------------------
# the plain versions against lurk_tpu's jitted programs
# ---------------------------------------------------------------------------

def _jnp(a):
    return jnp.asarray(np.asarray(a, np.uint32))


def _canon(mont):
    return _mul(np.asarray(mont, U), RINV)


def test_eval_plain_matches_lurk_tpu():
    """eval_plain (device_ext_powers + _eval_coeffs per point) equals
    lurk_tpu's _ext_powers_fn + _eval_coeffs_fn at each point."""
    rng = np.random.default_rng(11)
    h, w = 1 << 4, 5
    coeffs = _field(rng, h, w)
    zs = [_ext(rng), (P - 1, 0, 1, 0)]
    got = ok.open_eval(torch.from_numpy(coeffs.astype(np.int32)), zs)
    for k, z in enumerate(zs):
        zp_mont = jdp.device_ext_powers_mont(z, h)
        np.testing.assert_array_equal(
            dp.device_ext_powers(z, h, CPU).numpy(), _canon(zp_mont))
        want = np.asarray(jdp._eval_coeffs_fn(h, w)(_jnp(coeffs), zp_mont))
        np.testing.assert_array_equal(got[k].numpy(), want)


def test_reduce_plain_matches_lurk_tpu():
    """reduce_plain (_inv_xz + _reduce_chunked + bb.fadd per point) equals
    lurk_tpu's _inv_xz_fn + _reduce_fn added into the codeword."""
    rng = np.random.default_rng(12)
    log_big, w = 4, 5
    big = 1 << log_big
    lde = _field(rng, big, w)
    zs = [_ext(rng), _ext(rng)]
    weights = np.stack([_field(rng, w, 4) for _ in zs])
    y_alpha = _field(rng, 2, 4)
    ro = _field(rng, big, 4)
    got = ok.open_reduce(torch.from_numpy(ro.astype(np.int32)),
                         torch.from_numpy(lde.astype(np.int32)), zs, weights,
                         y_alpha)
    want = ro.astype(U)
    xs = jdp._xs_dev(log_big)
    for k, z in enumerate(zs):
        inv_xz = jdp._inv_xz_fn(big)(xs, jdp.ext_scalar_dev(z))
        np.testing.assert_array_equal(
            dp._inv_xz(dp._xs_dev(log_big, CPU),
                       dp.ext_scalar_dev(z, CPU)).numpy(),
            np.asarray(inv_xz))
        contrib = jdp._reduce_fn(big, w)(
            _jnp(lde), _jnp(_mul(weights[k], R1)), _jnp(y_alpha[k]), inv_xz)
        want = (want + np.asarray(contrib, U)) % U(P)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_plain_matches_lurk_tpu():
    """fold_plain (_fold + bb.fadd) equals lurk_tpu's _fold_fn with the
    next height's codeword added."""
    rng = np.random.default_rng(13)
    log_n = 4
    cw = _field(rng, 1 << log_n, 4)
    extra = _field(rng, 1 << (log_n - 1), 4)
    beta = _ext(rng)
    shift = layer_shift(log_n + 3, 3)
    got = ok.fri_fold(torch.from_numpy(cw.astype(np.int32)), beta, shift,
                      torch.from_numpy(extra.astype(np.int32)))
    folded = jdp._fold_fn(log_n)(_jnp(cw), _jnp(_mul(beta, R1)),
                                 jdp._inv_2x_dev(log_n, shift))
    np.testing.assert_array_equal(
        got.numpy(), (np.asarray(folded, U) + extra.astype(U)) % U(P))
