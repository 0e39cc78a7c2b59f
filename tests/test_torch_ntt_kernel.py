"""The NTT kernel's passes (field/ntt_kernel.py) on the CPU.

A CUDA kernel cannot run here, so what the wrapper hands csrc/ntt.cu is
read back by a numpy interpreter of lurk_ntt_pass: for each pass, every
block's points gathered through the row map (c c_in + g g_in + t t_in +
j j_in; a pass in place must write the rows it read), scaled by the load table's powers, placed at bit-reversed
positions, the radix-2 stages taken two at a time as the kernel takes them
(TW[h + i], TW[2h + i], TW[3h + i]) and the last one alone, then scaled by
the store table's twiddles and the Montgomery factor and written through
the output row map. Its results must equal the plain versions (field/
ntt.py's eager int64 stages, device_prover._lde_kernel) and lurk_tpu's
host NTT and LDE, value for value:

- the two-coset LDE formula (even rows on GENERATOR, odd rows on
  GENERATOR * w_2h) and the plain LDE against lurk_tpu.field.ntt.lde and
  intt;
- the interpreted passes of the NTT, forward and inverse, in one pass, two
  (the four-step split) and three (with passes of at most 2^3 points, so
  that three-pass plans come at small sizes), and of the LDE;
- the pass plan from the shape alone; the tables; the structure's fields
  and the constants against the source's.

device_ntt sends a CPU tensor to the plain version and launches nothing;
the kernel's entry points raise ValueError on what they do not take, a CPU
tensor too. Tolerances are exact.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lurk_tpu.field import ntt as jntt
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.field import ntt as tntt
from lurk_tpu_torch.field import ntt_kernel as nk
from lurk_tpu_torch.stark import device_prover as dp

SOURCE = (Path(nk.__file__).resolve().parents[1] / "csrc" /
          "ntt.cu").read_text()
PP = np.uint64(bb.P)
R_INV = np.uint64(bb.R_INV_MOD_P)


def _mat(rng, rows, w):
    m = rng.integers(0, bb.P, (rows, w), dtype=np.uint64)
    if rows * w >= 3:
        m.flat[:3] = [0, 1, bb.P - 1]
    return m.astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(torch.int32)


def _mmul(a, b):
    """Montgomery product a * b * 2^-32 mod p, as babybear.cuh's mmul."""
    return a.astype(np.uint64) * b.astype(np.uint64) % PP * R_INV % PP


# ---------------------------------------------------------------------------
# a numpy interpreter of csrc/ntt.cu's lurk_ntt_pass
# ---------------------------------------------------------------------------

def _pow_of(tab: np.ndarray, e: np.ndarray) -> np.ndarray:
    """base^e from a three-level power table, as csrc/ntt.cu's pow_of."""
    t = 1 << nk.TAB_LOG
    return _mmul(_mmul(tab[t + ((e >> nk.TAB_LOG) & (t - 1))],
                       tab[e & (t - 1)]), tab[2 * t + (e >> 2 * nk.TAB_LOG)])


def _table(t):
    return None if t is None else t.numpy().astype(np.uint32).astype(
        np.uint64)


def interpret(a: dict, mem: dict) -> None:
    """One pass over the packed NttArgs `a`, reading and writing the numpy
    copies in `mem` (tensor id -> flat uint64 array)."""
    src, dst = mem[id(a["src"])], mem[id(a["dst"])]
    m, lg, w = a["log_pts"], a["log_lanes"], a["w"]
    n, lanes = 1 << m, 1 << lg
    tiles = -(-w // lanes)
    assert tiles * lanes >= w and 4 * (n << lg) <= 4 << nk.BLOCK_WORDS_LOG
    tw = _table(a["stage_tw"])
    ltab, stab = _table(a["load_tab"]), _table(a["store_tab"])
    c = np.arange(a["cosets"])[:, None, None, None, None]
    t = np.arange(a["batches"])[None, :, None, None, None]
    g = np.arange(a["groups"])[None, None, :, None, None]
    j = np.arange(n)[None, None, None, :, None]
    col = np.arange(w)[None, None, None, None, :]
    at = g * a["g_in"] + t * a["t_in"] + j * a["j_in"]
    x = src[(c * a["c_in"] + at) * w + col]          # (C, T, G, n, w)
    if ltab is not None:
        size = 3 << nk.TAB_LOG
        tabs = np.stack([ltab[k * size:(k + 1) * size]
                         for k in range(a["cosets"])])
        x = _mmul(x, np.stack([_pow_of(tabs[k], at[0].astype(np.int64))
                               for k in range(a["cosets"])]))
    rev = np.array([int(format(i, f"0{m}b")[::-1], 2) if m else 0
                    for i in range(n)])
    X = np.empty_like(x)
    X[:, :, :, rev] = x
    s = 0
    while s + 2 <= m:
        h = 1 << s
        blk = X.reshape(X.shape[:3] + (n // (4 * h), 4, h, w))
        i = np.arange(h)[:, None]
        x0, x1, x2, x3 = (blk[..., k, :, :] for k in range(4))
        u = _mmul(x1, tw[h + i])
        x0, x1 = (x0 + u) % PP, (x0 + PP - u) % PP
        u = _mmul(x3, tw[h + i])
        x2, x3 = (x2 + u) % PP, (x2 + PP - u) % PP
        u = _mmul(x2, tw[2 * h + i])
        x0, x2 = (x0 + u) % PP, (x0 + PP - u) % PP
        u = _mmul(x3, tw[3 * h + i])
        x1, x3 = (x1 + u) % PP, (x1 + PP - u) % PP
        X = np.stack([x0, x1, x2, x3], axis=-3).reshape(X.shape)
        s += 2
    if s < m:
        h = 1 << s
        blk = X.reshape(X.shape[:3] + (n // (2 * h), 2, h, w))
        u = _mmul(blk[..., 1, :, :], tw[h + np.arange(h)[:, None]])
        X = np.stack([(blk[..., 0, :, :] + u) % PP,
                      (blk[..., 0, :, :] + PP - u) % PP], axis=-3).reshape(
            X.shape)
    if stab is not None:
        X = _mmul(X, _pow_of(stab, ((g + t * a["tw_t"]) * j).astype(
            np.int64)))
    if a["scale"]:
        X = _mmul(X, np.uint64(a["scale"]))
    rows = c * a["c_out"] + g * a["g_out"] + t * a["t_out"] + j * a["k_out"]
    if a["src"] is a["dst"]:     # in place: a block writes the rows it read
        read = np.broadcast_to(c * a["c_in"] + at, rows.shape)
        assert (np.sort(read, axis=3) == np.sort(rows, axis=3)).all()
    dst[rows * w + col] = X


def run(passes: list) -> None:
    """Interpret a transform's passes in order on their tensors."""
    mem = {}
    for p in passes:
        for name in ("src", "dst"):
            mem.setdefault(id(p[name]),
                           p[name].numpy().astype(np.uint64).reshape(-1))
    for p in passes:
        interpret(p, mem)
    for p in passes:
        p["dst"].copy_(torch.from_numpy(
            mem[id(p["dst"])].astype(np.int64)).view(p["dst"].shape))


@pytest.fixture
def small_passes(monkeypatch):
    """Passes of at most 2^3 points: three-pass plans from 2^7 rows."""
    for inverse in (False, True):
        nk.stage_table(inverse)        # cached at the full size first
    monkeypatch.setattr(nk, "MAX_PASS_LOG", 3)


def two_coset_lde(cfs: torch.Tensor, log_h: int) -> torch.Tensor:
    """lde[2i + c] = the h-point NTT of c_k (s w_2h^c)^k, s = GENERATOR, in
    eager int64 (device_ntt_plain)."""
    h = 1 << log_h
    lde = torch.empty((2 * h, int(cfs.shape[1])), dtype=torch.int32)
    for c, base in enumerate((nk.GENERATOR, bb.mul_s(
            nk.GENERATOR, bb.two_adic_generator_s(log_h + 1)))):
        sp = torch.from_numpy(nk._powers(base, h).astype(np.int64))
        lde[c::2] = tntt.device_ntt_plain(cfs.to(torch.int64) * sp[:, None]
                                          % bb.P, log_h, False).to(
            torch.int32)
    return lde


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("log_h", [0, 1, 3, 10])
@pytest.mark.parametrize("w", [1, 8, 13])
def test_two_coset_lde_matches_lurk_tpu(log_h, w):
    """Even rows the h-point NTT of c_k s^k, odd rows of c_k (s w_2h)^k:
    lurk_tpu's zero-padded 2h-point coset LDE, as the plain LDE
    (device_prover._lde_kernel) has it, and its coefficients."""
    mat = _mat(np.random.default_rng(100 * log_h + w), 1 << log_h, w)
    cfs, lde = dp._lde_kernel(_t(mat), log_h)
    np.testing.assert_array_equal(bb.to_numpy(cfs), jntt.intt(mat))
    np.testing.assert_array_equal(bb.to_numpy(lde), jntt.lde(mat, 1))
    np.testing.assert_array_equal(bb.to_numpy(two_coset_lde(cfs, log_h)),
                                  jntt.lde(mat, 1))


@pytest.mark.parametrize("log_n,w", [(0, 3), (1, 1), (2, 33), (3, 4),
                                     (5, 7), (11, 4), (12, 7), (13, 33),
                                     (17, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_interpreted_ntt_matches_plain(log_n, w, inverse):
    x = _t(_mat(np.random.default_rng(log_n * 7 + w), 1 << log_n, w))
    out = torch.full_like(x, -7)
    passes = nk.transform_args(x, out, log_n, inverse)
    assert len(passes) == (1 if log_n <= nk.MAX_PASS_LOG else 2)
    run(passes)
    want = tntt.device_ntt_plain(x, log_n, inverse).to(torch.int32)
    assert torch.equal(out, want)


@pytest.mark.parametrize("log_n,w", [(7, 3), (8, 33), (9, 1)])
@pytest.mark.parametrize("inverse", [False, True])
def test_interpreted_three_pass_ntt_matches_plain(small_passes, log_n, w,
                                                  inverse):
    """The three-pass plan (above 2^22 rows on the card): pass 0 from the
    input into the output, the two later passes in place."""
    x = _t(_mat(np.random.default_rng(log_n * 5 + w), 1 << log_n, w))
    out = torch.full_like(x, -7)
    passes = nk.transform_args(x, out, log_n, inverse)
    assert [p["log_pts"] for p in passes] == \
        [m for m, _ in nk.pass_plan(log_n, 1)] and len(passes) == 3
    assert [p["src"] is x for p in passes] == [True, False, False]
    run(passes)
    want = tntt.device_ntt_plain(x, log_n, inverse).to(torch.int32)
    assert torch.equal(out, want)


@pytest.mark.parametrize("log_h,three", [(0, False), (3, False),
                                         (12, False), (13, False),
                                         (8, True)])
def test_interpreted_lde_matches_plain(request, log_h, three):
    """lde_cuda's passes (the INTT with its 1/h, both cosets' forward
    passes) against the plain LDE; with `three`, in three passes each."""
    if three:
        request.getfixturevalue("small_passes")
    h, w = 1 << log_h, 9
    group = _t(_mat(np.random.default_rng(log_h), h, w))
    cfs = torch.full((h, w), -7, dtype=torch.int32)
    lde = torch.full((2 * h, w), -7, dtype=torch.int32)
    passes = nk.transform_args(group, cfs, log_h, True,
                               scale=bb.inv_s(h % bb.P)) + \
        nk.transform_args(cfs, lde, log_h, False, coset_log_h=log_h)
    assert len(passes) == 2 * len(nk.pass_plan(log_h, w))
    run(passes)
    want_c, want_l = dp._lde_kernel(group, log_h)
    assert torch.equal(cfs, want_c) and torch.equal(lde, want_l)


def test_pass_plan_follows_the_shape():
    assert nk.pass_plan(0, 1) == [(0, 0)]
    assert nk.pass_plan(9, 655) == [(9, 5)]
    assert nk.pass_plan(10, 655) == [(10, 4)]
    assert nk.pass_plan(11, 4) == [(11, 2)]
    assert nk.pass_plan(12, 33) == [(6, 5), (6, 5)]
    assert nk.pass_plan(18, 655) == [(9, 5), (9, 5)]
    assert nk.pass_plan(19, 4) == [(9, 2), (10, 2)]
    assert nk.pass_plan(22, 32) == [(11, 3), (11, 3)]
    assert nk.pass_plan(23, 4) == [(7, 2), (8, 2), (8, 2)]
    assert nk.pass_plan(27, 100) == [(9, 5), (9, 5), (9, 5)]
    for log_n in range(nk.MAX_LOG + 1):
        plan = nk.pass_plan(log_n, 1000)
        for m, lanes in plan:
            assert m <= nk.MAX_PASS_LOG and m + lanes <= nk.BLOCK_WORDS_LOG
        assert sum(m for m, _ in nk.pass_plan(log_n, 1)) == log_n
        assert len(plan) == max(1, -(-log_n // nk.MAX_PASS_LOG)) <= 3
    with pytest.raises(ValueError, match="2\\^27"):
        nk.pass_plan(nk.MAX_LOG + 1, 1)


def test_tables():
    """TW[h + j] is w_2h^j, and a power table gives base^e for e < 2^27."""
    from_m = bb.np_from_mont
    for inverse in (False, True):
        tw = from_m(nk.stage_table(inverse))
        for s in (0, 3, nk.MAX_PASS_LOG - 1):
            root = bb.two_adic_generator_s(s + 1)
            root = bb.inv_s(root) if inverse else root
            h = 1 << s
            assert [int(v) for v in tw[h:2 * h:max(1, h // 4)]] == \
                [bb.pow_s(root, j) for j in range(0, h, max(1, h // 4))]
    tab = nk.power_table(7).astype(np.uint64)
    e = np.array([0, 1, 2047, 2048, 123457, (1 << 22) - 1, 1 << 22,
                  (1 << 27) - 1])
    assert [int(v) for v in from_m(_pow_of(tab, e).astype(np.uint32))] == \
        [bb.pow_s(7, int(k)) for k in e]


def test_structure_matches_the_source():
    """The ctypes structure lists NttArgs's fields in order, each an 8-byte
    integer or a pointer as in the source; the constants are the
    wrapper's."""
    body = re.search(r"struct NttArgs \{(.*?)\};", SOURCE, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    assert tuple(n for _, n in decl) == nk.NTT_FIELDS
    for ctype, n in decl:
        assert ctype.endswith("*") == (n in nk.PTR_FIELDS), (n, ctype)
        assert (ctype == "long long") == (n not in nk.PTR_FIELDS), (n, ctype)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", SOURCE))
    assert {k: int(consts[k]) for k in ("MAX_PASS_LOG", "MAX_LANES_LOG",
                                        "BLOCK_WORDS_LOG", "TAB_LOG")} == {
        "MAX_PASS_LOG": nk.MAX_PASS_LOG, "MAX_LANES_LOG": nk.MAX_LANES_LOG,
        "BLOCK_WORDS_LOG": nk.BLOCK_WORDS_LOG, "TAB_LOG": nk.TAB_LOG}
    assert ctypes.sizeof(nk._NttArgs) == 8 * len(nk.NTT_FIELDS)


def test_cpu_tensors_take_the_plain_version():
    """device_ntt on a CPU tensor is device_ntt_plain and launches nothing;
    the kernel's entry points refuse a CPU tensor."""
    x = _t(_mat(np.random.default_rng(5), 1 << 6, 5))
    before = nk.ntt_cuda.launches
    for inverse in (False, True):
        assert torch.equal(tntt.device_ntt(x, 6, inverse),
                           tntt.device_ntt_plain(x, 6, inverse))
    for call in (lambda: nk.ntt_cuda(x, 6, False), lambda: nk.lde_cuda(x, 6),
                 lambda: nk.coset_lde_cuda(x, 6)):
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()
    assert nk.ntt_cuda.launches == before


def test_rejects_what_the_kernel_does_not_take():
    x = _t(_mat(np.random.default_rng(6), 1 << 4, 3))
    with pytest.raises(ValueError, match="int32"):
        nk.ntt_cuda(x.to(torch.int64), 4, False)
    with pytest.raises(ValueError, match="2-D"):
        nk.lde_cuda(x[:, 0], 4)
    with pytest.raises(ValueError, match=r"\(8, w\)"):
        nk.ntt_cuda(x, 3, False)
    with pytest.raises(ValueError, match="contiguous"):
        nk.coset_lde_cuda(torch.zeros((3, 16), dtype=torch.int32).t(), 4)
    with pytest.raises(ValueError, match="2\\^27"):
        nk.transform_args(x, x, 28, False)
    with pytest.raises(ValueError, match="must be a torch tensor"):
        nk.ntt_cuda(np.zeros((16, 3), np.int32), 4, False)
