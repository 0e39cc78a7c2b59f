"""lurk_tpu_torch on a CUDA card: the Poseidon2 kernel against its plain
PyTorch version, the hasher's device path against the host path, the
golden proof, and a default-config prove in a process capped to the
memory the planner's model asks for; the constraint-quotient and LogUp
perm-trace kernels (stark/quotient_kernel.py) against their plain
versions on every plan chip of golden.LURK_PROGRAM, direct and compiled,
and the Lurk golden proof through them; the PCS-opening and FRI-fold
kernels (stark/open_kernel.py) against their plain versions at heights
2^1 to 2^19 and widths 1 to 300, open_eval and open_reduce over every
height group of fib(100000)'s shard 0 in one launch each (and an
all-(p - 1) column of 2^15 + 3 rows, an all-(p - 1) group wider than
open_reduce's s32 sums), from three threads at once in a fresh process,
in device_open_rounds (a repeated point) and in the Lurk golden proof;
the device witness kernel (lair/witness_kernel.py) against its plain
version on every VM chip of golden.LURK_PROGRAM and of a fib(3000) in
shards of 1024 rows, from three threads at once in a fresh process, and
in the Lurk golden proofs in one shard and two; the NTT kernel
(field/ntt_kernel.py) against field/ntt.py's eager stages from 2^0 to
2^23 rows (one pass to three) and 1 to 655 columns, its LDE against
_lde_kernel's, from three threads at once in a fresh process, and in the
Lurk golden proof with its launches counted in the commit and quotient
spans. Every test skips without a card.

This file imports no jax (the card's machine has none), so it runs there
without tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs come from numpy seeds. Tolerances are exact.
"""

import functools

import numpy as np
import pytest
import torch

from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.poseidon import perm, ref
from lurk_tpu_torch.poseidon.cuda_kernel import WIDTHS, permute_mont_cuda
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import golden, hasher
from lurk_tpu_torch.stark import quotient_kernel as qk
from lurk_tpu_torch.stark.fri import FriConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_matches_plain_and_oracle(cuda, width):
    rng = np.random.default_rng(width)
    for batch in (1 << 12, (1 << 12) + 3, 1):
        st = torch.from_numpy(rng.integers(0, bb.P, (width, batch))
                              .astype(np.int32)).to(cuda)
        for n_chain in (1, 2):
            before = permute_mont_cuda.launches
            got = permute_mont_cuda(st, n_chain)
            assert permute_mont_cuda.launches == before + 1
            want = st
            for _ in range(n_chain):
                want = perm.permute_mont(want)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        col = bb.from_mont(st[:, :1]).cpu().numpy()[:, 0]
        out = bb.from_mont(permute_mont_cuda(st)[:, :1]).cpu().numpy()[:, 0]
        assert [int(x) for x in out] == ref.permute_s([int(x) for x in col])


def test_kernel_rejects_non_contiguous(cuda):
    st = torch.zeros((8, 16), dtype=torch.int32, device=cuda).T
    with pytest.raises(ValueError):
        permute_mont_cuda(st)


@pytest.mark.parametrize("w", [0, 13, 18])
def test_hasher_on_card_matches_host(cuda, w):
    rng = np.random.default_rng(w)
    mat = rng.integers(0, bb.P, (1000, w), dtype=np.uint64)
    got = hasher.hash_rows(torch.from_numpy(mat.astype(np.int32)).to(cuda))
    np.testing.assert_array_equal(bb.to_numpy(got), hasher._hash_rows_np(mat))
    left, right = mat[:, :8], mat[::-1, :8]
    if w >= 8:
        got = hasher.compress_pairs(
            torch.from_numpy(left.astype(np.int32)).to(cuda),
            torch.from_numpy(np.ascontiguousarray(right).astype(np.int32))
            .to(cuda))
        np.testing.assert_array_equal(bb.to_numpy(got),
                                      hasher._compress_pairs_np(left, right))


def test_golden_proof_on_card(cuda):
    from lurk_tpu_torch.stark.challenger import Challenger
    before = permute_mont_cuda.launches
    machine, vk, proof, digest = golden.fib_proof(cuda)
    assert permute_mont_cuda.launches > before
    assert digest == golden.GOLDEN_FIB1000_SHA256
    assert machine.verify(vk, proof, Challenger())


def test_capped_default_config_prove_stays_inside_the_model(cuda):
    """Demo fib 2^20 at the default config in a process capped by
    set_per_process_memory_fraction at a limit whose budget the modeled
    prove fills to 0.9: no OOM, the proof verifies, and the reserved peak
    stays under the model."""
    from lurk_tpu_torch.stark import hbm
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    cuda = torch.device("cuda", torch.cuda.current_device())
    machine, q = golden.fib_machine((1 << 20) - 8, FriConfig())
    pk, vk = machine.setup()
    shards, _ = hbm.plan_shards(machine, q, None, cuda)
    modeled = hbm.modeled_prove_bytes(machine, shards, "full", cuda)
    limit = hbm.limit_for_budget(int(modeled / 0.9))
    total = torch.cuda.mem_get_info(cuda)[1]
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(limit / total, cuda)
    try:
        proof = machine.prove(pk, q, Challenger(), device=True)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
    stats = machine.last_device_prove
    assert (stats["shards"], stats["keep_mode"]) == (1, "full")
    assert stats["modeled_prove_bytes"] >= 0.8 * stats["budget_bytes"]
    assert stats["peak_reserved_bytes"] <= stats["modeled_prove_bytes"]
    assert machine.verify(vk, proof, Challenger())


@functools.lru_cache(maxsize=None)
def _lurk_plan_chips(compiled: bool):
    machine, q, _ = golden.lurk_machine(golden.LURK_PROGRAM,
                                        FriConfig(1, 8, 2), compiled)
    chips = [(c.name, machine.builder_for(c)) for c in machine.chips]
    return [(n, b, dp.plan_for(b)) for n, b in chips
            if dp.plan_for(b) is not None], len(q.expect_public_values())


def _odd_stride_slices(rng, rows, widths, device):
    """Column slices of one (rows, odd width) int32 matrix on `device`."""
    total = sum(widths) + 3 + (sum(widths) % 2 == 0)
    whole = torch.from_numpy(rng.integers(0, bb.P, (rows, total))
                             .astype(np.int32)).to(device)
    whole[-1, :] = 0
    whole[0, :] = bb.P - 1
    out, off = [], 1
    for w in widths:
        out.append(None if w == 0 else whole[:, off:off + w])
        off += w
    return out


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, bb.P, 4))


@pytest.mark.parametrize("compiled", [False, True], ids=["direct", "compiled"])
@pytest.mark.parametrize("log_h", [0, 9])
def test_quotient_kernel_matches_plain(cuda, compiled, log_h):
    chips, n_pv = _lurk_plan_chips(compiled)
    rng = np.random.default_rng(log_h + 2 * compiled)
    big = 2 << log_h
    for name, builder, _ in chips:
        nb = (len(builder.interactions) + 1) // 2
        main, prep, perm = _odd_stride_slices(
            rng, big, [builder.main_width, builder.preprocessed_width,
                       4 * (nb + 1)], cuda)
        pv = [int(v) for v in rng.integers(0, bb.P, n_pv)]
        qi = dp.quotient_inputs(builder, main, prep, perm, pv,
                                *(_ext(rng) for _ in range(4)), log_h)
        before = qk.constraint_quotient.launches
        got = qk.constraint_quotient(qi)
        assert qk.constraint_quotient.launches == before + 1
        want = qk.quotient_plain(qi)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and tuple(got.shape) == (big, 4)
        assert torch.equal(got.long(), want), name


@pytest.mark.parametrize("compiled", [False, True], ids=["direct", "compiled"])
@pytest.mark.parametrize("log_h", [0, 10])
def test_perm_kernel_matches_plain(cuda, compiled, log_h):
    chips, n_pv = _lurk_plan_chips(compiled)
    rng = np.random.default_rng(10 + log_h + 2 * compiled)
    h = 1 << log_h
    for name, builder, plan in chips:
        if not builder.interactions:
            continue
        nb = plan.n_batches
        main, prep = _odd_stride_slices(
            rng, h, [builder.main_width, builder.preprocessed_width], cuda)
        pv = [int(v) for v in rng.integers(0, bb.P, n_pv)]
        r, gamma = _ext(rng), _ext(rng)
        a = dp._plan_arrays(plan, pv, r, gamma, pad_d_one=False,
                            n_keep=2 * nb)
        got = torch.full((h, 4 * (nb + 1)), -1, dtype=torch.int32,
                         device=cuda)
        want = got.clone()
        before = qk.logup_perm_phi.launches
        qk.logup_perm_phi(got, main, prep, a, plan.n_inter_padded)
        assert qk.logup_perm_phi.launches == before + 1
        qk.perm_phi_plain(want, main, prep, a, plan.n_inter_padded)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name


@pytest.mark.parametrize("compiled", [False, True], ids=["direct", "compiled"])
def test_perm_kernel_zero_and_constant_fingerprints(cuda, compiled):
    """On every plan chip with at least three interactions: interaction 0
    with a constant fingerprint, interaction 1 with a constant zero one,
    and a later one of the same group that is 0 on rows 3 and 5 only
    (its constant zeroed and those rows' main columns zeroed): the kernel
    equals the plain version."""
    chips, n_pv = _lurk_plan_chips(compiled)
    rng = np.random.default_rng(20 + compiled)
    h, n = 1 << 9, 0
    for name, builder, plan in chips:
        nb = plan.n_batches
        main, prep = _odd_stride_slices(
            rng, h, [builder.main_width, builder.preprocessed_width], cuda)
        pv = [int(v) for v in rng.integers(0, bb.P, n_pv)]
        a = dp._plan_arrays(plan, pv, _ext(rng), _ext(rng), pad_d_one=False,
                            n_keep=2 * nb)
        live = (a["tw"] != 0).any(axis=2)                # (T, 2 nb)
        main_only = [k for k in range(2, 2 * nb) if live[:, k].any() and
                     (a["ti"][:, k][live[:, k]] < builder.main_width).all()]
        if not main_only:
            continue
        n += 1
        a["tw"][:, :2] = 0
        a["dconst"][1] = 0
        a["dconst"][main_only[0]] = 0
        main[[3, 5]] = 0
        got = torch.full((h, 4 * (nb + 1)), -1, dtype=torch.int32,
                         device=cuda)
        want = got.clone()
        qk.logup_perm_phi(got, main, prep, a, plan.n_inter_padded)
        qk.perm_phi_plain(want, main, prep, a, plan.n_inter_padded)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
    assert n > 10


def test_quotient_kernels_reject_layouts_they_do_not_take(cuda):
    chips, n_pv = _lurk_plan_chips(False)
    name, builder, plan = next(c for c in chips if c[1].interactions)
    rng = np.random.default_rng(3)
    nb = plan.n_batches
    main, perm = _odd_stride_slices(rng, 64, [builder.main_width,
                                              4 * (nb + 1)], cuda)
    args = ([0] * n_pv, (1, 2, 3, 4), (5, 6, 7, 8), (9, 1, 2, 3),
            (4, 5, 6, 7), 5)
    for bad in (main.T.contiguous().T, main.to(torch.int64)):
        with pytest.raises(ValueError):
            qk.constraint_quotient(dp.quotient_inputs(builder, bad, None,
                                                      perm, *args))
    a = dp._plan_arrays(plan, [0] * n_pv, (1, 2, 3, 4), (5, 6, 7, 8),
                        pad_d_one=False, n_keep=2 * nb)
    out = torch.empty((32, 4 * (nb + 1)), dtype=torch.int32, device=cuda)
    for bad_out in (out.T.contiguous().T, out.to(torch.int64)):
        with pytest.raises(ValueError):
            qk.logup_perm_phi(bad_out, main[:32], None, a, 4)


# Run in a fresh process, so that no launch before it has set the
# kernel's shared-memory attribute: host threads launch constraint_quotient
# at once on one card with tiles of 1 KB, 51 KB and 144 KB of shared
# memory (one-constraint programs 60, 3,200 and 9,000 columns wide on a
# 2-row LDE), as parallel/shard_prover.py's threads do on a mesh whose
# slots repeat a device. Every launch must succeed and equal the plain
# version.
_THREADS_CHILD = """
import sys, threading
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import quotient_kernel as qk
from lurk_tpu_torch.stark.constraint_vm import OP_ADD, VMProgram
cuda = torch.device("cuda")

def inputs(main_w):
    wx = main_w + 4
    prog = VMProgram(main_w, 0, 1, np.array([[OP_ADD, 0, 2, 2 + wx + 1]],
                                            np.int32), [0], [], 2)
    empty = lambda *shape: np.zeros(shape, np.int64)
    plan = dict(ti=empty(0, 2), tw=empty(0, 2, 4),
                dconst=np.array([[1, 0, 0, 0]] * 2), mi=empty(0, 2),
                mw=empty(0, 2), mconst=empty(2))
    main = torch.arange(2 * main_w, dtype=torch.int32,
                        device=cuda).reshape(2, main_w)
    return qk.QuotientInputs(
        prog=prog, consts=np.zeros(4, np.int64), main=main, prep=None,
        perm=torch.ones((2, 8), dtype=torch.int32, device=cuda),
        sels=dp._coset_tables(0, cuda)["sels"], plan=plan, nb=1,
        wbase=np.array([[1, 2, 3, 4]]), wb=np.array([[5, 6, 7, 8]]),
        wsel=np.ones((3, 4), np.int64), cum=np.zeros(4, np.int64), stride=2)

qs = [inputs(w) for w in (60, 3200, 9000)]
sizes = [qk.quotient_smem_bytes(a["n_consts"], a["tile"], 2, a["ld"],
                                a["op_chunk"], a["max_folds"], a["rec_words"])
         for a in map(qk.quotient_args, qs)]
assert sizes[0] < 48 * 1024 <= sizes[1] < sizes[2], sizes
errors, start = [], threading.Barrier(len(qs))

def work(q):
    try:
        args = qk.quotient_args(q)
        start.wait()
        outs = [qk.constraint_quotient(q) for _ in range(100)]
        for _ in range(2000):          # mostly inside the library's call
            qk.launch_quotient(args)
        torch.cuda.synchronize()
        want = qk.quotient_plain(q)
        assert all(torch.equal(o.long(), want)
                   for o in outs + [args["out"].tensor])
    except Exception as e:
        errors.append(repr(e))

threads = [threading.Thread(target=work, args=(q,)) for q in qs]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert not errors, errors
assert qk.constraint_quotient.launches == 3 * 2100
print("ok")
"""


def test_quotient_kernel_launches_from_threads_at_once(cuda):
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _THREADS_CHILD, str(root)],
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and run.stdout.split()[-1:] == ["ok"], \
        run.stdout[-2000:] + run.stderr[-4000:]


def test_lurk_golden_through_the_quotient_kernels(cuda, monkeypatch):
    """golden.LURK_PROGRAM with every chip on the device path: the proof
    keeps lurk_tpu's sha256, and both kernels ran."""
    from lurk_tpu_torch.stark.challenger import Challenger
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", "0")
    q0, p0 = qk.constraint_quotient.launches, qk.logup_perm_phi.launches
    machine, vk, proof, digest = golden.lurk_proof(cuda)
    assert digest == golden.GOLDEN_LURK_SHA256
    assert qk.constraint_quotient.launches > q0
    assert qk.logup_perm_phi.launches > p0
    assert machine.verify(vk, proof, Challenger())


# ---------------------------------------------------------------------------
# the PCS-opening and FRI-fold kernels (stark/open_kernel.py)
# ---------------------------------------------------------------------------

def _special_points(rng, n):
    """n ext points, the last with 0, 1, p - 1 and a value past 2^30."""
    return [_ext(rng) for _ in range(n - 1)] + [(0, 1, bb.P - 1, 1 << 30)]


@pytest.mark.parametrize("log_h", [1, 12, 17])
@pytest.mark.parametrize("w", [1, 7, 300])
def test_open_eval_kernel_matches_plain(cuda, log_h, w):
    from lurk_tpu_torch.stark import open_kernel as ok
    rng = np.random.default_rng(30 + log_h + w)
    coeffs, = _odd_stride_slices(rng, 1 << log_h, [w], cuda)
    for n in (1, 2):
        zs = _special_points(rng, n)
        before = ok.open_eval.launches
        got = ok.open_eval(coeffs, zs)
        assert ok.open_eval.launches == before + 1
        want = ok.eval_plain(coeffs, zs)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and tuple(got.shape) == (n, w, 4)
        assert torch.equal(got, want), (log_h, w, n)


@pytest.mark.parametrize("log_big", [1, 12, 17])
@pytest.mark.parametrize("w", [1, 7, 300])
def test_open_reduce_kernel_matches_plain(cuda, log_big, w):
    """open_reduce_groups into new codewords and into given ones: at
    log_big, a slice of an odd-stride matrix with dense weights (the
    one-group open_reduce) beside a contiguous group with weights from
    alpha^o segments (matrices of w and w // 2 + 1 columns, the first at
    two points, the second at its second point twice) and a third group
    at zeta^2, so the height has three distinct points; one launch. The
    second point is the domain's x at row 1 (x - z = 0 there)."""
    from lurk_tpu_torch.field import ext as ext_t
    from lurk_tpu_torch.field.ntt import GENERATOR
    from lurk_tpu_torch.stark import open_kernel as ok
    rng = np.random.default_rng(40 + log_big + w)
    big = 1 << log_big
    lde, = _odd_stride_slices(rng, big, [w], cuda)
    x1 = GENERATOR * bb.two_adic_generator_s(log_big) % bb.P
    alpha, zeta = _ext(rng), _ext(rng)
    w2 = w // 2 + 1
    contiguous = torch.from_numpy(rng.integers(0, bb.P, (big, w + w2))
                                  .astype(np.int32)).to(cuda)
    segs = [(0, 0, w, ext_t.epow_s(alpha, 3)), (1, 0, w, alpha),
            (1, w, w2, ext_t.epow_s(alpha, 5)),
            (1, w, w2, ext_t.epow_s(alpha, 900))]
    zs = [zeta, (x1, 0, 0, 0)]
    zeta2 = [ext_t.emul_s(zeta, zeta)]
    for zsd in (_special_points(rng, 1), [_ext(rng), (x1, 0, 0, 0)]):
        weights = rng.integers(0, bb.P, (len(zsd), w, 4))
        weights[0, 0] = (0, 1, bb.P - 1, 1 << 30)
        y_alpha = rng.integers(0, bb.P, (len(zsd), 4))
        for ro in (None, torch.from_numpy(rng.integers(
                0, bb.P, (big, 4)).astype(np.int32)).to(cuda)):
            want = ok.reduce_plain(None if ro is None else ro.clone(), lde,
                                   zsd, weights, y_alpha)
            before = ok.open_reduce.launches
            got = ok.open_reduce(ro, lde, zsd, weights, y_alpha)
            assert ok.open_reduce.launches == before + 1
            torch.cuda.synchronize()
            assert ro is None or got is ro
            assert got.dtype == torch.int32 and tuple(got.shape) == (big, 4)
            assert torch.equal(got, want), (log_big, w, len(zsd))
            groups = [(contiguous, zs, segs, rng.integers(0, bb.P, (2, 4))),
                      (lde, zeta2, [(0, 0, w, ext_t.epow_s(alpha, 7))],
                       rng.integers(0, bb.P, (1, 4)))]
            given = None if ro is None else {log_big: ro.clone()}
            want = ok.reduce_groups_plain(
                groups, alpha, None if ro is None else {log_big: ro})
            before = ok.open_reduce.launches
            got = ok.open_reduce_groups(groups, alpha, given)
            assert ok.open_reduce.launches == before + 1
            torch.cuda.synchronize()
            assert list(got) == [log_big]
            assert torch.equal(got[log_big], want[log_big]), (log_big, w)


@pytest.mark.parametrize("log_n", [2, 12, 19])
def test_fri_fold_kernel_matches_plain(cuda, log_n):
    """A layer's pair matrix folded into the next layer's, with and
    without the next height's codeword added."""
    from lurk_tpu_torch.stark import open_kernel as ok
    from lurk_tpu_torch.stark.fri import layer_shift
    rng = np.random.default_rng(50 + log_n)
    n = 1 << log_n
    cw = torch.from_numpy(rng.integers(0, bb.P, (n, 4)).astype(np.int32)) \
        .to(cuda)
    cw[0] = torch.tensor([0, 1, bb.P - 1, 1 << 30])
    pair = dp.pairs(cw)
    add = torch.from_numpy(rng.integers(0, bb.P, (n // 2, 4))
                           .astype(np.int32)).to(cuda)
    for extra in (None, add):
        beta, shift = _ext(rng), layer_shift(log_n + 2, 2)
        before = ok.fri_fold.launches
        got = ok.fri_fold(pair, beta, shift, extra)
        assert ok.fri_fold.launches == before + 1
        want = ok.fold_plain(pair, beta, shift, extra)
        torch.cuda.synchronize()
        assert got.dtype == torch.int32 and tuple(got.shape) == (n // 4, 8)
        assert torch.equal(got, want), log_n


@functools.lru_cache(maxsize=1)
def _shard0_groups():
    """plan_stats.open_groups of direct fib(100000)'s shard 0 at
    ShardingConfig(262144): (round, log2 height, width, points)."""
    from lurk_tpu_torch import plan_stats
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair.execute import ShardingConfig
    toplevel, zstore, _ = build_lurk_toplevel()
    _, q = evaluate(toplevel, zstore, (
        "(letrec ((fib (lambda (n) (if (<= n 1) n (+ (fib (- n 1)) "
        "(fib (- (- n 1) 1))))))) (fib 100000))"))
    machine = new_machine(toplevel, FriConfig())
    return plan_stats.open_groups(machine, q, ShardingConfig(262144))[0]


def test_grouped_open_eval_matches_plain_at_shard0_shapes(cuda):
    """open_eval_groups over every height group of fib(100000)'s shard 0
    (25 groups, 2^0 to 2^18 rows, 6 to 663 columns, slices of odd-stride
    matrices) and an all-(p - 1) column of 2^15 + 3 rows at z = (p - 1,
    ...): one launch, each group bit-equal to the plain version, and the
    same arguments launched again give the same values."""
    from lurk_tpu_torch.field import ext as ext_t
    from lurk_tpu_torch.stark import open_kernel as ok
    groups = _shard0_groups()
    assert len(groups) == 25
    rng = np.random.default_rng(60)
    zeta = _ext(rng)
    egroups = []
    for _, log_h, w, n in groups:
        coeffs, = _odd_stride_slices(rng, 1 << log_h, [w], cuda)
        g = bb.two_adic_generator_s(log_h) if log_h else 1
        egroups.append((coeffs, [zeta, ext_t.emul_s(
            zeta, (g, 0, 0, 0))][:n]))
    worst = torch.full(((1 << 15) + 3, 3), bb.P - 1, dtype=torch.int32,
                       device=cuda)[:, 1:2]
    egroups.append((worst, [(bb.P - 1,) * 4, (bb.P - 1, 0, 0, bb.P - 1)]))
    before = ok.open_eval.launches
    args = ok.eval_args(egroups)
    got = ok.launch_eval(args).clone()
    again = ok.launch_eval(args)
    assert ok.open_eval.launches == before + 2
    want = ok.eval_groups_plain(egroups)
    torch.cuda.synchronize()
    off = 0
    for coeffs, zs in egroups:
        rows = len(zs) * int(coeffs.shape[1])
        assert torch.equal(got[off:off + rows], want[off:off + rows]), \
            (tuple(coeffs.shape), len(zs))
        off += rows
    assert off == len(want) and torch.equal(again, want)


def test_grouped_open_reduce_matches_plain_at_shard0_shapes(cuda):
    """open_reduce_groups over every height group of fib(100000)'s shard
    0 (25 groups, 8 heights of 2^1 to 2^19 rows, contiguous LDEs of 6 to
    663 columns, the prover's points: zeta and zeta * g, zeta^2 for the
    quotient round, one matrix a group with its alpha^o segments) and an
    all-(p - 1) group of 2 rows wider than FLUSH_CHUNKS chunks with a
    point on the domain: one launch, each height bit-equal to the plain
    version, and the same arguments launched again give the same
    values."""
    from lurk_tpu_torch.field import ext as ext_t
    from lurk_tpu_torch.field.ntt import GENERATOR
    from lurk_tpu_torch.stark import open_kernel as ok
    rng = np.random.default_rng(61)
    alpha, zeta = _ext(rng), _ext(rng)
    groups, o = [], 0
    for rnd, log_h, w, n in _shard0_groups():
        g = bb.two_adic_generator_s(log_h) if log_h else 1
        zs = [ext_t.emul_s(zeta, zeta)] if rnd == "quotient" else \
            [zeta, ext_t.emul_s(zeta, (g, 0, 0, 0))][:n]
        segs = []
        for k in range(len(zs)):
            segs.append((k, 0, w, ext_t.epow_s(alpha, o)))
            o += w
        lde = torch.from_numpy(rng.integers(0, bb.P, (2 << log_h, w))
                               .astype(np.int32)).to(cuda)
        groups.append((lde, zs, segs, rng.integers(0, bb.P, (len(zs), 4))))
    wide = ok.FLUSH_CHUNKS * ok.REDUCE_COLS + 3
    x1 = GENERATOR * (bb.P - 1) % bb.P
    groups.append((torch.full((2, wide), bb.P - 1, dtype=torch.int32,
                              device=cuda),
                   [(x1, 0, 0, 0)], [(0, 0, wide, alpha)],
                   rng.integers(0, bb.P, (1, 4))))
    before = ok.open_reduce.launches
    args = ok.reduce_groups_args(groups, alpha)
    got = {k: v.clone() for k, v in ok.launch_reduce(args).items()}
    again = ok.launch_reduce(args)
    assert ok.open_reduce.launches == before + 2
    want = ok.reduce_groups_plain(groups, alpha)
    torch.cuda.synchronize()
    assert sorted(got) == sorted(want) and len(want) == 8
    for lh in want:
        assert torch.equal(got[lh], want[lh]), lh
        assert torch.equal(again[lh], want[lh]), lh


def test_open_kernels_reject_layouts_they_do_not_take(cuda):
    from lurk_tpu_torch.stark import open_kernel as ok
    rng = np.random.default_rng(6)
    coeffs, = _odd_stride_slices(rng, 64, [5], cuda)
    z = [_ext(rng)]
    for bad in (coeffs.T.contiguous().T, coeffs.to(torch.int64)):
        with pytest.raises(ValueError):
            ok.open_eval(bad, z)
    with pytest.raises(ValueError):
        ok.open_eval(coeffs, z * (ok.MAX_POINTS + 1))
    with pytest.raises(ValueError):               # not a power of two rows
        ok.open_reduce(None, coeffs[:48], z, np.zeros((1, 5, 4)),
                       np.zeros((1, 4)))
    with pytest.raises(ValueError):               # a codeword on the CPU
        ok.open_reduce(torch.zeros((64, 4), dtype=torch.int32), coeffs, z,
                       np.zeros((1, 5, 4)), np.zeros((1, 4)))
    pair = torch.zeros((64, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ok.fri_fold(pair[::2], z[0], 31)
    with pytest.raises(ValueError):
        ok.fri_fold(pair[:, :4].contiguous(), z[0], 31)
    with pytest.raises(ValueError):
        ok.fri_fold(pair, z[0], 31, pair)
    with pytest.raises(ValueError):             # groups on two devices
        ok.open_eval_groups([(coeffs, z), (coeffs.cpu(), z)])


# Run in a fresh process, so that no launch before it has set open_eval's
# shared-memory attribute: three host threads launch each open kernel at
# once on one card (open_eval on two groups at a time), as
# parallel/shard_prover.py's threads do on a mesh whose slots repeat a
# device. Every output must equal the plain version and every launch be
# counted.
_OPEN_THREADS_CHILD = """
import sys, threading
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import open_kernel as ok
cuda = torch.device("cuda")
rng = np.random.default_rng(7)

def rand(*shape):
    return torch.from_numpy(rng.integers(0, bb.P, shape).astype(np.int32)
                            ).to(cuda)

def ext():
    return tuple(int(v) for v in rng.integers(0, bb.P, 4))

cases = []
for w in (3, 40, 260):
    coeffs, small = rand(1 << 10, w + 3)[:, 1:1 + w], rand(64, w)
    lde = rand(1 << 11, w)
    zs = [ext(), ext()]
    cases.append(([(coeffs, zs), (small, zs[:1])], lde, zs,
                  rng.integers(0, bb.P, (2, w, 4)),
                  rng.integers(0, bb.P, (2, 4)), dp.pairs(rand(1 << 11, 4)),
                  ext()))
errors, start = [], threading.Barrier(len(cases))

def work(case):
    groups, lde, zs, weights, ya, pair, beta = case
    try:
        start.wait()
        outs = [(ok.open_eval_groups(groups),
                 ok.open_reduce(None, lde, zs, weights, ya),
                 ok.fri_fold(pair, beta, 31)) for _ in range(50)]
        torch.cuda.synchronize()
        want = (ok.eval_groups_plain(groups),
                ok.reduce_plain(None, lde, zs, weights, ya),
                ok.fold_plain(pair, beta, 31))
        assert all(torch.equal(g, w) for o in outs for g, w in zip(o, want))
    except Exception as e:
        errors.append(repr(e))

threads = [threading.Thread(target=work, args=(c,)) for c in cases]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert not errors, errors
assert [f.launches for f in (ok.open_eval, ok.open_reduce, ok.fri_fold)] \\
    == [150] * 3
print("ok")
"""


def test_open_kernels_from_threads_at_once(cuda):
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _OPEN_THREADS_CHILD,
                          str(root)], capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0 and run.stdout.split()[-1:] == ["ok"], \
        run.stdout[-2000:] + run.stderr[-4000:]


def test_open_rounds_with_a_repeated_point(cuda):
    """device_open_rounds on rounds of 1-row matrices (whose point list
    repeats zeta, as zeta * g == zeta at height 1), 16-row and 2^17-row
    ones, with every FRI layer on the device: the PCS proof on the card is
    the CPU's, byte for byte, and every open kernel ran."""
    from lurk_tpu_torch.stark import open_kernel as ok
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.utils import codec
    rng = np.random.default_rng(8)
    shapes = [(1, 3), (1, 2), (16, 5), (1 << 17, 4)]
    mats = [rng.integers(0, bb.P, s).astype(np.uint64) for s in shapes]
    zeta = _ext(rng)
    g16 = bb.two_adic_generator_s(4)
    g17 = bb.two_adic_generator_s(17)
    from lurk_tpu_torch.field import ext as ext_t
    points = [[[zeta, zeta], [zeta], [zeta, ext_t.emul_s(zeta, (g16, 0, 0, 0))],
               [zeta, ext_t.emul_s(zeta, (g17, 0, 0, 0))]]]
    config = FriConfig(1, 4, 1)
    proofs = []
    counts = [f.launches for f in (ok.open_eval, ok.open_reduce, ok.fri_fold)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LURK_TPU_FRI_HOST_TAIL_LOG", "0")
        for device in (torch.device("cpu"), cuda):
            rnd = dp.dcommit([m.copy() for m in mats], device)
            ch = Challenger()
            for root in rnd.roots:
                ch.observe_many(root)
            proofs.append(codec.encode(dp.device_open_rounds(
                [rnd], points, config, ch)))
    assert proofs[0] == proofs[1]
    after = [f.launches for f in (ok.open_eval, ok.open_reduce, ok.fri_fold)]
    # one open_eval and one open_reduce for every group of the round
    assert [a - b for a, b in zip(after, counts)] == [1, 1, 17]


def test_lurk_golden_through_the_open_kernels(cuda, monkeypatch):
    """golden.LURK_PROGRAM with every chip on the device path and every
    FRI layer on the device: the proof keeps lurk_tpu's sha256, and each
    open kernel ran as often as plan_stats counts."""
    from lurk_tpu_torch import plan_stats
    from lurk_tpu_torch.stark import open_kernel as ok
    from lurk_tpu_torch.stark.challenger import Challenger
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", "0")
    monkeypatch.setenv("LURK_TPU_FRI_HOST_TAIL_LOG", "0")
    fns = (ok.open_eval, ok.open_reduce, ok.fri_fold)
    before = [f.launches for f in fns]
    machine, vk, proof, digest = golden.lurk_proof(cuda)
    assert digest == golden.GOLDEN_LURK_SHA256
    assert machine.verify(vk, proof, Challenger())
    planned = plan_stats.kernel_launches(
        machine, golden.lurk_machine(golden.LURK_PROGRAM,
                                     FriConfig(1, 8, 2))[1], None)
    got = [f.launches - b for f, b in zip(fns, before)]
    assert got == [planned["open_eval"], planned["open_reduce"],
                   planned["fri_fold"]]
    assert min(got) > 0


# ---------------------------------------------------------------------------
# the device witness kernel (lair/witness_kernel.py)
# ---------------------------------------------------------------------------

# Run in a fresh process, so that no launch before it has set the kernel's
# shared-memory attribute: three host threads launch witness_trace at once
# on one card, as parallel/shard_prover.py's threads do on a mesh whose
# slots repeat a device, over every VM chip of golden.LURK_PROGRAM (one
# shard) and of a Lurk fib(3000) at ShardingConfig(1024) (every shard),
# three times each; every trace must equal the plain version's
# (device_trace.plain_trace on the card) bit for bit.
_WITNESS_CHILD = """
import sys, threading
import torch
sys.path.insert(0, sys.argv[1])
from lurk_tpu_torch.lair import device_trace as dt
from lurk_tpu_torch.lair import witness_kernel as wk
from lurk_tpu_torch.lair.chips import chip_included
from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark.fri import FriConfig
cuda = torch.device("cuda")
FIB3000 = ("(letrec ((fib (lambda (n) (if (<= n 1) n (+ (fib (- n 1)) "
           "(fib (- (- n 1) 1))))))) (fib 3000))")
cases = []
for code, size in ((golden.LURK_PROGRAM, None), (FIB3000, 1024)):
    machine, q, _ = golden.lurk_machine(code, FriConfig(1, 8, 2))
    cfg = None if size is None else ShardingConfig(size)
    for shard in Shard(q, 0, cfg).shard():
        for chip in machine.chips:
            if dt._plans_for(chip) is not None and \\
                    chip_included(chip, shard) and chip.num_rows(shard):
                cases.append((chip, shard, dt.plain_trace(chip, shard, cuda)))
torch.cuda.synchronize()
errors, start = [], threading.Barrier(3)

def work(mine):
    try:
        start.wait()
        outs = [[wk.witness_trace(c, s, cuda) for c, s, _ in mine]
                for _ in range(3)]
        torch.cuda.synchronize()
        for out in outs:
            for got, (c, s, want) in zip(out, mine):
                assert torch.equal(got, want), (c.name, s.index)
    except Exception as e:
        errors.append(repr(e))

threads = [threading.Thread(target=work, args=(cases[k::3],))
           for k in range(3)]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert not errors, errors
assert wk.witness_trace.launches == 3 * len(cases), len(cases)
print(len(cases), "ok")
"""


def test_witness_kernel_matches_plain_from_threads_at_once(cuda):
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _WITNESS_CHILD, str(root)],
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0 and run.stdout.split()[-1:] == ["ok"], \
        run.stdout[-2000:] + run.stderr[-4000:]


def test_lurk_golden_through_the_witness_kernel(cuda, monkeypatch):
    """golden.LURK_PROGRAM with every chip on the device path, in one shard
    (keep mode `light`) and in two (keep mode `none`: pass 2 makes each
    device witness again): the proofs keep lurk_tpu's sha256, and the
    kernel made every VM chip's witness, its rows counted as
    `witness_kernel_rows`."""
    from lurk_tpu_torch.lair import device_trace as dt
    from lurk_tpu_torch.lair.chips import chip_included
    from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
    from lurk_tpu_torch.stark import hbm, spans
    from lurk_tpu_torch.stark.challenger import Challenger
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", "0")
    monkeypatch.setattr(hbm, "keep_rounds_fits", lambda *a: False)
    monkeypatch.setattr(hbm, "keep_light_fits", lambda *a: False)
    machine, q, _ = golden.lurk_machine(golden.LURK_PROGRAM,
                                        FriConfig(1, 8, 2))
    spans.enable(True)
    try:
        for size, want in ((None, golden.GOLDEN_LURK_SHA256),
                           (golden.LURK_2SHARD_SIZE,
                            golden.GOLDEN_LURK_2SHARD_SHA256)):
            _, vk, proof, digest = golden.lurk_proof(cuda, size, (machine, q))
            assert digest == want
            assert machine.verify(vk, proof, Challenger())
            stats = machine.last_device_prove
            made = 1 if size is None else 2
            assert stats["keep_mode"] == ("light" if made == 1 else "none")
            rows = [c.num_rows(s) for s in Shard(
                q, 0, None if size is None else ShardingConfig(size)).shard()
                for c in machine.chips if dt._plans_for(c) is not None
                and chip_included(c, s) and c.num_rows(s)]
            assert stats["witness_launches"] == made * len(rows) > 0
            assert stats["counters"]["witness_kernel_rows"] == \
                made * sum(rows)
    finally:
        spans.enable(None)


# ---------------------------------------------------------------------------
# the NTT kernel (field/ntt_kernel.py)
# ---------------------------------------------------------------------------

NTT_WIDTHS = (1, 4, 7, 32, 33, 655)   # 655: sum100k's hash4; 4: the epilogue


@pytest.mark.parametrize("log_n", [0, 1, 5, 11, 12, 17, 19, 20, 23])
def test_ntt_kernel_matches_plain(cuda, log_n):
    """ntt_cuda forward and inverse against field/ntt.py's eager stages on
    the card, at every width whose plain transform fits (n w <= 2^27);
    device_ntt takes the kernel. 2^23 rows: the quotient epilogue's INTT
    of a 2^22-row chip, in three passes."""
    from lurk_tpu_torch.field import ntt as tntt
    from lurk_tpu_torch.field import ntt_kernel as nk
    rng = np.random.default_rng(log_n)
    n = 1 << log_n
    for w in (w for w in NTT_WIDTHS if n * w <= 1 << 27):
        x = torch.from_numpy(rng.integers(0, bb.P, (n, w)).astype(np.int32))
        x.view(-1)[:2] = torch.tensor([0, bb.P - 1])[:n * w]
        x = x.to(cuda)
        for inverse in (False, True):
            before = nk.ntt_cuda.launches
            got = nk.ntt_cuda(x, log_n, inverse)
            want = tntt.device_ntt_plain(x, log_n, inverse)
            assert torch.equal(got, want.to(torch.int32)), (log_n, w, inverse)
            assert nk.ntt_cuda.launches - before == \
                len(nk.pass_plan(log_n, w))
            assert torch.equal(tntt.device_ntt(x, log_n, inverse), want)
        del x, got, want
    torch.cuda.empty_cache()


@pytest.mark.parametrize("log_h,w", [(0, 3), (3, 8), (9, 38), (10, 5),
                                     (12, 100), (17, 655), (18, 40),
                                     (22, 4), (23, 2)])
def test_lde_kernel_matches_plain(cuda, log_h, w):
    """lde_cuda and coset_lde_cuda against _lde_kernel's eager composition
    on the card (group shapes as the commits have them: sum100k's hash4 at
    2^17 x 655; the two passes of 2^22 rows and the three of 2^23)."""
    from lurk_tpu_torch.field import ntt_kernel as nk
    rng = np.random.default_rng(log_h * 1000 + w)
    h = 1 << log_h
    group = torch.from_numpy(rng.integers(0, bb.P, (h, w)).astype(
        np.int32)).to(cuda)
    want_c, want_l = dp._lde_kernel(group, log_h)
    cfs, lde = nk.lde_cuda(group, log_h)
    assert torch.equal(cfs, want_c) and torch.equal(lde, want_l)
    assert torch.equal(nk.coset_lde_cuda(want_c, log_h), want_l)
    del group, want_c, want_l, cfs, lde
    torch.cuda.empty_cache()


def test_ntt_kernel_rejects_what_it_does_not_take(cuda):
    from lurk_tpu_torch.field import ntt_kernel as nk
    x = torch.zeros((16, 3), dtype=torch.int32, device=cuda)
    for bad, match in ((x.long(), "int32"), (x[:, 0], "2-D"),
                       (x[:8], r"\(16, w\)"),
                       (torch.zeros((3, 16), dtype=torch.int32,
                                    device=cuda).t(), "contiguous"),
                       (x.cpu(), "CUDA tensor")):
        with pytest.raises(ValueError, match=match):
            nk.ntt_cuda(bad, 4, False)
        with pytest.raises(ValueError, match=match):
            nk.lde_cuda(bad, 4)
        with pytest.raises(ValueError, match=match):
            nk.coset_lde_cuda(bad, 4)


_NTT_CHILD = r"""
import sys, threading
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from lurk_tpu_torch.field import ntt as tntt
from lurk_tpu_torch.field import ntt_kernel as nk
cuda = torch.device("cuda")
rng = np.random.default_rng(7)
cases = [(log_n, w, torch.from_numpy(rng.integers(
    0, 2013265921, (1 << log_n, w)).astype(np.int32)).to(cuda))
    for log_n, w in ((3, 5), (10, 40), (13, 7), (16, 33), (18, 4), (12, 1))]
want = [(tntt.device_ntt_plain(x, log_n, False).to(torch.int32),
         tntt.device_ntt_plain(x, log_n, True).to(torch.int32))
        for log_n, w, x in cases]
torch.cuda.synchronize()
errors = []
def work(k):
    try:
        for _ in range(4):
            for (log_n, w, x), (fwd, inv) in zip(cases[k::3], want[k::3]):
                assert torch.equal(nk.ntt_cuda(x, log_n, False), fwd)
                assert torch.equal(nk.ntt_cuda(x, log_n, True), inv)
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=work, args=(k,)) for k in range(3)]
for t in threads:
    t.start()
for t in threads:
    t.join()
assert not errors, errors
assert nk.ntt_cuda.launches == 4 * 2 * sum(
    len(nk.pass_plan(log_n, w)) for log_n, w, _ in cases)
print("ok")
"""


def test_ntt_kernel_launches_from_threads_at_once(cuda):
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", _NTT_CHILD, str(root)],
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and run.stdout.split()[-1:] == ["ok"], \
        run.stdout[-2000:] + run.stderr[-4000:]


def test_lurk_golden_through_the_ntt_kernel(cuda, monkeypatch):
    """golden.LURK_PROGRAM proved with the NTT kernel: lurk_tpu's sha256,
    NTT launches counted per prove, every main.commit, perm.commit and
    quotient.device span counts ntt_launches and ntt_cells, and no eager
    NTT stage runs on the card (device_ntt_plain refuses CUDA tensors)."""
    from lurk_tpu_torch.field import ntt as tntt
    from lurk_tpu_torch.field import ntt_kernel as nk
    from lurk_tpu_torch.stark import spans
    from lurk_tpu_torch.stark.challenger import Challenger
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", "0")
    plain = tntt.device_ntt_plain

    def host_only(x, log_n, inverse):
        assert x.device.type != "cuda", (tuple(x.shape), log_n, inverse)
        return plain(x, log_n, inverse)

    monkeypatch.setattr(tntt, "device_ntt_plain", host_only)
    monkeypatch.setattr(dp, "device_ntt_plain", host_only)
    before = nk.ntt_cuda.launches
    spans.enable(True)
    try:
        machine, vk, proof, digest = golden.lurk_proof(cuda)
    finally:
        spans.enable(None)
    assert digest == golden.GOLDEN_LURK_SHA256
    assert machine.verify(vk, proof, Challenger())
    stats = machine.last_device_prove
    assert 0 < stats["ntt_launches"] <= nk.ntt_cuda.launches - before
    assert stats["counters"]["ntt_launches"] == stats["ntt_launches"]
    seen = set()
    for s in stats["spans"]:
        if s["name"] in ("main.commit", "perm.commit", "quotient.device"):
            assert s.get("ntt_launches", 0) > 0, s
            assert s.get("ntt_cells", 0) > 0, s
            seen.add(s["name"])
    assert seen == {"main.commit", "perm.commit", "quotient.device"}
