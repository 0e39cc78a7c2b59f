"""lurk_tpu_torch on a CUDA card: the Poseidon2 kernel against its plain
PyTorch version, the hasher's device path against the host path, the
golden proof, and a default-config prove in a process capped to the
memory the planner's model asks for; the constraint-quotient and LogUp
perm-trace kernels (stark/quotient_kernel.py) against their plain
versions on every plan chip of golden.LURK_PROGRAM, direct and compiled,
and the Lurk golden proof through them; the PCS-opening and FRI-fold
kernels (stark/open_kernel.py) against their plain versions at heights
2^1 to 2^19 and widths 1 to 300, open_eval over every height group of
fib(100000)'s shard 0 in one launch (and an all-(p - 1) column of 2^15 +
3 rows), from three threads at once in a fresh process, in
device_open_rounds (a repeated point) and in the Lurk golden proof. Every
test skips without a card.

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
    """Into a new codeword and into a given one; the second point of the
    two-point case is the domain's x at row 1 (x - z = 0 there)."""
    from lurk_tpu_torch.stark import open_kernel as ok
    from lurk_tpu_torch.field.ntt import GENERATOR
    rng = np.random.default_rng(40 + log_big + w)
    big = 1 << log_big
    lde, = _odd_stride_slices(rng, big, [w], cuda)
    x1 = GENERATOR * bb.two_adic_generator_s(log_big) % bb.P
    for zs in (_special_points(rng, 1), [_ext(rng), (x1, 0, 0, 0)]):
        weights = rng.integers(0, bb.P, (len(zs), w, 4))
        weights[0, 0] = (0, 1, bb.P - 1, 1 << 30)
        y_alpha = rng.integers(0, bb.P, (len(zs), 4))
        for ro in (None, torch.from_numpy(rng.integers(
                0, bb.P, (big, 4)).astype(np.int32)).to(cuda)):
            want = ok.reduce_plain(None if ro is None else ro.clone(), lde,
                                   zs, weights, y_alpha)
            before = ok.open_reduce.launches
            got = ok.open_reduce(ro, lde, zs, weights, y_alpha)
            assert ok.open_reduce.launches == before + 1
            torch.cuda.synchronize()
            assert ro is None or got is ro
            assert got.dtype == torch.int32 and tuple(got.shape) == (big, 4)
            assert torch.equal(got, want), (log_big, w, len(zs))


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
    # one open_eval for every group of the round, one open_reduce a group
    assert [a - b for a, b in zip(after, counts)] == [1, 3, 17]


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
