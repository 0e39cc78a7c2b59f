"""lurk_tpu_torch's device-memory planner (stark/hbm.py) on the CPU.

The planner reads the memory of the prover's own device: the CPU plans at
lurk_tpu's 16 GB default on any machine, and a CUDA device reads its own
total, scaled by the process's memory fraction (both monkeypatched here to
a pretend card). The model of a prove, on a synthetic machine (chips with
rows, widths, LogUp batches and VM registers, no Lurk toplevel): keeping
more in pass 1 never models less memory, and halving the shard size never
raises a shard's high-water. The small programs that the CPU byte-identity
tests prove still plan one shard in keep mode `full`, as in lurk_tpu.
The transients the model counts are bounded by the prover's chunks, and
chunks far smaller than the matrices give the same values.
"""

from types import SimpleNamespace

import pytest
import torch

from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
from lurk_tpu_torch.stark import golden, hbm
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

GIB = 1 << 30


@pytest.fixture
def pretend_cards(monkeypatch):
    """Two pretend CUDA cards of 80 and 40 GiB; cuda:1 capped at 0.25."""
    totals = {0: 80 * GIB, 1: 40 * GIB}
    fractions = {0: 1.0, 1: 0.25}
    index = lambda d: 0 if d is None else torch.device(d).index
    monkeypatch.delenv("LURK_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d=None: (GIB, totals[index(d)]))
    monkeypatch.setattr(torch.cuda, "get_per_process_memory_fraction",
                        lambda d=None: fractions[index(d)])
    return totals, fractions


def test_cpu_plans_at_lurk_tpus_default_beside_a_card(pretend_cards):
    assert hbm.device_hbm_bytes(torch.device("cpu")) == hbm._DEFAULT_HBM
    assert hbm.device_hbm_bytes("cpu") == hbm._DEFAULT_HBM


def test_cuda_device_reads_its_own_memory(pretend_cards, monkeypatch):
    totals, fractions = pretend_cards
    assert hbm.device_hbm_bytes("cuda:0") == totals[0]
    assert hbm.device_hbm_bytes(torch.device("cuda")) == totals[0]
    assert hbm.device_hbm_bytes() == totals[0]
    assert hbm.device_hbm_bytes("cuda:1") == int(totals[1] * fractions[1])
    fractions[1] = 1.0
    assert hbm.device_hbm_bytes("cuda:1") == totals[1]
    monkeypatch.setenv("LURK_TPU_HBM_BYTES", str(3 * GIB))
    assert hbm.device_hbm_bytes("cuda:1") == 3 * GIB


class _Chip:
    """A chip whose rows are a share of the shard size."""

    def __init__(self, width, batches, regs, share):
        self.width = width
        self.share = share
        self.builder = SimpleNamespace(
            interactions=[None] * (2 * batches),
            _vm_program=SimpleNamespace(n_regs=regs, x_width=width + 4))

    def included(self, shard):
        return True

    def num_rows(self, shard):
        return max(1, int(shard.size * self.share))


class _Machine:
    def __init__(self, chips):
        self.chips = chips

    def builder_for(self, chip):
        return chip.builder


# widths, batches and register counts of the Lurk machine's largest chips
_MACHINE = _Machine([_Chip(148, 78, 624, 0.25), _Chip(114, 30, 220, 0.2),
                     _Chip(78, 22, 128, 0.5), _Chip(12, 1, 8, 0.1),
                     _Chip(13, 6, 3, 0.02)])


def _shards(size, n):
    return [SimpleNamespace(size=size) for _ in range(n)]


@pytest.mark.parametrize("size", [1 << 14, 1 << 18, 1 << 21])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_keeping_more_never_models_less(size, n_shards):
    shards = _shards(size, n_shards)
    full, light, none = (hbm.modeled_prove_bytes(_MACHINE, shards, mode, "cpu")
                         for mode in ("full", "light", "none"))
    assert full >= light >= none > 0
    if n_shards > 1:
        assert full > light > none
        budget = (full + light) // 2
        assert not hbm.keep_rounds_fits(_MACHINE, shards, budget, "cpu")
        assert hbm.keep_light_fits(_MACHINE, shards, budget, "cpu")
        assert hbm.keep_mode(_MACHINE, shards, budget, "cpu") == "light"
        assert hbm.keep_mode(_MACHINE, shards, none, "cpu") == "none"
    else:
        assert hbm.keep_mode(_MACHINE, shards, 1, "cpu") == "light"


def test_halving_the_shard_size_never_raises_the_highwater():
    sizes = [1 << k for k in range(22, 9, -1)]
    marks = [hbm.shard_highwater_bytes(_MACHINE, SimpleNamespace(size=s),
                                       "cpu")
             for s in sizes]
    assert all(a >= b for a, b in zip(marks, marks[1:]))
    assert marks[0] > 4 * marks[-1]


def test_phases_follow_the_prove():
    """One label per stamp device_prove makes, pass 1 before pass 2."""
    phases = [p for p, _ in hbm.prove_phases(_MACHINE, _shards(1 << 12, 2),
                                             "none", "cpu")]
    per_shard = ["main recommit", "perm trace", "perm commit", "quotient",
                 "quotient commit", "open"]
    assert phases == ["shard0 witness", "shard0 main commit",
                      "shard1 witness", "shard1 main commit"] + \
        [f"shard{j} {p}" for j in range(2) for p in per_shard]
    full = [p for p, _ in hbm.prove_phases(_MACHINE, _shards(1 << 12, 2),
                                           "full", "cpu")]
    assert "shard0 main recommit" not in full and len(full) == 14


@pytest.mark.parametrize("machine_queries", [
    lambda: golden.fib_machine(golden.GOLDEN_N, FriConfig(1, 8, 2)),
    lambda: golden.ackermann_machine(2, 7, FriConfig(1, 8, 2)),
    lambda: golden.lurk_machine(golden.LURK_PROGRAM, FriConfig(1, 8, 2))[:2],
], ids=["fib1000", "ackermann", "lurk_program"])
def test_cpu_plans_one_full_shard_for_small_programs(machine_queries):
    machine, q = machine_queries()
    shards, budget = hbm.plan_shards(machine, q, None, torch.device("cpu"))
    assert len(shards) == 1
    assert budget == hbm._budget(hbm._DEFAULT_HBM)
    assert hbm.keep_rounds_fits(machine, shards, budget, "cpu")
    cfg = ShardingConfig(64)
    explicit, _ = hbm.plan_shards(machine, q, cfg, torch.device("cpu"),
                                  limit_bytes=1)
    assert len(explicit) == len(Shard(q, 0, cfg).shard())



def _field(rng, *shape):
    from lurk_tpu_torch.field.babybear import P
    return torch.from_numpy(rng.integers(0, P, shape).astype("int32"))


def test_small_chunks_give_the_same_openings(monkeypatch):
    """The opened values and the reduced openings run over row blocks of
    about LDE_CHUNK_CELLS cells; blocks far smaller than the matrix give
    the same values as one block."""
    import numpy as np
    from lurk_tpu_torch.field.babybear import I64
    from lurk_tpu_torch.stark import device_prover as dp
    rng = np.random.default_rng(6)
    coeffs, zp = _field(rng, 1 << 9, 13), _field(rng, 1 << 9, 4).to(I64)
    lde, inv_xz = _field(rng, 1 << 10, 13), _field(rng, 1 << 10, 4)
    apows, y = _field(rng, 13, 4).to(I64), _field(rng, 4).to(I64)
    whole = dp._eval_coeffs(coeffs, zp), \
        dp._reduce_chunked(lde, apows, y, inv_xz)
    monkeypatch.setattr(dp, "LDE_CHUNK_CELLS", 1 << 6)
    assert dp._open_rows(13, 1 << 9) == 1 << 2
    for got, want in zip((dp._eval_coeffs(coeffs, zp),
                          dp._reduce_chunked(lde, apows, y, inv_xz)), whole):
        assert torch.equal(got, want)


def test_small_windows_give_the_same_quotient(monkeypatch):
    """The constraint-VM quotient runs over windows of _vm_rows LDE rows
    (plus the next rows, wrapping at the end); windows far smaller than the
    LDE give the same quotient as one window."""
    import numpy as np
    from lurk_tpu_torch.stark import device_prover as dp
    machine, _ = golden.fib_machine(30, FriConfig(1, 8, 2))
    chip = next(c for c in machine.chips if c.name == "Func[fib]")
    builder = machine.builder_for(chip)
    nb = (len(builder.interactions) + 1) // 2
    rng = np.random.default_rng(7)
    log_h = 6
    args = (builder, _field(rng, 2 << log_h, chip.width), None,
            _field(rng, 2 << log_h, 4 * (nb + 1)), [1, 2, 3],
            (5, 6, 7, 8), (9, 10, 11, 12), (13, 14, 15, 16),
            (17, 18, 19, 20), log_h)
    whole = dp.device_quotient_chunk_vm(*args)
    monkeypatch.setattr(dp, "_vm_rows", lambda width: 16)
    assert torch.equal(dp.device_quotient_chunk_vm(*args), whole)


def test_cuda_models_the_quotient_kernels_buffers(monkeypatch):
    """On CUDA the perm trace and the quotient hold the kernels' buffers
    (the running-sum scan; the constraint_quotient fold and its epilogue,
    with no register file in device memory, whatever the program's
    registers), not the plain versions' int64 windows, which the CPU's
    model keeps so that its plans stay lurk_tpu's."""
    c = hbm.ChipShape(h=1 << 18, width=148, batches=78, x_width=152,
                      n_regs=624, on_device=True)
    assert hbm._quotient_transient(c, cuda=True) == 512 * c.h
    wide = hbm.ChipShape(h=1 << 18, width=148, batches=78, x_width=152,
                         n_regs=9954, on_device=True)
    assert hbm._quotient_transient(wide, cuda=True) == 512 * c.h
    assert hbm._quotient_transient(c, cuda=False) > \
        4 * hbm._quotient_transient(c, cuda=True)
    assert hbm._perm_transient(c, cuda=True) == 128 * c.h
    shards = _shards(1 << 18, 4)
    cpu = dict(hbm.prove_phases(_MACHINE, shards, "full", "cpu"))
    cuda = dict(hbm.prove_phases(_MACHINE, shards, "full", "cuda"))
    assert cpu.keys() == cuda.keys()
    assert cuda["shard0 quotient"] < cpu["shard0 quotient"]
    # the model is the named device's, whatever this process has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert dict(hbm.prove_phases(_MACHINE, shards, "full", "cpu")) == cpu


def test_cuda_models_the_open_kernels_buffers():
    """On CUDA the open phase holds the open kernels' small buffers (every
    group's opened values, accumulators and tables at once, for open_eval's
    one launch; open_reduce's height, chunk and segment records, for its
    one launch) and the int32 reduced codewords, one (2h, 4) a height, not
    the plain versions' int64 row blocks, which the CPU's model keeps."""
    groups = [(1 << 18, 520), (1 << 17, 218), (1 << 18, 660), (16, 120)]
    cuda = hbm._open_transient(groups, cuda=True)
    # open_eval's tables: 1,024 B of powers a group; 92 B a column tile
    # (5, 2, 6 and 1 tiles); 4 B a block (tiles x rows / 1,024)
    tables = 4 * 1024 + 92 * (5 + 2 + 6 + 1) + \
        4 * (5 * 256 + 2 * 128 + 6 * 256 + 1)
    # open_reduce's: 312 B a height (3); 64 B and 2,048 B of weight
    # planes a 32-column chunk (17, 7, 21 and 4 chunks); 112 B a chunk
    # and a column for the segments; 16 B of counters
    chunks = 17 + 7 + 21 + 4
    reduce_tables = 312 * 3 + (64 + 2048) * chunks + \
        112 * (chunks + 520 + 218 + 660 + 120) + 16
    assert cuda == 96 * (520 + 218 + 660 + 120) + tables + reduce_tables + \
        32 * ((1 << 18) + (1 << 17) + 16)
    assert hbm._open_transient(groups, cuda=False) > 10 * cuda
    assert hbm._open_transient([], cuda=True) == 0
    shards = _shards(1 << 18, 4)
    cpu = dict(hbm.prove_phases(_MACHINE, shards, "full", "cpu"))
    on_card = dict(hbm.prove_phases(_MACHINE, shards, "full", "cuda"))
    assert on_card["shard0 open"] < cpu["shard0 open"]


def test_cuda_models_the_ntt_kernels_commit():
    """On CUDA the commit holds the NTT kernel's outputs, which the round
    counts, and the group's concat: no int64 column chunk of the LDE,
    which the CPU's model keeps (its plans stay lurk_tpu's). The leaf
    sponge's row block is the same on both."""
    from lurk_tpu_torch.stark import device_prover as dp
    h, w = 1 << 18, 148
    groups = {h: w}
    assert hbm._commit_transient(groups, cuda=True) == max(
        4 * h * w, 32 * min(2 * h * w, dp.LDE_CHUNK_CELLS))
    assert hbm._commit_transient(groups, from_coeffs=True, cuda=True) == \
        32 * min(2 * h * w, dp.LDE_CHUNK_CELLS)
    chunk = h * min(w, max(8, dp.LDE_CHUNK_CELLS // h))
    assert hbm._commit_transient(groups) == 104 * chunk + 4 * h * w
    shards = _shards(1 << 18, 4)
    cpu = dict(hbm.prove_phases(_MACHINE, shards, "full", "cpu"))
    cuda = dict(hbm.prove_phases(_MACHINE, shards, "full", "cuda"))
    assert cuda["shard0 main commit"] < cpu["shard0 main commit"]
