"""lurk_tpu_torch/parallel against lurk_tpu/parallel on the CPU.

The port's mesh is a list of device slots; here every slot is the CPU,
and lurk_tpu runs on conftest's 8 virtual CPU devices. The mesh blocks
(sharded permutation, leaf hash, LogUp sum, commit step) and the
four-step mesh NTT must equal lurk_tpu's exactly over 2, 4 and 8 slots;
mesh_prove over 2 slots and over 3 must give lurk_tpu's host proof bytes
with a zero balance; the mesh commit inside the device prover (every
group through mesh_lde over 8 slots) must give lurk_tpu's host proof
bytes.

Each proof costs tens of CPU-seconds, so this file holds two proof tests
(pytest-xdist's file scheduler starts files with the most tests first).
"""

import functools
import sys

import numpy as np
import pytest
import torch

from lurk_tpu.field.babybear import P
from lurk_tpu.parallel import mesh as jmesh
from lurk_tpu.parallel import ntt_mesh as jntt_mesh
from lurk_tpu.stark.challenger import Challenger as JChallenger
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu.utils import codec as jcodec
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.lair.execute import ShardingConfig
from lurk_tpu_torch.parallel import mesh as pmesh
from lurk_tpu_torch.parallel import ntt_mesh
from lurk_tpu_torch.parallel.shard_prover import (mesh_cumulative_balance,
                                                  mesh_prove)
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.device_prover import _lde_group
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.utils import codec

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

CPU = torch.device("cpu")
CASES = [(log_n, width, d) for log_n, width in ((10, 3), (8, 1), (12, 2))
         for d in (2, 4, 8) if (1 << log_n) >= d * d]


def _meshes(d: int):
    return jmesh.make_mesh(d), pmesh.Mesh([CPU] * d, ("shard",))


def _rand(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, P, size=shape,
                                                dtype=np.uint32)


@pytest.mark.parametrize("log_n,width,d", CASES)
def test_mesh_ntt_matches_lurk_tpu(log_n, width, d):
    jm, m = _meshes(d)
    x = _rand(100 * log_n + d, (1 << log_n, width))
    fwd = ntt_mesh.mesh_ntt(m, x)
    assert np.array_equal(bb.to_numpy(fwd),
                          np.asarray(jntt_mesh.mesh_ntt(jm, x)))
    inv = ntt_mesh.mesh_intt(m, x)
    assert np.array_equal(bb.to_numpy(inv),
                          np.asarray(jntt_mesh.mesh_intt(jm, x)))
    assert np.array_equal(bb.to_numpy(ntt_mesh.mesh_intt(m, fwd)), x)
    # mesh_lde == the single-device prover's _lde_group (held against
    # lurk_tpu's LDE by the prover tests)
    cfs, lde = ntt_mesh.mesh_lde(m, x)
    want = _lde_group([bb.from_numpy(x, CPU)], log_n)
    assert torch.equal(cfs, want[0]) and torch.equal(lde, want[1])


@pytest.mark.parametrize("log_n,width,d", CASES)
def test_mesh_blocks_match_lurk_tpu(log_n, width, d):
    jm, m = _meshes(d)
    rows = 1 << log_n
    states = _rand(log_n + d, (rows, 16))
    assert np.array_equal(bb.to_numpy(pmesh.sharded_permute(m, states)),
                          np.asarray(jmesh.sharded_permute(jm, states)))
    mat = _rand(2 * log_n + d, (rows, width))
    assert np.array_equal(bb.to_numpy(pmesh.sharded_leaf_hash(m, mat)),
                          np.asarray(jmesh.sharded_leaf_hash(jm, mat)))
    phi = _rand(3 * log_n + d, (rows, 4))
    got = pmesh.sharded_logup_sum(m, phi)
    assert np.array_equal(bb.to_numpy(got),
                          np.asarray(jmesh.sharded_logup_sum(jm, phi)))
    assert np.array_equal(bb.to_numpy(got),
                          phi.astype(np.uint64).sum(axis=0) % np.uint64(P))
    digests, total = pmesh.sharded_commit_step(m, mat)
    jdigests, jtotal = jmesh.sharded_commit_step(jm, mat)
    assert np.array_equal(bb.to_numpy(digests), np.asarray(jdigests))
    assert np.array_equal(bb.to_numpy(total), np.asarray(jtotal))
    # a tensor input keeps its device; the mesh only lends its slots
    t = bb.from_numpy(mat, CPU)
    assert torch.equal(pmesh.sharded_leaf_hash(m, t), digests)


def test_mesh_slots_and_env(monkeypatch):
    """LURK_TPU_MESH_DEVICES names a default mesh's slots; a slot may
    repeat a device; a 2-D mesh lends the slots of one axis."""
    monkeypatch.setenv(pmesh.ENV_DEVICES, "cpu,cpu,cpu")
    m = pmesh.make_mesh()
    assert m.devices.size == 3 and m.devices.shape == (3,)
    assert m.axis_names == ("shard",)
    assert pmesh.make_mesh(2).slots("shard") == [CPU, CPU]
    grid = pmesh.Mesh([[CPU] * 4] * 2, ("host", "shard"))
    assert grid.devices.shape == (2, 4)
    assert len(grid.slots("shard")) == 4 and len(grid.slots("host")) == 2
    with pytest.raises(ValueError, match="power of two"):
        ntt_mesh.mesh_ntt(m, _rand(0, (64, 1)))
    with pytest.raises(ValueError, match="n >= D"):
        ntt_mesh.mesh_ntt(pmesh.Mesh([CPU] * 8, ("shard",)),
                          _rand(0, (32, 1)))


def test_mesh_lde_threads():
    """mesh_prove's workers may call mesh_lde at once: with more threads
    than cores and a short switch interval every result is right and the
    call count loses no update."""
    from concurrent.futures import ThreadPoolExecutor
    m = pmesh.Mesh([CPU] * 2, ("shard",))
    x = _rand(7, (16, 2))
    want = _lde_group([bb.from_numpy(x, CPU)], 4)
    calls = ntt_mesh.mesh_lde.calls
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            outs = list(pool.map(lambda _: ntt_mesh.mesh_lde(m, x),
                                 range(64), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert all(torch.equal(c, want[0]) and torch.equal(l, want[1])
               for c, l in outs)
    assert ntt_mesh.mesh_lde.calls - calls == 64


@functools.lru_cache(maxsize=None)
def _lurk_tpu_host_proof(kind: str) -> bytes:
    """lurk_tpu's host proof bytes of Ackermann(2, 7) at ShardingConfig(16),
    FriConfig(1, 2, 1), or of demo fib(200) at FriConfig(1, 4, 1)
    (tests/test_torch_multihost.py uses the first too)."""
    from lurk_tpu.lair.chips import build_lair_chip_vector
    from lurk_tpu.lair.demo import demo_toplevel
    from lurk_tpu.lair.execute import QueryRecord, ShardingConfig as JSC
    from lurk_tpu.lair.execute import execute_by_name
    from lurk_tpu.lair.toplevel import Toplevel
    from lurk_tpu.lair.trace import FuncChip
    from lurk_tpu.stark.machine import StarkMachine
    from tests.test_lair_air import _ackermann_func
    if kind == "ackermann":
        tl = Toplevel([_ackermann_func()])
        entry, args, config, cfg = "ackermann", [2, 7], JFriConfig(1, 2, 1), \
            JSC(16)
    else:
        tl = demo_toplevel()
        entry, args, config, cfg = "fib", [200], JFriConfig(1, 4, 1), None
    q = QueryRecord(tl)
    execute_by_name(tl, entry, args, q)
    machine = StarkMachine(build_lair_chip_vector(FuncChip.from_name(entry,
                                                                     tl)),
                           len(q.expect_public_values()), config)
    pk, _ = machine.setup()
    return jcodec.encode(machine.prove(pk, q, JChallenger(), shard_config=cfg,
                                       device=False))


def test_mesh_prove_matches_lurk_tpu():
    """Shard i on slot i % n: over 2 slots (3 shards, so the rounds are
    recommitted) and over 3 (one shard each, rounds kept) the proof is
    lurk_tpu's host proof, verifies, and the balance over the mesh is
    zero. (lurk_tpu's test reorders 3 of its virtual devices; the cpu
    slots here are one device, so the slot count is what varies.)"""
    machine, q = golden.ackermann_machine(2, 7, FriConfig(1, 2, 1))
    pk, vk = machine.setup()
    for n_slots in (2, 3):
        proof = mesh_prove(machine, pk, q, Challenger(),
                           devices=[CPU] * n_slots,
                           shard_config=ShardingConfig(16))
        assert len(proof.shard_proofs) == 3
        assert codec.encode(proof) == _lurk_tpu_host_proof("ackermann"), \
            n_slots
        assert machine.verify(vk, proof, Challenger())
        mesh = pmesh.Mesh([CPU] * n_slots, ("shard",))
        assert mesh_cumulative_balance(mesh, proof.shard_proofs) == \
            (0, 0, 0, 0)


def test_mesh_commit_in_prover_matches_lurk_tpu(monkeypatch):
    """LURK_TPU_MESH_COMMIT with a budget of 64 cells over 8 slots routes
    every group of at least 64 rows through mesh_lde inside dcommit; the
    proof is lurk_tpu's host proof."""
    from lurk_tpu_torch.stark.device_prover import device_prove
    monkeypatch.setenv(pmesh.ENV_DEVICES, ",".join(["cpu"] * 8))
    monkeypatch.setenv("LURK_TPU_MESH_COMMIT", "1")
    monkeypatch.setenv("LURK_TPU_MESH_COMMIT_CELLS", "64")
    machine, q = golden.fib_machine(200, FriConfig(1, 4, 1))
    pk, vk = machine.setup()
    calls = ntt_mesh.mesh_lde.calls
    proof = device_prove(machine, pk, q, Challenger(), device="cpu")
    # the fib chip (256 rows) and the bytes chip in each of the prep,
    # main, perm and quotient rounds
    assert ntt_mesh.mesh_lde.calls - calls >= 4
    assert codec.encode(proof) == _lurk_tpu_host_proof("fib200")
    assert machine.verify(vk, proof, Challenger())
