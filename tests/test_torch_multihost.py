"""lurk_tpu_torch/parallel/multihost.py in two real processes.

Mirrors tests/test_multihost.py: two Python processes join one
torch.distributed group over gloo through `multihost.initialize`, each
with 4 CPU slots (LURK_TPU_MESH_DEVICES). The workers import torch and
the port only, never jax. One test runs the collectives (the mesh
builders, the cross-process LogUp sum, equal challenger transcripts);
the other proves Ackermann(2, 7) in 3 shards with `multihost_prove(...,
device="cpu")`, each process proving its own shards, and both processes'
proof bytes must equal lurk_tpu's single-process host proof, computed
here.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tests.test_torch_parallel import _lurk_tpu_host_proof

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

HEADER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
os.environ["LURK_TPU_MESH_DEVICES"] = "cpu,cpu,cpu,cpu"

import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)

from lurk_tpu_torch.parallel import multihost as mh
mh.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
              process_id=pid)
assert dist.get_world_size() == nproc and dist.get_rank() == pid
"""

FOOTER = r"""
assert "jax" not in sys.modules
dist.destroy_process_group()
print(f"MULTIHOST-OK {pid}", flush=True)
"""

COLLECTIVES_WORKER = HEADER + r"""
from lurk_tpu_torch.field.babybear import P
from lurk_tpu_torch.parallel import mesh as pmesh
from lurk_tpu_torch.stark.challenger import Challenger

# mesh builders over the slots of both processes
assert mh.flat_mesh().devices.size == nproc * 4
grid = mh.host_chip_mesh()
assert grid.devices.shape == (nproc, 4)
assert grid.axis_names == ("host", "shard")

# cross-process LogUp balance: every process holds the same seeded rows
# (the oracle), sums its own quarter over its 4 slots, and the partial
# sums are gathered over gloo
rows = 16 * nproc * 4
phi = np.random.default_rng(42).integers(0, P, size=(rows, 4),
                                         dtype=np.uint32)
local = phi[pid * rows // nproc:(pid + 1) * rows // nproc]
part = pmesh.sharded_logup_sum(pmesh.make_mesh(), local)
parts = mh.process_allgather(part.numpy().astype(np.int64))
assert parts.shape == (nproc, 4)
total = parts.sum(axis=0) % P
oracle = phi.astype(np.int64).sum(axis=0) % P
assert np.array_equal(total, oracle), (total, oracle)

# transcript determinism across processes: absorbing the same sequence
# gives the same challenges in every process
ch = Challenger()
ch.observe_many([int(x) for x in total])
ch.observe_many([1, 2, 3, 4, 5, 6, 7, 8])
samples = np.array(ch.sample_ext(), np.int64)
gathered = mh.process_allgather(samples)
assert (gathered == gathered[0]).all(), gathered
""" + FOOTER

PROVE_WORKER = HEADER + r"""
from lurk_tpu_torch.lair.execute import ShardingConfig
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.utils import codec

machine, q = golden.ackermann_machine(2, 7, FriConfig(1, 2, 1))
pk, vk = machine.setup()
# each process proves its own shards; roots and proofs ride gloo; both
# return the complete MachineProof
proof = mh.multihost_prove(machine, pk, q, Challenger(),
                           shard_config=ShardingConfig(16), device="cpu")
assert len(proof.shard_proofs) > nproc, len(proof.shard_proofs)
assert machine.verify(vk, proof, Challenger())
with open(f"proof{pid}.bin", "wb") as f:
    f.write(codec.encode(proof))
""" + FOOTER


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two_process(tmp_path, script: str, timeout: float):
    worker = tmp_path / "worker.py"
    worker.write_text(script)
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "LURK_TPU_MESH_DEVICES")}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=str(tmp_path))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("multi-process workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"MULTIHOST-OK {i}" in out, out


def test_two_process_collectives(tmp_path):
    _run_two_process(tmp_path, COLLECTIVES_WORKER, timeout=120)


def test_two_process_multihost_prove_matches_lurk_tpu(tmp_path):
    """Two processes split a 3-shard proof (shard i on process i % 2),
    exchange only roots and encoded shard proofs, and both return
    lurk_tpu's single-process host proof, byte for byte."""
    _run_two_process(tmp_path, PROVE_WORKER, timeout=300)
    want = _lurk_tpu_host_proof("ackermann")
    for pid in range(2):
        assert (tmp_path / f"proof{pid}.bin").read_bytes() == want, pid
