"""Multi-process proving over torch.distributed.

The counterpart of lurk_tpu/parallel/multihost.py. Processes join one
process group over gloo (`initialize`); each proves its own proof shards
on its own device, and the only traffic between them is host data:

  * the main-trace Merkle roots of every shard, gathered so that every
    process absorbs the same transcript in shard order;
  * optionally the codec-encoded shard proofs, so that every process
    returns the same complete MachineProof.

That is what lurk_tpu's multihost_prove exchanges through
`multihost_utils.process_allgather`; here `process_allgather` is
`dist.all_gather` of CPU tensors (int64 roots and lengths, uint8 proof
bytes), so processes that share one card work as well as processes on
several cards or hosts.

Placement: proof shards are the coarse unit, shard i on process
i % world_size. Within a process, rows and batches go over the slots of
a mesh (parallel/mesh.py, parallel/ntt_mesh.py); a mesh's slots belong to
one process, and `flat_mesh` / `host_chip_mesh` describe the slots of all
processes in rank order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Join the process group over gloo. `coordinator_address` is
    "host:port" (or a torch init method URL); with no arguments torch's
    env:// variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK) name
    the group."""
    init_method = "env://"
    if coordinator_address is not None:
        init_method = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
    dist.init_process_group(
        "gloo", init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def _world() -> tuple:
    """(process count, this process's rank); (1, 0) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def host_chip_mesh(host_axis: str = "host",
                   chip_axis: str = "shard") -> Mesh:
    """(processes, slots per process) mesh: the host axis carries proof
    shards, the chip axis row and batch sharding. Every process is taken
    to have this process's slots (make_mesh's)."""
    local = list(make_mesh().devices.flat)
    return Mesh([local] * _world()[0], (host_axis, chip_axis))


def flat_mesh(axis: str = "shard") -> Mesh:
    """One flat axis over the slots of every process, in rank order."""
    local = list(make_mesh().devices.flat)
    return Mesh(local * _world()[0], (axis,))


def process_allgather(arr: np.ndarray) -> np.ndarray:
    """(processes, *arr.shape): every process's `arr` in rank order (the
    counterpart of multihost_utils.process_allgather; int64 or uint8,
    which gloo gathers)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(_world()[0])]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _process_device(device):
    """multihost_prove's `device` as StarkMachine.prove reads it: False is
    the host prover (None here); None or True this process's card,
    cuda:{rank % cards}, raising without one; anything else names the
    device the device prover runs on."""
    if device is False:
        return None
    if device is None or device is True:
        if not torch.cuda.is_available():
            raise RuntimeError("multihost_prove needs a CUDA device; pass "
                               "device='cpu' or device=False to prove on "
                               "the CPU")
        return torch.device("cuda", _world()[1] % torch.cuda.device_count())
    return torch.device(device)


def multihost_prove(machine, pk, queries, challenger, shard_config=None,
                    gather: bool = True, device=None):
    """Multi-process proving: process p proves shards p, p+P, p+2P, ...
    (P = process count). Every process holds the same QueryRecord
    (deterministic interpreter output), so the only traffic is

      1. the main-trace Merkle ROOTS of every shard (gathered so that
         every process absorbs the identical transcript in shard order),
         and
      2. optionally (`gather=True`) the codec-encoded shard proofs, so
         every process returns the same complete MachineProof.

    Proofs are byte-identical to StarkMachine.prove in one process: the
    transcript absorbs prep roots, public values, then every shard's main
    roots in shard order (tests/test_torch_multihost.py runs two
    processes against lurk_tpu's single-process proof). `device` reads
    as in StarkMachine.prove: None or True is this process's card, False
    the host prover, a name or torch.device the device prover there.
    """
    from ..lair.chips import chip_included
    from ..lair.execute import Shard
    from ..stark import pcs
    from ..stark.machine import MachineProof
    from ..utils import codec

    dev = _process_device(device)
    nproc, pid = _world()
    if nproc == 1:
        return machine.prove(pk, queries, challenger,
                             shard_config=shard_config,
                             device=False if dev is None else dev)

    shards = Shard(queries, 0, shard_config).shard()
    pv = queries.expect_public_values()
    own = [i for i in range(len(shards)) if i % nproc == pid]
    max_own = (len(shards) + nproc - 1) // nproc
    n_chips = len(machine.chips)

    prep_round_dev = None
    if pk.prep_round is not None:
        for root in pk.prep_round.roots:
            challenger.observe_many(root)
    challenger.observe_many(pv)

    # commit the shards this process owns
    if dev is not None:
        from ..stark.device_prover import dcommit
    committed = {}
    for i in own:
        shard = shards[i]
        chips = [c for c in machine.chips if chip_included(c, shard)]
        traces = [np.asarray(c.generate_trace(shard), np.uint64)
                  for c in chips]
        rnd = dcommit(traces, dev) if dev is not None else pcs.commit(traces)
        committed[i] = (chips, traces, rnd)

    # exchange roots: fixed-shape padded allgather (roots are one
    # (8,)-digest per height group, <= one per chip - bytes, not matrices)
    counts = np.zeros(max_own, np.int64)
    flat = np.zeros(max_own * n_chips * 8, np.int64)
    off = 0
    for slot, i in enumerate(own):
        roots = committed[i][2].roots
        counts[slot] = len(roots)
        for root in roots:
            flat[off:off + 8] = np.asarray(root, np.int64)
            off += 8
    all_counts = process_allgather(counts)
    all_flat = process_allgather(flat)

    # absorb every shard's roots in global shard order (identical
    # challenger state in every process)
    offs = [0] * nproc
    for i in range(len(shards)):
        p = i % nproc
        for _ in range(int(all_counts[p][i // nproc])):
            o = offs[p]
            challenger.observe_many(
                tuple(int(x) for x in all_flat[p][o:o + 8]))
            offs[p] = o + 8

    # prove the owned shards from identical challenger forks
    if dev is not None:
        from ..stark.device_prover import _device_prove_shard
        prep_names = []
        if pk.prep_round is not None:
            prep_round_dev = dcommit(pk.prep_round.matrices, dev)
            prep_names = pk.prep_chip_names
    local = {}
    for i in own:
        chips, traces, rnd = committed[i]
        ch = challenger.copy()
        if dev is not None:
            local[i] = _device_prove_shard(
                machine, pk, prep_round_dev, prep_names, shards[i],
                chips, traces, rnd, pv, ch)
        else:
            local[i] = machine._prove_shard(pk, shards[i], chips, traces,
                                            rnd, pv, ch)
        committed[i] = None  # free this shard's round

    if not gather:
        return local

    # gather encoded shard proofs so that every process assembles the full
    # MachineProof (padded-bytes allgather; lengths first)
    blobs = [codec.encode(local[i]) for i in own]
    lens = np.zeros(max_own, np.int64)
    for slot, b in enumerate(blobs):
        lens[slot] = len(b)
    all_lens = process_allgather(lens)
    maxlen = int(all_lens.max()) if len(shards) else 0
    buf = np.zeros((max_own, max(maxlen, 1)), np.uint8)
    for slot, b in enumerate(blobs):
        buf[slot, :len(b)] = np.frombuffer(b, np.uint8)
    all_bufs = process_allgather(buf)

    sps = []
    for i in range(len(shards)):
        p, slot = i % nproc, i // nproc
        n = int(all_lens[p][slot])
        sps.append(codec.decode(bytes(all_bufs[p][slot][:n])))
    return MachineProof(sps, list(pv))
