"""Shard-parallel proving over the slots of a mesh.

The counterpart of lurk_tpu/parallel/shard_prover.py. The proof shard is
the scale-out unit: row ranges of the func tables become independent
shard proofs glued by the global LogUp balance. Shard i is proved on slot
i % n:

  * trace commit, LogUp permutation, quotient and FRI of a shard run on
    its slot's device through stark/device_prover.py, which follows the
    device of the tensors it is given;
  * the Fiat-Shamir transcript is the single-device prover's: the commit
    phase observes every shard's roots in shard order, then each shard
    proof forks a challenger copy, so proofs are byte-identical whatever
    the slots (tests/test_torch_parallel.py);
  * the global LogUp balance is also summed over the mesh
    (mesh_cumulative_balance, through parallel/mesh.sharded_logup_sum).

One worker thread per slot walks that slot's shards serially, so device
work overlaps across cards while each slot holds one live shard. Workers
are keyed by slot index, not by device: slots that repeat a device are
separate workers on the same card.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from ..lair.chips import chip_included
from ..lair.execute import Shard


def _on(device: torch.device):
    """Make `device` the worker thread's current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def mesh_prove(machine, pk, queries, challenger, devices: Optional[list] = None,
               shard_config=None):
    """Multi-slot equivalent of StarkMachine.prove(device=True): same
    transcript, same proof object; shard i's traces live on devices[i % n].
    `devices` defaults to make_mesh()'s slots (the CUDA cards, or
    LURK_TPU_MESH_DEVICES) and raises without them. With one slot this is
    the single-device prover on that slot."""
    from ..stark.device_prover import (dcommit, device_prove,
                                       _device_prove_shard)
    from ..stark.machine import MachineProof
    from .mesh import make_mesh

    if devices is None:
        devices = list(make_mesh().devices.flat)
    devices = [torch.device(d) for d in devices]
    if len(devices) == 1:
        return device_prove(machine, pk, queries, challenger, shard_config,
                            device=devices[0])

    shards = Shard(queries, 0, shard_config).shard()
    pv = queries.expect_public_values()

    # one worker per slot, each walking its own shards serially: device
    # memory is bounded by one live shard per slot while work still
    # overlaps across cards
    ids_by_slot = {k: list(range(k, len(shards), len(devices)))
                   for k in range(min(len(devices), len(shards)))}
    # when shards outnumber slots, holding every shard's committed round
    # (mats + LDEs + coeffs + trees) at once scales device memory with the
    # TOTAL trace: drop the rounds after the roots are read and recommit in
    # the open phase
    keep_rounds = len(shards) <= len(devices)

    prep_names: List[str] = []
    if pk.prep_round is not None:
        prep_names = pk.prep_chip_names
        for root in pk.prep_round.roots:
            challenger.observe_many(root)
    challenger.observe_many(pv)

    # commit phase: per-shard trace generation and commit on the shard's
    # slot; roots observed in shard order for the transcript
    committed: List[Optional[tuple]] = [None] * len(shards)

    def commit_slot(k):
        dev = devices[k]
        with _on(dev):
            for i in ids_by_slot[k]:
                shard = shards[i]
                chips = [c for c in machine.chips
                         if chip_included(c, shard)]
                traces_np = [np.asarray(c.generate_trace(shard), np.uint64)
                             for c in chips]
                rnd = dcommit(traces_np, dev)
                roots = rnd.roots
                if not keep_rounds:
                    rnd = None  # free the device buffers
                committed[i] = (chips, traces_np, rnd, roots)

    with ThreadPoolExecutor(max_workers=len(ids_by_slot)) as pool:
        list(pool.map(commit_slot, ids_by_slot))
    for _, _, _, roots in committed:
        for root in roots:
            challenger.observe_many(root)

    # open phase: each fork of the challenger is identical, so shard proofs
    # are independent of scheduling order; each slot's prep commit is built
    # inside its own worker
    shard_proofs: List[Optional[object]] = [None] * len(shards)

    def prove_slot(k):
        dev = devices[k]
        with _on(dev):
            prep_round = None
            if pk.prep_round is not None:
                prep_round = dcommit(pk.prep_round.matrices, dev)
            for i in ids_by_slot[k]:
                chips, traces_np, main_round, roots = committed[i]
                if main_round is None:
                    # recommit (deterministic): one extra commit per shard
                    # buys device memory bounded by a single shard
                    main_round = dcommit(traces_np, dev)
                    assert main_round.roots == roots, \
                        "device main commitment is not deterministic"
                ch = challenger.copy()
                shard_proofs[i] = _device_prove_shard(
                    machine, pk, prep_round, prep_names, shards[i], chips,
                    traces_np, main_round, pv, ch)
                committed[i] = None  # release this shard's buffers

    with ThreadPoolExecutor(max_workers=len(ids_by_slot)) as pool:
        list(pool.map(prove_slot, ids_by_slot))

    return MachineProof(shard_proofs, list(pv))


def mesh_cumulative_balance(mesh, shard_proofs) -> tuple:
    """Global LogUp balance across shards summed over the mesh: returns the
    (4,) extension sum (0 for a sound proof). The host verifier performs
    the same check; this is the collective form."""
    from .mesh import sharded_logup_sum

    cums = [np.asarray(cp.cumulative_sum, np.uint32)
            for sp in shard_proofs for cp in sp.chip_proofs]
    n = len(cums)
    n_dev = mesh.devices.size
    pad = (-n) % n_dev
    block = np.zeros((n + pad, 4), np.uint32)
    if n:
        block[:n] = np.stack(cums)
    total = sharded_logup_sum(mesh, block)
    return tuple(int(x) for x in total.cpu())
