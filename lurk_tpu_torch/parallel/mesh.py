"""Multi-device sharding layouts for the prover, on torch devices.

The counterpart of lurk_tpu/parallel/mesh.py. A mesh is an ordered 1-D or
2-D array of device slots with axis names. A slot may repeat a device:
several slots on one card run every line of the mesh code, as lurk_tpu's
tests do with virtual CPU devices. The mapping:

  * trace rows / Poseidon lanes  -> one row block per slot, in slot order
  * LogUp running sums           -> exact sums mod p, added over the slots
  * Merkle leaf digests          -> gathered in slot order
  * proof shards                 -> one worker per slot
                                    (parallel/shard_prover.py)

Each row block runs on its slot's device through poseidon/cuda_kernel.py
and stark/hasher.py, so through the CUDA kernel on a card, and the
results are gathered in slot order onto the input's device (the first
slot's for a host array). The slots of a mesh belong to this process; the
traffic between processes is parallel/multihost.py's.

lurk_tpu splits its cross-device sums into 16-bit halves and adds them in
a pairwise tree (`_psum_mod`, `_modsum_axis0`) because the TPU has no
64-bit datapath; here the sums accumulate in int64, as
stark/device_prover.mod_tree_sum does, which gives the same sum mod p.

LURK_TPU_MESH_DEVICES, a comma list such as `cuda:0,cuda:0,cuda:0,cuda:0`,
names the slots of a default mesh (make_mesh) in place of one slot per
CUDA card: the counterpart of XLA's
--xla_force_host_platform_device_count.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..field import babybear as bb
from ..poseidon.cuda_kernel import permute_cuda
from ..stark import hasher
from ..stark.device_prover import mod_tree_sum

ENV_DEVICES = "LURK_TPU_MESH_DEVICES"


class Mesh:
    """An ordered array of torch.device slots with one name per axis.
    `devices` is a numpy object array, so `.size` and `.shape` read as on
    a jax Mesh."""

    def __init__(self, devices, axis_names):
        flat = [torch.device(d) for d in np.asarray(devices, object).flat]
        self.devices = np.empty(len(flat), object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(np.shape(devices))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names) or not flat:
            raise ValueError(f"a mesh of shape {self.devices.shape} needs one "
                             f"name per axis, got {self.axis_names}")

    def slots(self, axis: str) -> List[torch.device]:
        """The slots along `axis`, in order (on a 2-D mesh, those at index
        0 of the other axis: the rest are replicas)."""
        i = self.axis_names.index(axis)
        grid = np.moveaxis(self.devices, i, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])


def mesh_devices() -> List[torch.device]:
    """The slots a default mesh takes: LURK_TPU_MESH_DEVICES when it is
    set, else one per CUDA card (none without CUDA)."""
    names = os.environ.get(ENV_DEVICES, "").strip()
    if names:
        return [torch.device(s.strip()) for s in names.split(",")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """A 1-D mesh over the CUDA cards (the first n_devices of them), or
    over the slots LURK_TPU_MESH_DEVICES names. Raises without either:
    there is no CPU fallback."""
    devs = mesh_devices()
    if not devs:
        raise RuntimeError(f"a mesh needs a CUDA device; set {ENV_DEVICES} "
                           "(for example cpu,cpu) to name its slots")
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def _blocks(devices, x) -> list:
    """Row blocks of x (a host array or a tensor of canonical values), one
    per slot in slot order, each as int32 on its slot's device."""
    if isinstance(x, torch.Tensor):
        return [b.to(device=d, dtype=bb.I32)
                for b, d in zip(x.tensor_split(len(devices)), devices)]
    return [bb.from_numpy(b, d)
            for b, d in zip(np.array_split(np.asarray(x), len(devices)),
                            devices)]


def _out_device(x, devices) -> torch.device:
    """Results go to the input tensor's device, or the first slot's."""
    return x.device if isinstance(x, torch.Tensor) else devices[0]


def _gather(blocks, device) -> torch.Tensor:
    """Concatenate per-slot row blocks in slot order on `device`, int32."""
    return torch.cat([b.to(device=device, dtype=bb.I32) for b in blocks])


def _sum_over_slots(partials, device) -> torch.Tensor:
    """Exact sum mod p of per-slot partial sums, int32 on `device`."""
    return mod_tree_sum(torch.stack([p.to(device) for p in partials]), dim=0)


def sharded_permute(mesh: Mesh, states, axis: str = "shard"):
    """Batch-parallel Poseidon2 permutation: canonical (batch, width)
    states, rows split over the slots."""
    devices = mesh.slots(axis)
    outs = [permute_cuda(b) for b in _blocks(devices, states)]
    return _gather(outs, _out_device(states, devices))


def sharded_leaf_hash(mesh: Mesh, mat, axis: str = "shard"):
    """Row-sharded Merkle leaf hashing: (rows, w) -> (rows, 8) digests."""
    devices = mesh.slots(axis)
    outs = [hasher.hash_rows(b) for b in _blocks(devices, mat)]
    return _gather(outs, _out_device(mat, devices))


def sharded_logup_sum(mesh: Mesh, phi_blocks, axis: str = "shard"):
    """Global LogUp cumulative sum: per-slot partial sums mod p, added over
    the slots. phi_blocks: (rows, 4) base-flattened extension
    contributions. Returns the (4,) sum."""
    devices = mesh.slots(axis)
    partials = [mod_tree_sum(b, dim=0) for b in _blocks(devices, phi_blocks)]
    return _sum_over_slots(partials, _out_device(phi_blocks, devices))


def sharded_commit_step(mesh: Mesh, trace, axis: str = "shard"):
    """One multi-slot 'prover step' over a row-sharded trace: Poseidon2
    leaf hashing of the rows and a LogUp-style sum mod p of the digests'
    first 4 lanes. Returns (digests (rows, 8), sum (4,))."""
    devices = mesh.slots(axis)
    digests = [hasher.hash_rows(b) for b in _blocks(devices, trace)]
    out = _out_device(trace, devices)
    partials = [mod_tree_sum(d[:, :4], dim=0) for d in digests]
    return _gather(digests, out), _sum_over_slots(partials, out)
