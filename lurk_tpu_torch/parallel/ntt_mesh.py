"""Distributed four-step NTT over the slots of a mesh.

The counterpart of lurk_tpu/parallel/ntt_mesh.py. A length-n
column-batched NTT decomposes as an (N1, N2) matrix of NTTs
(Bailey/four-step): local length-N1 NTTs down the columns, a pointwise
twiddle, local length-N2 NTTs along the rows, and a transposed read-out.
Sharded over the slots, the three data movements are all-to-all
exchanges (lurk_tpu's `jax.lax.all_to_all(..., tiled=True)`, here
explicit copies between the slots' devices); every arithmetic step is
local and runs field/ntt.py's device_ntt on the slot's device.

Bit-exact against field.ntt.ntt on any power-of-two mesh with D^2 <= n.

Derivation (w = w_n, j = j1*N2 + j2, k = k1 + k2*N1):
    X[k1 + k2*N1] = sum_j2 w^(j2*k1) * w_N2^(j2*k2)
                      * [ sum_j1 A[j1,j2] * w_N1^(j1*k1) ]
so: column NTTs (length N1), twiddle by w^(j2*k1), row NTTs (length N2),
and X read out with k1 fast - the final transpose.

The sharded values between the steps are lists of int64 row blocks, one
per slot in slot order; the public functions take a host array or a
tensor and return int32 tensors on the input's device (the first slot's
for a host array).
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np
import torch

from ..field import babybear as bb
from ..field.ntt import GENERATOR, _geom_powers_np, device_ntt, \
    shift_powers_dev
from .mesh import Mesh, _blocks, _gather, _out_device

_CALLS_LOCK = threading.Lock()


@lru_cache(maxsize=None)
def _root_powers(log_n: int, inverse: bool, device: torch.device):
    """[w^0 .. w^(n-1)] canonical int64 on `device` for the length-n root w
    (or its inverse): the twiddle table indexed by (j2*k1) mod n
    (lurk_tpu's _root_powers_mont, in canonical form)."""
    w = bb.two_adic_generator_s(log_n)
    if inverse:
        w = bb.inv_s(w)
    return torch.from_numpy(
        _geom_powers_np(w, 1 << log_n).astype(np.int64)).to(device)


def _split_sizes(log_n: int, n_dev: int):
    """(log_n1, log_n2) with n1*n2 = n, both divisible by n_dev."""
    log_d = n_dev.bit_length() - 1
    if 1 << log_d != n_dev:
        raise ValueError(f"mesh size must be a power of two, got {n_dev}")
    log_n1 = log_n // 2
    log_n2 = log_n - log_n1
    if min(log_n1, log_n2) < log_d:
        raise ValueError(f"four-step mesh NTT needs n >= D^2 (n=2^{log_n}, "
                         f"D={n_dev})")
    return log_n1, log_n2


def _log2_rows(x) -> int:
    n = int(x.shape[0])
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError(f"n must be a power of two, got {n}")
    return log_n


def _all_to_all(blocks, devices, split_axis: int, concat_axis: int):
    """lax.all_to_all(tiled=True) over the slots: slot d receives chunk d
    of every slot's `split_axis`, concatenated along `concat_axis` in
    source-slot order."""
    n = len(devices)
    chunks = [b.tensor_split(n, dim=split_axis) for b in blocks]
    # a copy to the host must be blocking (its bytes are read at once)
    return [torch.cat([chunks[s][d].to(dev, non_blocking=dev.type == "cuda")
                       for s in range(n)], dim=concat_axis)
            for d, dev in enumerate(devices)]


def _ntt_blocks(devices, blocks, log_n: int, inverse: bool):
    """The four-step NTT of the row-sharded (n, width) matrix whose row
    blocks (n/D rows each, slot order) are `blocks`; returns the row blocks
    of the output in natural order, int64. inverse=True composes the
    UNSCALED inverse transforms, as field.ntt.ntt(x, inverse=True) does."""
    n_dev = len(devices)
    log_n1, log_n2 = _split_sizes(log_n, n_dev)
    n, n1, n2 = 1 << log_n, 1 << log_n1, 1 << log_n2
    rows, width = n // n_dev, int(blocks[0].shape[1])
    # view as (n1/D, n2, width): slot d owns j1-rows
    a = [b.reshape(n1 // n_dev, n2, width) for b in blocks]
    # transpose #1: -> (n1, n2/D, width), slot d owns j2-columns
    a = _all_to_all(a, devices, 1, 0)
    for d, dev in enumerate(devices):
        # local column NTTs (length n1 along axis 0)
        col = device_ntt(a[d].reshape(n1, -1), log_n1, inverse)
        # twiddle: B[k1, j2] *= w^(j2*k1); j2 global = d*(n2/D) + local
        k1 = torch.arange(n1, device=dev)[:, None]
        j2 = d * (n2 // n_dev) + torch.arange(n2 // n_dev, device=dev)[None]
        tw = _root_powers(log_n, inverse, dev)[(k1 * j2) & (n - 1)]
        a[d] = col.view(n1, n2 // n_dev, width) * tw[:, :, None] % bb.P
    # transpose #2: -> (n1/D, n2, width), slot d owns k1-rows
    a = _all_to_all(a, devices, 0, 1)
    # local row NTTs (length n2 along axis 1)
    a = [device_ntt(b.transpose(0, 1).reshape(n2, -1), log_n2, inverse)
         .view(n2, n1 // n_dev, width).transpose(0, 1) for b in a]
    # read-out transpose #3: X[k1 + k2*n1] = D[k1, k2]; shard by k2
    a = _all_to_all(a, devices, 1, 0)                       # (n1, n2/D, w)
    return [b.transpose(0, 1).reshape(rows, width) for b in a]   # (n/D, w)


def _intt_blocks(devices, blocks, log_n: int):
    """Evaluations -> coefficients on row blocks: the unscaled inverse
    four-step NTT, then the 1/n scale on every block."""
    n_inv = bb.inv_s((1 << log_n) % bb.P)
    return [b * n_inv % bb.P
            for b in _ntt_blocks(devices, blocks, log_n, True)]


def mesh_ntt(mesh: Mesh, x, inverse: bool = False, axis: str = "shard"):
    """NTT of a row-sharded (n, width) matrix of canonical values, natural
    order, bit-exact against the single-device field.ntt.ntt."""
    devices = mesh.slots(axis)
    log_n = _log2_rows(x)
    out = _ntt_blocks(devices, _blocks(devices, x), log_n, inverse)
    return _gather(out, _out_device(x, devices))


def mesh_intt(mesh: Mesh, x, axis: str = "shard"):
    """Evaluations -> coefficients, sharded (field.ntt.intt's values)."""
    devices = mesh.slots(axis)
    out = _intt_blocks(devices, _blocks(devices, x), _log2_rows(x))
    return _gather(out, _out_device(x, devices))


def mesh_lde(mesh: Mesh, mat, log_blowup: int = 1, axis: str = "shard"):
    """Row-sharded coset LDE: (h, w) trace evaluations -> (coeffs (h, w),
    lde (h << log_blowup, w)), int32 on the input's device.

    The values of the single-device prover's _lde_group (the same INTT,
    1/n scale, shift-powers multiply and forward NTT): the in-prover
    integration point for trace groups whose LDE exceeds one device's
    budget, wired in by stark/device_prover.dcommit under
    LURK_TPU_MESH_COMMIT. `mesh_lde.calls` counts the calls."""
    devices = mesh.slots(axis)
    n_dev = len(devices)
    log_h = _log2_rows(mat)
    width = int(mat.shape[1])
    coeffs = _intt_blocks(devices, _blocks(devices, mat), log_h)
    big_log = log_h + log_blowup
    per = ((1 << log_h) // n_dev) << log_blowup   # padded rows per slot
    padded = []
    for d, dev in enumerate(devices):
        # padded block d holds coefficient blocks d*2^b .. (d+1)*2^b - 1;
        # those past the last slot are the zero padding
        parts = [coeffs[c].to(dev) for c in range(d << log_blowup,
                                                  (d + 1) << log_blowup)
                 if c < n_dev]
        fill = per - sum(int(p.shape[0]) for p in parts)
        if fill:
            parts.append(torch.zeros((fill, width), dtype=bb.I64,
                                     device=dev))
        shift = shift_powers_dev(big_log, GENERATOR, dev)[d * per:
                                                          (d + 1) * per]
        padded.append(torch.cat(parts) * shift[:, None] % bb.P)
    lde = _ntt_blocks(devices, padded, big_log, False)
    with _CALLS_LOCK:
        mesh_lde.calls += 1
    out = _out_device(mat, devices)
    return _gather(coeffs, out), _gather(lde, out)


mesh_lde.calls = 0
