"""Batched Poseidon2 permutation in plain PyTorch.

The plain version of the CUDA kernel (poseidon/cuda_kernel.py): the CPU
path of every device hash and the oracle the kernel is held against on
the card. Layout: state is a (width, batch) int32 tensor in Montgomery
form, as lurk_tpu.poseidon.perm.permute_mont takes it.

The permutation of a Montgomery state is the Montgomery form of the
permutation of the canonical state (every step is an exact field
operation), so this version converts once at entry and exit and runs the
rounds on canonical int64 values, reducing after every product.

Semantics match lurk_tpu.poseidon.ref (and therefore the reference's
src/poseidon/wide/trace.rs:12-82) bit-exactly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..field import babybear as bb
from .constants import get_config

P = bb.P


def _external_layer(st: torch.Tensor) -> torch.Tensor:
    """Blockwise M4 + block-column sums on a (width, batch) int64 state of
    canonical values: adds only, one reduction at the end (the largest
    intermediate is below 2^40)."""
    w = st.shape[0]
    v = st.view(w // 4, 4, -1)
    x0, x1, x2, x3 = v[:, 0], v[:, 1], v[:, 2], v[:, 3]
    t01 = x0 + x1
    t23 = x2 + x3
    t0123 = t01 + t23
    t01123 = t0123 + x1
    t01233 = t0123 + x3
    blocks = torch.stack([t01123 + t01, t01123 + 2 * x2,
                          t01233 + t23, t01233 + 2 * x0], dim=1)
    blocks = blocks + blocks.sum(dim=0, keepdim=True)
    return (blocks % P).view(w, -1)


def _pow7(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x % P
    x3 = x2 * x % P
    return x3 * x3 % P * x % P


@lru_cache(maxsize=None)
def _tables(width: int, device: torch.device):
    """Canonical int64 (full_rc (r_f, w), part_rc (r_p,), diag (w,))."""
    cfg = get_config(width)
    return tuple(bb.upload(np.asarray(a, np.int64), device)
                 for a in (cfg.full_rc, cfg.part_rc, cfg.diag))


def permute_canonical(st: torch.Tensor) -> torch.Tensor:
    """Permute a canonical (width, batch) state; int64 out."""
    width = st.shape[0]
    cfg = get_config(width)
    full, part, diag = _tables(width, st.device)
    st = _external_layer(st.to(bb.I64))

    def full_round(st, r):
        return _external_layer(_pow7((st + full[r][:, None]) % P))

    for r in range(cfg.r_f // 2):
        st = full_round(st, r)
    for r in range(cfg.r_p):
        x0 = _pow7((st[0] + part[r]) % P)
        st = torch.cat([x0[None], st[1:]], dim=0)
        s = st.sum(dim=0) % P          # width * (p-1) < 2^37
        st = (st * diag[:, None] + s[None, :]) % P
    for r in range(cfg.r_f // 2, cfg.r_f):
        st = full_round(st, r)
    return st


def permute_mont(state_wb: torch.Tensor) -> torch.Tensor:
    """Permute Montgomery-form (width, batch) int32 state."""
    return bb.to_mont(permute_canonical(bb.from_mont(state_wb)))


def permute(states: torch.Tensor) -> torch.Tensor:
    """Permute canonical (batch, width) states; canonical int32 out."""
    return permute_canonical(states.T).T.contiguous().to(bb.I32)


def hash_n(inputs: torch.Tensor, width: int) -> torch.Tensor:
    """(batch, width) canonical felts -> (batch, 8) digests."""
    assert inputs.shape[1] == width
    return permute(inputs)[:, :8]
