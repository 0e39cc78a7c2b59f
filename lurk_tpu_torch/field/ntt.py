"""Radix-2 NTT / coset LDE over BabyBear, column-batched.

The counterpart of lurk_tpu/field/ntt.py:
  * Operates on (n, width) matrices, butterflies along axis 0, all columns
    in parallel.
  * Natural-order domains everywhere: the trace domain is g^i in row order;
    the LDE domain is shift*k^j in row order. FRI folding pairs rows
    (i, i + N/2) since x_{i+N/2} = -x_i in natural order - no bit-reversal
    permutations in the data layout (DEVIATIONS.md section 2). The NTT
    itself permutes its input into bit-reversed order internally and
    emits natural order.

Routing goes by the argument: a numpy array takes the host path (numpy,
or cpp/liblair.so when it loads); a torch tensor takes the torch path on
the tensor's own device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import babybear as bb

GENERATOR = bb.GENERATOR  # coset shift for LDEs (p3 convention: F::generator())


@lru_cache(maxsize=None)
def _stage_twiddles(log_n: int, inverse: bool):
    """Tuple of per-stage Montgomery-form twiddle arrays for a DIT NTT.

    Stage s (s = 0..log_n-1) has half-block size m = 2^s and uses twiddles
    w^(j * n/(2m)) for j in 0..m.
    """
    n = 1 << log_n
    w = bb.two_adic_generator_s(log_n)
    if inverse:
        w = bb.inv_s(w)
    half = n // 2
    tw = _geom_powers_np(w, max(half, 1))
    stages = []
    for s in range(log_n):
        m = 1 << s
        step = n // (2 * m)
        stages.append(bb.np_to_mont(tw[: half : step][:m].copy()))
    return tuple(stages)


_PP = np.uint64(bb.P)


def _geom_powers_np(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] canonical uint32, vectorized doubling."""
    pw = np.empty(n, np.uint64)
    pw[0] = 1
    k = 1
    while k < n:
        m = min(k, n - k)
        pw[k:k + m] = (pw[:m] * pw[k - 1] % _PP) * np.uint64(base) % _PP
        k += k
    return pw.astype(np.uint32)


@lru_cache(maxsize=None)
def _bitrev_perm(log_n: int):
    n = 1 << log_n
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# torch path
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _torch_tables(log_n: int, inverse: bool, device: torch.device):
    """(bit-reversal index, per-stage canonical int64 twiddles) on device."""
    rev = bb.upload(_bitrev_perm(log_n), device)
    stages = tuple(bb.upload(bb.np_from_mont(t).astype(np.int64), device)
                   for t in _stage_twiddles(log_n, inverse))
    return rev, stages


def device_ntt(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """Column-batched NTT of a (2^log_n, w) tensor of canonical values;
    natural order in and out. Returns int64 canonical values (the callers
    chain more int64 arithmetic). A CUDA tensor takes the hand-written
    kernel (field/ntt_kernel.py::ntt_cuda, up to the field's 2^27 points);
    a CPU tensor the eager stages of device_ntt_plain."""
    if x.device.type == "cuda":
        from . import ntt_kernel
        return ntt_kernel.ntt_cuda(x.to(bb.I32).contiguous(), log_n,
                                   inverse).to(bb.I64)
    return device_ntt_plain(x, log_n, inverse)


def device_ntt_plain(x: torch.Tensor, log_n: int,
                     inverse: bool) -> torch.Tensor:
    """The eager radix-2 DIT stages over the whole int64 matrix: a
    bit-reversal gather, then per stage a strided product, its reduction,
    the sums and differences and their fix-ups. int64 canonical out."""
    if log_n == 0:
        return x.to(bb.I64)
    n = 1 << log_n
    rev, stages = _torch_tables(log_n, inverse, x.device)
    x = x.to(bb.I64).index_select(0, rev)
    w = x.shape[1]
    for s in range(log_n):
        m = 1 << s
        blocks = x.view(n // (2 * m), 2, m, w)
        a = blocks[:, 0]
        tb = blocks[:, 1] * stages[s].view(1, m, 1) % bb.P
        hi = a + tb
        lo = a - tb
        x = torch.stack([torch.where(hi >= bb.P, hi - bb.P, hi),
                         torch.where(lo < 0, lo + bb.P, lo)],
                        dim=1).view(n, w)
    return x


# ---------------------------------------------------------------------------
# host path and routing
# ---------------------------------------------------------------------------

_HOST_PIN = 0


class host_compute:
    """Context manager pinning NTT/LDE/hashing of host arrays to the
    host-native path (numpy / cpp/liblair.so). Host (numpy) arrays always
    take that path in this package, so the pin only records intent for
    callers shared with lurk_tpu; torch tensors stay on their device
    either way, as jnp arrays do in lurk_tpu. Re-entrant."""

    def __enter__(self):
        global _HOST_PIN
        _HOST_PIN += 1
        return self

    def __exit__(self, *exc):
        global _HOST_PIN
        _HOST_PIN -= 1
        return False


@lru_cache(maxsize=None)
def _flat_twiddles(log_n: int, inverse: bool) -> np.ndarray:
    """Concatenated canonical per-stage twiddle tables (native NTT input)."""
    return np.concatenate(
        [bb.np_from_mont(t) for t in _stage_twiddles(log_n, inverse)]) \
        if log_n else np.zeros(0, np.uint32)


def _ntt_np(mat: np.ndarray, inverse: bool, log_n: int) -> np.ndarray:
    n = 1 << log_n
    from ..lair import native
    if native.native_available():
        try:
            x = np.ascontiguousarray(mat[_bitrev_perm(log_n)], np.uint32)
            return native.ntt_stages(x, _flat_twiddles(log_n, inverse))
        except Exception:
            pass  # stale library without the NTT entry point
    x = mat.astype(np.uint64)[_bitrev_perm(log_n)]
    pp = np.uint64(bb.P)
    for s in range(log_n):
        m = 1 << s
        tw = _stage_twiddles(log_n, inverse)[s]
        tw_canon = bb.np_from_mont(tw).astype(np.uint64)
        blocks = x.reshape(n // (2 * m), 2, m, -1)
        a = blocks[:, 0]
        b_ = blocks[:, 1]
        tb = (b_ * tw_canon[None, :, None]) % pp
        x = np.stack([(a + tb) % pp, (a + pp - tb) % pp], axis=1).reshape(n, -1)
    return x.astype(np.uint32)


def ntt(mat, inverse: bool = False):
    """Column-batched NTT of a (n, w) matrix; natural order in/out.

    Convention: `ntt` maps *coefficients* -> *evaluations* on H (row i =
    eval at g^i). Use `intt` for evaluations -> coefficients.
    """
    n = mat.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if isinstance(mat, torch.Tensor):
        return device_ntt(mat, log_n, inverse).to(bb.I32)
    if n == 1:
        return np.asarray(mat)
    return _ntt_np(np.asarray(mat), inverse, log_n)


def intt(mat):
    """Evaluations on H (natural order) -> coefficients."""
    n = mat.shape[0]
    n_inv = bb.inv_s(n % bb.P)
    if isinstance(mat, torch.Tensor):
        log_n = n.bit_length() - 1
        return (device_ntt(mat, log_n, True) * n_inv % bb.P).to(bb.I32)
    if n == 1:
        return np.asarray(mat)
    out = ntt(mat, inverse=True)
    from ..lair import native
    if out.size >= (1 << 16) and native.native_available():
        try:
            return native.scale_rows64(
                out.astype(np.uint64),
                np.uint64(n_inv)).astype(np.uint32)
        except Exception:
            pass
    return ((out.astype(np.uint64) * np.uint64(n_inv))
            % np.uint64(bb.P)).astype(np.uint32)


@lru_cache(maxsize=None)
def _shift_powers(log_n: int, shift: int):
    """[shift^0 .. shift^(n-1)] in Montgomery form (lurk_tpu's table)."""
    return bb.np_to_mont(_geom_powers_np(shift, 1 << log_n))


@lru_cache(maxsize=None)
def shift_powers_dev(log_n: int, shift: int, device: torch.device):
    """Canonical int64 [shift^0 .. shift^(n-1)] on device."""
    return bb.upload(_geom_powers_np(shift, 1 << log_n).astype(np.int64),
                     device)


def coset_eval(coeffs, log_blowup: int, shift: int = GENERATOR):
    """Coefficients (n rows) -> evaluations on the coset shift*K, |K| =
    n * 2^log_blowup, natural order."""
    n = coeffs.shape[0]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    big_log = log_n + log_blowup
    big_n = 1 << big_log
    if isinstance(coeffs, torch.Tensor):
        padded = torch.zeros((big_n, coeffs.shape[1]), dtype=bb.I64,
                             device=coeffs.device)
        padded[:n] = coeffs
        sp = shift_powers_dev(big_log, shift, coeffs.device)
        return device_ntt(padded * sp[:, None] % bb.P, big_log,
                          False).to(bb.I32)
    padded = np.zeros((big_n, coeffs.shape[1]), np.uint64)
    padded[:n] = np.asarray(coeffs)
    sp = bb.np_from_mont(_shift_powers(big_log, shift)).astype(np.uint64)
    from ..lair import native
    if native.native_available():
        try:
            shifted = native.scale_rows64(padded, sp).astype(np.uint32)
            return _ntt_np(shifted, False, big_log)
        except Exception:
            pass
    shifted = ((padded * sp[:, None]) % np.uint64(bb.P)).astype(np.uint32)
    return _ntt_np(shifted, False, big_log)


def lde(mat, log_blowup: int, shift: int = GENERATOR):
    """Evaluations on H -> evaluations on the blown-up coset (the LDE)."""
    return coset_eval(intt(mat), log_blowup, shift)


# --- slow scalar oracles ----------------------------------------------------

def eval_poly_s(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + int(c)) % bb.P
    return acc
