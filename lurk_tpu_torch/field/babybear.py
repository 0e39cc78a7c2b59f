"""BabyBear field arithmetic on torch tensors.

p = 2^31 - 2^27 + 1 = 0x78000001, the field of the whole proving stack
(the counterpart of lurk_tpu/field/babybear.py).

Representation:
  * Field elements live in int32 tensors: p < 2^31, so every canonical
    value is a non-negative int32. Arithmetic widens to int64 (torch's CPU
    uint32 has no add, shift or compare) and reduces after every product:
    a product of two elements is < 2^62, so a sum of three overflows int64.
  * Montgomery form uses R = 2^32, as in p3-baby-bear and lurk_tpu.
    `mont_mul(a, b)` = a*b*R^-1 mod p, so `mont_mul(canonical, mont)`
    returns a canonical value. The Montgomery reduction itself lives in
    the CUDA kernel (csrc/poseidon2.cu); here every op reduces with an
    exact int64 `%`, which gives the same canonical result.
  * Every op takes int32 (or int64) tensors holding canonical values and
    returns int32 tensors on the same device.

Python-int helpers (suffix `_s`) are the slow, obviously-correct oracles
shared with lurk_tpu.
"""

from __future__ import annotations

import numpy as np
import torch

from ..stark import spans

# ---------------------------------------------------------------------------
# Field constants
# ---------------------------------------------------------------------------

P = 2013265921  # 2^31 - 2^27 + 1
TWO_ADICITY = 27
# Smallest multiplicative generator of F_p^* (order p-1 = 2^27 * 3 * 5).
GENERATOR = 31

# Montgomery constants for R = 2^32.
R = 1 << 32
R_MOD_P = R % P                    # R mod p        (= to_mont(1))
R2_MOD_P = (R * R) % P             # R^2 mod p      (to_mont multiplier)
P_INV_NEG = (-pow(P, -1, R)) % R   # -p^-1 mod 2^32 (the Montgomery mu)
R_INV_MOD_P = pow(R_MOD_P, P - 2, P)

I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# Scalar (python int) oracle ops
# ---------------------------------------------------------------------------

def add_s(a: int, b: int) -> int:
    return (a + b) % P


def sub_s(a: int, b: int) -> int:
    return (a - b) % P


def mul_s(a: int, b: int) -> int:
    return (a * b) % P


def inv_s(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in BabyBear")
    return pow(a, P - 2, P)


def pow_s(a: int, e: int) -> int:
    return pow(a, e, P)


def two_adic_generator_s(bits: int) -> int:
    """Generator of the order-2^bits subgroup (canonical form)."""
    assert 0 <= bits <= TWO_ADICITY
    return pow(GENERATOR, (P - 1) >> bits, P)


# ---------------------------------------------------------------------------
# Vectorized torch ops (canonical int32 representation unless noted)
# ---------------------------------------------------------------------------

def _w(a) -> torch.Tensor:
    """Widen to int64 (python ints and tensors alike)."""
    if isinstance(a, torch.Tensor):
        return a.to(I64)
    return torch.as_tensor(a, dtype=I64)


def fadd(a, b):
    """(a + b) mod p. Also valid in Montgomery form."""
    s = _w(a) + _w(b)
    return torch.where(s >= P, s - P, s).to(I32)


def fsub(a, b):
    d = _w(a) - _w(b)
    return torch.where(d < 0, d + P, d).to(I32)


def fneg(a):
    a = _w(a)
    return torch.where(a == 0, a, P - a).to(I32)


def fmul(a, b):
    """Canonical modular product."""
    return (_w(a) * _w(b) % P).to(I32)


def mont_mul(a, b):
    """Montgomery product a*b*R^-1 mod p (inputs < p, output < p)."""
    return (_w(a) * _w(b) % P * R_INV_MOD_P % P).to(I32)


def to_mont(a):
    """canonical -> Montgomery form (a*R mod p)."""
    return (_w(a) * R_MOD_P % P).to(I32)


def from_mont(a):
    """Montgomery -> canonical form (a*R^-1 mod p)."""
    return (_w(a) * R_INV_MOD_P % P).to(I32)


def _pow64(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e on canonical int64 values, reducing after every product."""
    assert e >= 0
    acc = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            acc = acc * base % P
        base = base * base % P
        e >>= 1
    return acc


def fpow(a, e: int):
    """a^e for a static python-int exponent (canonical in/out)."""
    return _pow64(_w(a), e).to(I32)


def finv(a):
    """Batched field inverse via Fermat (a^(p-2)); finv(0) = 0."""
    return fpow(a, P - 2)


def fdiv(a, b):
    return fmul(a, finv(b))


# Montgomery-domain helpers ------------------------------------------------

def mont_sqr(a):
    return mont_mul(a, a)


def mont_pow7(a):
    """x^7 in Montgomery domain (2 squares + 2 muls): used by Poseidon2."""
    x2 = mont_sqr(a)
    x3 = mont_mul(x2, a)
    x6 = mont_sqr(x3)
    return mont_mul(x6, a)


def np_to_mont(a: np.ndarray) -> np.ndarray:
    """Host-side canonical->Montgomery for constant tables."""
    return ((a.astype(np.uint64) * np.uint64(R_MOD_P)) % np.uint64(P)).astype(np.uint32)


def np_from_mont(a: np.ndarray) -> np.ndarray:
    rinv = pow(R_MOD_P, P - 2, P)
    return ((a.astype(np.uint64) * np.uint64(rinv)) % np.uint64(P)).astype(np.uint32)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array -> tensor of its dtype on device (shared with `a` on
    the CPU, as torch.from_numpy is). The bytes count as `h2d_bytes` of a
    recorded prove (stark/spans.py)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    spans.count("h2d_bytes", t.nbytes)
    return t.to(device)


def from_numpy(a: np.ndarray, device) -> torch.Tensor:
    """Canonical host array (uint32/uint64/int) -> int32 tensor on device."""
    return upload(np.ascontiguousarray(a, np.int64).astype(np.int32), device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Canonical int32/int64 tensor -> uint32 host array. The bytes count
    as `d2h_bytes` of a recorded prove."""
    spans.count("d2h_bytes", t.nbytes)
    return t.detach().cpu().numpy().astype(np.uint32)
