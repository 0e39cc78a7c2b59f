"""BabyBear and its quartic extension in plain PyTorch (int64), written for
the benchmark's reference from the field's definition: p = 15 * 2^27 + 1,
the extension F_p[x] / (x^4 - 11), the multiplicative generator 31 (the
coset shift of every LDE) and the two-adic generators 31^((p - 1) / 2^k).

Tensors hold canonical values in int64; an extension element is a tensor
whose last axis has size 4 (coefficients in ascending degree). Products of
two canonical values stay below 2^62, so every product is reduced before
anything is added to it. Scalars (the transcript's challenges) are tuples of
Python ints.
"""

from __future__ import annotations

import torch

P = 2013265921
W = 11
GENERATOR = 31
TWO_ADICITY = 27


def two_adic_generator(bits: int) -> int:
    if not 0 <= bits <= TWO_ADICITY:
        raise ValueError(f"no subgroup of order 2^{bits}")
    return pow(GENERATOR, (P - 1) >> bits, P)


def inv(a: int) -> int:
    return pow(a, P - 2, P)


# -- scalar extension arithmetic (tuples of four ints) ----------------------

def emul_s(a, b) -> tuple:
    c = [0] * 7
    for i in range(4):
        for j in range(4):
            c[i + j] += a[i] * b[j]
    return tuple((c[k] + W * c[k + 4] if k < 3 else c[k]) % P
                 for k in range(4))


def eadd_s(a, b) -> tuple:
    return tuple((x + y) % P for x, y in zip(a, b))


def esub_s(a, b) -> tuple:
    return tuple((x - y) % P for x, y in zip(a, b))


def epow_s(a, e: int) -> tuple:
    out, base = (1, 0, 0, 0), tuple(a)
    while e:
        if e & 1:
            out = emul_s(out, base)
        base = emul_s(base, base)
        e >>= 1
    return out


def einv_s(a) -> tuple:
    """a^(p^4 - 2): the inverse of a nonzero element (0 maps to 0)."""
    return epow_s(a, P ** 4 - 2)


# -- tensor arithmetic -------------------------------------------------------

def ext(values, device) -> torch.Tensor:
    """An int64 tensor from nested ints, reduced mod p."""
    return torch.as_tensor(values, dtype=torch.int64, device=device) % P


def eadd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a + b) % P


def esub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b) % P


def emul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    c = [None] * 7
    for i in range(4):
        for j in range(4):
            t = a[..., i] * b[..., j] % P
            c[i + j] = t if c[i + j] is None else c[i + j] + t
    lo = [c[k] % P for k in range(7)]
    return torch.stack([(lo[0] + W * lo[4]) % P, (lo[1] + W * lo[5]) % P,
                        (lo[2] + W * lo[6]) % P, lo[3]], dim=-1)


def escale(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Extension elements times base-field values s (shape a.shape[:-1])."""
    return a * (s % P).unsqueeze(-1) % P


def epow(a: torch.Tensor, e: int) -> torch.Tensor:
    out = torch.zeros_like(a)
    out[..., 0] = 1
    base = a
    while e:
        if e & 1:
            out = emul(out, base)
        base = emul(base, base)
        e >>= 1
    return out


def einv(a: torch.Tensor) -> torch.Tensor:
    """a^(p^4 - 2): the inverse of every nonzero element (0 maps to 0)."""
    return epow(a, P ** 4 - 2)


def bpow(base: int, idx: torch.Tensor, scale: int = 1) -> torch.Tensor:
    """scale * base^idx mod p for an int64 index tensor."""
    out = torch.full_like(idx, scale % P)
    b, e = base % P, idx.clone()
    while bool((e > 0).any()):
        out = torch.where(e & 1 == 1, out * b % P, out)
        b = b * b % P
        e >>= 1
    return out


def powers(alpha, n: int, device) -> torch.Tensor:
    """(n, 4): alpha^0 .. alpha^(n - 1), by doubling blocks."""
    out = ext([[1, 0, 0, 0]], device)
    a = ext([list(alpha)], device)
    while out.shape[0] < n:
        step = epow(a, out.shape[0])
        out = torch.cat([out, emul(out, step)])
    return out[:n]
