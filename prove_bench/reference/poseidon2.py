"""Poseidon2 over BabyBear in plain PyTorch, batched over rows, and the
sponge and compression the proofs commit with. Written from the
permutation's definition (Lurk's Poseidon2, argumentcomputer/lurk
src/poseidon/config.rs; its constants in poseidon2_babybear.json, copied
from lurk_tpu/poseidon/_constants_data.py):

    state = M_E state
    R_F / 2 full rounds:  state = M_E sbox(state + rc)
    R_P partial rounds:   state[0] = sbox(state[0] + rc); state = M_I state
    R_F / 2 full rounds

with sbox(x) = x^7, M_E the 4 x 4 block [[2,3,1,1],[1,2,3,1],[1,1,2,3],
[3,1,1,2]] on each block of four plus the sums across blocks, and
(M_I s)[i] = diag[i] s[i] + sum(s).

hash_rows: the padding-free sponge of width 16 and rate 8 (each chunk of 8
overwrites the rate, the last chunk padded with zeros, an empty row one
chunk of zeros), the first 8 words of the state out. compress: the first 8
words of the permutation of left || right.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

import torch

from .field import P

RATE = 8
DIGEST = 8
_M4 = ((2, 3, 1, 1), (1, 2, 3, 1), (1, 1, 2, 3), (3, 1, 1, 2))


@lru_cache(maxsize=None)
def constants(width: int) -> dict:
    data = json.loads((Path(__file__).with_name("poseidon2_babybear.json")
                       ).read_text())
    return data["widths"][str(width)]


def _external(s: torch.Tensor) -> torch.Tensor:
    n, t = s.shape
    blk = s.view(n, t // 4, 4)
    m4 = torch.tensor(_M4, dtype=torch.int64, device=s.device)
    out = (blk.unsqueeze(-2) * m4).sum(-1)          # (n, t/4, 4), < 2^34
    out = (out + out.sum(1, keepdim=True)) % P
    return out.view(n, t)


def _sbox(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x % P
    x3 = x2 * x % P
    x6 = x3 * x3 % P
    return x6 * x % P


@lru_cache(maxsize=None)
def _tables(width: int, device: str):
    c = constants(width)
    as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
    return c["r_f"], c["r_p"], as_t(c["full_rc"]), as_t(c["part_rc"]), \
        as_t(c["diag"])


def permute(state: torch.Tensor) -> torch.Tensor:
    """(n, width) canonical int64 rows -> their permutations."""
    r_f, r_p, full_rc, part_rc, diag = _tables(state.shape[1],
                                               str(state.device))
    s = _external(state % P)
    for r in range(r_f // 2):
        s = _external(_sbox((s + full_rc[r]) % P))
    for r in range(r_p):
        s[:, 0] = _sbox((s[:, 0] + part_rc[r]) % P)
        s = (s * diag % P + s.sum(1, keepdim=True)) % P
    for r in range(r_f // 2, r_f):
        s = _external(_sbox((s + full_rc[r]) % P))
    return s


def hash_rows(rows: torch.Tensor) -> torch.Tensor:
    """(n, w) -> (n, 8) sponge digests."""
    n, w = rows.shape
    pad = (-w) % RATE if w else RATE
    if pad:
        rows = torch.cat([rows, rows.new_zeros(n, pad)], dim=1)
    state = rows.new_zeros(n, 16)
    for c in range(0, rows.shape[1], RATE):
        state = torch.cat([rows[:, c:c + RATE], state[:, RATE:]], dim=1)
        state = permute(state)
    return state[:, :DIGEST]


def compress(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    return permute(torch.cat([left, right], dim=1))[:, :DIGEST]


def _external_ints(s: list) -> list:
    out = []
    for b in range(0, len(s), 4):
        x0, x1, x2, x3 = s[b:b + 4]
        t01, t23 = x0 + x1, x2 + x3
        out += [t01 + t01 + x1 + t23, t01 + x1 + x2 + x2 + t23,
                t23 + t23 + x3 + t01, t01 + t23 + x0 + x0 + x3]
    s0, s1, s2, s3 = (sum(out[k::4]) for k in range(4))
    return [(v + (s0, s1, s2, s3)[i & 3]) % P for i, v in enumerate(out)]


def permute_ints(state: list) -> list:
    """The same permutation on one state of Python ints (the transcript's
    duplexes, one after another, where a tensor's per-call cost would
    dominate)."""
    c = constants(len(state))
    full, part, diag = c["full_rc"], c["part_rc"], c["diag"]
    half = c["r_f"] // 2

    def full_round(s, rc):
        out = []
        for x, k in zip(s, rc):
            x = (x + k) % P
            x3 = x * x % P * x % P
            out.append(x3 * x3 % P * x % P)
        return _external_ints(out)

    s = _external_ints([v % P for v in state])
    for r in range(half):
        s = full_round(s, full[r])
    for k in part:
        x = (s[0] + k) % P
        x3 = x * x % P * x % P
        s[0] = x3 * x3 % P * x % P
        total = sum(s)
        s = [(v * d + total) % P for v, d in zip(s, diag)]
    for r in range(half, c["r_f"]):
        s = full_round(s, full[r])
    return s


def hash_n(values) -> tuple:
    """The first 8 words of the permutation of len(values) words (the
    hashes that intern Lurk data: 24, 32 or 40 words)."""
    return tuple(permute_ints(list(values))[:DIGEST])
