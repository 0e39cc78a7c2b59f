"""The work a prove needs, counted from the proof's own shapes (every
committed matrix and FRI layer, every opened group) and the card's
published peaks; the least time of that work, which the rooflines divide
by the kernels' measured device time.

Shapes: a shard proof opens, per round (preprocessed, main, perm,
quotient), one matrix per chip, each at one or two points (zeta, zeta * g;
the quotient's chunks at zeta^2); its trace height is the chip's
`log_height` (the preprocessed matrices' heights are the key's), its LDE
height twice that (blowup 2). Each round commits one Merkle tree per LDE
height; FRI commits one tree of (f(x), f(-x)) pairs per layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

from .peaks import (CLOCK_HZ, EXACT_PRODUCTS_PER_S, HBM_BYTES_PER_S,
                    INT_LANES_PER_SM, SMS)

LOG_BLOWUP = 1
# the FRI layers whose codeword has at most 2^16 rows are committed on the
# host (lurk_tpu_torch's device prover, _fri_host_tail_log); the layers
# above are hashed on the card
FRI_HOST_TAIL_LOG = 16
# a Montgomery product of BabyBear takes 5 integer multiply-add slots and a
# modular addition 2 integer ALU slots (chip_smoke.py's _MUL_SLOTS and
# _ADD_SLOTS); an extension product 19 products and 12 additions, an
# extension inverse (chip_smoke.py's _EXT_MUL and _EXT_INV)
MUL_SLOTS, ADD_SLOTS = 5, 2
EXT_MUL = (19, 12)
EXT_INV = (8 + 2 * 19 + 5 + 31 + 4, 2 * 12 + 3)


@dataclass(frozen=True)
class Matrix:
    round: str          # "preprocessed", "main", "perm" or "quotient"
    log_h: int          # trace height, log2
    width: int          # base-field columns
    points: tuple       # opening points, as labels


def shard_matrices(proof, key) -> List[List[Matrix]]:
    """Per shard, every matrix its rounds open, in round order."""
    out = []
    for sp in proof.shard_proofs:
        lh = {cp.name: int(cp.log_height) for cp in sp.chip_proofs}

        def pts(log_h):
            return ("z", ("zg", log_h)) if log_h else ("z", "z")

        rounds = list(sp.pcs_proof.opened)
        mats = []
        if key.prep_roots:
            prep = rounds.pop(0)
            for name, plh, w in zip(key.prep_chip_names, key.prep_log_heights,
                                    key.prep_widths):
                mats.append(Matrix("preprocessed", plh, w,
                                   pts(lh[name]) if name in lh else ("z",)))
            assert len(prep) == len(key.prep_widths)
        for rnd, opened in zip(("main", "perm"), rounds[:2]):
            for cp, mv in zip(sp.chip_proofs, opened):
                mats.append(Matrix(rnd, int(cp.log_height), len(mv[0]),
                                   pts(int(cp.log_height))))
        for cp in sp.chip_proofs:
            mats.append(Matrix("quotient", int(cp.log_height), 8, ("z2",)))
        out.append(mats)
    return out


def fri_layers(mats: List[Matrix], log_blowup: int = LOG_BLOWUP) -> List[int]:
    """log2 rows of each FRI layer's codeword, from the largest LDE down to
    2^(log_blowup + 1)."""
    max_log = max(m.log_h for m in mats) + LOG_BLOWUP
    return list(range(max_log, log_blowup, -1))


def _groups(mats):
    g: dict = {}
    for m in mats:
        g.setdefault((m.round, m.log_h), []).append(m)
    return g


def poseidon2_perm_ops(width: int = 16, r_f: int = 8, r_p: int = 13):
    """(products, additions) that one Poseidon2 permutation needs: the
    external layer (each block of four by M4 in 11 additions, the sums
    across blocks, their addition to every word) before the rounds and
    after each full round; a full round adds its constants and takes x^7
    of every word (4 products); a partial round adds one constant, takes
    x^7 of one word, sums the state and multiplies each word by its
    diagonal entry."""
    ext = 11 * width // 4 + 4 * (width // 4 - 1) + width
    adds = ext + r_f * (width + ext) + r_p * (1 + (width - 1) + width)
    muls = r_f * 4 * width + r_p * (4 + width)
    return muls, adds


def commit_work(mats: List[Matrix]) -> dict:
    """Permutations and bytes of one shard's commits on the card: a tree
    per (round, height) of the main, perm and quotient rounds (the
    preprocessed round is committed once, at set-up) and a tree per FRI
    layer above the host tail. A leaf hashes its row at rate 8 (an empty
    row once); each of the leaves - 1 inner nodes is one compression. Bytes:
    each LDE word read once, each digest written once."""
    perms = n_bytes = 0
    for (rnd, log_h), ms in _groups(mats).items():
        if rnd == "preprocessed":
            continue
        leaves = 1 << (log_h + LOG_BLOWUP)
        w = sum(m.width for m in ms)
        perms += leaves * max(-(-w // 8), 1) + leaves - 1
        n_bytes += 4 * leaves * w + 32 * (2 * leaves - 1)
    for log_n in fri_layers(mats):
        if log_n > FRI_HOST_TAIL_LOG:
            leaves = 1 << (log_n - 1)
            perms += 2 * leaves - 1
            n_bytes += 4 * 8 * leaves + 32 * (2 * leaves - 1)
    return {"perms": perms, "bytes": n_bytes}


def open_work(mats: List[Matrix]) -> dict:
    """(bytes, products, additions) of open_eval and of open_reduce over
    one shard's rounds, as chip_smoke.py's _open_ops and _reduce_ops count
    them: open_eval evaluates each matrix's h coefficient rows at its
    points (a product by each power of z, the powers one extension product
    a row and point) and writes the opened values; open_reduce reads each
    LDE word once, weights it by alpha's powers at each point, and writes
    each height's reduced codeword once (the domain points one product a
    row; 1 / (x - z) by one batch; a product by each inverse)."""
    em, ea = EXT_MUL
    ev = [0, 0, 0]
    red = [0, EXT_INV[0], EXT_INV[1]]
    heights: dict = {}
    for (rnd, log_h), ms in _groups(mats).items():
        h, big = 1 << log_h, 1 << (log_h + LOG_BLOWUP)
        n_pts = max(len(m.points) for m in ms)
        ev[1] += n_pts * em * h
        ev[2] += n_pts * ea * h
        for m in ms:
            n = len(m.points)
            ev[0] += 4 * h * m.width + 16 * n * m.width
            ev[1] += n * 4 * h * m.width
            ev[2] += n * 4 * h * m.width
            red[0] += 4 * big * m.width
            red[1] += n * (4 * big * m.width + em * m.width)
            red[2] += n * (4 * big * m.width + ea * m.width)
            heights.setdefault(big, set()).update(m.points)
    for big, zs in heights.items():
        red[0] += 16 * big
        red[1] += big * (1 + len(zs) * 4 * em)
        red[2] += big * len(zs) * (1 + 4 * ea + 8)
    return {"open_eval": tuple(ev), "open_reduce": tuple(red)}


def cuda_core_s(muls: int, adds: int) -> float:
    """Least seconds on the CUDA cores: the busier of the multiply-add and
    ALU pipes, INT_LANES_PER_SM thread-instructions each per SM per clock."""
    return max(muls * MUL_SLOTS, adds * ADD_SLOTS) / INT_LANES_PER_SM \
        / (SMS * CLOCK_HZ)


def poseidon2_least_s(mats: List[Matrix]) -> float:
    """Least seconds of one shard's commits: the larger of their bytes over
    HBM and their permutations' operations on the CUDA cores."""
    w = commit_work(mats)
    muls, adds = poseidon2_perm_ops()
    return max(w["bytes"] / HBM_BYTES_PER_S,
               cuda_core_s(w["perms"] * muls, w["perms"] * adds))


def open_least_s(mats: List[Matrix]) -> float:
    """Least seconds of one shard's open_eval and open_reduce: for each, the
    larger of its bytes over HBM and its products at the tensor cores'
    exact rate."""
    total = 0.0
    for n_bytes, muls, _ in open_work(mats).values():
        total += max(n_bytes / HBM_BYTES_PER_S, muls / EXACT_PRODUCTS_PER_S)
    return total
