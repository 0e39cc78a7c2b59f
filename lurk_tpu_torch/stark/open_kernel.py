"""The PCS openings and the FRI fold as hand-written CUDA kernels
(csrc/open.cu, csrc/babybear.cuh).

The port of lurk_tpu's jitted open and FRI programs
(lurk_tpu/stark/device_prover.py). Each kernel beside its plain PyTorch
version, the eager code of stark/device_prover.py that ran on every device
before and that the CPU still runs:

  open_eval    _ext_powers_fn + _eval_coeffs_fn   device_ext_powers +
                                                  _eval_coeffs
  open_reduce  _inv_xz_fn + _reduce_fn, and the   segment_weights +
               add into the reduced codeword      _inv_xz + _reduce_chunked
                                                  (+ bb.fadd)
  fri_fold     _fold_fn, and the add of the next  _fold (+ bb.fadd)
               height's input codeword

`open_eval_groups(groups)` returns the opened values of every (coeffs,
points) height group of a shard at all of their points in one launch;
`open_eval(coeffs, zs)` is its case of one group.
`open_reduce_groups(groups, alpha)` returns the reduced codeword of every
height of a shard's (lde, points, weight segments, y_alpha) groups in one
launch, each height's written once; its weights are alpha^(o + e), made
on the card from one scalar alpha^o a (matrix, point) segment.
`open_reduce(ro, lde, zs, weights, y_alpha)` is its case of one group
with dense weights (a segment a column), added into its height's
reduced codeword `ro` (or making it, where `ro` is None). `fri_fold(pair,
beta, shift, add)` folds one FRI layer, given as its committed pair
matrix, into the next layer's pair matrix and adds the input codeword of
the next height. A CUDA tensor goes to the kernel and a CPU tensor to the
plain version. Each raises ValueError on a layout its kernel does not
take and RuntimeError on a failed build or launch; each counts its kernel
launches in `.launches` (open_eval_groups in `open_eval.launches`,
open_reduce_groups in `open_reduce.launches`), under a lock, since
parallel/shard_prover.py proves from one thread per device slot. The
library builds at first use (utils/cuda_build.py), launches on PyTorch's
current stream and leaves the calling thread's current device as it was.

`eval_args`, `reduce_groups_args` and `fold_args` pack each kernel's
structure, field for field in the order of its C structure: a Ptr for
each pointer (the coefficient and LDE slices in place, with their row
strides), an int for each count, tables as words of the structure;
open_eval's column-tile records (TILE_FIELDS), its block -> tile map and
its groups' tables of z^(2^j), and open_reduce's height, chunk and
segment records (HEIGHT_FIELDS, CHUNK_FIELDS, SEG_FIELDS: points
Montgomery, y_alpha canonical), in one int32 buffer uploaded through
pinned memory without a host sync. The CPU tests read the packing back
with a numpy interpreter of the kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext as ext_t
from ..field.ntt import GENERATOR
from ..utils import cuda_build
from . import device_prover as dp
from .quotient_kernel import (Ptr, _check_device, _count, _launch, _mont,
                              _pack, _slice)

P = bb.P
I32 = bb.I32
I64 = bb.I64

# csrc/open.cu's constants (tests/test_torch_open_kernel.py holds them)
MAX_POINTS = 2
LOG_POWERS = 32
EVAL_THREADS = 256
ITEM_ROWS = 1024
STAGE_WORDS = 4096
MMA_COLS = 16           # coefficient columns of an MMA tile
MAX_M_TILES = 8         # MMA tiles of a column tile (one a warp)
REDUCE_THREADS = 128
REDUCE_ROWS = 64        # rows of an open_reduce block
REDUCE_COLS = 32        # LDE columns of a chunk (a stage)
MAX_SLOTS = 4           # distinct points of one height
MAX_SEG_W = 256         # columns of a weight segment
LOG_SEG = 8
FLUSH_CHUNKS = 256      # chunks summed in s32 between reductions
WEIGHT_CHUNKS = 8       # chunks of a weight ticket
WB_WORDS = 512          # a chunk's weight planes, words
FOLD_THREADS = 256
FOLD_RUN = 4

_ARRAYS = {"beta": 4, "g_inv": LOG_POWERS, "gens": LOG_POWERS,
           "apow": 4 * LOG_SEG}
EVAL_FIELDS = ("tiles", "block_tile", "zpow", "n_tiles", "blocks", "acc",
               "counter", "out")
# an EvalTile record: the slice's address, then 8-byte integers
TILE_FIELDS = ("coeffs", "ld", "h", "w", "n_points", "c0", "m_tiles",
               "group", "out_row", "first_block", "items")
REDUCE_FIELDS = ("heights", "chunks", "segs", "wts", "ctr", "n_heights",
                 "n_chunks", "wblocks", "blocks", "seg_w", "x0", "gens",
                 "apow")
# open_reduce's records, 8-byte words: a ReduceHeight (its codeword's and
# its addend's addresses first), a ReduceChunk (its slice's address
# first) and a ReduceSeg; the arrays' lengths
HEIGHT_FIELDS = ("out", "add", "log_h", "n_slots", "first_chunk", "chunks",
                 "first_block", "z", "ya")
CHUNK_FIELDS = ("lde", "ld", "w", "c0", "vec", "tiles", "first_seg", "segs")
SEG_FIELDS = ("c0", "w", "slot", "a")
RECORD_ARRAYS = {"z": 4 * MAX_SLOTS, "ya": 4 * MAX_SLOTS, "a": 4}
FOLD_FIELDS = ("pair", "add", "log_n", "beta", "inv_shift2", "g_inv", "out")
# the structures' 8-byte integer fields (and arrays of them); every other
# field is a pointer
INT_FIELDS = {"n_tiles", "blocks", "n_heights", "n_chunks", "wblocks",
              "seg_w", "x0", "log_n", "inv_shift2", *_ARRAYS}


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _struct(name: str, fields) -> type:
    def ctype(f):
        if f in _ARRAYS:
            return ctypes.c_longlong * _ARRAYS[f]
        return ctypes.c_longlong if f in INT_FIELDS else ctypes.c_void_p
    return type(name, (ctypes.Structure,),
                {"_fields_": [(f, ctype(f)) for f in fields]})


_EvalArgs = _struct("EvalArgs", EVAL_FIELDS)
_ReduceArgs = _struct("ReduceArgs", REDUCE_FIELDS)
_FoldArgs = _struct("FoldArgs", FOLD_FIELDS)
_KERNELS = (("open_eval", _EvalArgs, EVAL_FIELDS),
            ("open_reduce", _ReduceArgs, REDUCE_FIELDS),
            ("fri_fold", _FoldArgs, FOLD_FIELDS))


def build(verbose: bool = False):
    """Compile csrc/open.cu (with its headers) into build/."""
    return cuda_build.build("open", "open.cu",
                            ("babybear.cuh", "on_device.cuh"),
                            verbose=verbose)


@lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    for name, st, _ in _KERNELS:
        size = getattr(lib, f"lurk_{name}_args_size")
        size.restype, size.argtypes = ctypes.c_longlong, []
        fn = getattr(lib, f"lurk_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        if size() != ctypes.sizeof(st):
            raise RuntimeError(f"{st.__name__}: the library's layout is "
                               f"{size()} bytes, the wrapper's "
                               f"{ctypes.sizeof(st)}")
    return lib


def _to_struct(st_type, fields, args: dict):
    def value(v):
        if isinstance(v, Ptr):
            return v.address()
        if v is None:
            return 0
        if isinstance(v, np.ndarray):
            return (ctypes.c_longlong * len(v))(*(int(x) for x in v))
        return int(v)
    return st_type(*(value(args[f]) for f in fields))


def _launch_args(name: str, st_type, fields, args: dict, fn) -> None:
    """Launch `fn` on the structure of `args`, packed at its first launch
    and kept in args["struct"] (a repeated launch packs nothing)."""
    st = args.get("struct")
    if st is None:
        st = args["struct"] = _to_struct(st_type, fields, args)
    _launch(name, fn, st, args["device"])


def _words(name: str, values, rows: int) -> np.ndarray:
    """`rows` ext values as the structure's array field `name` (4 words
    each, zero past the last)."""
    out = np.zeros(_ARRAYS[name], np.int64)
    vals = np.asarray(values, np.int64).reshape(-1)
    if len(vals) != 4 * rows:
        raise ValueError(f"{name}: {rows} extension values expected")
    out[:len(vals)] = vals % P
    return out


def _points(zs) -> int:
    n = len(zs)
    if not 1 <= n <= MAX_POINTS:
        raise ValueError(f"{n} opening points: the kernels take 1 to "
                         f"{MAX_POINTS}")
    return n


def _log2_rows(t: torch.Tensor, name: str) -> int:
    n = int(t.shape[0])
    if n < 1 or n & (n - 1):
        raise ValueError(f"{name}: {n} rows is not a power of two")
    return n.bit_length() - 1


def _rows(name: str, t: Optional[torch.Tensor], rows: int, device,
          width: int = 4):
    """Ptr of a contiguous (rows, width) int32 tensor on `device` (16-byte
    aligned: the kernels move 4 words as one 16-byte word)."""
    if t is None:
        return None
    if not isinstance(t, torch.Tensor) or t.dtype != I32 or \
            tuple(t.shape) != (rows, width) or t.device != device or \
            not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"({rows}, {width}) int32 tensor on {device}")
    return Ptr(t)


# ---------------------------------------------------------------------------
# open_eval: the opened values of every height group of a shard
# ---------------------------------------------------------------------------

def column_tiles(w: int) -> list:
    """(first column, MMA tiles) of each column tile of a w-column group:
    tiles of MAX_M_TILES * MMA_COLS columns, and the rest in the fewest
    MMA tiles (a power of two) that cover it."""
    full = MMA_COLS * MAX_M_TILES
    tiles = [(c0, MAX_M_TILES) for c0 in range(0, w - w % full, full)]
    if w % full:
        m = 1 << (_ceil(w % full, MMA_COLS) - 1).bit_length()
        tiles.append((w - w % full, m))
    return tiles


def _ext_square(a0: int, a1: int, a2: int, a3: int) -> tuple:
    """(a0 + a1 x + a2 x^2 + a3 x^3)^2 mod x^4 - 11, canonical."""
    return ((a0 * a0 + 11 * (2 * a1 * a3 + a2 * a2)) % P,
            2 * (a0 * a1 + 11 * a2 * a3) % P,
            (2 * a0 * a2 + a1 * a1 + 11 * a3 * a3) % P,
            2 * (a0 * a3 + a1 * a2) % P)


def power_tables(groups: Sequence[Tuple[int, Sequence[tuple]]]
                 ) -> np.ndarray:
    """(groups, MAX_POINTS, LOG_POWERS, 4) int64: for each (h, points)
    group, z^(2^j) in Montgomery form for each point z and each j below
    the bit length of h - 1 (at least z itself), the exponents of the
    group's rows; zero elsewhere. Each distinct point is squared once, as
    far as its tallest group needs."""
    keys = [[tuple(int(v) % P for v in z) for z in zs] for _, zs in groups]
    bits = [max(1, (h - 1).bit_length()) for h, _ in groups]
    need: Dict[tuple, int] = {}
    for zs, b in zip(keys, bits):
        for z in zs:
            need[z] = max(need.get(z, 1), b)
    tabs = {}
    for z, b in need.items():
        tab = [z]
        while len(tab) < b:
            tab.append(_ext_square(*tab[-1]))
        tabs[z] = _mont(np.array(tab, np.int64))
    out = np.zeros((len(groups), MAX_POINTS, LOG_POWERS, 4), np.int64)
    for gi, (zs, b) in enumerate(zip(keys, bits)):
        for k, z in enumerate(zs):
            out[gi, k, :b] = tabs[z][:b]
    return out


def eval_args(groups: Sequence[Tuple[torch.Tensor, Sequence[tuple]]]
              ) -> dict:
    """open_eval's EvalArgs for (coeffs, points) height groups, each a
    (h, w) coefficient slice with 1 or 2 points: one EvalTile record a
    column tile (a block for each ITEM_ROWS of its rows), the block ->
    tile map, the power tables, the zeroed accumulators and counters and
    the (sum n w, 4) output on the groups' device. `groups` keeps each
    group's Ptr (records hold addresses)."""
    if not groups:
        raise ValueError("open_eval: no groups")
    device = groups[0][0].device
    recs, ptrs, blocks, out_rows = [], [], 0, 0
    for gi, (coeffs, zs) in enumerate(groups):
        h = int(coeffs.shape[0]) if isinstance(coeffs, torch.Tensor) else 0
        ptr, ld, w = _slice("coeffs", coeffs, h, device)
        if h < 1 or w < 1:
            raise ValueError(f"coeffs {tuple(coeffs.shape)}: no values")
        n = _points(zs)
        items = _ceil(h, ITEM_ROWS)
        for c0, m in column_tiles(w):
            recs.append((ptr.address(), ld, h, w, n, c0, m, gi, out_rows,
                         blocks, items))
            blocks += items
        ptrs.append(ptr)
        out_rows += n * w
    recs = np.asarray(recs, np.int64)
    small = _pack(device, [
        ("tiles", recs.view(np.int32)),
        ("block_tile", np.repeat(np.arange(len(recs), dtype=np.int32),
                                 recs[:, TILE_FIELDS.index("items")])),
        ("zpow", power_tables([(int(c.shape[0]), zs)
                               for c, zs in groups]))])
    acc = torch.zeros(out_rows * 4 + _ceil(len(recs), 2), dtype=I64,
                      device=device)
    return dict(tiles=small["tiles"], block_tile=small["block_tile"],
                zpow=small["zpow"], n_tiles=len(recs), blocks=blocks,
                acc=Ptr(acc), counter=Ptr(acc[out_rows * 4:].view(I32)),
                out=Ptr(torch.empty((out_rows, 4), dtype=I32,
                                    device=device)),
                groups=ptrs, device=device)


def launch_eval(args: dict) -> torch.Tensor:
    """Launch open_eval on packed EvalArgs (eval_args) and count it;
    returns the (sum n w, 4) int32 output. The kernel leaves the
    accumulators and counters zero, so the same arguments may be launched
    again."""
    _launch_args("open_eval", _EvalArgs, EVAL_FIELDS, args,
                 _library().lurk_open_eval)
    _count(open_eval)
    return args["out"].tensor


def eval_plain(coeffs: torch.Tensor, zs: Sequence[tuple]) -> torch.Tensor:
    """The plain version of open_eval for one group: device_ext_powers and
    _eval_coeffs per point, (n_points, w, 4)."""
    h = int(coeffs.shape[0])
    return torch.stack([dp._eval_coeffs(coeffs, dp.device_ext_powers(
        z, h, coeffs.device)) for z in zs])


def eval_groups_plain(groups) -> torch.Tensor:
    """The plain version of open_eval_groups: eval_plain per group."""
    return torch.cat([eval_plain(c, zs).reshape(-1, 4) for c, zs in groups])


def open_eval_groups(groups: Sequence[Tuple[torch.Tensor, Sequence[tuple]]]
                     ) -> torch.Tensor:
    """(sum n w, 4) canonical int32: for each (coeffs, zs) group in order,
    its (n, w, 4) values sum_i coeffs[i, c] * z^i for every column c of
    the (h, w) canonical coefficients and every point z (an ext tuple) of
    `zs`, row k * w + c of the group's block. One launch for all groups on
    a card."""
    if not groups:
        raise ValueError("open_eval: no groups")
    kinds = {_check_device(c) for c, _ in groups}
    if len({c.device for c, _ in groups}) > 1:
        raise ValueError("open_eval: groups on more than one device")
    if kinds == {"cpu"}:
        return eval_groups_plain(groups)
    return launch_eval(eval_args(groups))


def open_eval(coeffs: torch.Tensor, zs: Sequence[tuple]) -> torch.Tensor:
    """(n_points, w, 4) canonical int32: open_eval_groups of one group."""
    return open_eval_groups([(coeffs, zs)]).view(len(zs), -1, 4)


open_eval.launches = 0


# ---------------------------------------------------------------------------
# open_reduce: the reduced codeword of every height of a shard's groups
# ---------------------------------------------------------------------------

def _ext_tuple(v) -> tuple:
    if isinstance(v, tuple) and len(v) == 4:
        return tuple(int(x) % P for x in v)
    return tuple(int(x) % P for x in np.asarray(v, np.int64).reshape(4))


def _copy_words(ptr: Ptr, ld: int) -> int:
    """Words a copy of open_reduce's stages takes from a slice: 16-byte
    copies where its address and row stride allow, else 8 or 4 bytes."""
    a = ptr.address() | 4 * ld
    return 4 if a % 16 == 0 else 2 if a % 8 == 0 else 1


def _pieces(segments, n: int, w: int, step: tuple):
    """A group's (k, c0, width, a) weight segments (weight a * alpha^e at
    column c0 + e of point k, e < width) checked and cut into pieces of at
    most MAX_SEG_W columns, the scalar of each piece stepped from the
    last by step = alpha^MAX_SEG_W: (k, c0, width, a)."""
    out = []
    for k, c0, width, a in segments:
        k, c0, width = int(k), int(c0), int(width)
        if not 0 <= k < n or c0 < 0 or width < 0 or c0 + width > w:
            raise ValueError(f"segment {(k, c0, width)} outside the "
                             f"group's {n} points and {w} columns")
        a = _ext_tuple(a)
        for p0 in range(0, width, MAX_SEG_W):
            if p0:
                a = ext_t.emul_s(a, step)
            out.append((k, c0 + p0, min(MAX_SEG_W, width - p0), a))
    return out


def _two_adic_table() -> np.ndarray:
    """g_k, the generator of the 2^k-th roots of unity, for k below
    LOG_POWERS (zero past the field's two-adicity), Montgomery."""
    gens = np.zeros(LOG_POWERS, np.int64)
    for k in range(min(LOG_POWERS, bb.TWO_ADICITY + 1)):
        gens[k] = bb.two_adic_generator_s(k)
    return _mont(gens)


_GENS = _two_adic_table()


def reduce_groups_args(groups, alpha: tuple,
                       ro: Optional[Dict[int, torch.Tensor]] = None) -> dict:
    """open_reduce's ReduceArgs for (lde, zs, segments, y_alpha) groups:
    each an (H, w) LDE slice read in place, its 1 or 2 points, its weight
    segments (k, c0, width, a) (columns c0 .. c0 + width of point k weigh
    a * alpha^e, a canonical ext tuple, as alpha^o for the segment's
    alpha-power offset o) and its (n, 4) canonical y_alpha. One
    ReduceHeight a height in first-seen order (its groups' distinct
    points, at most MAX_SLOTS, in first-seen order, and y_alpha summed
    per point; its codeword ro[log H] added into in place where `ro` has
    it, else a new (H, 4) tensor), one ReduceChunk a group's REDUCE_COLS
    columns (with the n-tiles its segments' slots need), the segments
    that meet each chunk (pieces of at most MAX_SEG_W columns); a weight
    ticket for each WEIGHT_CHUNKS chunks and a row item for each
    REDUCE_ROWS rows of a height; the weight planes' buffer and the zeroed
    counters. Keeps the slices' Ptrs and the codewords (`outs`, by
    log H)."""
    if not groups:
        raise ValueError("open_reduce: no groups")
    device = groups[0][0].device
    alpha = _ext_tuple(alpha)
    step = ext_t.epow_s(alpha, MAX_SEG_W)
    heights: Dict[int, dict] = {}
    for lde, zs, segments, y_alpha in groups:
        log_h = _log2_rows(lde, "lde")
        ptr, ld, w = _slice("lde", lde, 1 << log_h, device)
        n = _points(zs)
        y_alpha = np.asarray(y_alpha, np.int64)
        if y_alpha.shape != (n, 4):
            raise ValueError(f"y_alpha {y_alpha.shape}, expected {(n, 4)}")
        hgt = heights.setdefault(log_h, dict(
            slots=[], ya=np.zeros((MAX_SLOTS, 4), np.int64), groups=[]))
        slot = []
        for z in zs:
            z = _ext_tuple(z)
            if z not in hgt["slots"]:
                if len(hgt["slots"]) == MAX_SLOTS:
                    raise ValueError(f"more than {MAX_SLOTS} distinct "
                                     f"points at height 2^{log_h}")
                hgt["slots"].append(z)
            slot.append(hgt["slots"].index(z))
        for k in range(n):
            hgt["ya"][slot[k]] = (hgt["ya"][slot[k]] + y_alpha[k] % P) % P
        hgt["groups"].append((ptr, ld, w, [
            (slot[k], c0, width, tuple(v * bb.R_MOD_P % P for v in a))
            for k, c0, width, a in _pieces(segments, n, w, step)]))
    hrecs, crecs, srecs, outs, ptrs, items = [], [], [], {}, [], 0
    seg_w = 1
    for log_h, hgt in heights.items():
        big = 1 << log_h
        out = None if ro is None else ro.get(log_h)
        add = out
        if out is None:
            out = torch.empty((big, 4), dtype=I32, device=device)
        outs[log_h] = out
        first_chunk = len(crecs)
        for ptr, ld, w, pieces in hgt["groups"]:
            ptrs.append(ptr)
            vec, address = _copy_words(ptr, ld), ptr.address()
            for c0 in range(0, w, REDUCE_COLS):
                meet = [p for p in pieces
                        if p[1] < c0 + REDUCE_COLS and p[1] + p[2] > c0]
                tiles = max([1] + [p[0] // 2 + 1 for p in meet])
                crecs.append((address, ld, w, c0, vec, tiles, len(srecs),
                              len(meet)))
                for j, s0, width, a in meet:
                    srecs.append((s0, width, j, *a))
                    seg_w = max(seg_w, width)
        z = np.zeros((MAX_SLOTS, 4), np.int64)
        z[:len(hgt["slots"])] = _mont(np.asarray(hgt["slots"], np.int64))
        hrecs.append((_rows("ro", out, big, device).address(),
                      0 if add is None else add.data_ptr(), log_h,
                      len(hgt["slots"]), first_chunk,
                      len(crecs) - first_chunk, items,
                      *z.reshape(-1), *hgt["ya"].reshape(-1)))
        items += _ceil(big, REDUCE_ROWS)
    apow = [alpha]
    for _ in range(LOG_SEG - 1):
        apow.append(_ext_square(*apow[-1]))
    small = _pack(device, [
        ("heights", np.asarray(hrecs, np.int64).view(np.int32)),
        ("chunks", np.asarray(crecs, np.int64).view(np.int32)),
        ("segs", np.asarray(srecs, np.int64).reshape(-1, 7)
         .view(np.int32))])
    return dict(heights=small["heights"], chunks=small["chunks"],
                segs=small["segs"],
                wts=Ptr(torch.empty(len(crecs) * WB_WORDS, dtype=I32,
                                    device=device)),
                ctr=Ptr(torch.zeros(4, dtype=I32, device=device)),
                n_heights=len(hrecs), n_chunks=len(crecs),
                wblocks=_ceil(len(crecs), WEIGHT_CHUNKS), blocks=items,
                n_segs=len(srecs), seg_w=seg_w, x0=int(_mont(GENERATOR)),
                gens=_GENS, apow=_mont(np.asarray(apow, np.int64))
                .reshape(-1), outs=outs, lde=ptrs, device=device)


def launch_reduce(args: dict) -> Dict[int, torch.Tensor]:
    """Launch open_reduce on packed ReduceArgs (reduce_groups_args) and
    count it; returns the (H, 4) reduced codewords by log H."""
    _launch_args("open_reduce", _ReduceArgs, REDUCE_FIELDS, args,
                 _library().lurk_open_reduce)
    _count(open_reduce)
    return args["outs"]


def _unit_segments(weights: np.ndarray) -> list:
    """Dense (n, w, 4) weights as segments of one column each."""
    weights = np.asarray(weights, np.int64) % P
    return [(k, c, 1, tuple(int(v) for v in weights[k, c]))
            for k, c in zip(*np.nonzero(weights.any(axis=2)))]


def reduce_args(ro: Optional[torch.Tensor], lde: torch.Tensor,
                zs: Sequence[tuple], weights: np.ndarray,
                y_alpha: np.ndarray) -> dict:
    """reduce_groups_args of one group with dense (n_points, w, 4)
    canonical weights (a segment a column), into `ro` in place or a new
    (H, 4) codeword where `ro` is None."""
    n, w = _points(zs), int(lde.shape[1]) if lde.dim() == 2 else 0
    weights = np.asarray(weights, np.int64)
    if weights.shape != (n, w, 4):
        raise ValueError(f"weights {weights.shape}, expected {(n, w, 4)}")
    log_h = _log2_rows(lde, "lde")
    return reduce_groups_args([(lde, zs, _unit_segments(weights), y_alpha)],
                              (1, 0, 0, 0),
                              None if ro is None else {log_h: ro})


def _weight_rows(w, device) -> torch.Tensor:
    if isinstance(w, torch.Tensor):
        return w.to(device=device, dtype=I64) % P
    return bb.upload(np.asarray(w, np.int64) % P, device)


def reduce_plain(ro, lde, zs, weights, y_alpha,
                 inv_cache: Optional[Dict[tuple, torch.Tensor]] = None):
    """The plain version of open_reduce: per point, _inv_xz (kept in
    `inv_cache` by (height, point) where one is given), _reduce_chunked and
    bb.fadd into ro."""
    device = lde.device
    log_big = _log2_rows(lde, "lde")
    cache = inv_cache if inv_cache is not None else {}
    for k, z in enumerate(zs):
        inv_xz = cache.get((log_big, z))
        if inv_xz is None:
            inv_xz = dp._inv_xz(dp._xs_dev(log_big, device),
                                dp.ext_scalar_dev(z, device))
            cache[(log_big, z)] = inv_xz
        contrib = dp._reduce_chunked(
            lde, _weight_rows(weights[k], device),
            dp.ext_scalar_dev(y_alpha[k], device), inv_xz)
        ro = contrib if ro is None else bb.fadd(ro, contrib)
    return ro


def segment_weights(segments, n: int, w: int, alpha: tuple,
                    device) -> torch.Tensor:
    """(n, w, 4) canonical int64 weights of (k, c0, width, a) segments:
    a * alpha^e at column c0 + e of point k, summed where they meet."""
    out = torch.zeros((n, w, 4), dtype=I64, device=device)
    widest = max((int(s[2]) for s in segments), default=0)
    if widest:
        powers = dp.device_ext_powers(alpha, widest, device)
    for k, c0, width, a in segments:
        k, c0, width = int(k), int(c0), int(width)
        if width:
            part = ext_t.emul(powers[:width], dp.ext_scalar_dev(
                _ext_tuple(a), device).expand(width, 4)).to(I64)
            out[k, c0:c0 + width] = (out[k, c0:c0 + width] + part) % P
    return out


def reduce_groups_plain(groups, alpha: tuple,
                        ro: Optional[Dict[int, torch.Tensor]] = None
                        ) -> Dict[int, torch.Tensor]:
    """The plain version of open_reduce_groups: each group's weights
    (segment_weights), then reduce_plain into its height's codeword, the
    1/(x - z) of a (height, point) made once for all groups."""
    out = dict(ro) if ro else {}
    inv_cache: Dict[tuple, torch.Tensor] = {}
    for lde, zs, segments, y_alpha in groups:
        log_h = _log2_rows(lde, "lde")
        weights = segment_weights(segments, len(zs), int(lde.shape[1]),
                                  alpha, lde.device)
        out[log_h] = reduce_plain(out.get(log_h), lde, zs, weights,
                                  np.asarray(y_alpha, np.int64), inv_cache)
    return out


def open_reduce_groups(groups, alpha: tuple,
                       ro: Optional[Dict[int, torch.Tensor]] = None
                       ) -> Dict[int, torch.Tensor]:
    """The reduced codeword of every height of (lde, zs, segments,
    y_alpha) groups (reduce_groups_args), by log H: at every row x of the
    coset GENERATOR * <g_H>, the sum over the height's groups of sum_k
    (sum_c W[k, c] * lde[x, c] - y_alpha[k]) / (x - z_k) (1/0 taken as 0),
    W[k, c0 + e] = a * alpha^e summed over the segments (k, c0, width, a)
    that hold column c0 + e; plus ro[log H] where `ro` has it (in place
    on a card). One launch for all groups on a card."""
    if not groups:
        raise ValueError("open_reduce: no groups")
    kinds = {_check_device(g[0]) for g in groups}
    if len({g[0].device for g in groups}) > 1:
        raise ValueError("open_reduce: groups on more than one device")
    if kinds == {"cpu"}:
        return reduce_groups_plain(groups, alpha, ro)
    out = dict(ro) if ro else {}
    out.update(launch_reduce(reduce_groups_args(groups, alpha, ro)))
    return out


def open_reduce(ro: Optional[torch.Tensor], lde: torch.Tensor,
                zs: Sequence[tuple], weights: np.ndarray,
                y_alpha: np.ndarray,
                inv_cache: Optional[Dict[tuple, torch.Tensor]] = None
                ) -> torch.Tensor:
    """ro + sum_k (sum_c weights[k, c] * lde[x, c] - y_alpha[k]) / (x - z_k)
    at every row x of the group's (H, w) canonical LDE on the coset
    GENERATOR * <g_H> (1/0 taken as 0): the (H, 4) canonical int32 reduced
    codeword, `ro` itself on a card (added into in place), or new where
    `ro` is None. open_reduce_groups of one group with dense weights;
    `inv_cache` keeps the plain version's 1/(x - z)."""
    if _check_device(lde) == "cpu":
        return reduce_plain(ro, lde, zs, weights, y_alpha, inv_cache)
    args = reduce_args(ro, lde, zs, weights, y_alpha)
    return launch_reduce(args)[_log2_rows(lde, "lde")]


open_reduce.launches = 0


# ---------------------------------------------------------------------------
# fri_fold: one FRI layer's pair matrix into the next layer's
# ---------------------------------------------------------------------------

def fold_args(pair: torch.Tensor, beta: tuple, shift: int,
              add: Optional[torch.Tensor] = None) -> dict:
    """fri_fold's FoldArgs for the (n / 2, 8) pair matrix of a codeword of
    n rows on the coset shift * <g_n> (row i: f(x_i), f(-x_i)), with the
    (n / 4, 8) output allocated on its device."""
    device = pair.device
    log_n = _log2_rows(pair, "pair") + 1
    if log_n < 2:
        raise ValueError("pair: a fold into pairs needs 2 rows or more")
    half = 1 << (log_n - 1)
    g_inv = bb.inv_s(bb.two_adic_generator_s(log_n))
    table = [g_inv]
    for _ in range(LOG_POWERS - 1):
        table.append(table[-1] * table[-1] % P)
    return dict(pair=_rows("pair", pair, half, device, 8),
                add=_rows("add", add, half, device), log_n=log_n,
                beta=_words("beta", _mont(np.asarray(beta, np.int64) % P), 1),
                inv_shift2=int(_mont(bb.inv_s(2 * shift % P))),
                g_inv=_mont(np.asarray(table, np.int64)),
                out=Ptr(torch.empty((half // 2, 8), dtype=I32,
                                    device=device)), device=device)


def launch_fold(args: dict) -> torch.Tensor:
    """Launch fri_fold on packed FoldArgs (fold_args) and count it;
    returns the next layer's (n / 4, 8) pair matrix."""
    _launch_args("fri_fold", _FoldArgs, FOLD_FIELDS, args,
                 _library().lurk_fri_fold)
    _count(fri_fold)
    return args["out"].tensor


def fold_plain(pair, beta, shift: int, add=None):
    """The plain version of fri_fold: _fold of the unpaired codeword with
    the cached 1/(2x), bb.fadd of `add`, then the next layer's pairs."""
    log_n = _log2_rows(pair, "pair") + 1
    out = dp._fold(dp.unpair(pair), dp.ext_scalar_dev(beta, pair.device),
                   dp._inv_2x_dev(log_n, shift, pair.device))
    return dp.pairs(out if add is None else bb.fadd(out, add))


def fri_fold(pair: torch.Tensor, beta: tuple, shift: int,
             add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n / 4, 8) canonical int32, the next layer's pair matrix of out[i]
    = (f(x) + f(-x)) / 2 + beta (f(x) - f(-x)) / (2x) (plus add[i], the
    (n / 2, 4) input codeword of the next height, where given), from the
    layer's (n / 2, 8) canonical pair matrix (row i: f(x_i), f(-x_i)) on
    the coset shift * <g_n>."""
    if _check_device(pair) == "cpu":
        return fold_plain(pair, beta, shift, add)
    return launch_fold(fold_args(pair, beta, shift, add))


fri_fold.launches = 0
