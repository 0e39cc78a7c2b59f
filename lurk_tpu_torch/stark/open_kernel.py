"""The PCS openings and the FRI fold as hand-written CUDA kernels
(csrc/open.cu, csrc/babybear.cuh).

The port of lurk_tpu's jitted open and FRI programs
(lurk_tpu/stark/device_prover.py). Each kernel beside its plain PyTorch
version, the eager code of stark/device_prover.py that ran on every device
before and that the CPU still runs:

  open_eval    _ext_powers_fn + _eval_coeffs_fn   device_ext_powers +
                                                  _eval_coeffs
  open_reduce  _inv_xz_fn + _reduce_fn, and the   _inv_xz + _reduce_chunked
               add into the reduced codeword      (+ bb.fadd)
  fri_fold     _fold_fn, and the add of the next  _fold (+ bb.fadd)
               height's input codeword

`open_eval_groups(groups)` returns the opened values of every (coeffs,
points) height group of a shard at all of their points in one launch;
`open_eval(coeffs, zs)` is its case of one group. `open_reduce(ro, lde,
zs, weights, y_alpha)` adds a group's reduced openings into its height's
reduced codeword `ro` (or makes it, where `ro` is None); `fri_fold(pair,
beta, shift, add)` folds one FRI layer, given as its committed pair matrix,
into the next layer's pair matrix and adds the input codeword of the next
height. A CUDA tensor goes to the kernel and a CPU tensor to the plain
version. Each raises ValueError on a layout its kernel does not take and
RuntimeError on a failed build or launch; each counts its kernel launches
in `.launches` (open_eval_groups in `open_eval.launches`), under a lock,
since parallel/shard_prover.py proves from one thread per device slot.
The library builds at first use (utils/cuda_build.py), launches on
PyTorch's current stream and leaves the calling thread's current device
as it was.

`eval_args`, `reduce_args` and `fold_args` pack each kernel's structure,
field for field in the order of its C structure: a Ptr for each pointer
(the coefficient and LDE slices in place, with their row strides), an int
for each count, points (Montgomery) and y_alpha (canonical) as words of
the structure; open_eval's column-tile records (TILE_FIELDS), its block ->
tile map and its groups' tables of z^(2^j), and open_reduce's weights
(Montgomery), in one int32 buffer uploaded through pinned memory without
a host sync. The CPU tests read the packing back with a numpy interpreter
of the kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..field import babybear as bb
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
FOLD_THREADS = 256
FOLD_RUN = 4

_ARRAYS = {"z": 4 * MAX_POINTS, "ya": 4 * MAX_POINTS, "beta": 4,
           "g_inv": LOG_POWERS}
EVAL_FIELDS = ("tiles", "block_tile", "zpow", "n_tiles", "blocks", "acc",
               "counter", "out")
# an EvalTile record: the slice's address, then 8-byte integers
TILE_FIELDS = ("coeffs", "ld", "h", "w", "n_points", "c0", "m_tiles",
               "group", "out_row", "first_block", "items")
REDUCE_FIELDS = ("lde", "ld", "log_big", "w", "n_points", "z", "ya",
                 "weights", "x0", "g", "accumulate", "out")
FOLD_FIELDS = ("pair", "add", "log_n", "beta", "inv_shift2", "g_inv", "out")
# the structures' 8-byte integer fields (and arrays of them); every other
# field is a pointer
INT_FIELDS = {"n_tiles", "blocks", "ld", "w", "n_points", "log_big", "x0",
              "g", "accumulate", "log_n", "inv_shift2", *_ARRAYS}


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
    _launch(name, fn, st, args["out"].tensor.device)


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
                groups=ptrs)


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
# open_reduce: one group's reduced openings, into its height's codeword
# ---------------------------------------------------------------------------

def reduce_args(ro: Optional[torch.Tensor], lde: torch.Tensor,
                zs: Sequence[tuple], weights: np.ndarray,
                y_alpha: np.ndarray) -> dict:
    """open_reduce's ReduceArgs: the (H, w) LDE slice in place, the
    group's points, its (n_points, w, 4) canonical alpha-power weights
    (uploaded in Montgomery form) and (n_points, 4) y_alpha; the output is
    `ro`, added into, or a new (H, 4) tensor where `ro` is None."""
    device = lde.device
    log_big = _log2_rows(lde, "lde")
    big = 1 << log_big
    ptr, ld, w = _slice("lde", lde, big, device)
    n = _points(zs)
    weights = np.asarray(weights, np.int64)
    if weights.shape != (n, w, 4):
        raise ValueError(f"weights {weights.shape}, expected {(n, w, 4)}")
    out = ro if ro is not None else \
        torch.empty((big, 4), dtype=I32, device=device)
    small = _pack(device, [("weights", _mont(weights % P))])
    return dict(lde=ptr, ld=ld, log_big=log_big, w=w, n_points=n,
                z=_words("z", _mont(np.asarray(zs, np.int64) % P), n),
                ya=_words("ya", y_alpha, n), weights=small["weights"],
                x0=int(_mont(GENERATOR)),
                g=int(_mont(bb.two_adic_generator_s(log_big))),
                accumulate=int(ro is not None),
                out=_rows("ro", out, big, device))


def launch_reduce(args: dict) -> torch.Tensor:
    """Launch open_reduce on packed ReduceArgs (reduce_args) and count it;
    returns the (H, 4) reduced codeword."""
    _launch_args("open_reduce", _ReduceArgs, REDUCE_FIELDS, args,
                 _library().lurk_open_reduce)
    _count(open_reduce)
    return args["out"].tensor


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
            lde, torch.from_numpy(np.asarray(weights[k], np.int64) % P)
            .to(device), dp.ext_scalar_dev(y_alpha[k], device), inv_xz)
        ro = contrib if ro is None else bb.fadd(ro, contrib)
    return ro


def open_reduce(ro: Optional[torch.Tensor], lde: torch.Tensor,
                zs: Sequence[tuple], weights: np.ndarray,
                y_alpha: np.ndarray,
                inv_cache: Optional[Dict[tuple, torch.Tensor]] = None
                ) -> torch.Tensor:
    """ro + sum_k (sum_c weights[k, c] * lde[x, c] - y_alpha[k]) / (x - z_k)
    at every row x of the group's (H, w) canonical LDE on the coset
    GENERATOR * <g_H> (1/0 taken as 0): the (H, 4) canonical int32 reduced
    codeword, `ro` itself on a card (added into in place), or new where
    `ro` is None. `inv_cache` keeps the plain version's 1/(x - z)."""
    if _check_device(lde) == "cpu":
        return reduce_plain(ro, lde, zs, weights, y_alpha, inv_cache)
    return launch_reduce(reduce_args(ro, lde, zs, weights, y_alpha))


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
                                    device=device)))


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
