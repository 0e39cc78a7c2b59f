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

`open_eval(coeffs, zs)` returns a height group's opened values at all of
its points; `open_reduce(ro, lde, zs, weights, y_alpha)` adds the group's
reduced openings into its height's reduced codeword `ro` (or makes it,
where `ro` is None); `fri_fold(cw, beta, shift, add)` folds one FRI layer
and adds the input codeword of the next height. A CUDA tensor goes to the
kernel and a CPU tensor to the plain version. Each raises ValueError on a
layout its kernel does not take and RuntimeError on a failed build or
launch; each counts its kernel launches in `.launches`, under a lock,
since parallel/shard_prover.py proves from one thread per device slot.
Each launches once per call, for all of a group's points. The library
builds at first use (utils/cuda_build.py), launches on PyTorch's current
stream and leaves the calling thread's current device as it was.

`eval_args`, `reduce_args` and `fold_args` pack each kernel's structure,
field for field in the order of its C structure: a Ptr for each pointer
(the coefficient and LDE slices in place, with their row strides), an int
for each count, the points (Montgomery) and y_alpha (canonical) as words
of the structure, the weights (Montgomery) in one int32 buffer uploaded
through pinned memory without a host sync. The CPU tests read the packing
back with a numpy interpreter of the kernels.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Dict, Optional, Sequence

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
EVAL_THREADS = 256
EVAL_TILE = 64
# open_eval's blocks over rows: about this many blocks in all, so that
# the card's 132 SMs each take a few
EVAL_BLOCKS = 1056

_ARRAYS = {"z": 4 * MAX_POINTS, "ya": 4 * MAX_POINTS, "beta": 4}
EVAL_FIELDS = ("coeffs", "ld", "h", "w", "n_points", "z", "rows_per_block",
               "tx", "ty", "acc", "counter", "out")
REDUCE_FIELDS = ("lde", "ld", "log_big", "w", "n_points", "z", "ya",
                 "weights", "x0", "g", "accumulate", "out")
FOLD_FIELDS = ("cw", "add", "log_n", "beta", "inv_shift2", "g_inv", "out")
# the structures' 8-byte integer fields (and arrays of them); every other
# field is a pointer
INT_FIELDS = {"ld", "h", "w", "n_points", "rows_per_block", "tx", "ty",
              "log_big", "x0", "g", "accumulate", "log_n", "inv_shift2",
              "g_inv",
              *_ARRAYS}


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


def _ext_rows(name: str, t: Optional[torch.Tensor], rows: int, device):
    """Ptr of a contiguous (rows, 4) int32 tensor on `device` (16-byte
    aligned: the kernels move a row as one 16-byte word)."""
    if t is None:
        return None
    if not isinstance(t, torch.Tensor) or t.dtype != I32 or \
            tuple(t.shape) != (rows, 4) or t.device != device or \
            not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                         f"({rows}, 4) int32 tensor on {device}")
    return Ptr(t)


# ---------------------------------------------------------------------------
# open_eval: the opened values of one height group
# ---------------------------------------------------------------------------

def eval_threads(w: int) -> tuple:
    """(tx, ty) of an open_eval block for a group of w columns: tx
    neighbouring columns (a power of two below a warp, else the columns
    of a column tile rounded up to a warp, tiles of at most EVAL_THREADS
    columns) and ty rows taken at once, tx * ty <= EVAL_THREADS."""
    if w < 32:
        tx = 1 << (w - 1).bit_length()
    else:
        tx = _ceil(_ceil(w, _ceil(w, EVAL_THREADS)), 32) * 32
    return tx, max(1, EVAL_THREADS // tx)


def eval_rows_per_block(h: int, col_tiles: int) -> int:
    """Rows of an open_eval block: a multiple of EVAL_TILE giving about
    EVAL_BLOCKS blocks over the group's column tiles."""
    rows = _ceil(h, max(1, EVAL_BLOCKS // col_tiles))
    return max(EVAL_TILE, _ceil(rows, EVAL_TILE) * EVAL_TILE)


def eval_args(coeffs: torch.Tensor, zs: Sequence[tuple]) -> dict:
    """open_eval's EvalArgs for a (h, w) coefficient slice and the
    group's points, with the (n_points, w, 4) output and the zeroed
    accumulators allocated on its device."""
    device = coeffs.device
    h = int(coeffs.shape[0]) if isinstance(coeffs, torch.Tensor) else 0
    c, ld, w = _slice("coeffs", coeffs, h, device)
    if h < 1 or w < 1:
        raise ValueError(f"coeffs {tuple(coeffs.shape)}: no values")
    n = _points(zs)
    tx, ty = eval_threads(w)
    tiles = _ceil(w, tx)
    acc = torch.zeros(n * w * 4 + tiles, dtype=I64, device=device)
    return dict(coeffs=c, ld=ld, h=h, w=w, n_points=n,
                z=_words("z", _mont(np.asarray(zs, np.int64) % P), n),
                rows_per_block=eval_rows_per_block(h, tiles), tx=tx, ty=ty,
                acc=Ptr(acc), counter=Ptr(acc[n * w * 4:].view(I32)),
                out=Ptr(torch.empty((n, w, 4), dtype=I32, device=device)))


def launch_eval(args: dict) -> torch.Tensor:
    """Launch open_eval on packed EvalArgs (eval_args) and count it;
    returns the (n_points, w, 4) int32 output. The kernel leaves the
    accumulators zero, so the same arguments may be launched again."""
    out = args["out"].tensor
    _launch("open_eval", _library().lurk_open_eval,
            _to_struct(_EvalArgs, EVAL_FIELDS, args), out.device)
    _count(open_eval)
    return out


def eval_plain(coeffs: torch.Tensor, zs: Sequence[tuple]) -> torch.Tensor:
    """The plain version of open_eval: device_ext_powers and _eval_coeffs
    per point."""
    h = int(coeffs.shape[0])
    return torch.stack([dp._eval_coeffs(coeffs, dp.device_ext_powers(
        z, h, coeffs.device)) for z in zs])


def open_eval(coeffs: torch.Tensor, zs: Sequence[tuple]) -> torch.Tensor:
    """(n_points, w, 4) canonical int32: sum_i coeffs[i, c] * z^i for every
    column c of the (h, w) canonical coefficients and every point z (an
    ext tuple) of `zs`."""
    if _check_device(coeffs) == "cpu":
        return eval_plain(coeffs, zs)
    return launch_eval(eval_args(coeffs, zs))


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
                out=_ext_rows("ro", out, big, device))


def launch_reduce(args: dict) -> torch.Tensor:
    """Launch open_reduce on packed ReduceArgs (reduce_args) and count it;
    returns the (H, 4) reduced codeword."""
    out = args["out"].tensor
    _launch("open_reduce", _library().lurk_open_reduce,
            _to_struct(_ReduceArgs, REDUCE_FIELDS, args), out.device)
    _count(open_reduce)
    return out


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
# fri_fold: one FRI layer, with the next height's input codeword
# ---------------------------------------------------------------------------

def fold_args(cw: torch.Tensor, beta: tuple, shift: int,
              add: Optional[torch.Tensor] = None) -> dict:
    """fri_fold's FoldArgs for a (n, 4) codeword on the coset shift *
    <g_n>, with the (n / 2, 4) output allocated on its device."""
    device = cw.device
    log_n = _log2_rows(cw, "cw")
    if log_n < 1:
        raise ValueError("cw: a fold needs at least 2 rows")
    half = 1 << (log_n - 1)
    inv_2shift = bb.inv_s(2 * shift % P)
    return dict(cw=_ext_rows("cw", cw, 2 * half, device),
                add=_ext_rows("add", add, half, device), log_n=log_n,
                beta=_words("beta", _mont(np.asarray(beta, np.int64) % P), 1),
                inv_shift2=int(_mont(inv_2shift)),
                g_inv=int(_mont(bb.inv_s(bb.two_adic_generator_s(log_n)))),
                out=Ptr(torch.empty((half, 4), dtype=I32, device=device)))


def launch_fold(args: dict) -> torch.Tensor:
    """Launch fri_fold on packed FoldArgs (fold_args) and count it;
    returns the (n / 2, 4) folded codeword."""
    out = args["out"].tensor
    _launch("fri_fold", _library().lurk_fri_fold,
            _to_struct(_FoldArgs, FOLD_FIELDS, args), out.device)
    _count(fri_fold)
    return out


def fold_plain(cw, beta, shift: int, add=None):
    """The plain version of fri_fold: _fold with the cached 1/(2x), then
    bb.fadd of `add`."""
    log_n = _log2_rows(cw, "cw")
    out = dp._fold(cw, dp.ext_scalar_dev(beta, cw.device),
                   dp._inv_2x_dev(log_n, shift, cw.device))
    return out if add is None else bb.fadd(out, add)


def fri_fold(cw: torch.Tensor, beta: tuple, shift: int,
             add: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(n / 2, 4) canonical int32: (f(x) + f(-x)) / 2 + beta (f(x) -
    f(-x)) / (2x) over the natural-order halves of the (n, 4) canonical
    codeword on the coset shift * <g_n>, plus `add` (the (n / 2, 4) input
    codeword of the next height) where given."""
    if _check_device(cw) == "cpu":
        return fold_plain(cw, beta, shift, add)
    return launch_fold(fold_args(cw, beta, shift, add))


fri_fold.launches = 0
