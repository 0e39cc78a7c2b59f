"""The device witness of a func chip as one hand-written CUDA kernel
(csrc/witness.cu, csrc/babybear.cuh).

The port of lurk_tpu's jitted witness VM and row scatter
(lurk_tpu/lair/device_trace.py: _witness_vm, a lax.scan over one (chip,
path) row group's register bytecode, and _scatter_rows), which run per
row group after the host has gathered, padded and uploaded the group's
streams. `witness_trace(chip, shard, device)` writes a chip's whole
(height, width) int32 trace on a CUDA device in one launch;
device_trace.generate_trace_device calls it for a CUDA device, and its
eager row groups (_run_group, _witness_vm) are the plain version, taken
for CPU tensors only.

What the kernel reads is prepared here:
- `program_table(chip)`: every path's PathPlan (device_trace's compiler)
  as a header of PATH_FIELDS and sections of one word array, built once
  per chip and uploaded once per device;
- `witness_args(chip, shard, device)`: the chip's range of its
  ColumnarQueryMap streams as they are, 32-bit words in one buffer filled
  in pinned memory and copied without a host sync (the offset streams
  keep their values: the kernel takes the range's first off), the chip's
  rows sorted by path (a radix sort of the path stream) and cut into
  tiles of up to T rows of one path, T from the register file's shared
  memory (quotient_kernel.tile_rows).
The upload is a `witness.upload` span of a recorded prove and counts as
`h2d_bytes`; each launch counts its rows as `witness_kernel_rows`.

ValueError, naming the chip, on a layout the kernel does not take (rows
of a path the chip has no plan for, a register file that does not fit a
block of one row); RuntimeError on a failed build or launch.
`witness_trace.launches` counts the launches, under a lock, since
parallel/shard_prover.py proves from one thread per device slot. The CPU
tests read the packing back with a numpy interpreter of the kernel.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..stark import spans
from ..stark.quotient_kernel import (Ptr, _count, _launch, _on_device, _pack,
                                     tile_rows)
from ..utils import cuda_build
from . import device_trace as dt
from .trace import next_power_of_two

# a path's header (csrc/witness.cu's PathWord, in order)
PATH_FIELDS = ("n_ops", "ops", "n_req", "req", "n_hint", "hint", "n_dlt",
               "dlt", "n_depth", "depth", "in", "out", "sel", "prov_nonce",
               "prov_count", "pad")
DLT_WORDS = 12          # a depth less-than witness: hint index, 10 columns
META = 4                # shared words a row beside its registers
WITNESS_FIELDS = (
    "tiles", "n_tiles", "pad_tiles", "tile", "ld", "n_reg", "paths", "prog",
    "order", "start", "n", "args", "n_in", "outs", "n_out", "provide",
    "depth", "req_offs", "req", "dreq_offs", "dreq", "hint_offs", "hint",
    "trace", "height", "width")
# the structure's 8-byte integer fields; every other field is a pointer
INT_FIELDS = {"n_tiles", "pad_tiles", "tile", "ld", "n_reg", "start", "n",
              "n_in", "n_out", "height", "width"}

_WitnessArgs = type("WitnessArgs", (ctypes.Structure,), {"_fields_": [
    (f, ctypes.c_longlong if f in INT_FIELDS else ctypes.c_void_p)
    for f in WITNESS_FIELDS]})


def build(verbose: bool = False):
    """Compile csrc/witness.cu (with its headers) into build/."""
    return cuda_build.build("witness", "witness.cu",
                            ("babybear.cuh", "on_device.cuh"),
                            verbose=verbose)


@lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.lurk_witness_args_size.restype = ctypes.c_longlong
    lib.lurk_witness_args_size.argtypes = []
    lib.lurk_witness_trace.restype = ctypes.c_int
    lib.lurk_witness_trace.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
    size = lib.lurk_witness_args_size()
    if size != ctypes.sizeof(_WitnessArgs):
        raise RuntimeError(f"WitnessArgs: the library's layout is {size} "
                           f"bytes, the wrapper's "
                           f"{ctypes.sizeof(_WitnessArgs)}")
    return lib


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


@dataclass
class ProgramTable:
    """A chip's paths as the kernel reads them: `headers` (paths,
    PATH_FIELDS) and the sections they point into, `words`, both int64
    holding int32 values; the paths' idents in header order (ascending),
    `row_of` (ident -> header row, -1 where the chip has no such path) and
    the most registers of any path."""
    idents: np.ndarray
    row_of: np.ndarray
    headers: np.ndarray
    words: np.ndarray
    n_reg: int
    device_arrays: dict


@lru_cache(maxsize=None)
def program_table(chip) -> ProgramTable:
    """The program table of a chip whose paths all compile (device_trace.
    _plans_for), cached per chip. A require is (nonce, count, inverse
    column, 2 k + s): pair k of the row's requires (s = 0) or depth
    requires (s = 1), in the plan's replay order; a depth less-than
    witness is (hint index, its 10 columns, 0)."""
    plans = dt._plans_for(chip)
    idents = np.array(sorted(plans), np.int64)
    sections, n_words = [], 0

    def section(values) -> int:
        nonlocal n_words
        a = np.asarray(values, np.int64).reshape(-1)
        off = n_words
        sections.append(np.pad(a, (0, _pad4(len(a)) - len(a))))
        n_words += _pad4(len(a))
        return off

    headers = np.zeros((len(idents), len(PATH_FIELDS)), np.int64)
    for k, ident in enumerate(idents):
        p = plans[int(ident)]
        src = p.req_src.astype(np.int64)
        pair = np.zeros(len(src), np.int64)
        for s in (0, 1):
            pair[src == s] = np.arange(int((src == s).sum()))
        reqs = np.concatenate([p.req_cols.astype(np.int64),
                               (2 * pair + src)[:, None]], axis=1)
        dlt = np.concatenate([p.dlt_hint_idx[:, None].astype(np.int64),
                              p.dlt_cols,
                              np.zeros((len(p.dlt_cols), 1), np.int64)],
                             axis=1)
        head = {"n_ops": len(p.instrs), "ops": section(p.instrs),
                "n_req": len(reqs), "req": section(reqs),
                "n_hint": p.n_hint, "hint": section(p.hint_cols),
                "n_dlt": len(dlt), "dlt": section(dlt),
                # a plan has depth columns only for a partial func, where
                # the eager VM places the depth's bytes
                "n_depth": len(p.depth_cols), "depth": section(p.depth_cols),
                "in": p.in_off, "out": p.out_off, "sel": p.sel_col,
                "prov_nonce": p.prov_cols[0], "prov_count": p.prov_cols[1],
                "pad": 0}
        headers[k] = [head[f] for f in PATH_FIELDS]
    row_of = np.full(int(idents.max()) + 1, -1, np.int64)
    row_of[idents] = np.arange(len(idents))
    return ProgramTable(
        idents=idents, row_of=row_of, headers=headers,
        words=np.concatenate(sections) if sections else np.zeros(0, np.int64),
        n_reg=max(p.n_reg for p in plans.values()), device_arrays={})


def smem_bytes(n_reg: int, tile: int) -> int:
    """Shared memory of a block of `tile` rows: their meta words and
    n_reg registers at a stride of tile | 1 words."""
    return 4 * (META * tile + n_reg * (tile | 1))


def _tiles(chip, counts: np.ndarray, tile: int) -> np.ndarray:
    """(n_tiles, 4) tiles of up to `tile` rows of one path (header row,
    first sorted row, rows, 0) over rows sorted by path ident, from the
    rows of each ident."""
    table = program_table(chip)
    if len(counts) > len(table.row_of) or \
            counts[table.row_of[:len(counts)] < 0].any():
        raise ValueError(f"{chip.name}: rows of a path it has no plan for")
    c = np.zeros(len(table.idents), np.int64)
    known = table.idents < len(counts)
    c[known] = counts[table.idents[known]]
    per = -(-c // tile)
    which = np.repeat(np.arange(len(c)), per)
    k = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    first = (np.cumsum(c) - c)[which] + k * tile
    rows = np.minimum(tile, c[which] - k * tile)
    return np.stack([which, first, rows, np.zeros_like(rows)], axis=1)


def witness_args(chip, shard, device) -> dict:
    """The kernel's WitnessArgs for one chip of `shard` (its func queries
    a ColumnarQueryMap, at least one row), with the (height, width) int32
    trace allocated on `device`."""
    device = torch.device(device)
    table = program_table(chip)
    fq = shard.queries.func_queries[chip.func.index]
    rng = shard.get_func_range(chip.func.index)
    s, e = rng.start, rng.stop
    n = e - s
    try:
        tile = tile_rows(lambda t: smem_bytes(table.n_reg, t), n)
    except ValueError as err:
        raise ValueError(f"{chip.name}: {err}") from None
    path = fq.path[s:e]
    tiles = _tiles(chip, np.bincount(path), tile)
    # every ident has a header row now, so a narrow key sorts the same
    key = path.astype(np.uint16) if len(table.row_of) <= 1 << 16 else path
    order = np.argsort(key, kind="stable")
    streams = [("tiles", tiles), ("order", order), ("args", fq.args[s:e]),
               ("outs", fq.outputs[s:e]), ("provide", fq.provide[s:e]),
               ("depth", fq.depth[s:e])]
    for name, offs, flat in (("req", fq.req_offs, fq.req_flat),
                             ("dreq", fq.dreq_offs, fq.dreq_flat),
                             ("hint", fq.hint_offs, fq.hint_flat)):
        o = offs[s:e + 1]
        streams += [(f"{name}_offs", o), (name, flat[int(o[0]):int(o[-1])])]
    with spans.span("witness.upload", each=True):
        up = _pack(device, streams)
    prog = _on_device(table.device_arrays, device,
                      [("paths", table.headers), ("prog", table.words)])
    height = next_power_of_two(n)
    trace = torch.empty((height, chip.width), dtype=torch.int32,
                        device=device)
    return dict(up, **prog, n_tiles=len(tiles),
                pad_tiles=-(-(height - n) // tile), tile=tile, ld=tile | 1,
                n_reg=table.n_reg, start=s, n=n, n_in=fq.args.shape[1],
                n_out=fq.outputs.shape[1], trace=Ptr(trace), height=height,
                width=chip.width)


def launch_witness(args: dict) -> torch.Tensor:
    """Launch the kernel on packed WitnessArgs (witness_args), count it and
    its rows; returns the trace."""
    trace = args["trace"].tensor
    st = _WitnessArgs(*(args[f].address() if isinstance(args[f], Ptr)
                        else int(args[f]) for f in WITNESS_FIELDS))
    _launch("witness_trace", _library().lurk_witness_trace, st, trace.device)
    _count(witness_trace)
    spans.count("witness_kernel_rows", args["n"])
    return trace


def witness_trace(chip, shard, device) -> torch.Tensor:
    """A chip's (height, width) int32 trace on a CUDA device, made by the
    kernel in one launch: generate_trace_device's result, bit for bit."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"witness_trace runs on a CUDA device, not "
                         f"{device}: device_trace's row groups are its plain "
                         f"version")
    return launch_witness(witness_args(chip, shard, device))


witness_trace.launches = 0
