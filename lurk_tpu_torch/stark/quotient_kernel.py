"""The constraint quotient and the LogUp perm trace as hand-written CUDA
kernels (csrc/quotient.cu, csrc/babybear.cuh).

The port of lurk_tpu's jitted device programs for the two stages
(lurk_tpu/stark/device_prover.py): the constraint VM `_vm_fn` and the
perm-quotient `_pq_fn`, which device_quotient_chunk_vm runs per row window,
become one kernel, `constraint_quotient`; the plan-driven perm trace
`_generic_perm_fn` (device_perm_trace_plan) becomes `logup_perm_phi`.

`constraint_quotient(q)` returns one chip's (big, 4) alpha-folded
constraint values over its LDE rows, and `logup_perm_phi(perm, ...)`
writes a chip's LogUp batch contributions into its perm matrix. A CUDA
tensor goes to the kernel and a CPU tensor to the plain PyTorch version
below (the eager code that ran on every device before: _vm_eval, _pq_eval
and the _fingerprints loop). Each raises ValueError on a layout its kernel
does not take (or whose tile does not fit in a block's shared memory) and
RuntimeError on a failed build or launch; each counts its kernel launches
in `.launches`, under a lock, since parallel/shard_prover.py proves from
one thread per device slot. Each launches once per call, over all rows.
The library builds at first use (utils/cuda_build.py), launches on
PyTorch's current stream and leaves the calling thread's current device as
it was.

What the kernels read is prepared here. `compile_program` turns a VM
program into the kernel's op stream (cached per program and row stride):
scratch registers renumbered to the S the program uses, writes of the
constraint registers folded on write where a register is written once and
never read, each op packed into two words. `quotient_args(q)` and
`perm_args(...)` pack each kernel's structure, field for field in the
order of its C structure: a Ptr for each pointer (the LDE slices in place,
with their row strides; the small arrays in one int32 buffer uploaded
through pinned memory without a host sync), an int for each count, and
the tile's rows per block. Values the kernels multiply are uploaded in
the Montgomery form they compute in; the fold weights stay canonical, so
the kernels' outputs are canonical. The CPU tests read the packing back
with a numpy interpreter of the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch

from ..field import babybear as bb
from ..field import ext as ext_t
from ..utils import cuda_build
from . import device_prover as dp
from . import spans

P = bb.P
I32 = bb.I32
I64 = bb.I64
_LOCK = threading.Lock()

# a block's shared memory on sm_90 (227 KB) and the share of it a tile
# aims at, so that four blocks stay resident on an SM
SMEM_BYTES = 232448
_SMEM_TARGET = SMEM_BYTES // 4
# rows (and threads) of a block: a power of two, at most MAX_TILE, at
# least a warp's where the shared memory allows
MAX_TILE = 128
_MIN_TILE = 32

# the packed op: word 0 holds operands a and b (16-bit offsets), word 1
# the destination below bit 24 and the opcode and flags above it
_OPCODE_SHIFT = 24
OP_MOV = 3
_A_CONST, _B_CONST, _FOLD = 4, 8, 16

# VM ops staged in a block's shared memory at a time; batches of the
# perm-quotient and interactions of the perm trace in one staged record
# (the latter is the kernel's G, the group of one batched inverse)
OP_CHUNK = 256
QUOTIENT_GROUP = 2
PERM_GROUP = 8

QUOTIENT_FIELDS = (
    "main", "main_ld", "main_w", "prep", "prep_ld", "prep_w", "perm",
    "perm_ld", "nb", "first", "last", "trans", "log_big", "stride", "ops",
    "n_ops", "op_chunk", "fold_off", "max_folds", "wfold", "consts",
    "n_consts", "recs", "rec_off", "rec_words", "group", "wsel", "cum",
    "ld", "tile", "out")
PERM_FIELDS = (
    "main", "main_ld", "main_w", "prep", "prep_ld", "prep_w", "h", "nb",
    "recs", "rec_off", "rec_words", "ld", "tile", "out", "out_ld")


@dataclass(frozen=True)
class Ptr:
    """Element `offset` of `tensor`'s data: the address the kernel gets."""
    tensor: torch.Tensor
    offset: int = 0

    def address(self) -> int:
        return self.tensor.data_ptr() + self.offset * \
            self.tensor.element_size()


# the structures' 8-byte integer fields; every other field is a pointer
_INT_FIELDS = {"main_ld", "main_w", "prep_ld", "prep_w", "perm_ld", "nb",
               "log_big", "stride", "n_ops", "op_chunk", "max_folds",
               "n_consts", "rec_words", "group", "ld", "tile", "h",
               "out_ld"}


def _struct(name: str, fields) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": [
        (f, ctypes.c_longlong if f in _INT_FIELDS else ctypes.c_void_p)
        for f in fields]})


_QuotientArgs = _struct("QuotientArgs", QUOTIENT_FIELDS)
_PermArgs = _struct("PermArgs", PERM_FIELDS)


def build(verbose: bool = False):
    """Compile csrc/quotient.cu (with its headers) into build/."""
    return cuda_build.build("quotient", "quotient.cu",
                            ("babybear.cuh", "on_device.cuh"),
                            verbose=verbose)


@lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in ("lurk_quotient_args_size", "lurk_perm_args_size"):
        getattr(lib, fn).restype = ll
        getattr(lib, fn).argtypes = []
    for fn in ("lurk_constraint_quotient", "lurk_logup_perm_phi"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = [ctypes.c_int, vp, vp]
    lib.lurk_kernel_occupancy.restype = ctypes.c_int
    lib.lurk_kernel_occupancy.argtypes = [ctypes.c_int, ctypes.c_int, ll, ll]
    for fn, st in (("lurk_quotient_args_size", _QuotientArgs),
                   ("lurk_perm_args_size", _PermArgs)):
        if getattr(lib, fn)() != ctypes.sizeof(st):
            raise RuntimeError(f"{st.__name__}: the library's layout is "
                               f"{getattr(lib, fn)()} bytes, the wrapper's "
                               f"{ctypes.sizeof(st)}")
    return lib


def _pack(device, arrays) -> Dict[str, Ptr]:
    """Upload int32-valued arrays as one int32 buffer, each at a 16-byte
    boundary: name -> Ptr into it. On a card the buffer is filled in
    pinned memory and copied without blocking the host (the caching host
    allocator keeps the pinned block until the copy has run)."""
    offs, n = [], 0
    for _, a in arrays:
        offs.append(n)
        n += -(-int(np.size(a)) // 4) * 4
    cuda = torch.device(device).type == "cuda"
    host = torch.empty(n, dtype=I32, pin_memory=cuda)
    view = host.numpy()
    for (_, a), off in zip(arrays, offs):
        flat = np.asarray(a).reshape(-1)
        view[off:off + len(flat)] = flat
    if cuda:
        spans.count("h2d_bytes", host.nbytes)
    buf = host.to(device, non_blocking=True) if cuda else host
    return {name: Ptr(buf, off) for (name, _), off in zip(arrays, offs)}


def _slice(name: str, t: Optional[torch.Tensor], rows: int, device,
           width: Optional[int] = None):
    """(Ptr, row stride, width) of an int32 row-major slice, read in place."""
    if t is None:
        return None, 0, 0
    if not isinstance(t, torch.Tensor) or t.dtype != I32 or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D int32 tensor")
    if t.device != device or int(t.shape[0]) != rows:
        raise ValueError(f"{name} must be ({rows}, w) on {device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    if width is not None and int(t.shape[1]) != width:
        raise ValueError(f"{name} must have {width} columns")
    if t.shape[1] > 1 and t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name}: columns must be contiguous within a row "
                         f"(strides {t.stride()})")
    return Ptr(t), int(t.stride(0)), int(t.shape[1])


def _check_device(t: torch.Tensor) -> str:
    if not isinstance(t, torch.Tensor):
        raise TypeError("expected a torch.Tensor")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _count(fn) -> None:
    with _LOCK:
        fn.launches += 1


def _odd(n: int) -> int:
    return n | 1


def tile_rows(block_bytes, rows: int) -> int:
    """Rows of a kernel's block: the largest power of two up to MAX_TILE
    whose block_bytes(T) is at most a quarter of SMEM_BYTES, stopping at a
    warp (32); below a warp only as far as SMEM_BYTES forces; never more
    than `rows` rounded up to a power of two. ValueError where one row does
    not fit."""
    if block_bytes(1) > SMEM_BYTES:
        raise ValueError(f"a tile row of {block_bytes(1)} bytes does not "
                         f"fit in a block's {SMEM_BYTES} bytes of shared "
                         f"memory")
    t = MAX_TILE
    while t > _MIN_TILE and block_bytes(t) > _SMEM_TARGET:
        t //= 2
    while t > 1 and block_bytes(t) > SMEM_BYTES:
        t //= 2
    return min(t, 1 << max(rows - 1, 0).bit_length())


# ---------------------------------------------------------------------------
# the affine plan as per-interaction lists of nonzero terms
# ---------------------------------------------------------------------------

def _mont(a) -> np.ndarray:
    """Canonical values in Montgomery form (x * 2^32 mod p), int64."""
    return np.asarray(a, np.int64) * bb.R_MOD_P % P


def _weights8(w: np.ndarray) -> np.ndarray:
    """(n, 4) canonical ext weights as the kernels' (n, 8) Montgomery
    w0..w3, W w1, W w2, W w3, 0."""
    w = np.asarray(w, np.int64).reshape(-1, 4)
    out = np.concatenate([w, w[:, 1:] * ext_t.W % P,
                          np.zeros((len(w), 1), np.int64)], axis=1)
    return _mont(out)


def _pad4(n):
    return -(-n // 4) * 4


def _on_device(cache: dict, device, arrays) -> Dict[str, Ptr]:
    """_pack(device, arrays) once per device, kept in `cache`; the first
    upload is waited for, so that a launch on any stream may read it."""
    key = str(device)
    if key not in cache:
        packed = _pack(device, arrays)
        if torch.device(device).type == "cuda":
            torch.cuda.current_stream(device).synchronize()
        cache[key] = packed
    return cache[key]


@dataclass
class _Layout:
    """Where each value of a plan's records goes. It depends on the plan's
    term columns and on which weights are nonzero, not on the claim's
    values, so it is built once per chip (and kind of record)."""
    template: np.ndarray             # the words, counts and columns set
    t_mask: np.ndarray               # (n, T) the nonzero term weights
    m_mask: np.ndarray               # (n, M)
    at_mconst: np.ndarray            # (n,) word of each mconst
    at_d: np.ndarray                 # (n, 4)
    at_tw: np.ndarray                # (terms, 4)
    at_mw: np.ndarray                # (mult terms,)
    at_wb: Optional[np.ndarray]      # (nb, 8) with batch weights
    const: np.ndarray                # (n,) fingerprints without a term
    offs: np.ndarray                 # record offsets
    rec_words: int                   # the longest record
    device_arrays: dict


_LAYOUTS: Dict[tuple, _Layout] = {}


def _layout(plan: Dict[str, np.ndarray], per_record: int,
            batches: bool) -> _Layout:
    """The records' layout (see _records) of a plan, cached."""
    ti, mi = np.asarray(plan["ti"]), np.asarray(plan["mi"])
    t_mask = np.asarray(plan["tw"]).any(axis=2).T
    m_mask = (np.asarray(plan["mw"]) != 0).T
    key = (per_record, batches, ti.shape, mi.shape, ti.tobytes(),
           mi.tobytes(), t_mask.tobytes(), m_mask.tobytes())
    lay = _LAYOUTS.get(key)
    if lay is not None:
        return lay
    n = t_mask.shape[0]
    tc, mc = t_mask.sum(axis=1), m_mask.sum(axis=1)
    size = 8 + 4 * tc + _pad4(tc) + _pad4(2 * mc)
    if batches:
        unit = 8 + size[0::2] + size[1::2]              # each batch
        first = np.cumsum(unit) - unit
        start = np.stack([first + 8, first + 8 + size[0::2]], 1).reshape(-1)
    else:
        unit = size                                     # each interaction
        start = np.cumsum(unit) - unit
    template = np.zeros(int(unit.sum()), np.int64)
    template[start] = tc
    template[start + 1] = mc
    k = np.repeat(np.arange(n), tc)                     # each term's
    j = np.arange(len(k)) - np.repeat(np.cumsum(tc) - tc, tc)  # place
    at_tw = (start[k] + 8 + 4 * j)[:, None] + np.arange(4)
    template[start[k] + 8 + 4 * tc[k] + j] = ti.T[t_mask]
    k = np.repeat(np.arange(n), mc)
    j = np.arange(len(k)) - np.repeat(np.cumsum(mc) - mc, mc)
    pairs = start[k] + 8 + 4 * tc[k] + _pad4(tc[k]) + 2 * j
    template[pairs] = mi.T[m_mask]
    offs = np.concatenate([(np.cumsum(unit) - unit)[::per_record],
                           [len(template)]])
    lay = _Layout(template=template, t_mask=t_mask, m_mask=m_mask,
                  at_mconst=start + 2, at_d=start[:, None] + 4 + np.arange(4),
                  at_tw=at_tw, at_mw=pairs + 1,
                  at_wb=(first[:, None] + np.arange(8)) if batches else None,
                  const=tc == 0, offs=offs,
                  rec_words=int(np.diff(offs).max(initial=0)),
                  device_arrays={})
    _LAYOUTS[key] = lay
    return lay


def _records(plan: Dict[str, np.ndarray], per_record: int,
             wb: Optional[np.ndarray] = None, invert_constants: bool = False
             ) -> tuple:
    """The plan as the records a kernel stages in shared memory: (layout,
    words). An interaction is a header [term count, multiplicity-term
    count, mconst (Montgomery), 0, d0..d3], its nonzero term weights (4
    words each, Montgomery), their columns (padded to 4 words) and its
    (column, canonical weight) multiplicity pairs (padded to 4 words); d
    is dconst * 2^64 mod p, where a sum of Montgomery products starts, or
    with invert_constants, for a fingerprint without terms, its Montgomery
    inverse (0 for 0). With wb (the perm-quotient's batch weights), a
    batch is wb's 8 words (_weights8) and its two interactions. A record
    holds per_record batches (with wb) or interactions; every offset is a
    multiple of 4 words."""
    lay = _layout(plan, per_record, wb is not None)
    words = lay.template.copy()
    words[lay.at_mconst] = _mont(plan["mconst"])
    d = np.asarray(plan["dconst"], np.int64) * bb.R2_MOD_P % P
    if invert_constants and lay.const.any():
        cd = torch.from_numpy(np.asarray(plan["dconst"], np.int64)
                              [lay.const])
        d[lay.const] = _mont(ext_t.einv(cd).to(I64).numpy())
    words[lay.at_d] = d
    words[lay.at_tw] = _mont(np.asarray(plan["tw"]).transpose(1, 0, 2)
                             [lay.t_mask])
    words[lay.at_mw] = np.asarray(plan["mw"]).T[lay.m_mask]
    if wb is not None:
        words[lay.at_wb] = _weights8(wb)
    return lay, words


# ---------------------------------------------------------------------------
# kernel A: the constraint quotient
# ---------------------------------------------------------------------------

@dataclass
class QuotientInputs:
    """What one chip's constraint quotient reads. The LDE slices are int32
    device tensors over the chip's `big` LDE rows; the rest is canonical
    host data: the chip's VM program and its constants, the affine plan's
    arrays (device_prover._plan_arrays with pad_d_one, 2 nb interactions),
    the ext fold weights (wbase for the constraints, wb for the batches,
    wsel for the three running-sum constraints) and the cumulative sum."""
    prog: object                     # constraint_vm.VMProgram
    consts: np.ndarray               # (n_consts,) canonical
    main: torch.Tensor               # (big, main_w) LDE slice
    prep: Optional[torch.Tensor]     # (big, prep_w) LDE slice or None
    perm: torch.Tensor               # (big, 4 (nb + 1)) perm LDE slice
    sels: Dict[str, torch.Tensor]    # first/last/transition (big,) int64
    plan: Dict[str, np.ndarray]
    nb: int
    wbase: np.ndarray                # (n_cons, 4)
    wb: np.ndarray                   # (nb, 4)
    wsel: np.ndarray                 # (3, 4)
    cum: np.ndarray                  # (4,)
    stride: int                      # the next row's offset


@dataclass(frozen=True)
class CompiledProgram:
    """A VM program as constraint_quotient runs it: `ops` (n_ops, 2)
    int32 (then a zero op where n_ops is odd) in chunks of OP_CHUNK; the
    constraint folded by each FOLD op in stream order (`fold_cons`), the
    first fold of each chunk (`fold_off`) and the most folds in one chunk;
    its S scratch slots and the tile row stride `ld` (odd, at least Wx + S
    words)."""
    ops: np.ndarray
    n_ops: int
    fold_cons: np.ndarray
    fold_off: np.ndarray
    max_folds: int
    n_scratch: int
    ld: int
    folded_on_write: int             # constraint registers folded on write
    device_arrays: dict


def compile_program(prog, stride: int) -> CompiledProgram:
    """The kernel's op stream of a VM program whose next row is `stride`
    rows on (cached on the program). Operand offsets count words from the
    thread's tile row: local column c at c, next column c at stride * ld +
    c, scratch slot s at Wx + s; a constant is its index into the constant
    table. A constraint register written once and never read is folded
    when written (its op carries the FOLD flag and, for a destination, the
    fold's place among its chunk's staged weights); any other keeps a
    scratch slot and is folded by a MOV at the end, so every program is
    right, whatever it does with its registers."""
    cache = prog.__dict__.setdefault("_quotient_kernel_ops", {})
    if stride in cache:
        return cache[stride]
    R, nc, wx = prog.n_regs, prog.n_cons, prog.x_width
    ops = np.asarray(prog.ops, np.int64).reshape(-1, 4)
    code, dst, oa, ob = ops.T
    operands = np.concatenate([oa, ob])
    writes = np.bincount(dst[dst < nc], minlength=nc)
    read = np.zeros(nc, bool)
    read[operands[operands < nc]] = True
    fold = (writes == 1) & ~read
    used = np.zeros(R, bool)
    used[dst] = True
    used[operands[operands < R]] = True
    keep = used & ~np.concatenate([fold, np.zeros(R - nc, bool)])
    slot_of = np.cumsum(keep) - 1
    n_scratch = int(keep.sum())
    ld = _odd(wx + n_scratch)

    def offsets(o):
        off = np.where(o < R, wx + slot_of[np.minimum(o, R - 1)],
                       np.where(o < R + wx, o - R,
                                np.where(o < R + 2 * wx,
                                         stride * ld + o - R - wx,
                                         o - R - 2 * wx)))
        return off, o >= R + 2 * wx

    a_off, a_const = offsets(oa)
    b_off, b_const = offsets(ob)
    # a 16-bit offset reaches 2^16 words: past that the tile (and the
    # constant table) would not fit in shared memory anyway
    if max(a_off.max(initial=0), b_off.max(initial=0), stride * ld + wx) \
            >= 1 << 16 or nc >= 1 << _OPCODE_SHIFT:
        raise ValueError(f"the program's tile ({ld} words a row, the next "
                         f"row {stride} rows on) does not fit in "
                         f"{SMEM_BYTES} bytes of shared memory")
    to_fold = (dst < nc) & fold[np.minimum(dst, nc - 1)]
    late = np.nonzero(keep[:nc] & (writes > 0))[0]       # folded at the end
    late_off = wx + slot_of[late]
    is_fold = np.concatenate([to_fold, np.ones(len(late), bool)])
    fold_cons = np.concatenate([dst[to_fold], late])
    chunk = np.arange(len(is_fold)) // OP_CHUNK
    n_chunks = -(-len(is_fold) // OP_CHUNK)
    per_chunk = np.bincount(chunk[is_fold], minlength=n_chunks)
    fold_off = np.concatenate([[0], np.cumsum(per_chunk)])
    local = np.cumsum(is_fold) - 1 - fold_off[chunk]     # a fold's place
    dst_field = np.where(is_fold, local, 0)
    dst_field[:len(dst)][~to_fold] = wx + slot_of[dst[~to_fold]]
    flags = np.concatenate([
        code | a_const * _A_CONST | b_const * _B_CONST | to_fold * _FOLD,
        np.full(len(late), OP_MOV | _FOLD)])
    a_word = np.concatenate([a_off | b_off << 16, late_off | late_off << 16])
    words = np.stack([a_word, dst_field | flags << _OPCODE_SHIFT], axis=1)
    # a zero op after the last where the count is odd: the kernel stages
    # 16 bytes (two ops) at a time
    words = np.concatenate([words, np.zeros((len(words) % 2, 2), np.int64)])
    out = CompiledProgram(ops=words.astype(np.uint32).view(np.int32),
                          n_ops=len(is_fold), fold_cons=fold_cons,
                          fold_off=fold_off,
                          max_folds=int(per_chunk.max(initial=0)),
                          n_scratch=n_scratch, ld=ld,
                          folded_on_write=int(fold.sum()), device_arrays={})
    cache[stride] = out
    return out


def quotient_smem_bytes(n_consts: int, tile: int, stride: int, ld: int,
                        op_chunk: int, max_folds: int,
                        rec_words: int) -> int:
    """Shared memory of one constraint_quotient block: the staged op chunk
    and its fold weights, the constant table (padded to 4 words), the
    staged record and tile + stride rows of ld words."""
    return 4 * (2 * op_chunk + 4 * max_folds + _pad4(n_consts)
                + rec_words + (tile + stride) * ld)


def quotient_args(q: QuotientInputs) -> dict:
    """The kernel's QuotientArgs for q, with the (big, 4) output allocated
    on q.main's device."""
    device = q.main.device
    big = int(q.main.shape[0])
    if big & (big - 1) or big == 0:
        raise ValueError(f"the LDE height {big} is not a power of two")
    prog = q.prog
    main, main_ld, main_w = _slice("main", q.main, big, device)
    prep, prep_ld, prep_w = _slice("prep", q.prep, big, device)
    perm, perm_ld, _ = _slice("perm", q.perm, big, device, 4 * (q.nb + 1))
    if main_w + prep_w + 4 != prog.x_width:
        raise ValueError(f"main {main_w} + prep {prep_w} columns do not "
                         f"match the program's x_width {prog.x_width}")
    for k in ("first", "last", "transition"):
        s = q.sels[k]
        if s.dtype != I64 or s.device != device or \
                tuple(s.shape) != (big,) or not s.is_contiguous():
            raise ValueError(f"selector {k} must be a contiguous ({big},) "
                             f"int64 tensor on {device}")
    n_consts = len(q.consts)
    cp = compile_program(prog, q.stride)
    op_chunk = min(OP_CHUNK, cp.n_ops + cp.n_ops % 2)
    lay, recs = _records(q.plan, QUOTIENT_GROUP, wb=q.wb)
    tile = tile_rows(lambda t: quotient_smem_bytes(
        n_consts, t, q.stride, cp.ld, op_chunk, cp.max_folds,
        lay.rec_words), big)
    fixed = _on_device(cp.device_arrays, device, [("ops", cp.ops),
                                                  ("fold_off", cp.fold_off)])
    rec_off = _on_device(lay.device_arrays, device, [("rec_off", lay.offs)])
    small = _pack(device, [
        ("consts", _mont(q.consts)),
        ("wfold", np.asarray(q.wbase, np.int64)[cp.fold_cons]),
        ("recs", recs), ("wsel", _weights8(q.wsel)), ("cum", q.cum)])
    return dict(
        main=main, main_ld=main_ld, main_w=main_w,
        prep=prep, prep_ld=prep_ld, prep_w=prep_w,
        perm=perm, perm_ld=perm_ld, nb=q.nb,
        first=Ptr(q.sels["first"]), last=Ptr(q.sels["last"]),
        trans=Ptr(q.sels["transition"]),
        log_big=big.bit_length() - 1, stride=q.stride,
        ops=fixed["ops"], n_ops=cp.n_ops, op_chunk=op_chunk,
        fold_off=fixed["fold_off"], max_folds=cp.max_folds,
        wfold=small["wfold"], consts=small["consts"], n_consts=n_consts,
        recs=small["recs"], rec_off=rec_off["rec_off"],
        rec_words=lay.rec_words, group=QUOTIENT_GROUP, wsel=small["wsel"],
        cum=small["cum"], ld=cp.ld, tile=tile,
        out=Ptr(torch.empty((big, 4), dtype=I32, device=device)))


def _to_struct(st_type, fields, args: dict):
    return st_type(*(v.address() if isinstance(v, Ptr) else
                     0 if v is None else int(v)
                     for v in (args[f] for f in fields)))


def resident_blocks(kernel: str, tile: int, smem: int,
                    device: torch.device) -> int:
    """Blocks of `tile` threads and `smem` bytes of constraint_quotient
    (kernel "quotient") or logup_perm_phi ("perm") that one SM of the card
    holds at once."""
    n = _library().lurk_kernel_occupancy(
        device.index if device.index is not None else
        torch.cuda.current_device(), 0 if kernel == "quotient" else 1,
        tile, smem)
    if n < 0:
        raise RuntimeError(f"occupancy of the {kernel} kernel failed")
    return n


def _launch(name: str, fn, st, device) -> None:
    err = fn(device.index, ctypes.byref(st),
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def launch_quotient(args: dict) -> torch.Tensor:
    """Launch constraint_quotient on packed QuotientArgs (quotient_args)
    and count it; returns the (big, 4) int32 output."""
    out = args["out"].tensor
    _launch("constraint_quotient", _library().lurk_constraint_quotient,
            _to_struct(_QuotientArgs, QUOTIENT_FIELDS, args), out.device)
    _count(constraint_quotient)
    return out


def constraint_quotient(q: QuotientInputs) -> torch.Tensor:
    """(big, 4) canonical alpha-fold of one chip's constraints and LogUp
    perm-quotient constraints at every LDE row: int32 from the kernel on a
    CUDA device, int64 from the plain version on the CPU."""
    if _check_device(q.main) == "cpu":
        return quotient_plain(q)
    return launch_quotient(quotient_args(q))


constraint_quotient.launches = 0


# ---------------------------------------------------------------------------
# kernel B: the LogUp perm trace's batch contributions
# ---------------------------------------------------------------------------

def perm_smem_bytes(tile: int, ld: int, rec_words: int) -> int:
    """Shared memory of one logup_perm_phi block: the staged record and
    tile rows of ld words."""
    return 4 * (rec_words + tile * ld)


def perm_args(perm: torch.Tensor, main: torch.Tensor,
              prep: Optional[torch.Tensor], plan: Dict[str, np.ndarray]
              ) -> dict:
    """The kernel's PermArgs: phi into `perm`'s first 4 nb columns from
    the (h, w) trace columns and the plan arrays (pad_d_one off, 2 nb
    interactions). The fingerprints without a row-varying term are
    inverted here, once (0 for 0)."""
    device = main.device
    h = int(main.shape[0])
    nb = int(perm.shape[1]) // 4 - 1
    if nb < 1 or int(perm.shape[1]) != 4 * (nb + 1):
        raise ValueError(f"perm must be (h, 4 (nb + 1)) with nb >= 1, got "
                         f"{tuple(perm.shape)}")
    m, m_ld, m_w = _slice("main", main, h, device)
    p, p_ld, p_w = _slice("prep", prep, h, device)
    out, out_ld, _ = _slice("perm", perm, h, device)
    if plan["dconst"].shape[0] != 2 * nb:
        raise ValueError(f"the plan arrays hold {plan['dconst'].shape[0]} "
                         f"interactions, the perm matrix {nb} batches")
    ld = _odd(m_w + p_w + 3)
    lay, recs = _records(plan, PERM_GROUP, invert_constants=True)
    tile = tile_rows(lambda t: perm_smem_bytes(t, ld, lay.rec_words), h)
    rec_off = _on_device(lay.device_arrays, device, [("rec_off", lay.offs)])
    small = _pack(device, [("recs", recs)])
    return dict(main=m, main_ld=m_ld, main_w=m_w, prep=p, prep_ld=p_ld,
                prep_w=p_w, h=h, nb=nb, recs=small["recs"],
                rec_off=rec_off["rec_off"], rec_words=lay.rec_words, ld=ld,
                tile=tile, out=out, out_ld=out_ld)


def launch_perm(args: dict) -> None:
    """Launch logup_perm_phi on packed PermArgs (perm_args) and count it."""
    _launch("logup_perm_phi", _library().lurk_logup_perm_phi,
            _to_struct(_PermArgs, PERM_FIELDS, args),
            args["out"].tensor.device)
    _count(logup_perm_phi)


def logup_perm_phi(perm: torch.Tensor, main: torch.Tensor,
                   prep: Optional[torch.Tensor], plan: Dict[str, np.ndarray],
                   n_inter_padded: int) -> None:
    """Write every trace row's LogUp batch contributions phi_b = m_2b /
    d_2b + m_2b+1 / d_2b+1 (1/0 taken as 0) into perm[:, :4 nb], canonical;
    the running-sum columns are left as they were. n_inter_padded sizes
    the plain version's row chunks."""
    if _check_device(main) == "cpu":
        return perm_phi_plain(perm, main, prep, plan, n_inter_padded)
    launch_perm(perm_args(perm, main, prep, plan))


logup_perm_phi.launches = 0


# ---------------------------------------------------------------------------
# the plain versions: eager torch ops in int64
# ---------------------------------------------------------------------------

def _fingerprints(X, a):
    """(rows, n, 4) ext fingerprints d = dconst + sum_t tw_t * X[:, ti_t]
    and (rows, n) base multiplicities m = mconst + sum_t mw_t * X[:, mi_t]
    from canonical int64 plan arrays `a` and int64 columns X."""
    D = a["dconst"].expand(X.shape[0], -1, -1)
    for t in range(a["ti"].shape[0]):
        col = X[:, a["ti"][t]]                        # (rows, n)
        D = (D + a["tw"][t] * col[:, :, None] % P) % P
    M = a["mconst"].expand(X.shape[0], -1)
    for t in range(a["mi"].shape[0]):
        M = (M + a["mw"][t] * X[:, a["mi"][t]] % P) % P
    return D, M


def _on(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: bb.upload(np.ascontiguousarray(v, np.int64), device)
            for k, v in arrays.items()}


def perm_phi_plain(perm, main, prep, plan, n_inter_padded: int) -> None:
    """The plain version of logup_perm_phi: the fingerprints of row
    chunks of X = [main | prep | first | last | transition] in int64, their
    inverses times the multiplicities, paired into batches."""
    h = int(main.shape[0])
    nb = int(perm.shape[1]) // 4 - 1
    a = _on(plan, main.device)
    parts = [main] + ([prep] if prep is not None else []) + \
        [dp._x_extras(h, main.device)]
    X = torch.cat(parts, dim=1)
    rows = min(h, dp._gperm_rows(n_inter_padded))
    for c0 in range(0, h, rows):
        D, M = _fingerprints(X[c0:c0 + rows].to(I64), a)
        # padded interactions have D = 0 and M = 0: einv(0) = 0 keeps
        # their contribution zero
        contrib = ext_t.einv(D).to(I64) * M[:, :, None] % P
        phi = (contrib[:, 0::2] + contrib[:, 1::2]) % P      # (rows, nb, 4)
        perm[c0:c0 + rows, :4 * nb] = phi.reshape(-1, 4 * nb).to(I32)


def _vm_eval(prog, consts, local, nxt, weights):
    """Run the VM program over (rows, Wx) int64 local/next columns and
    alpha-fold the constraint registers with canonical ext weights (n_cons,
    4). Returns the (rows, 4) int64 fold."""
    from .constraint_vm import OP_ADD, OP_SUB
    R = prog.n_regs
    Wx = prog.x_width
    regs: list = [None] * R

    def operand(i):
        if i < R:
            return regs[i]
        if i < R + Wx:
            return local[:, i - R]
        if i < R + 2 * Wx:
            return nxt[:, i - R - Wx]
        return consts[i - R - 2 * Wx]

    for o, d, ia, ib in prog.ops.tolist():
        va, vb = operand(ia), operand(ib)
        if o == OP_ADD:
            v = (va + vb) % P
        elif o == OP_SUB:
            v = (va - vb) % P
        else:
            v = va * vb % P
        if not isinstance(v, torch.Tensor):
            v = torch.full((local.shape[0],), v, dtype=I64,
                           device=local.device)
        regs[d] = v
    folded = torch.zeros((local.shape[0], 4), dtype=I64, device=local.device)
    for i in range(prog.n_cons):
        folded = (folded + weights[i] * regs[i][:, None] % P) % P
    return folded


def _pq_eval(a, nb: int, local, nxt, phi_l, phi_n, s_l, s_n, sel_l, cum,
             wb, wsel):
    """LogUp perm-quotient over one row chunk: each batch's lhs - rhs and
    the three running-sum constraints, alpha-folded with canonical ext
    weights wb (nb, 4) and wsel (3, 4). Padded interaction partners carry
    d = 1 and m = 0, so singleton batches fold through."""
    D, M = _fingerprints(local, a)
    d0, d1 = D[:, 0::2], D[:, 1::2]
    m0, m1 = M[:, 0::2], M[:, 1::2]
    lhs = ext_t.emul(ext_t.emul(phi_l, d0), d1).to(I64)
    rhs = (dp._ext_times_base(d1, m0).to(I64)
           + dp._ext_times_base(d0, m1).to(I64)) % P
    outs = (lhs - rhs) % P                                   # (rows, nb, 4)
    folded = torch.zeros((local.shape[0], 4), dtype=I64, device=local.device)
    for b in range(nb):
        folded = (folded + dp.ext_mul_scalar(outs[:, b], wb[b])) % P
    total_phi = dp.mod_tree_sum(phi_l, dim=1)
    total_phi_next = dp.mod_tree_sum(phi_n, dim=1)
    first, last, trans = sel_l
    sel_vals = [
        first[:, None] * ((s_l - total_phi) % P) % P,
        trans[:, None] * ((s_n - s_l - total_phi_next) % P) % P,
        last[:, None] * ((s_l - cum) % P) % P,
    ]
    for k, v in enumerate(sel_vals):
        folded = (folded + dp.ext_mul_scalar(v, wsel[k])) % P
    return folded


def quotient_plain(q: QuotientInputs) -> torch.Tensor:
    """The plain version of constraint_quotient: the VM program and the
    perm-quotient as eager int64 ops over row chunks of _vm_rows rows, each
    with `stride` next rows (wrapping at the end of the LDE)."""
    device = q.main.device
    big = int(q.main.shape[0])
    sels = q.sels
    small = _on(dict(wbase=q.wbase, wb=q.wb, wsel=q.wsel, cum=q.cum), device)
    a = _on(q.plan, device)
    consts = [int(c) for c in q.consts]
    # X = [main | prep | first | last | transition | ones]: the VM's local
    # column space; the plan's indices address its first x_width columns
    parts = [q.main] + ([q.prep] if q.prep is not None else []) + \
        [torch.stack([sels["first"], sels["last"], sels["transition"],
                      torch.ones_like(sels["first"])], dim=1)]
    x_width = sum(int(p.shape[1]) for p in parts)
    rows = min(big, dp._vm_rows(q.prog.n_regs + 2 * x_width))
    nb, stride = q.nb, q.stride
    outs = []
    for c0 in range(0, big, rows):
        # rows c0 .. c0 + rows + stride (mod big) in int64: the chunk's
        # local rows, and `stride` rows on its next rows
        win = torch.cat([dp._window(p, c0, rows, stride, big).to(I64)
                         for p in parts], dim=1)
        pwin = dp._window(q.perm, c0, rows, stride, big).to(I64)
        phi = pwin[:, :4 * nb].reshape(-1, nb, 4)
        s = pwin[:, 4 * nb:4 * nb + 4]
        X, Xn = win[:rows], win[stride:stride + rows]
        sl = slice(c0, c0 + rows)
        sel_l = (sels["first"][sl], sels["last"][sl], sels["transition"][sl])
        folded = _vm_eval(q.prog, consts, X, Xn, small["wbase"])
        folded = (folded + _pq_eval(a, nb, X, Xn, phi[:rows],
                                    phi[stride:stride + rows], s[:rows],
                                    s[stride:stride + rows], sel_l,
                                    small["cum"], small["wb"],
                                    small["wsel"])) % P
        outs.append(folded)
    return torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
