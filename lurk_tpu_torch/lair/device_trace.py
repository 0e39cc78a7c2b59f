"""Device-resident witness generation: trace rows populated on the card.

The counterpart of lurk_tpu/lair/device_trace.py. Host trace generation
(trace.py) materializes every padded trace cell on the host and uploads
it; here each big func chip receives only its dense query streams (args,
outputs, requires, hints, depths) and every derived column (require
inverses, Mul/Inv/Not witnesses, AssertNe one-hots, depth less-than
witnesses, selectors) is computed on the device that holds the trace.

Design: witness generation as data, not programs. Each (func, path) row
group executes one straight-line op sequence (trace.py groups rows the
same way), so the op replay is compiled once into a small register
bytecode (the PathPlan compiler below, lurk_tpu's verbatim) and run by
one VM shared by every func and path. On a CUDA device the VM is one
hand-written kernel (csrc/witness.cu, lair/witness_kernel.py): the chip's
raw query streams go up once and one launch writes the whole trace. On
the CPU the eager VM below is its plain version: it walks the bytecode in
Python over whole-group tensors, one torch op per instruction over every
row of the group, with the instructions in host numpy.

Bit-exactness contract: output rows are identical to
FuncChip.generate_trace (tests/test_torch_device_trace.py) — mod-p
arithmetic is exact, field inverses are unique (INVZ maps 0 to 0, as
batch_inv does), and the compiler mirrors _replay_op's column order
instruction for instruction.

Funcs whose paths contain ExternCall ops (hash/u64 gadget witnesses) stay
on the host path, except the terminal hashers (hash3/4/5), whose wide
Poseidon2 witness columns come from poseidon/witness.py's torch path.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..field import babybear as bb
from ..stark import spans
from . import bytecode as B
from .func_chip import DEPTH_W, DEPTH_LT_NUM_REQUIRES

I32 = torch.int32
I64 = torch.int64
P = bb.P

# VM opcodes. Every op reads registers a (and b), writes register dst.
NOP = 0          # write 0 to the scratch register
ADD = 1          # dst = a + b mod p
SUB = 2          # dst = a - b mod p
MUL = 3          # dst = a * b mod p
INVZ = 4         # dst = a^(p-2) mod p (0 -> 0)
EQZ = 5          # dst = (a == 0) ? 1 : 0
CONST = 6        # dst = immediate (in field a)
_N_OPS = 7


# ---------------------------------------------------------------------------
# compiler: (func, path) -> PathPlan
# ---------------------------------------------------------------------------

@dataclass
class PathPlan:
    """Register program + stream placement tables for one (func, path).

    Registers [0, width) are the trace row's columns (nonce | input |
    output | aux | sel); register `width` is the NOP scratch slot; higher
    registers are temps. Stream-derived columns are scattered into the
    register file before the VM runs; the VM fills the computed columns.
    """
    width: int
    n_reg: int
    instrs: np.ndarray          # (I, 4) int32: op, dst, a, b
    in_off: int
    n_in: int
    out_off: int
    n_out: int
    sel_col: int
    prov_cols: Tuple[int, int]
    # requires: func-intro depth-requires + op requires + per-call depth
    # requires, in replay order. Each entry consumes one (nonce, count)
    # pair from the interleaved require stream and fills 3 columns.
    req_cols: np.ndarray        # (R, 3) int32 target cols (nonce,count,inv)
    req_src: np.ndarray         # (R,) int32: 0 = requires stream, 1 = dreqs
    n_req: int                  # ordinary requires consumed
    n_dreq: int                 # depth-requires consumed
    hint_cols: np.ndarray       # (H,) int32: target col per hint (-1 = none)
    n_hint: int
    depth_cols: np.ndarray      # (DEPTH_W,) own-depth byte cols (or empty)
    # depth less-than witnesses: one per partial Call/PreImg.
    # dep value = hint index; emits dep bytes (4) + is_comp (4) + lhs + rhs
    dlt_hint_idx: np.ndarray    # (C,) int32 hint index of the dep value
    dlt_cols: np.ndarray        # (C, 10) int32 target cols


class _SymReg:
    __slots__ = ("reg", "deg")

    def __init__(self, reg: int, deg: int):
        self.reg = reg
        self.deg = deg


class _Compiler:
    """Mirrors trace._ReplayCtx/_replay_op symbolically: same aux column
    order, same hint/require consumption order, registers instead of
    numpy arrays."""

    def __init__(self, chip, path_ident: int):
        func = chip.func
        layout = chip.layout
        self.toplevel = chip.toplevel
        self.width = layout.total
        self.in_off = 1
        self.out_off = self.in_off + layout.input
        self.aux_off = self.out_off + layout.output
        self.sel_off = self.aux_off + layout.aux
        self.aux_i = 0
        self.next_temp = self.width + 1      # width = scratch slot
        self.instrs: List[Tuple[int, int, int, int]] = []
        self.req_cols: List[Tuple[int, int, int]] = []
        self.req_src: List[int] = []
        self.n_req = 0
        self.n_dreq = 0
        self.hint_cols: List[int] = []
        self.depth_cols: List[int] = []
        self.dlt_hint_idx: List[int] = []
        self.dlt_cols: List[List[int]] = []
        self.const_regs: Dict[int, int] = {}

        prog = chip.paths[path_ident]
        self.the_map: List[_SymReg] = [
            _SymReg(self.in_off + j, 1) for j in range(layout.input)
        ]
        # provide columns (nonce, count) — stream-derived
        self.prov_cols = (self._aux_col(), self._aux_col())
        if func.partial:
            for _ in range(DEPTH_W):
                self.depth_cols.append(self._aux_col())
            for _ in range(DEPTH_W // 2 + DEPTH_W % 2):
                self._push_require(dreq=True)
        for op in prog.ops:
            self._compile_op(op)
        self.sel_col = self.sel_off + path_ident
        self.n_in = layout.input
        self.n_out = layout.output

    # -- column / register helpers ---------------------------------------
    def _aux_col(self) -> int:
        c = self.aux_off + self.aux_i
        self.aux_i += 1
        return c

    def _temp(self) -> int:
        t = self.next_temp
        self.next_temp += 1
        return t

    def _emit(self, op, dst, a=0, b=0):
        self.instrs.append((op, dst, a, b))

    def _const(self, val: int) -> int:
        r = self.const_regs.get(val)
        if r is None:
            r = self._temp()
            self._emit(CONST, r, int(val) % bb.P, 0)
            self.const_regs[val] = r
        return r

    def _push_require(self, dreq: bool = False):
        self.req_cols.append((self._aux_col(), self._aux_col(),
                              self._aux_col()))
        self.req_src.append(1 if dreq else 0)
        if dreq:
            self.n_dreq += 1
        else:
            self.n_req += 1

    def _next_hint_col(self) -> Tuple[int, int]:
        """Returns (hint index, register) for a hint that IS an aux col."""
        idx = len(self.hint_cols)
        col = self._aux_col()
        self.hint_cols.append(col)
        return idx, col

    def _next_hint_nocol(self) -> int:
        """Hint consumed but not emitted as a column (dep depths)."""
        idx = len(self.hint_cols)
        self.hint_cols.append(-1)
        return idx

    def _push_depth(self, dep_hint_idx: int):
        cols = []
        for _ in range(DEPTH_W):                 # dep depth bytes
            cols.append(self._aux_col())
        for _ in range(DEPTH_W):                 # is_comp one-hot
            cols.append(self._aux_col())
        cols.append(self._aux_col())             # lhs limb
        cols.append(self._aux_col())             # rhs limb
        self.dlt_hint_idx.append(dep_hint_idx)
        self.dlt_cols.append(cols)
        for _ in range(DEPTH_LT_NUM_REQUIRES):
            self._push_require(dreq=True)

    # -- op compilation (mirrors trace._replay_op) -------------------------
    def _compile_op(self, op):
        t = type(op)
        m = self.the_map
        if t is B.AssertEq:
            pass
        elif t is B.AssertNe:
            # first-nonzero one-hot with inverse, linearized:
            #   nz_j   = 1 - (d_j == 0)
            #   first  = nz_j * (1 - seen)        (seen starts at 0)
            #   col_j  = first * d_j^-1
            #   seen  += first
            one = self._const(1)
            seen = None
            for a, b_ in zip(op.a, op.b):
                d = self._temp()
                self._emit(SUB, d, m[a].reg, m[b_].reg)
                ez = self._temp()
                self._emit(EQZ, ez, d)
                nz = self._temp()
                self._emit(SUB, nz, one, ez)
                if seen is None:
                    first = nz
                else:
                    ns = self._temp()
                    self._emit(SUB, ns, one, seen)
                    first = self._temp()
                    self._emit(MUL, first, nz, ns)
                inv = self._temp()
                self._emit(INVZ, inv, d)
                col = self._aux_col()
                self._emit(MUL, col, first, inv)
                if seen is None:
                    seen = first
                else:
                    ns2 = self._temp()
                    self._emit(ADD, ns2, seen, first)
                    seen = ns2
        elif t is B.Contains:
            b_ = m[op.b].reg
            acc = None
            for a in op.a:
                d = self._temp()
                self._emit(SUB, d, m[a].reg, b_)
                if acc is None:
                    acc = d
                else:
                    col = self._aux_col()
                    self._emit(MUL, col, acc, d)
                    acc = col
        elif t is B.Const:
            m.append(_SymReg(self._const(op.val), 0))
        elif t in (B.Add, B.Sub, B.Mul):
            a, b_ = m[op.a], m[op.b]
            if t is B.Add:
                r = self._temp()
                self._emit(ADD, r, a.reg, b_.reg)
                m.append(_SymReg(r, max(a.deg, b_.deg)))
            elif t is B.Sub:
                r = self._temp()
                self._emit(SUB, r, a.reg, b_.reg)
                m.append(_SymReg(r, max(a.deg, b_.deg)))
            else:
                deg = a.deg + b_.deg
                if deg < 2:
                    r = self._temp()
                    self._emit(MUL, r, a.reg, b_.reg)
                    m.append(_SymReg(r, deg))
                else:
                    col = self._aux_col()
                    self._emit(MUL, col, a.reg, b_.reg)
                    m.append(_SymReg(col, 1))
        elif t is B.Inv:
            a = m[op.a]
            if a.deg == 0:
                r = self._temp()
                self._emit(INVZ, r, a.reg)
                m.append(_SymReg(r, 0))
            else:
                col = self._aux_col()
                self._emit(INVZ, col, a.reg)
                m.append(_SymReg(col, 1))
        elif t is B.Not:
            a = m[op.a]
            if a.deg == 0:
                r = self._temp()
                self._emit(EQZ, r, a.reg)
                m.append(_SymReg(r, 0))
            else:
                dcol = self._aux_col()
                self._emit(INVZ, dcol, a.reg)
                fcol = self._aux_col()
                self._emit(EQZ, fcol, a.reg)
                m.append(_SymReg(fcol, 1))
        elif t in (B.Call, B.PreImg):
            func = self.toplevel.func_by_index(op.func_idx)
            n_vals = (func.output_size if t is B.Call else func.input_size)
            for _ in range(n_vals):
                _, col = self._next_hint_col()
                m.append(_SymReg(col, 1))
            self._push_require()
            if func.partial:
                dep_idx = self._next_hint_nocol()
                self._push_depth(dep_idx)
        elif t is B.Store:
            _, col = self._next_hint_col()
            m.append(_SymReg(col, 1))
            self._push_require()
        elif t is B.Load:
            for _ in range(op.len):
                _, col = self._next_hint_col()
                m.append(_SymReg(col, 1))
            self._push_require()
        elif t is B.ExternCall:
            raise _HasExtern()
        elif t is B.RangeU8:
            for _ in range(len(op.vals) // 2 + len(op.vals) % 2):
                self._push_require()
        elif t in (B.Emit, B.Breakpoint, B.Debug):
            pass
        else:
            raise TypeError(op)

    def plan(self) -> PathPlan:
        instrs = (np.asarray(self.instrs, np.int32).reshape(-1, 4)
                  if self.instrs else np.zeros((0, 4), np.int32))
        return PathPlan(
            width=self.width,
            n_reg=self.next_temp,
            instrs=instrs,
            in_off=self.in_off, n_in=self.n_in,
            out_off=self.out_off, n_out=self.n_out,
            sel_col=self.sel_col,
            prov_cols=self.prov_cols,
            req_cols=(np.asarray(self.req_cols, np.int32).reshape(-1, 3)
                      if self.req_cols else np.zeros((0, 3), np.int32)),
            req_src=np.asarray(self.req_src, np.int32),
            n_req=self.n_req, n_dreq=self.n_dreq,
            hint_cols=np.asarray(self.hint_cols, np.int32),
            n_hint=len(self.hint_cols),
            depth_cols=np.asarray(self.depth_cols, np.int32),
            dlt_hint_idx=np.asarray(self.dlt_hint_idx, np.int32),
            dlt_cols=(np.asarray(self.dlt_cols, np.int32).reshape(-1, 10)
                      if self.dlt_cols else np.zeros((0, 10), np.int32)),
        )


class _HasExtern(Exception):
    pass


@lru_cache(maxsize=None)
def _plans_for(chip_key) -> Optional[Dict[int, PathPlan]]:
    """Compile every path of a FuncChip; None if any path has externs.
    chip_key is the FuncChip itself (hashable by identity; FuncChips are
    cached per machine)."""
    chip = chip_key
    if not hasattr(chip, "paths") or not hasattr(chip, "func"):
        return None        # only FuncChips replay path programs
    plans = {}
    try:
        for ident in chip.paths:
            plans[ident] = _Compiler(chip, ident).plan()
    except _HasExtern:
        return None
    return plans


# ---------------------------------------------------------------------------
# the VM
# ---------------------------------------------------------------------------

def _bucket(n: int, granule: int) -> int:
    return max(granule, ((n + granule - 1) // granule) * granule)


def _pow2_bucket(n: int, lo: int = 1 << 12, hi: int = 1 << 18) -> int:
    b = lo
    while b < min(n, hi):
        b <<= 1
    return b


def _up(a: np.ndarray, device) -> torch.Tensor:
    """Host integer array -> int64 tensor on device: a `witness.upload`
    span of a recorded prove."""
    with spans.span("witness.upload", each=True):
        return bb.upload(np.ascontiguousarray(a, np.int64), device)


def _finv(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) on canonical int64 values: the field inverse, 0 -> 0."""
    return bb._pow64(x, P - 2)


def _witness_vm(instrs: np.ndarray, X: torch.Tensor, reqs, req_tgts,
                hints, hint_tgts, dlt_deps, dlt_tgts, own_depth,
                depth_w: int, width: int) -> torch.Tensor:
    """Fill one row group's register file and return its first `width`
    registers as the (mp, width) int32 row block.

    X:         (n_reg, mp) int64 — stream-preplaced registers (nonce,
               args, outputs, provide, own-depth bytes, selector), zeros
               elsewhere; written in place
    reqs:      (R, 2, mp) int64 nonce/count per require (replay order);
               req_tgts (R, 3) int64 target registers
    hints:     (H, mp) int64; hint_tgts (H,) int64 target register, or the
               scratch register for non-column hints
    dlt_deps:  (C, mp) int64 dep depth values; dlt_tgts (C, 10) int64
    own_depth: (mp,) int64 (zeros when the func is not partial)
    instrs:    (I, 4) host int32 op, dst, a, b
    """
    # hints straight into their columns (scratch row for dep-only hints)
    if hints.shape[0]:
        X[hint_tgts] = hints

    # require triples: nonce, count, (count+1)^-1
    if reqs.shape[0]:
        X[req_tgts[:, 0]] = reqs[:, 0]
        X[req_tgts[:, 1]] = reqs[:, 1]
        X[req_tgts[:, 2]] = _finv((reqs[:, 1] + 1) % P)

    # depth less-than witnesses: dep bytes + most-significant differing
    # byte one-hot + compared limbs (mirrors trace._ReplayCtx.push_depth).
    # Shifts run on int64, so depths at or above 2^31 shift correctly.
    if dlt_deps.shape[0]:
        C, mp = dlt_deps.shape
        shifts = torch.arange(depth_w, dtype=I64, device=X.device) * 8
        lhs = (dlt_deps[:, None, :] >> shifts[None, :, None]) & 0xFF
        rhs = ((own_depth[None, None, :] >> shifts[None, :, None]) & 0xFF
               ).expand(C, depth_w, mp)
        # the most significant differing byte: the first True of the
        # reversed byte axis (torch.argmax returns the first maximum); no
        # difference at all gives byte depth_w - 1, as in lurk_tpu
        rev = (lhs != rhs).flip(1).to(torch.uint8)
        ms = (depth_w - 1) - torch.argmax(rev, dim=1)           # (C, mp)
        is_comp = (torch.arange(depth_w, device=X.device)[None, :, None]
                   == ms[:, None, :]).to(I64)
        lhs_ms = torch.gather(lhs, 1, ms[:, None, :])
        rhs_ms = torch.gather(rhs, 1, ms[:, None, :])
        block = torch.cat([lhs, is_comp, lhs_ms, rhs_ms], dim=1)
        X[dlt_tgts.reshape(-1)] = block.reshape(-1, mp)

    # the register program: one whole-group op per instruction. Registers
    # are rows of X; a result replaces its destination row's tensor in the
    # list (operands are read before the write, as in lurk_tpu's scan).
    regs = list(X.unbind(0))
    for op, dst, a, b_ in instrs.tolist():
        if op == ADD:
            v = (regs[a] + regs[b_]) % P
        elif op == SUB:
            v = (regs[a] - regs[b_]) % P
        elif op == MUL:
            v = regs[a] * regs[b_] % P
        elif op == INVZ:
            v = _finv(regs[a])
        elif op == EQZ:
            v = (regs[a] == 0).to(I64)
        elif op == CONST:
            v = torch.full_like(regs[dst], a)
        else:                                                   # NOP
            v = torch.zeros_like(regs[dst])
        regs[dst] = v
    return torch.stack(regs[:width], dim=1).to(I32)


def _init_trace(height: int, width: int, start: int, device) -> torch.Tensor:
    """(height, width) int32 zeros with column 0 = row index + start (the
    host trace's padding nonces)."""
    t = torch.zeros((height, width), dtype=I32, device=device)
    t[:, 0] = (torch.arange(height, dtype=I64, device=device)
               + start).to(I32)
    return t


def _scatter_rows(trace, block, ridx: np.ndarray):
    """Write the group's m real rows of `block` at trace rows `ridx`; the
    bucket's padding rows (block rows m and up) are never written."""
    m = len(ridx)
    trace[_up(ridx, trace.device)] = block[:m]
    return trace


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def supported(chip) -> bool:
    """True when the chip generates on device: every path compiles to
    the VM (no externs), or the func is a terminal hasher."""
    return _hasher_width(chip) is not None or _plans_for(chip) is not None


def _hasher_width(chip) -> Optional[int]:
    """Poseidon width for 'terminal hasher' funcs — body is exactly ONE
    ExternCall to a requires-free hasher chipset followed by Return
    (hash3/hash4/hash5, core/misc.py). These are the widest traces in
    the Lurk machine (reference: src/poseidon/wide/columns.rs:8-41) and
    fully straight-line, so their witness is generated on device by the
    batched torch permutation witness instead of the register VM."""
    func = getattr(chip, "func", None)
    if func is None:                 # Mem/Bytes/Entrypoint chips
        return None
    body = func.body
    if func.partial or len(body.ops) != 1:
        return None
    op = body.ops[0]
    if not isinstance(op, B.ExternCall) or not isinstance(body.ctrl,
                                                          B.Return):
        return None
    ext = chip.toplevel.chip_by_index(op.chip_idx)
    width = getattr(ext, "width", None)
    if width is None or getattr(ext, "require_size", 1) != 0 or \
            not hasattr(ext, "populate_witness_batch") or \
            type(ext).__name__ != "HasherChip":
        return None
    from ..poseidon.witness import num_cols
    expect = 1 + func.input_size + func.output_size + 2 \
        + (8 + num_cols(width)) + 1
    if chip.width != expect or len(op.inp) != width:
        return None
    return width


def _hasher_trace_device(chip, shard, width: int, device) -> torch.Tensor:
    """(height, chip.width) device trace for a terminal-hasher func:
    row = [nonce | preimg(W) | img(8) | provide(2) | out8+wide witness |
    sel]. Streams uploaded: args/outputs/provide only (~W+10 values/row);
    the hundreds of witness columns are born on the device. A
    `witness.hasher` span of a recorded prove (its uploads are
    `witness.upload` spans inside it); its real rows count as
    `hasher_rows`."""
    with spans.span("witness.hasher", each=True):
        return _hasher_trace(chip, shard, width, device)


def _hasher_trace(chip, shard, width: int, device) -> torch.Tensor:
    from ..poseidon.witness import populate_batch_device
    from .trace import next_power_of_two
    fq = shard.queries.func_queries[chip.func.index]
    rng = shard.get_func_range(chip.func.index)
    n = len(rng)
    spans.count("hasher_rows", n)
    height = next_power_of_two(n)
    trace = _init_trace(height, chip.width, rng.start, device)
    if n == 0:
        return trace
    m = n
    mp = _pow2_bucket(m)

    def pad(a):
        return np.pad(a, [(0, mp - a.shape[0])] + [(0, 0)] *
                      (a.ndim - 1)) if a.shape[0] != mp else a

    args = _up(pad(fq.args[rng.start:rng.stop]), device)
    outs = _up(pad(fq.outputs[rng.start:rng.stop]), device)
    prov = _up(pad(fq.provide[rng.start:rng.stop]), device)
    nonce = _up(pad((np.arange(rng.start, rng.stop, dtype=np.uint64)
                     % np.uint64(bb.P))[:, None]), device)
    witness, _result = populate_batch_device(width, args)
    sel = torch.ones((mp, 1), dtype=I64, device=device)
    block = torch.cat([nonce, args, outs, prov, witness.to(I64), sel],
                      dim=1).to(I32)
    return _scatter_rows(trace, block, np.arange(m, dtype=np.int64))


def generate_trace_device(chip, shard, device) -> Optional[torch.Tensor]:
    """Device-resident equivalent of FuncChip.generate_trace: returns the
    full (height, width) int32 trace as a tensor on `device`, or None when
    the chip can't run on the VM (extern paths other than terminal
    hashers / non-columnar query maps). A VM chip's rows come from one
    launch of csrc/witness.cu on a CUDA device (witness_kernel.py) and
    from plain_trace, its plain version, on the CPU."""
    from .columnar import ColumnarQueryMap
    device = torch.device(device)
    hw = _hasher_width(chip)
    if hw is None and _plans_for(chip) is None:
        return None
    fq = shard.queries.func_queries[chip.func.index]
    if not isinstance(fq, ColumnarQueryMap):
        return None
    if hw is not None:
        return _hasher_trace_device(chip, shard, hw, device)
    if device.type == "cuda" and len(shard.get_func_range(chip.func.index)):
        from .witness_kernel import witness_trace
        return witness_trace(chip, shard, device)
    return plain_trace(chip, shard, device)


def plain_trace(chip, shard, device) -> torch.Tensor:
    """The witness kernel's plain version, on any device: the trace of a
    VM chip (its paths compile, its queries are columnar) from eager row
    groups, one per path, each gathered and padded on the host, uploaded,
    run through _witness_vm and scattered into the rows."""
    plans = _plans_for(chip)
    fq = shard.queries.func_queries[chip.func.index]
    rng = shard.get_func_range(chip.func.index)
    from .trace import next_power_of_two
    trace = _init_trace(next_power_of_two(len(rng)), chip.width, rng.start,
                        torch.device(device))
    paths_arr = fq.path[rng.start:rng.stop]
    partial_func = chip.func.partial
    for p in np.unique(paths_arr):
        plan = plans[int(p)]
        ridx_all = np.nonzero(paths_arr == p)[0].astype(np.int64)
        qidx_all = ridx_all + rng.start
        # chunk the group so the register file stays bounded
        chunk = 1 << 18
        for c0 in range(0, len(ridx_all), chunk):
            ridx = ridx_all[c0:c0 + chunk]
            qidx = qidx_all[c0:c0 + chunk]
            trace = _run_group(trace, plan, fq, ridx, qidx, partial_func)
    return trace


def _gather_seg(offs: np.ndarray, flat: np.ndarray, qidx: np.ndarray,
                k: int) -> np.ndarray:
    """(m, k) segment gather (host: the streams live in host memory)."""
    if k == 0:
        return np.zeros((len(qidx), 0), flat.dtype)
    starts = offs[qidx].astype(np.int64)
    return flat[starts[:, None] + np.arange(k, dtype=np.int64)[None, :]]


def _run_group(trace, plan: PathPlan, fq, ridx: np.ndarray,
               qidx: np.ndarray, partial_func: bool):
    device = trace.device
    m = len(ridx)
    mp = _pow2_bucket(m)
    n_reg = _bucket(plan.n_reg + 1, 16)
    scratch = n_reg - 1

    def pad_rows(a: np.ndarray) -> np.ndarray:
        if a.shape[-1] == mp:
            return a
        pad = [(0, 0)] * (a.ndim - 1) + [(0, mp - a.shape[-1])]
        return np.pad(a, pad)

    # ---- stream-preplaced registers: only the placed rows are uploaded,
    # then scattered into the zeroed register file on the device ----------
    x0_rows: List[np.ndarray] = []
    x0_tgts: List[int] = []

    def place(cols, mat):
        # cols: list/array of register ids; mat (m, k)
        for j, c in enumerate(np.atleast_1d(np.asarray(cols, np.int64))):
            x0_tgts.append(int(c))
            x0_rows.append(np.asarray(mat[:, j], np.int64))

    P64 = np.uint64(bb.P)
    place([0], qidx[:, None].astype(np.uint64) % P64)
    if plan.n_in:
        place(range(plan.in_off, plan.in_off + plan.n_in), fq.args[qidx])
    if plan.n_out:
        place(range(plan.out_off, plan.out_off + plan.n_out),
              fq.outputs[qidx])
    place(list(plan.prov_cols), fq.provide[qidx])
    depth = fq.depth[qidx].astype(np.int64)
    if partial_func and len(plan.depth_cols):
        dbytes = np.stack([(depth >> (8 * b)) & 0xFF
                           for b in range(DEPTH_W)], axis=1)
        place(plan.depth_cols, dbytes)
    place([plan.sel_col], np.ones((m, 1), np.int64))

    X = torch.zeros((n_reg, mp), dtype=I64, device=device)
    X[_up(x0_tgts, device)] = _up(pad_rows(np.stack(x0_rows, axis=0)),
                                  device)

    # ---- require streams, interleaved in replay order -------------------
    R = plan.req_cols.shape[0]
    reqs = np.zeros((R, 2, mp), np.int64)
    if R:
        ord_req = _gather_seg(fq.req_offs, fq.req_flat, qidx,
                              2 * plan.n_req).reshape(m, plan.n_req, 2)
        dreq = _gather_seg(fq.dreq_offs, fq.dreq_flat, qidx,
                           2 * plan.n_dreq).reshape(m, plan.n_dreq, 2)
        i_r = i_d = 0
        for i, src in enumerate(plan.req_src):
            if src == 0:
                reqs[i, :, :m] = ord_req[:, i_r].T
                i_r += 1
            else:
                reqs[i, :, :m] = dreq[:, i_d].T
                i_d += 1
    req_tgts = plan.req_cols if R else np.zeros((0, 3), np.int32)

    # ---- hints -----------------------------------------------------------
    H = plan.n_hint
    hints = _gather_seg(fq.hint_offs, fq.hint_flat, qidx, H)
    hints = pad_rows(hints.astype(np.int64).T) if H else \
        np.zeros((0, mp), np.int64)
    hint_tgts = np.where(plan.hint_cols < 0, scratch, plan.hint_cols)

    # ---- depth less-than deps -------------------------------------------
    C = plan.dlt_cols.shape[0]
    if C:
        dlt_deps = hints[plan.dlt_hint_idx]
        own = pad_rows(depth)
    else:
        dlt_deps = np.zeros((0, mp), np.int64)
        own = np.zeros(mp, np.int64)

    block = _witness_vm(plan.instrs, X, _up(reqs, device),
                        _up(req_tgts, device), _up(hints, device),
                        _up(hint_tgts, device), _up(dlt_deps, device),
                        _up(plan.dlt_cols, device), _up(own, device),
                        DEPTH_W, plan.width)
    return _scatter_rows(trace, block, ridx)
