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
does not take and RuntimeError on a failed build or launch; each counts
its kernel launches in `.launches`, under a lock, since
parallel/shard_prover.py proves from one thread per device slot. The
library builds at first use (utils/cuda_build.py), launches on PyTorch's
current stream and leaves the calling thread's current device as it was.

`quotient_args(q)` and `perm_args(...)` pack what each kernel reads, field
for field in the order of its C structure: a Ptr for each pointer (the
LDE slices in place, with their row strides; the small arrays in one
uploaded int32 buffer), an int for each count. The CPU tests read the
packing back with a numpy interpreter of the kernels.
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

P = bb.P
I32 = bb.I32
I64 = bb.I64
_LOCK = threading.Lock()
# rows of one constraint_quotient launch: its (n_regs, rows) int32
# register file stays near this many bytes
SCRATCH_BYTES = 1 << 28
_BLOCK = 256

QUOTIENT_FIELDS = (
    "main", "main_ld", "main_w", "prep", "prep_ld", "prep_w", "perm",
    "perm_ld", "nb", "first", "last", "trans", "log_big", "stride", "ops",
    "n_ops", "n_regs", "consts", "n_consts", "wbase", "n_cons", "wb", "wsel",
    "ti", "tw", "n_t", "dconst", "mi", "mw", "n_m", "mconst", "cum",
    "scratch", "scratch_ld", "out")
PERM_FIELDS = (
    "main", "main_ld", "main_w", "prep", "prep_ld", "prep_w", "h", "nb",
    "ti", "tw", "n_t", "dconst", "mi", "mw", "n_m", "mconst", "out",
    "out_ld")
# the plan arrays in the packed buffer's order
_PLAN_KEYS = ("ti", "tw", "dconst", "mi", "mw", "mconst")


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
               "log_big", "stride", "n_ops", "n_regs", "n_consts", "n_cons",
               "n_t", "n_m", "scratch_ld", "h", "out_ld"}


def _struct(name: str, fields) -> type:
    return type(name, (ctypes.Structure,), {"_fields_": [
        (f, ctypes.c_longlong if f in _INT_FIELDS else ctypes.c_void_p)
        for f in fields]})


_QuotientArgs = _struct("QuotientArgs", QUOTIENT_FIELDS)
_PermArgs = _struct("PermArgs", PERM_FIELDS)


def build(verbose: bool = False):
    """Compile csrc/quotient.cu (with csrc/babybear.cuh) into build/."""
    return cuda_build.build("quotient", "quotient.cu", ("babybear.cuh",),
                            verbose=verbose)


@lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for fn in ("lurk_quotient_args_size", "lurk_perm_args_size"):
        getattr(lib, fn).restype = ll
        getattr(lib, fn).argtypes = []
    lib.lurk_constraint_quotient.restype = ctypes.c_int
    lib.lurk_constraint_quotient.argtypes = [ctypes.c_int, vp, ll, ll, vp]
    lib.lurk_logup_perm_phi.restype = ctypes.c_int
    lib.lurk_logup_perm_phi.argtypes = [ctypes.c_int, vp, vp]
    for fn, st in (("lurk_quotient_args_size", _QuotientArgs),
                   ("lurk_perm_args_size", _PermArgs)):
        if getattr(lib, fn)() != ctypes.sizeof(st):
            raise RuntimeError(f"{st.__name__}: the library's layout is "
                               f"{getattr(lib, fn)()} bytes, the wrapper's "
                               f"{ctypes.sizeof(st)}")
    return lib


def _pack(device, arrays) -> Dict[str, Ptr]:
    """Upload canonical arrays as one int32 buffer: name -> Ptr into it."""
    flats = [np.ascontiguousarray(a, np.int64).reshape(-1) for _, a in arrays]
    sizes = [len(f) for f in flats]
    buf = torch.from_numpy(np.concatenate(flats).astype(np.int32)
                           if flats else np.zeros(0, np.int32)).to(device)
    offs = np.cumsum([0] + sizes[:-1])
    return {name: Ptr(buf, int(off)) for (name, _), off in zip(arrays, offs)}


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


def launch_rows(n_regs: int, big: int) -> int:
    """Rows of one constraint_quotient launch: a power of two whose
    register file is at most SCRATCH_BYTES (at least one block of rows),
    and no more than the LDE."""
    rows = _BLOCK
    while rows * 2 <= big and rows * 2 * 4 * n_regs <= SCRATCH_BYTES:
        rows *= 2
    return min(rows, big)


def quotient_args(q: QuotientInputs) -> dict:
    """The kernel's QuotientArgs for q, with the register file and the
    (big, 4) output allocated on q.main's device."""
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
    small = _pack(device, [("ops", prog.ops), ("consts", q.consts),
                           ("wbase", q.wbase), ("wb", q.wb),
                           ("wsel", q.wsel), ("cum", q.cum)]
                  + [(k, q.plan[k]) for k in _PLAN_KEYS])
    rows = launch_rows(prog.n_regs, big)
    return dict(
        main=main, main_ld=main_ld, main_w=main_w,
        prep=prep, prep_ld=prep_ld, prep_w=prep_w,
        perm=perm, perm_ld=perm_ld, nb=q.nb,
        first=Ptr(q.sels["first"]), last=Ptr(q.sels["last"]),
        trans=Ptr(q.sels["transition"]),
        log_big=big.bit_length() - 1, stride=q.stride,
        ops=small["ops"], n_ops=int(prog.ops.shape[0]),
        n_regs=prog.n_regs, consts=small["consts"],
        n_consts=int(len(q.consts)), wbase=small["wbase"],
        n_cons=prog.n_cons, wb=small["wb"], wsel=small["wsel"],
        ti=small["ti"], tw=small["tw"], n_t=int(q.plan["ti"].shape[0]),
        dconst=small["dconst"], mi=small["mi"], mw=small["mw"],
        n_m=int(q.plan["mi"].shape[0]), mconst=small["mconst"],
        cum=small["cum"],
        scratch=Ptr(torch.empty((prog.n_regs, rows), dtype=I32,
                                device=device)),
        scratch_ld=rows,
        out=Ptr(torch.empty((big, 4), dtype=I32, device=device)))


def _to_struct(st_type, fields, args: dict):
    vals = {}
    for f in fields:
        v = args[f]
        vals[f] = v.address() if isinstance(v, Ptr) else \
            (0 if v is None else int(v))
    return st_type(**vals)


def constraint_quotient(q: QuotientInputs) -> torch.Tensor:
    """(big, 4) canonical alpha-fold of one chip's constraints and LogUp
    perm-quotient constraints at every LDE row: int32 from the kernel on a
    CUDA device, int64 from the plain version on the CPU."""
    if _check_device(q.main) == "cpu":
        return quotient_plain(q)
    args = quotient_args(q)
    st = _to_struct(_QuotientArgs, QUOTIENT_FIELDS, args)
    lib = _library()
    device = q.main.device
    stream = torch.cuda.current_stream(device).cuda_stream
    big, rows = 1 << args["log_big"], args["scratch_ld"]
    for row0 in range(0, big, rows):
        err = lib.lurk_constraint_quotient(device.index, ctypes.byref(st),
                                           row0, min(rows, big - row0),
                                           stream)
        if err != 0:
            raise RuntimeError(f"constraint_quotient launch failed: "
                               f"cudaError {err}")
        _count(constraint_quotient)
    return args["out"].tensor


constraint_quotient.launches = 0


# ---------------------------------------------------------------------------
# kernel B: the LogUp perm trace's batch contributions
# ---------------------------------------------------------------------------

def perm_args(perm: torch.Tensor, main: torch.Tensor,
              prep: Optional[torch.Tensor], plan: Dict[str, np.ndarray]
              ) -> dict:
    """The kernel's PermArgs: phi into `perm`'s first 4 nb columns from
    the (h, w) trace columns and the plan arrays (pad_d_one off, 2 nb
    interactions)."""
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
    small = _pack(device, [(k, plan[k]) for k in _PLAN_KEYS])
    return dict(main=m, main_ld=m_ld, main_w=m_w, prep=p, prep_ld=p_ld,
                prep_w=p_w, h=h, nb=nb, ti=small["ti"], tw=small["tw"],
                n_t=int(plan["ti"].shape[0]), dconst=small["dconst"],
                mi=small["mi"], mw=small["mw"],
                n_m=int(plan["mi"].shape[0]), mconst=small["mconst"],
                out=out, out_ld=out_ld)


def logup_perm_phi(perm: torch.Tensor, main: torch.Tensor,
                   prep: Optional[torch.Tensor], plan: Dict[str, np.ndarray],
                   n_inter_padded: int) -> None:
    """Write every trace row's LogUp batch contributions phi_b = m_2b /
    d_2b + m_2b+1 / d_2b+1 (1/0 taken as 0) into perm[:, :4 nb], canonical;
    the running-sum columns are left as they were. n_inter_padded sizes
    the plain version's row chunks."""
    if _check_device(main) == "cpu":
        return perm_phi_plain(perm, main, prep, plan, n_inter_padded)
    args = perm_args(perm, main, prep, plan)
    st = _to_struct(_PermArgs, PERM_FIELDS, args)
    device = main.device
    err = _library().lurk_logup_perm_phi(
        device.index, ctypes.byref(st),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"logup_perm_phi launch failed: cudaError {err}")
    _count(logup_perm_phi)


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
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(device)
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
