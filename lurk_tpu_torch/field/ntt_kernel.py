"""The column-batched NTT and the commits' two-coset LDE as one hand-written
CUDA kernel (csrc/ntt.cu, csrc/babybear.cuh).

The port of lurk_tpu's jitted NTT (lurk_tpu/field/ntt.py: device_ntt, and
the LDE of lurk_tpu/stark/device_prover.py: _lde_kernel). field/ntt.py's
device_ntt sends a CUDA tensor here; a CPU tensor takes its eager int64
stages (device_ntt_plain), the plain version.

- `ntt_cuda(x, log_n, inverse)`: the NTT of a (2^log_n, w) int32 tensor
  of canonical values, natural order in and out, int32 out; no 1/n.
- `lde_cuda(group, log_h)`: trace evaluations -> (coefficients (h, w),
  LDE (2h, w)) on the blowup-2 coset, int32; `coset_lde_cuda(coeffs,
  log_h)` the LDE alone. The LDE's even rows are the h-point NTT of
  c_k s^k and its odd rows that of c_k (s w_2h)^k, s = GENERATOR: both
  cosets read the coefficients in one pass, scaled as they load, and
  write rows 2i and 2i + 1 straight into the LDE; no zero-padded 2h
  transform. The INTT's last pass stores the coefficients times 1/h.

Each takes contiguous CUDA tensors and allocates nothing but its outputs.
A transform is one launch of csrc/ntt.cu's lurk_ntt_pass a pass: one pass
up to 2^11 points, two up to 2^22 and three up to 2^27 (MAX_LOG, the
field's two-adicity), the four-step split. `pass_plan(log_n, w)` says
which, from the shape alone: each pass's points and the columns a block
takes. `transform_args` packs a transform's passes (NttArgs, field for
field in the order of the C structure), so that the CPU tests read them
back with a numpy interpreter of the kernel.

ValueError on a tensor the kernel does not take (dtype, device, layout,
shape, a size above MAX_LOG); RuntimeError on a failed build or launch.
`ntt_cuda.launches` counts the launches (every pass, the LDE's too), under
a lock, since parallel/shard_prover.py proves from one thread per device
slot; a recorded prove (stark/spans.py) counts them as `ntt_launches` and
the points times columns transformed as `ntt_cells`.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache

import numpy as np
import torch

from ..stark import spans
from ..utils import cuda_build
from . import babybear as bb

I32 = bb.I32
GENERATOR = bb.GENERATOR  # the LDE's coset shift (field/ntt.py's)
MAX_PASS_LOG = 11       # points of one pass (csrc/ntt.cu)
MAX_LOG = bb.TWO_ADICITY  # three passes at most
MAX_LANES_LOG = 5       # columns a block: at most 32
BLOCK_WORDS_LOG = 14    # a block's tile: at most 2^14 words
TAB_LOG = 11            # a power table: three levels of 2^11 words
NTT_FIELDS = ("src", "dst", "w", "log_pts", "log_lanes", "j_in", "g_in",
              "t_in", "c_in", "k_out", "g_out", "t_out", "c_out", "groups",
              "batches", "cosets", "tw_t", "stage_tw", "load_tab",
              "store_tab", "scale")
# the structure's pointer fields; every other field is an 8-byte integer
PTR_FIELDS = {"src", "dst", "stage_tw", "load_tab", "store_tab"}

_NttArgs = type("NttArgs", (ctypes.Structure,), {"_fields_": [
    (f, ctypes.c_void_p if f in PTR_FIELDS else ctypes.c_longlong)
    for f in NTT_FIELDS]})
_LOCK = threading.Lock()


def build(verbose: bool = False):
    """Compile csrc/ntt.cu (with its headers) into build/."""
    return cuda_build.build("ntt", "ntt.cu", ("babybear.cuh", "on_device.cuh"),
                            verbose=verbose)


@lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.lurk_ntt_args_size.restype = ctypes.c_longlong
    lib.lurk_ntt_args_size.argtypes = []
    lib.lurk_ntt_pass_launch.restype = ctypes.c_int
    lib.lurk_ntt_pass_launch.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]
    size = lib.lurk_ntt_args_size()
    if size != ctypes.sizeof(_NttArgs):
        raise RuntimeError(f"NttArgs: the library's layout is {size} bytes, "
                           f"the wrapper's {ctypes.sizeof(_NttArgs)}")
    return lib


# ---------------------------------------------------------------------------
# the plan and the tables
# ---------------------------------------------------------------------------

def pass_plan(log_n: int, w: int):
    """[(log points, log columns a block)] of each pass of a (2^log_n, w)
    transform: as few passes of at most 2^11 points as take log_n, their
    sizes as even as they go, the smaller first. A block takes 32
    columns, fewer where its tile would pass 2^14 words or the width is
    narrower."""
    if not 0 <= log_n <= MAX_LOG:
        raise ValueError(f"the NTT kernel takes 2^0 to 2^{MAX_LOG} rows, "
                         f"not 2^{log_n}")
    parts = max(1, -(-log_n // MAX_PASS_LOG))
    need = max(w - 1, 0).bit_length()
    return [((log_n + i) // parts,
             min(MAX_LANES_LOG, BLOCK_WORDS_LOG - (log_n + i) // parts, need))
            for i in range(parts)]


def _mont(values) -> np.ndarray:
    return bb.np_to_mont(np.asarray(values, np.uint64) % np.uint64(bb.P))


def _powers(base: int, n: int) -> np.ndarray:
    """[base^0 .. base^(n-1)] canonical, uint64."""
    out = np.empty(n, np.uint64)
    out[0] = 1
    k = 1
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = out[:m] * np.uint64(bb.pow_s(base, k)) % \
            np.uint64(bb.P)
        k += m
    return out


def _root(log_n: int, inverse: bool) -> int:
    w = bb.two_adic_generator_s(log_n)
    return bb.inv_s(w) if inverse else w


@lru_cache(maxsize=None)
def stage_table(inverse: bool) -> np.ndarray:
    """TW[h + j] = w_2h^j (Montgomery) for h = 2^s, s < MAX_PASS_LOG,
    j < h; TW[0] = 0."""
    tw = np.zeros(1 << MAX_PASS_LOG, np.uint32)
    for s in range(MAX_PASS_LOG):
        h = 1 << s
        tw[h:2 * h] = _mont(_powers(_root(s + 1, inverse), h))
    return tw


def power_table(base: int) -> np.ndarray:
    """base^e = T[e mod 2^11] * T[2^11 + (e >> 11) mod 2^11] *
    T[2^12 + (e >> 22)] for e < 2^27, Montgomery: three levels of 2^11
    words."""
    t = 1 << TAB_LOG
    return np.concatenate([_mont(_powers(bb.pow_s(base, t ** k), t))
                           for k in range(3)])


@lru_cache(maxsize=None)
def twiddle_table(log_n: int, inverse: bool) -> np.ndarray:
    """The powers of w_n, the four-step twiddles of a 2^log_n-point
    transform."""
    return power_table(_root(log_n, inverse))


@lru_cache(maxsize=None)
def coset_table(log_h: int) -> np.ndarray:
    """The LDE's coset powers: coset 0's s^k, then coset 1's (s w_2h)^k."""
    s = GENERATOR
    return np.concatenate([power_table(s), power_table(
        bb.mul_s(s, bb.two_adic_generator_s(log_h + 1)))])


_DEVICE_TABLES: dict = {}


def _on(device: torch.device, key: tuple, make) -> torch.Tensor:
    """The table `make()` as an int32 tensor on `device`, uploaded once
    and waited for, so that a launch on any stream may read it."""
    k = (str(device),) + key
    t = _DEVICE_TABLES.get(k)
    if t is None:
        t = torch.from_numpy(make().astype(np.int64).astype(np.int32))
        if device.type == "cuda":
            spans.count("h2d_bytes", t.nbytes)
            t = t.to(device)
            torch.cuda.current_stream(device).synchronize()
        t = _DEVICE_TABLES.setdefault(k, t)
    return t


# ---------------------------------------------------------------------------
# the passes of a transform
# ---------------------------------------------------------------------------

def _check(name: str, t, rows: int) -> None:
    """A contiguous 2-D int32 CUDA tensor of `rows` rows."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a torch tensor")
    if t.dtype != I32 or t.dim() != 2:
        raise ValueError(f"{name} must be a 2-D int32 tensor, not "
                         f"{t.dtype} of {t.dim()} dimensions")
    if int(t.shape[0]) != rows:
        raise ValueError(f"{name} must be ({rows}, w), not "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous (strides "
                         f"{t.stride()})")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, not on {t.device}")


def transform_args(src: torch.Tensor, dst: torch.Tensor, log_n: int,
                   inverse: bool, scale: int = 1, coset_log_h=None) -> list:
    """NttArgs dicts of the passes of one transform of src's 2^log_n rows
    into dst, both contiguous (tensors for the pointers, ints for the
    rest). With coset_log_h, the LDE's forward half: src holds
    coefficients and both cosets' rows go to dst's rows 2r + c. `scale`
    multiplies the last pass's outputs (the INTT's 1/n).

    With the passes' points n_0, n_1, ..., the digit k_l of the output
    index has the weight Q_l = n_0 ... n_(l-1). Pass 0 reads input row
    j_0 (n / n_0) + r, r the group (for three passes r = j_1 n_2 + j_2,
    the batch t = j_1 and the group g = j_2), and writes output k_0, times
    w_n^(r k_0), to row k_0 + j_1 Q_1 + j_2 Q_2: every digit at its place.
    Pass l > 0 takes, for each batch t < Q_l of the digits already
    transformed (row t) and each group g of the digit after it (row
    g Q_(l+1)), the digit at row j Q_l, and writes output k, times
    w_(n / Q_l)^(g k) unless it is the last pass, back to row k Q_l: the
    rows it read."""
    w = int(src.shape[1])
    dev = src.device
    cosets = 2 if coset_log_h is not None else 1
    plan = pass_plan(log_n, w)
    ns = [1 << m for m, _ in plan]
    q = [1]
    for k in ns:
        q.append(q[-1] * k)
    stage = _on(dev, ("stage", inverse), lambda: stage_table(inverse))
    load = None if coset_log_h is None else \
        _on(dev, ("coset", coset_log_h), lambda: coset_table(coset_log_h))
    common = dict(w=w, cosets=cosets, stage_tw=stage, c_out=cosets - 1,
                  load_tab=None, store_tab=None, scale=0, tw_t=0)
    rest = (1 << log_n) // ns[0]
    groups = ns[-1] if len(ns) > 1 else 1
    passes = [dict(common, src=src, dst=dst, log_pts=plan[0][0],
                   log_lanes=plan[0][1], j_in=rest, g_in=1, t_in=groups,
                   c_in=0, k_out=cosets, g_out=cosets * q[-2],
                   t_out=cosets * q[1], groups=groups,
                   batches=rest // groups, tw_t=groups, load_tab=load)]
    for l, (m, lanes) in enumerate(plan[1:], 1):
        groups = ns[l + 1] if l + 1 < len(ns) else 1
        passes.append(dict(common, src=dst, dst=dst, log_pts=m,
                           log_lanes=lanes, j_in=cosets * q[l],
                           g_in=cosets * q[l + 1], t_in=cosets,
                           c_in=cosets - 1, k_out=cosets * q[l],
                           g_out=cosets * q[l + 1], t_out=cosets,
                           groups=groups, batches=q[l]))
    log_left = log_n
    for p, (m, _) in zip(passes[:-1], plan):
        p["store_tab"] = _on(dev, ("twiddle", log_left, inverse),
                             lambda k=log_left: twiddle_table(k, inverse))
        log_left -= m
    if scale != 1:
        passes[-1]["scale"] = int(_mont([scale])[0])
    return passes


def _launch(passes: list, cells: int) -> None:
    """Launch each pass on the current stream of its tensors' device."""
    lib = _library()
    for p in passes:
        st = _NttArgs(*(p[f].data_ptr() if isinstance(p[f], torch.Tensor)
                        else 0 if p[f] is None else int(p[f])
                        for f in NTT_FIELDS))
        dev = p["dst"].device
        err = lib.lurk_ntt_pass_launch(
            dev.index, ctypes.byref(st),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"NTT pass launch failed: cudaError {err}")
        with _LOCK:
            ntt_cuda.launches += 1
    spans.count("ntt_launches", len(passes))
    spans.count("ntt_cells", cells)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

def ntt_cuda(x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
    """The NTT (inverse: with w^-1, no 1/n) of a (2^log_n, w) int32 CUDA
    tensor of canonical values, natural order in and out: a new int32
    tensor of canonical values."""
    n = 1 << log_n
    _check("x", x, n)
    pass_plan(log_n, 1)
    out = torch.empty_like(x)
    if x.shape[1]:
        _launch(transform_args(x, out, log_n, inverse), n * int(x.shape[1]))
    return out


ntt_cuda.launches = 0


def _check_lde(log_h: int) -> None:
    if not 0 <= log_h < MAX_LOG:
        raise ValueError(f"the NTT kernel's LDE takes 2^0 to "
                         f"2^{MAX_LOG - 1} rows, not 2^{log_h}")


def coset_lde_cuda(coeffs: torch.Tensor, log_h: int) -> torch.Tensor:
    """Coefficients (h, w), a CUDA tensor -> the (2h, w) LDE on GENERATOR
    times the 2h-th roots of unity, natural order, a new int32 tensor."""
    h = 1 << log_h
    _check("coeffs", coeffs, h)
    _check_lde(log_h)
    out = torch.empty((2 * h, int(coeffs.shape[1])), dtype=I32,
                      device=coeffs.device)
    if coeffs.shape[1]:
        _launch(transform_args(coeffs, out, log_h, False, coset_log_h=log_h),
                h * int(coeffs.shape[1]))
    return out


def lde_cuda(group: torch.Tensor, log_h: int):
    """Trace evaluations (h, w), a CUDA tensor -> (coefficients (h, w),
    LDE (2h, w)), new int32 tensors: field/ntt.py's intt and coset_eval
    at blowup 2, the values of device_prover's _lde_kernel."""
    h = 1 << log_h
    _check("group", group, h)
    _check_lde(log_h)
    cfs = torch.empty_like(group)
    lde = torch.empty((2 * h, int(group.shape[1])), dtype=I32,
                      device=group.device)
    if group.shape[1]:
        _launch(transform_args(group, cfs, log_h, True,
                               scale=bb.inv_s(h % bb.P))
                + transform_args(cfs, lde, log_h, False, coset_log_h=log_h),
                h * int(group.shape[1]))
    return cfs, lde
