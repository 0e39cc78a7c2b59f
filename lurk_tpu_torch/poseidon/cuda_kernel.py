"""Poseidon2 permutation as a hand-written CUDA kernel (csrc/poseidon2.cu).

The port of lurk_tpu/poseidon/tpu_kernel.py::permute_mont_tpu. The library
is compiled with nvcc for sm_90a into a shared library with a plain C
interface on first use (utils/cuda_build.py) and loaded with ctypes. The
kernel launches on PyTorch's current stream.

`permute_mont_cuda(state)` sends a CUDA tensor to the kernel and a CPU
tensor to the plain PyTorch version (poseidon/perm.py::permute_mont); it
raises on anything the kernel does not take and on a failed build or
launch. `permute_mont_cuda.launches` counts kernel launches. The wrapper
may be called from several threads at once (parallel/shard_prover.py
runs one worker per device slot): the constant upload and the count are
taken under a lock, and the library's entry points leave the calling
thread's current CUDA device as they found it.
"""

from __future__ import annotations

import ctypes
import threading
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

from ..field import babybear as bb
from ..utils import cuda_build
from . import perm
from .constants import get_config

WIDTHS = (16, 24, 32, 40)
# the constant uploads done so far, {(width, device index)}, and the lock
# that makes a concurrent first use upload once and the launch count exact
_LOADED = set()
_STATE_LOCK = threading.Lock()


def build(verbose: bool = False) -> Path:
    """Compile csrc/poseidon2.cu into build/ (utils/cuda_build.py). Returns
    the library path; raises on a failed build."""
    return cuda_build.build("poseidon2", "poseidon2.cu", ("on_device.cuh",),
                            verbose=verbose)


@lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    vp = ctypes.c_void_p
    lib.lurk_poseidon2_partial_rounds.restype = ctypes.c_int
    lib.lurk_poseidon2_partial_rounds.argtypes = [ctypes.c_int]
    lib.lurk_poseidon2_set_constants.restype = ctypes.c_int
    lib.lurk_poseidon2_set_constants.argtypes = [ctypes.c_int, ctypes.c_int,
                                                 vp, vp, vp]
    lib.lurk_poseidon2_permute.restype = ctypes.c_int
    lib.lurk_poseidon2_permute.argtypes = [ctypes.c_int, vp, vp, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           vp]
    return lib


def _constants_loaded(width: int, device_index: int) -> None:
    """Upload one width's Montgomery constants to the kernel's constant
    memory on the given device (once per process and device; a thread
    that comes while another uploads waits for it)."""
    if (width, device_index) in _LOADED:
        return
    with _STATE_LOCK:
        if (width, device_index) not in _LOADED:
            _upload_constants(width, device_index)
            _LOADED.add((width, device_index))


def _upload_constants(width: int, device_index: int) -> None:
    lib = _library()
    cfg = get_config(width)
    rp = lib.lurk_poseidon2_partial_rounds(width)
    if cfg.r_f != 8 or rp != cfg.r_p:
        raise RuntimeError(f"kernel compiled for R_P={rp}, constants have "
                           f"R_F={cfg.r_f} R_P={cfg.r_p} at width {width}")
    full = np.ascontiguousarray(cfg.full_rc_mont, np.uint32)
    part = np.ascontiguousarray(cfg.part_rc_mont, np.uint32)
    diag = np.ascontiguousarray(cfg.diag_mont, np.uint32)
    err = lib.lurk_poseidon2_set_constants(
        device_index, width, full.ctypes.data, part.ctypes.data,
        diag.ctypes.data)
    if err != 0:
        raise RuntimeError(f"Poseidon2 constant upload failed: cudaError {err}")


def permute_mont_cuda(state: torch.Tensor, n_chain: int = 1) -> torch.Tensor:
    """`n_chain` Poseidon2 permutations of a (width, batch) int32 tensor in
    Montgomery form. CUDA tensors run the kernel; CPU tensors run the
    plain version."""
    if not isinstance(state, torch.Tensor):
        raise TypeError("state must be a torch.Tensor")
    if state.dtype != torch.int32:
        raise TypeError(f"state must be int32, got {state.dtype}")
    if state.dim() != 2 or state.shape[0] not in WIDTHS:
        raise ValueError(f"state must be (width, batch) with width in "
                         f"{WIDTHS}, got {tuple(state.shape)}")
    if n_chain < 0:
        raise ValueError("n_chain must be >= 0")
    if state.device.type == "cpu":
        out = state
        for _ in range(n_chain):
            out = perm.permute_mont(out)
        return out
    if state.device.type != "cuda":
        raise ValueError(f"unsupported device {state.device}")
    if not state.is_contiguous():
        raise ValueError("state must be contiguous")
    width, batch = int(state.shape[0]), int(state.shape[1])
    _constants_loaded(width, state.device.index)
    out = torch.empty_like(state)
    if batch == 0 or n_chain == 0:
        return out.copy_(state)
    stream = torch.cuda.current_stream(state.device).cuda_stream
    err = _library().lurk_poseidon2_permute(
        state.device.index, state.data_ptr(), out.data_ptr(), width, batch,
        n_chain, stream)
    if err != 0:
        raise RuntimeError(f"Poseidon2 kernel launch failed: cudaError {err}")
    with _STATE_LOCK:
        permute_mont_cuda.launches += 1
    return out


permute_mont_cuda.launches = 0


def permute_cuda(states: torch.Tensor) -> torch.Tensor:
    """Canonical (batch, width) -> (batch, width) through the kernel."""
    st = bb.to_mont(states.T).contiguous()
    return bb.from_mont(permute_mont_cuda(st)).T.contiguous()
