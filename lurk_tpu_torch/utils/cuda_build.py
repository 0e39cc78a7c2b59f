"""Build a CUDA source of lurk_tpu_torch/csrc into a shared library.

Each library is compiled with nvcc for sm_90a into build/lurk_tpu_torch/
at the repository root (listed in .gitignore), at first use, with a plain
C interface that the caller loads with ctypes. Its file name carries a
hash of every source byte it compiles, headers included, and of the
flags, so an edited source or header is never served by a stale library.
One build of a library at a time in a process; different libraries build
in parallel.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = ROOT / "build" / "lurk_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                           "(set CUDA_HOME)")
    return found


def library_path(name: str, source: str, headers: Sequence[str] = ()) -> Path:
    """Where the library of csrc/<source> (with csrc/<headers>) is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in (source, *headers):
        h.update((CSRC / rel).read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, source: str, headers: Sequence[str] = (),
          verbose: bool = False) -> Path:
    """Compile csrc/<source> into lib<name>_<hash>.so unless it is built;
    returns the library path and raises on a failed build. With verbose,
    prints what `-Xptxas -v` says of each kernel."""
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        out = library_path(name, source, headers)
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(CSRC / source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if verbose and (res.stdout or res.stderr):
            print(res.stdout + res.stderr, flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):"
                               f"\n{res.stderr}")
        os.replace(tmp, out)
        return out
