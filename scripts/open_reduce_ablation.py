"""open_reduce's kernel with parts cut out, timed on the card on Lurk
fib(100000)'s shard 0 at ShardingConfig(262144): where its time goes.

    python3 scripts/open_reduce_ablation.py [VARIANT ...]

Builds csrc/open.cu as it stands and variants of it (a text edit of the
source each, compiled with nvcc in build/ablation/): `kernel` (as it
stands), `no_mma` (no tensor-core products: the stages still stream),
`no_epilogue` (no denominators, inverses or codeword writes: the
numerators still go to shared memory). Each runs on the same packed
arguments as phase 26 of chip_smoke.py (chip_smoke.reduce_groups), in
one launch, timed with CUDA events (mean of 10 after one warm-up);
`kernel` is held to the plain version. Needs a card; prints the card's
name and power limit, then a line a variant with its ms and LDE bytes
per second.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# variant -> (text in csrc/open.cu, its replacement)
EDITS = {
    "kernel": None,
    "no_mma": ("      if (busy) {\n        const uint32_t* buf",
               "      if (false) {\n        const uint32_t* buf"),
    "no_epilogue": ("    if (warp < ROW_WARPS)\n      reduce_epilogue(",
                    "    if (false)\n      reduce_epilogue("),
}


def build(variant: str) -> Path:
    from lurk_tpu_torch.utils import cuda_build
    out = ROOT / "build" / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    src = (cuda_build.CSRC / "open.cu").read_text()
    if EDITS[variant]:
        old, new = EDITS[variant]
        if src.count(old) != 1:
            raise RuntimeError(f"{variant}: its text is not in open.cu")
        src = src.replace(old, new)
    cu, lib = out / f"open_{variant}.cu", out / f"libopen_{variant}.so"
    cu.write_text(src)
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I",
                    str(cuda_build.CSRC), "-o", str(lib), str(cu)],
                   check=True)
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("open_reduce_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from lurk_tpu_torch import plan_stats
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair.execute import ShardingConfig
    from lurk_tpu_torch.stark import open_kernel as ok
    from lurk_tpu_torch.stark.fri import FriConfig
    variants = sys.argv[1:] or list(EDITS)
    libs = {v: build(v) for v in variants}
    print(chip_smoke._gpu_line(), flush=True)
    toplevel, zstore, _ = build_lurk_toplevel()
    _, q = evaluate(toplevel, zstore, chip_smoke.FIB100K_CODE)
    machine = new_machine(toplevel, FriConfig())
    mgroups = plan_stats.open_groups(machine, q, ShardingConfig(262144),
                                     matrices=True)[0]
    rng = np.random.default_rng(26)
    zeta, alpha = (tuple(int(v) for v in rng.integers(0, chip_smoke.P_FIELD,
                                                      4)) for _ in range(2))
    dev = torch.device("cuda")
    groups = chip_smoke.reduce_groups(dev, mgroups, zeta, alpha, rng)
    args = ok.reduce_groups_args(groups, alpha)
    st = ok._to_struct(ok._ReduceArgs, ok.REDUCE_FIELDS, args)
    lde_bytes = sum(4 * g[0].numel() for g in groups)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for v in variants:
        fn = ctypes.CDLL(str(libs[v])).lurk_open_reduce
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

        def launch():
            err = fn(dev.index or 0, ctypes.byref(st), stream)
            if err:
                raise RuntimeError(f"{v}: cudaError {err}")
        ms = chip_smoke._event_ms(launch, 10)
        held = ""
        if v == "kernel":
            want = ok.reduce_groups_plain(groups, alpha)
            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(args["outs"][k], want[k]) for k in want):
                raise AssertionError("the kernel != the plain version")
            held = ", == plain"
        print(f"{v}: {ms:.4f} ms, {lde_bytes / ms / 1e9:.3f} TB/s of LDE "
              f"bytes ({len(groups)} groups, {args['blocks']} row items"
              f"{held})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
