"""Profile one warm prove of Lurk fib(n) on a CUDA card with torch.profiler.

    python -m lurk_tpu_torch.profile_prove [--n 100000]
        [--shard-size 262144] [--trace DIR]

Evaluates benches/lurk_bench.py's fib program with the native
interpreter, sets up the full Lurk machine at the production FriConfig(),
proves once to warm up, then proves again under torch.profiler (CPU and
CUDA activities). Prints the card's name and power limit, the warm prove's
wall seconds, the device busy time (the union of the intervals of every
device event: kernels and copies) and its share of the wall, the number of
device events, the total time and launches of each hand-written kernel
(Poseidon2, constraint_quotient, logup_perm_phi, open_eval, open_reduce,
fri_fold), and the device kernels by total time. With --trace, writes the chrome trace there. Needs a card;
it exits non-zero without one.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100000)
    ap.add_argument("--shard-size", type=int, default=262144)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 2

    from .core.eval_api import evaluate
    from .core.eval_direct import build_lurk_toplevel
    from .core.stark_machine import new_machine
    from .lair.execute import ShardingConfig
    from .poseidon.cuda_kernel import permute_mont_cuda
    from .stark.challenger import Challenger
    from .stark.fri import FriConfig
    from .stark.open_kernel import fri_fold, open_eval, open_reduce
    from .stark.quotient_kernel import constraint_quotient, logup_perm_phi

    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    on = f"[{gpu}]"
    print(gpu)
    toplevel, zstore, _ = build_lurk_toplevel()
    code = ("(letrec ((fib (lambda (n) (if (<= n 1) n "
            "(+ (fib (- n 1)) (fib (- (- n 1) 1))))))) "
            f"(fib {args.n}))")
    _, queries = evaluate(toplevel, zstore, code)
    machine = new_machine(toplevel, FriConfig())
    pk, _ = machine.setup()
    cfg = ShardingConfig(max_shard_size=args.shard_size)

    def prove():
        proof = machine.prove(pk, queries, Challenger(), shard_config=cfg,
                              device=True)
        torch.cuda.synchronize()
        return proof

    prove()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # (wrapper, the kernel's name in the trace)
    kernels = {"Poseidon2": (permute_mont_cuda, "perm_kernel"),
               "constraint_quotient": (constraint_quotient,
                                       "quotient_kernel"),
               "logup_perm_phi": (logup_perm_phi, "perm_phi_kernel"),
               "open_eval": (open_eval, "open_eval_kernel"),
               "open_reduce": (open_reduce, "open_reduce_kernel"),
               "fri_fold": (fri_fold, "fri_fold_kernel")}
    for fn, _ in kernels.values():
        fn.launches = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prove()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
    per_kernel = []
    for name, (fn, key) in kernels.items():
        us = sum(e.time_range.elapsed_us() for e in dev if key in e.name)
        per_kernel.append(f"{name} {us / 1e3:.3f} ms over {fn.launches} "
                          "launches")
    per_kernel = ", ".join(per_kernel)
    print(f"fib({args.n}) warm prove under the profiler: {wall:.3f}s wall, "
          f"device busy {busy / 1e6:.3f}s ({100 * busy / 1e6 / wall:.1f} % "
          f"of the wall), {len(dev)} device events; {per_kernel} {on}")
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25, max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}/profile_prove.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
