"""Profile one warm prove of Lurk fib(n) on a CUDA card with torch.profiler.

    python -m lurk_tpu_torch.profile_prove [--n 100000]
        [--shard-size 262144] [--trace DIR]

Evaluates benches/lurk_bench.py's fib program with the native
interpreter, sets up the full Lurk machine at the production FriConfig(),
proves once to warm up, then proves again under torch.profiler (CPU and
CUDA activities) with the prove's spans recorded (stark/spans.py), each
also a torch.profiler.record_function range. Prints the card's name and
power limit, the warm prove's wall seconds, the device busy time (the
union of the intervals of every device event: kernels and copies) and its
share of the wall, the number of device events, the total time and
launches of each hand-written kernel (Poseidon2, constraint_quotient,
logup_perm_phi, open_eval, open_reduce, fri_fold, the NTT), the device
kernels by total time and, beside them, the host seconds of each span name
summed over the shards (with and without its child spans). With --trace,
writes the chrome trace there: the spans over the kernels, on one clock.
Needs a card; it exits non-zero without one.
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


def _span_table(rows) -> str:
    """Host seconds by span name, summed over the shards: with its child
    spans (inclusive) and without them (exclusive), and the spans' count."""
    by: dict = {}
    for r in rows:
        inc, exc, n = by.get(r["name"], (0.0, 0.0, 0))
        by[r["name"]] = (inc + (r["end_ns"] - r["start_ns"]) / 1e9,
                         exc + r["exclusive_s"], n + 1)
    lines = [f"{'span':<18} {'inclusive s':>12} {'exclusive s':>12} "
             f"{'spans':>6}"]
    for name, (inc, exc, n) in sorted(by.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"{name:<18} {inc:>12.6f} {exc:>12.6f} {n:>6}")
    return "\n".join(lines)


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
    from .field.ntt_kernel import ntt_cuda
    from .lair.execute import ShardingConfig
    from .poseidon.cuda_kernel import permute_mont_cuda
    from .stark.challenger import Challenger
    from .stark.fri import FriConfig
    from .stark.open_kernel import fri_fold, open_eval, open_reduce
    from .stark.quotient_kernel import constraint_quotient, logup_perm_phi
    from .stark import spans

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
               "fri_fold": (fri_fold, "fri_fold_kernel"),
               "NTT": (ntt_cuda, "lurk_ntt_pass")}
    for fn, _ in kernels.values():
        fn.launches = 0
    spans.enable(True, ranges=True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            prove()
            wall = time.perf_counter() - t0
    finally:
        spans.enable(None)
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
    print(_span_table(machine.last_device_prove["spans"]))
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}/profile_prove.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
