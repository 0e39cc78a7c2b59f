"""Time warm proves of Lurk fib(100000) at ShardingConfig(262144) on a
card, phase by phase, with one tree's lurk_tpu_torch.

    python3 scripts/prove_turns.py [TREE] [--warm N] [--profile]

TREE (default: this checkout) is the root of the checkout whose
lurk_tpu_torch runs, so that one call on the card can time two trees in
turns (parent, change, change, parent; a parent unpacked with `git
archive` under build/). Evaluates benches/lurk_bench.py's fib(100000) on
the direct machine at the production FriConfig(), proves once cold, then
N times warm (default 3) with LURK_TPU_PROVE_TIMING=1: per warm prove, its
wall seconds and the host stamps of device_prove summed over the shards
by phase ("open+fri" among them). With --profile, one more warm prove
under torch.profiler: its wall, the device busy share (the union of the
device events' intervals) and each hand-written kernel's device time and
launches, for the kernels the tree has. Needs a card; prints the card's
name and power limit first and one JSON line last.
"""

import argparse
import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# (module, wrapper, the kernel's name in a trace)
KERNELS = (("poseidon.cuda_kernel", "permute_mont_cuda", "perm_kernel"),
           ("stark.quotient_kernel", "constraint_quotient",
            "quotient_kernel"),
           ("stark.quotient_kernel", "logup_perm_phi", "perm_phi_kernel"),
           ("stark.open_kernel", "open_eval", "open_eval_kernel"),
           ("stark.open_kernel", "open_reduce", "open_reduce_kernel"),
           ("stark.open_kernel", "fri_fold", "fri_fold_kernel"))


def _phases(log: str) -> dict:
    """Seconds by phase from device_prove's [prove-timing] lines, summed
    over the shards ("shard3 witness+upload" counts as "witness+upload")."""
    out: dict = {}
    for label, sec in re.findall(r"^\[prove-timing\] (.+?): ([\d.]+)s",
                                 log, re.M):
        key = re.sub(r"^shard\d+ ", "", label.strip())
        out[key] = out.get(key, 0.0) + float(sec)
    return out


def _busy_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total, end = total + e - s, e
        elif e > end:
            total, end = total + e - end, e
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?",
                    default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--warm", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = Path(args.tree).resolve()
    os.environ["LURK_TPU_PROVE_TIMING"] = "1"
    sys.path.insert(0, str(root))
    os.chdir(root)
    import importlib
    import torch
    if not torch.cuda.is_available():
        print("prove_turns: no CUDA device", file=sys.stderr)
        return 2
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair.execute import ShardingConfig
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{gpu}; tree {root}", flush=True)
    toplevel, zstore, _ = build_lurk_toplevel()
    code = ("(letrec ((fib (lambda (n) (if (<= n 1) n "
            "(+ (fib (- n 1)) (fib (- (- n 1) 1))))))) (fib 100000))")
    _, q = evaluate(toplevel, zstore, code)
    machine = new_machine(toplevel, FriConfig())
    pk, _ = machine.setup()
    cfg = ShardingConfig(262144)

    def prove():
        log = io.StringIO()
        with contextlib.redirect_stderr(log):
            t0 = time.perf_counter()
            machine.prove(pk, q, Challenger(), shard_config=cfg, device=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return wall, _phases(log.getvalue())

    cold, _ = prove()
    runs = [prove() for _ in range(args.warm)]
    for i, (wall, phases) in enumerate(runs):
        print(f"warm prove {i}: {wall:.3f}s, open+fri "
              f"{phases.get('open+fri', 0.0):.3f}s, phases "
              + json.dumps({k: round(v, 3) for k, v in phases.items()})
              + f" [{gpu}]", flush=True)
    result = {"tree": str(root), "gpu": gpu, "cold_s": cold,
              "warm_s": [w for w, _ in runs],
              "warm_median_s": statistics.median(w for w, _ in runs),
              "open_fri_s": [p.get("open+fri", 0.0) for _, p in runs],
              "phases": [p for _, p in runs]}
    if args.profile:
        kernels = []
        for mod, attr, key in KERNELS:
            try:
                fn = getattr(importlib.import_module(
                    f"lurk_tpu_torch.{mod}"), attr)
            except (ImportError, AttributeError):
                continue                 # a kernel the tree does not have
            fn.launches = 0
            kernels.append((attr, fn, key))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            wall, phases = prove()
        dev = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = _busy_us((e.time_range.start, e.time_range.end) for e in dev)
        result["profiled"] = {
            "wall_s": wall, "busy_s": busy / 1e6,
            "busy_share": busy / 1e6 / wall, "device_events": len(dev),
            "phases": phases,
            "kernels": {name: {"ms": sum(e.time_range.elapsed_us()
                                         for e in dev if key in e.name) / 1e3,
                               "launches": fn.launches}
                        for name, fn, key in kernels}}
        print(f"profiled warm prove: {wall:.3f}s, device busy "
              f"{busy / 1e6:.3f}s ({100 * busy / 1e6 / wall:.1f} %), "
              f"{len(dev)} device events [{gpu}]", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
