"""Phases 25 and 26 of chip_smoke.py alone: constraint_quotient and
logup_perm_phi bit-equal to their plain versions and timed on the device
chips of Lurk fib(100000)'s shard 0 at ShardingConfig(262144); then, where
the tree's chip_smoke.py has phase 26, open_eval, open_reduce and
fri_fold at the same shard's shapes.

    python3 scripts/quotient_phase25.py [TREE] [--open] [--odd-stride]
    python3 scripts/quotient_phase25.py [TREE] --witness
    python3 scripts/quotient_phase25.py [TREE] --ntt

TREE (default: this checkout) is the root of the checkout whose
chip_smoke.py and lurk_tpu_torch to run, so that one call on the card can
time two trees in turns (parent, change, change, parent). With --open,
phase 26 alone; with --odd-stride, phase 26 also holds and times
open_eval on column slices of wider matrices (odd row strides, the
inputs of the tree before the grouped open_eval). With --witness, phase
27 alone (the device witness kernel), where the tree's chip_smoke.py has
it; with --ntt, phase 28 alone (the NTT kernel's LDE). Needs a card;
prints the card's name and power limit and each chip's or group's line as
chip_smoke.py does, then the totals as JSON.
"""

import json
import os
import sys
from pathlib import Path


def main() -> int:
    flags = {"--open", "--odd-stride", "--witness", "--ntt"}
    args = [a for a in sys.argv[1:] if a not in flags]
    root = Path(args[0] if args else
                Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("quotient_phase25: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair.execute import ShardingConfig
    from lurk_tpu_torch.stark.fri import FriConfig
    gpu = chip_smoke._gpu_line()
    print(f"{gpu}; tree {root}", flush=True)
    toplevel, zstore, _ = build_lurk_toplevel()
    machine = new_machine(toplevel, FriConfig())
    _, q = evaluate(toplevel, zstore, chip_smoke.FIB100K_CODE)
    mqs = (machine, None, None, q, ShardingConfig(262144))
    if "--ntt" in sys.argv:
        tot = {"lurk_ntt_pass": chip_smoke.ntt_kernel_full_width(
            torch.device("cuda"), f"[{gpu}]", mqs)} \
            if hasattr(chip_smoke, "ntt_kernel_full_width") else {}
        print(json.dumps(tot))
        return 0
    if "--witness" in sys.argv:
        tot = {"witness_trace": chip_smoke.witness_kernel_full_width(
            torch.device("cuda"), f"[{gpu}]", mqs)} \
            if hasattr(chip_smoke, "witness_kernel_full_width") else {}
        print(json.dumps(tot))
        return 0
    tot = {} if "--open" in sys.argv else \
        chip_smoke.quotient_kernels_full_width(torch.device("cuda"),
                                               f"[{gpu}]", mqs)
    if hasattr(chip_smoke, "open_kernels_full_width"):
        extra = {"odd_stride": True} if "--odd-stride" in sys.argv else {}
        tot.update(chip_smoke.open_kernels_full_width(
            torch.device("cuda"), f"[{gpu}]", mqs, **extra))
    print(json.dumps(tot))
    return 0


if __name__ == "__main__":
    sys.exit(main())
