"""Phase 25 of chip_smoke.py alone: constraint_quotient and logup_perm_phi
bit-equal to their plain versions and timed on the device chips of Lurk
fib(100000)'s shard 0 at ShardingConfig(262144).

    python3 scripts/quotient_phase25.py [TREE]

TREE (default: this checkout) is the root of the checkout whose
chip_smoke.py and lurk_tpu_torch to run, so that one call on the card can
time two trees in turns (parent, change, change, parent). Needs a card;
prints the card's name and power limit and each chip's line as
chip_smoke.py does, then the totals as JSON.
"""

import json
import os
import sys
from pathlib import Path


def main() -> int:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
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
    tot = chip_smoke.quotient_kernels_full_width(
        torch.device("cuda"), f"[{gpu}]",
        (machine, None, None, q, ShardingConfig(262144)))
    print(json.dumps(tot))
    return 0


if __name__ == "__main__":
    sys.exit(main())
