"""Count what a Lurk fib(n) prove plans, on the host: no card needed.

    python -m lurk_tpu_torch.plan_stats [--n 100000] [--shard-size 262144]

Evaluates benches/lurk_bench.py's fib program with the native
interpreter, splits it at ShardingConfig(shard_size) on the full Lurk
machine and prints, per shard and chip: rows, padded height, main and
LogUp perm widths, whether the device prover takes the chip's witness and
perm/quotient on the device, its constraint-VM instructions and the row
chunks the VM runs them over. Totals: padded main cells, perm cells, and
the eager torch launches the constraint VM dispatches per prove (two per
instruction and chunk: the operation and its reduction), over the chips
on the device path. These are counts, not times.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100000)
    ap.add_argument("--shard-size", type=int, default=262144)
    args = ap.parse_args(argv)

    from .core.eval_api import evaluate
    from .core.eval_direct import build_lurk_toplevel
    from .core.stark_machine import new_machine
    from .lair import device_trace
    from .lair.chips import chip_included, chip_preprocessed
    from .lair.execute import Shard, ShardingConfig
    from .logup.trace import perm_trace_width
    from .stark import device_prover as dp
    from .stark.fri import FriConfig

    toplevel, zstore, _ = build_lurk_toplevel()
    code = ("(letrec ((fib (lambda (n) (if (<= n 1) n "
            "(+ (fib (- n 1)) (fib (- (- n 1) 1))))))) "
            f"(fib {args.n}))")
    _, queries = evaluate(toplevel, zstore, code)
    machine = new_machine(toplevel, FriConfig())
    shards = Shard(queries, 0, ShardingConfig(args.shard_size)).shard()
    min_rows = dp._host_chip_min_rows()
    main_cells = perm_cells = vm_launches = 0
    print("shard chip rows height width perm_width device_path vm_ops "
          "vm_chunks")
    for shard in shards:
        for chip in machine.chips:
            if not chip_included(chip, shard):
                continue
            rows = chip.num_rows(shard)
            height = 1 << max(rows - 1, 0).bit_length()
            builder = machine.builder_for(chip)
            pw = perm_trace_width(builder)
            main_cells += height * chip.width
            perm_cells += height * pw
            on_device = rows >= min_rows
            prog = dp.vm_program_for(builder)
            prep = chip_preprocessed(chip)
            x_width = chip.width + (0 if prep is None
                                    else len(prep[0])) + 4
            big = 2 * height
            chunks = -(-big // min(big, dp._vm_rows(prog.n_regs
                                                    + 2 * x_width)))
            if on_device:
                vm_launches += 2 * len(prog.ops) * chunks
            witness = ("device" if on_device and device_trace.supported(chip)
                       else "host")
            print(shard.index, chip.name, rows, height, chip.width, pw,
                  f"{on_device}/{witness}-witness", len(prog.ops), chunks)
    print(f"fib({args.n}) at shard size {args.shard_size}: {len(shards)} "
          f"shards, {main_cells} padded main cells, {perm_cells} perm "
          f"cells, {vm_launches} constraint-VM launches per prove")
    return 0


if __name__ == "__main__":
    sys.exit(main())
