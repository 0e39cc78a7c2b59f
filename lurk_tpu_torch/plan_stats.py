"""Count what a Lurk fib(n) prove plans, on the host: no card needed.

    python -m lurk_tpu_torch.plan_stats [--n 100000] [--shard-size 262144]

Evaluates benches/lurk_bench.py's fib program with the native
interpreter, splits it at ShardingConfig(shard_size) on the full Lurk
machine and prints, per shard and chip: rows, padded height, main and
LogUp perm widths, whether the device prover takes the chip's witness and
perm/quotient on the device, its constraint-VM instructions, the row
chunks the plain (eager torch) VM runs them over and the launches of the
constraint_quotient kernel. Totals over the chips on the device path:
padded main cells, perm cells, the launches of the kernels of
stark/quotient_kernel.py and stark/open_kernel.py per prove on a card
(constraint_quotient: one per chip, over all its LDE rows;
logup_perm_phi: one per chip with interactions; open_eval: one per
shard, for every height group of its rounds; open_reduce: one per height
group of each round; fri_fold: one per FRI layer above the host tail),
and beside them the eager torch launches the plain constraint VM
dispatches per prove (two per instruction and chunk: the operation and
its reduction), which is what a card ran before the kernels. These are
counts, not times.
"""

from __future__ import annotations

import argparse
import sys


def open_groups(machine, queries, shard_config) -> list:
    """Per shard, the (round, log2 height, width, opening points) of every
    height group that device_open_rounds opens: the preprocessed round's
    groups (the machine's preprocessed traces), then the main, perm and
    quotient rounds' (one group per trace height of the shard's chips).
    Main, perm and preprocessed matrices open at zeta and zeta * g (one
    point where g = 1, at height 1; a preprocessed matrix whose chip is
    not in the shard at zeta alone), quotient chunks at zeta^2."""
    from .lair.chips import chip_included, chip_preprocessed
    from .lair.execute import Shard
    from .lair.trace import next_power_of_two
    from .logup.trace import perm_trace_width
    preps = [(c.name, chip_preprocessed(c)) for c in machine.chips]
    preps = [(n, p.shape) for n, p in preps if p is not None]
    out = []
    for shard in Shard(queries, 0, shard_config).shard():
        chips = [c for c in machine.chips if chip_included(c, shard)]
        log_h = {c.name: (next_power_of_two(c.num_rows(shard)) - 1)
                 .bit_length() for c in chips}
        groups: dict = {}

        def add(rnd, lh, width, n_points):
            w, n = groups.get((rnd, lh), (0, 0))
            groups[(rnd, lh)] = (w + width, max(n, n_points))

        for name, (rows, width) in preps:
            lh = (rows - 1).bit_length()
            add("preprocessed", lh, width, 2 if log_h.get(name, 0) else 1)
        for c in chips:
            lh = log_h[c.name]
            builder = machine.builder_for(c)
            add("main", lh, c.width, 2 if lh else 1)
            add("perm", lh, perm_trace_width(builder), 2 if lh else 1)
            add("quotient", lh, 8, 1)
        order = ("preprocessed", "main", "perm", "quotient")
        out.append(sorted(((r, lh, w, n) for (r, lh), (w, n)
                           in groups.items()),
                          key=lambda g: (order.index(g[0]), -g[1])))
    return out


def kernel_launches(machine, queries, shard_config) -> dict:
    """The launches of the kernels of stark/quotient_kernel.py and
    stark/open_kernel.py that a prove of `queries` at `shard_config` makes
    on a card: one constraint_quotient per chip on the device path of
    every shard, one logup_perm_phi per such chip with interactions; one
    open_eval per shard (all of its height groups at once); one
    open_reduce per height group of every round of every shard; one
    fri_fold per FRI layer above the host tail
    (device_prover._fri_host_tail_log) of every shard."""
    from .lair.chips import chip_included
    from .lair.execute import Shard
    from .stark import device_prover as dp
    min_rows = dp._host_chip_min_rows()
    out = {"constraint_quotient": 0, "logup_perm_phi": 0}
    for shard in Shard(queries, 0, shard_config).shard():
        for chip in machine.chips:
            if chip_included(chip, shard) and \
                    chip.num_rows(shard) >= min_rows:
                out["constraint_quotient"] += 1
                out["logup_perm_phi"] += \
                    bool(machine.builder_for(chip).interactions)
    groups = open_groups(machine, queries, shard_config)
    out["open_eval"] = sum(1 for g in groups if g)
    out["open_reduce"] = sum(map(len, groups))
    floor = max(dp._fri_host_tail_log(), machine.config.log_blowup)
    out["fri_fold"] = sum(max(0, max(lh for _, lh, _, _ in g)
                              + dp.LOG_BLOWUP - floor) for g in groups)
    return out


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
    cfg = ShardingConfig(args.shard_size)
    shards = Shard(queries, 0, cfg).shard()
    min_rows = dp._host_chip_min_rows()
    main_cells = perm_cells = vm_launches = 0
    print("shard chip rows height width perm_width device_path vm_ops "
          "vm_chunks quotient_launches")
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
                  f"{on_device}/{witness}-witness", len(prog.ops), chunks,
                  int(on_device))
    launches = kernel_launches(machine, queries, cfg)
    print(f"fib({args.n}) at shard size {args.shard_size}: {len(shards)} "
          f"shards, {main_cells} padded main cells, {perm_cells} perm "
          f"cells; kernel launches per prove on a card: "
          f"{launches['constraint_quotient']} constraint_quotient, "
          f"{launches['logup_perm_phi']} logup_perm_phi, "
          f"{launches['open_eval']} open_eval, {launches['open_reduce']} "
          f"open_reduce, {launches['fri_fold']} fri_fold; the plain "
          f"constraint VM's eager launches: {vm_launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
