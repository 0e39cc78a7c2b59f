#!/usr/bin/env python3
"""Compute the compiled-pipeline goldens of lurk_tpu_torch/stark/golden.py
with lurk_tpu's host prover on the CPU.

    JAX_PLATFORMS=cpu python scripts/compiled_goldens.py

Each golden is the sha256 of the encoded MachineProof of a program
evaluated by the compiled Lurk pipeline (core/eval_compiled.py, 43 chips)
and proved by lurk_tpu's host prover:
- golden.LURK_PROGRAM at FriConfig(1, 8, 2), one shard;
- the same at ShardingConfig(golden.LURK_2SHARD_SIZE), two shards;
- golden.CLI_PROGRAM (Lurk fib(1000)) at PRODUCTION_CONFIG, one shard.

Prints COMPILED_LURK_SHA256, COMPILED_LURK_2SHARD_SHA256 and
COMPILED_CLI_SHA256 as Python, each proof's padded main cells and the
seconds it took. Takes about 20 seconds on 8 cores.
"""

import hashlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lurk_tpu_torch.stark import golden  # noqa: E402  (imports no torch)


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lurk_tpu.core.eval_api import evaluate
    from lurk_tpu.core.eval_compiled import build_lurk_toplevel
    from lurk_tpu.core.stark_machine import PRODUCTION_CONFIG, new_machine
    from lurk_tpu.lair.execute import Shard, ShardingConfig
    from lurk_tpu.stark.challenger import Challenger
    from lurk_tpu.stark.fri import FriConfig
    from lurk_tpu.utils import codec

    toplevel, _, _ = build_lurk_toplevel()
    cases = [
        ("COMPILED_LURK_SHA256", golden.LURK_PROGRAM, FriConfig(1, 8, 2),
         None),
        ("COMPILED_LURK_2SHARD_SHA256", golden.LURK_PROGRAM,
         FriConfig(1, 8, 2), golden.LURK_2SHARD_SIZE),
        ("COMPILED_CLI_SHA256", golden.CLI_PROGRAM, PRODUCTION_CONFIG, None),
    ]
    for name, code, config, shard_size in cases:
        _, zstore, _ = build_lurk_toplevel()
        result, queries = evaluate(toplevel, zstore, code)
        machine = new_machine(toplevel, config)
        pk, vk = machine.setup()
        cfg = None if shard_size is None else ShardingConfig(shard_size)
        t0 = time.perf_counter()
        proof = machine.prove(pk, queries, Challenger(), shard_config=cfg,
                              device=False)
        dt = time.perf_counter() - t0
        assert machine.verify(vk, proof, Challenger())
        shards = len(Shard(queries, 0, cfg).shard())
        cells = machine._trace_cells(queries, cfg)
        print(f"# {zstore.fmt(result)}: {len(machine.chips)} chips, "
              f"{shards} shard(s), {cells} padded main cells, host prove "
              f"{dt:.1f}s")
        print(f"{name} = \\\n    "
              f"{hashlib.sha256(codec.encode(proof)).hexdigest()!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
