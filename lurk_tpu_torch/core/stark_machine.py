"""Machine construction for Lurk proofs (reference: src/core/stark_machine.rs).

Public values layout: input (8 tag + 8 expr digest + 8 env digest = 24) ++
output (8 tag + 8 result digest = 16) ++ depth LE bytes (4) = 44.
"""

from __future__ import annotations

from ..lair.trace import FuncChip
from ..lair.chips import build_lair_chip_vector
from ..stark.fri import FriConfig
from ..stark.machine import StarkMachine

INPUT_SIZE = 24
OUTPUT_SIZE = 16
DEPTH_SIZE = 4
NUM_PUBLIC_VALUES = INPUT_SIZE + OUTPUT_SIZE + DEPTH_SIZE

PRODUCTION_CONFIG = FriConfig(log_blowup=1, num_queries=100, pow_bits=16)


def new_machine(toplevel, config: FriConfig = PRODUCTION_CONFIG,
                entry_name: str = "lurk_main") -> StarkMachine:
    entry_chip = FuncChip.from_name(entry_name, toplevel)
    chips = build_lair_chip_vector(entry_chip)
    return StarkMachine(chips, NUM_PUBLIC_VALUES, config)
