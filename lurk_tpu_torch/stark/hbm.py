"""Device-memory planning: the shard size and keep mode of a prove, from a
model of what stark/device_prover.py holds on its device, in bytes.

The reference proves any workload at the default ``SHARD_SIZE`` (2^22)
because its prover lives in host RAM and its shard splitter exists to
bound PROOF size, not memory (reference: src/lair/execute.rs:226-241).
The device prover holds a shard's rounds in one card's memory, so the
same contract, "any size proves at the default config", must be honoured
by bounding device memory too: when no explicit shard size was requested,
pick the largest shard size whose modeled prove fits the device, and
decide the pass-1 keep mode (`full`, `light`, `none`) against the same
budget.

The model walks the prove's phases as device_prove runs them and sums,
for each phase, what is resident (the int32 rounds each keep mode
retains, the fixed tables) and the int64 transients of the stage, sized
by the prover's own chunk constants:

  witness         the device witness VM's int64 registers over chunks of
                  2^18 rows (lair/device_trace.py)
  commit          int32 trace mats (4 B/cell), coefficients (4 B/cell),
                  LDE (8 B/cell) and tree digests (128 B/row of a group);
                  on the CPU the int64 INTT + coset NTT of one
                  LDE_CHUNK_CELLS column chunk (on CUDA the NTT kernel
                  allocates nothing but the coefficients and the LDE); the
                  group's concat; the leaf sponge of one row block
  perm trace      on the CPU: the int32 columns of the chip, the int64
                  fingerprints of one _gperm_rows chunk, the whole-chip
                  int64 batch contributions before they narrow; on CUDA
                  (the logup_perm_phi kernel writes into the perm matrix):
                  the int64 running-sum scan
  quotient        on the CPU: one _vm_rows window of the chip's LDE and
                  perm LDE in int64, the constraint VM's registers over
                  it; on CUDA: the constraint_quotient kernel's int32
                  fold (the kernel keeps its registers in shared memory);
                  then the epilogue NTTs
  open            on the CPU: the int64 products of one _open_rows block
                  of a group's coefficients or LDE and the reduced
                  codewords; on CUDA: the open kernels' small buffers and
                  the int32 reduced codewords; FRI layers

The stage transients follow the prover's device: a CUDA device's are the
kernels' buffers, the CPU's the plain versions' (so that the CPU's plans
stay lurk_tpu's). A keep mode's prove high-water is the largest phase's,
with the caching
allocator's slack (reserved over allocated memory). The byte counts come
from the stages' code; the margin, the slack, the reserve and the headroom
were fitted on the card named beside them, where the model bounds the
measured max_memory_reserved of every proof chip_smoke.py runs by 1.06 to
1.32 times (NVIDIA H100 80GB HBM3, 700 W, with the NTT kernel).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

_DEFAULT_HBM = 16 << 30          # lurk_tpu's default (a 16 GB v5e)
# Memory outside the caching allocator: the CUDA context and the kernel's
# module, 0.60 GiB on NVIDIA H100 80GB HBM3, 700 W (chip_smoke.py prints
# it after start-up), and library workspaces.
_RESERVE = 1 << 30
_HEADROOM = 0.9                  # budget fraction of (limit - reserve)
# The measured allocated peak over the modeled one: 0.955 to 1.057 on
# NVIDIA H100 80GB HBM3, 700 W, over the phase peaks chip_smoke.py prints
# (fib(100000) in 1, 4 and 8 shards, compiled, lcs, sum(100000)).
_ALLOC_MARGIN = 1.1

# Bytes per element of the chunk named, counted from the stage's int64
# temporaries and checked against the phase peaks on the same card
_LDE_BYTES_PER_CELL = 104        # one INTT + coset NTT column chunk
_HASH_BYTES_PER_CELL = 32        # one leaf-sponge row block
_TREE_BYTES_PER_ROW = 128        # digests of a group's tree (2h leaves)
_WITNESS_BYTES_PER_CELL = 32     # device witness VM over 2^18-row chunks
_WITNESS_CHUNK = 1 << 18
_TABLE_BYTES_PER_ROW = 224       # cached NTT / coset / FRI tables per height


def device_hbm_bytes(device=None) -> int:
    """The device memory a prove on `device` may plan for.

    LURK_TPU_HBM_BYTES overrides. A CUDA device: its own total
    (torch.cuda.mem_get_info(device)), times the process's memory fraction
    where one is set (torch.cuda.set_per_process_memory_fraction). The CPU:
    lurk_tpu's 16 GB default, so that the CPU's shard and keep-mode plans
    are lurk_tpu's. With no device named, the prover's default: the
    current CUDA device, else the CPU."""
    env = os.environ.get("LURK_TPU_HBM_BYTES")
    if env:
        return int(env)
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return _DEFAULT_HBM
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return _DEFAULT_HBM
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    total = int(torch.cuda.mem_get_info(device)[1])
    return int(total * torch.cuda.get_per_process_memory_fraction(device))


def _pow2(rows: int) -> int:
    return 1 << max((rows - 1).bit_length(), 2) if rows else 0


@dataclass(frozen=True)
class ChipShape:
    """What the model reads of one chip in one shard."""
    h: int                # padded trace rows
    width: int            # main columns
    batches: int          # LogUp batches (perm width 4 * (batches + 1))
    x_width: int          # the VM's local columns: main + prep + 4
    n_regs: int           # the VM program's registers
    on_device: bool       # perm trace and quotient on the device

    @property
    def perm_width(self) -> int:
        return 4 * (self.batches + 1)


def chip_shapes(machine, shard) -> List[ChipShape]:
    from ..lair.chips import chip_included
    from .device_prover import _host_chip_min_rows, vm_program_for
    min_rows = _host_chip_min_rows()
    out = []
    for c in machine.chips:
        if not chip_included(c, shard):
            continue
        rows = c.num_rows(shard)
        builder = machine.builder_for(c)
        prog = vm_program_for(builder)
        out.append(ChipShape(_pow2(rows), c.width,
                             (len(builder.interactions) + 1) // 2,
                             prog.x_width, prog.n_regs, rows >= min_rows))
    return out


def _groups(pairs) -> Dict[int, int]:
    """{height: summed width} of (height, width) pairs."""
    out: Dict[int, int] = {}
    for h, w in pairs:
        out[h] = out.get(h, 0) + w
    return out


def _round_bytes(groups: Dict[int, int]) -> int:
    """A committed round's coefficients, LDE and tree digests."""
    return sum(12 * h * w + _TREE_BYTES_PER_ROW * h
               for h, w in groups.items())


def _commit_transient(groups: Dict[int, int], from_coeffs=False,
                      cuda: bool = False) -> int:
    """The largest group's concat, its LDE column chunk's int64 NTTs and
    its leaf-sponge row block (device_prover._lde_group, dcommit). On
    CUDA the NTT kernel (field/ntt_kernel.py) allocates nothing but its
    outputs, which the round holds: no LDE chunk."""
    from .device_prover import LDE_CHUNK_CELLS
    worst = 0
    for h, w in groups.items():
        chunk = 0 if cuda else h * min(w, max(8, LDE_CHUNK_CELLS // h))
        lde = _LDE_BYTES_PER_CELL * chunk + (0 if from_coeffs else 4 * h * w)
        leaf = _HASH_BYTES_PER_CELL * min(2 * h * w, LDE_CHUNK_CELLS)
        worst = max(worst, lde, leaf)
    return worst


def _perm_transient(c: ChipShape, cuda: bool) -> int:
    """device_perm_trace_plan. On CUDA: the running sum's int64 row totals
    and scan (the kernel writes the batch contributions into the perm
    matrix, read in place). On the CPU: the int32 column concat, one
    chunk's int64 fingerprints, inverses and contributions, the whole
    chip's int64 contributions before and after their concat."""
    from .device_prover import _gperm_rows
    if not c.batches:
        return 16 * c.h
    if cuda:
        return 128 * c.h
    rows = min(c.h, _gperm_rows(2 * c.batches))
    return (4 * c.h * c.x_width + 8 * rows * c.x_width
            + 600 * rows * c.batches + 80 * c.h * c.batches)


def _quotient_transient(c: ChipShape, cuda: bool) -> int:
    """device_quotient_chunk_vm, then the chip's folded values and the
    epilogue's NTTs. On CUDA: the kernel's (big, 4) int32 fold (its VM
    registers and row tiles live in shared memory; its packed program and
    plan records are kilobytes). On the CPU: one _vm_rows chunk's window
    of LDE and perm-LDE rows in int64 (and their concat), the VM's
    registers and the perm-quotient's temporaries."""
    from .device_prover import _vm_rows
    if cuda:
        return 512 * c.h
    rows = min(2 * c.h, _vm_rows(c.n_regs + 2 * c.x_width))
    return (rows * (16 * c.x_width + 20 * c.perm_width + 8 * c.n_regs
                    + 352 * c.batches) + 512 * c.h)


def _open_transient(groups: List[Tuple[int, int]], cuda: bool) -> int:
    """device_open_rounds over the (height, width) groups of a shard's
    rounds. On CUDA (the open kernels of stark/open_kernel.py): open_eval's
    one launch for every group, so every group's opened values and their
    64-bit accumulators (at most two points: 96 B a column) and its packed
    tables (z^(2^j) for each point: 1,024 B a group; a record and a
    counter a column tile: 92 B; the block -> tile map: 4 B a block)
    alive together; open_reduce's one launch, its packed tables (a
    ReduceHeight, 312 B a height; a ReduceChunk, 64 B a group's 32
    columns, and the chunk's weight planes, 2,048 B; ReduceSeg records
    of 56 B, at most two points' for every chunk and every matrix of a
    column or more: 112 B a chunk and a column; 16 B of counters); and
    the reduced codewords, one (2h, 4) int32 per height, all alive until
    FRI. On the CPU: one _open_rows block of a group's coefficients or LDE
    and its products in int64, and the group's reduced codewords."""
    from .device_prover import LDE_CHUNK_CELLS
    if not groups:
        return 0
    if cuda:
        from .open_kernel import ITEM_ROWS, REDUCE_COLS, column_tiles
        tables = sum(1024 + len(column_tiles(w))
                     * (92 + 4 * -(-h // ITEM_ROWS)) for h, w in groups)
        heights = {h for h, _ in groups}
        chunks = [-(-w // REDUCE_COLS) for _, w in groups]
        reduce_tables = 312 * len(heights) + 16 + sum(
            (64 + 2048) * c + 112 * (c + w)
            for c, (_, w) in zip(chunks, groups))
        return sum(96 * w for _, w in groups) + tables + reduce_tables + \
            32 * sum(heights)
    return max(24 * min(2 * h * w, LDE_CHUNK_CELLS) + 256 * h
               for h, w in groups)


class _Shard:
    """The byte counts of one shard's rounds and stage transients."""

    def __init__(self, shapes: List[ChipShape], cuda: bool):
        dev = [c for c in shapes if c.on_device]
        main = _groups((c.h, c.width) for c in shapes)
        perm = _groups((c.h, c.perm_width) for c in shapes)
        quot = _groups((c.h, 8) for c in shapes)
        self.mats = 4 * sum(c.h * c.width for c in shapes)
        self.main = _round_bytes(main)
        self.perm_mats = 4 * sum(c.h * c.perm_width for c in shapes)
        self.perm = _round_bytes(perm)
        self.quot_mats = 32 * sum(c.h for c in shapes)
        self.quot = _round_bytes(quot)
        self.t_witness = max((_WITNESS_BYTES_PER_CELL * c.width
                              * min(c.h, _WITNESS_CHUNK) for c in dev),
                             default=0)
        self.t_commit = _commit_transient(main, cuda=cuda)
        self.t_recommit = _commit_transient(main, from_coeffs=True,
                                            cuda=cuda)
        self.t_perm = max((_perm_transient(c, cuda) for c in dev),
                          default=0)
        self.t_perm_commit = _commit_transient(perm, cuda=cuda)
        self.t_quot = max((_quotient_transient(c, cuda) for c in dev),
                          default=0)
        self.t_quot_commit = _commit_transient(quot, cuda=cuda)
        self.t_open = _open_transient(list(main.items())
                                      + list(perm.items())
                                      + list(quot.items()), cuda)
        self.fri = 200 * max((c.h for c in shapes), default=0)
        self.heights = {c.h for c in dev}
        self.t_max = max(self.t_witness, self.t_commit, self.t_perm,
                         self.t_perm_commit, self.t_quot, self.t_quot_commit,
                         self.t_open)

    def kept(self, keep_mode: str) -> int:
        """What pass 1 keeps of this shard's main round for pass 2."""
        if keep_mode == "full":
            return self.mats + self.main
        if keep_mode == "light":
            return 2 * self.mats              # mats + coefficients
        return 0

    def pass2(self, held: int) -> List[Tuple[str, int]]:
        """Pass 2's phases after the main round is rebuilt, on top of
        `held` bytes (the later shards' kept rounds and the tables)."""
        main = held + self.main                    # mats released
        perm = main + self.perm                    # perm mats released
        quot = perm + self.quot
        return [
            ("perm trace", held + self.mats + self.main + self.perm_mats
             + self.t_perm),
            ("perm commit", main + self.perm_mats + self.perm
             + self.t_perm_commit),
            ("quotient", perm + self.quot_mats + self.t_quot),
            ("quotient commit", perm + self.quot_mats + self.quot
             + self.t_quot_commit),
            ("open", quot + self.t_open + self.fri),
        ]


def _shards_model(machine, shards, device) -> List[_Shard]:
    import torch
    cuda = torch.device(device).type == "cuda"
    return [_Shard(chip_shapes(machine, s), cuda) for s in shards]


def _tables(model: List[_Shard]) -> int:
    heights = set().union(*(m.heights for m in model)) if model else set()
    return _TABLE_BYTES_PER_ROW * sum(heights)


def prove_phases(machine, shards, keep_mode: str, device,
                 model: Optional[List[_Shard]] = None
                 ) -> List[Tuple[str, int]]:
    """[(phase, modeled bytes)] of a prove on `device`, in device_prove's
    order: the reserved
    memory of each phase, which is its allocated high-water (with a
    margin) and the caching allocator's slack: the freed blocks of the
    prove's largest transient, which it keeps for reuse and later stages,
    of other sizes, cannot all reuse (measured on NVIDIA H100 80GB HBM3,
    700 W: 1.89 to 2.97 GiB of reserved over allocated memory at the peak
    of chip_smoke.py's proofs of phases 10, 16 and 22-24, against largest
    transients of 3.60 to 4.81 GiB modeled). The labels are device_prove's
    phase_peaks labels."""
    model = model if model is not None else \
        _shards_model(machine, shards, device)
    cached = max((m.t_max for m in model), default=0)
    fixed = _tables(model)
    kept = [m.kept(keep_mode) for m in model]
    out = []
    for j, m in enumerate(model):
        before = fixed + sum(kept[:j])
        out.append((f"shard{j} witness", before + m.mats + m.t_witness))
        out.append((f"shard{j} main commit",
                    before + m.mats + m.main + m.t_commit))
    for j, m in enumerate(model):
        held = fixed + sum(kept[j + 1:])
        if keep_mode == "light":
            out.append((f"shard{j} main recommit",
                        held + m.mats + m.main + m.t_recommit))
        elif keep_mode == "none":
            out.append((f"shard{j} main recommit",
                        held + m.mats + max(m.t_witness,
                                            m.main + m.t_commit)))
        out += [(f"shard{j} {label}", b) for label, b in m.pass2(held)]
    return [(label, int(b * _ALLOC_MARGIN) + cached) for label, b in out]


def modeled_prove_bytes(machine, shards, keep_mode: str, device,
                        model: Optional[List[_Shard]] = None) -> int:
    """The whole prove's modeled high-water under `keep_mode` on
    `device`."""
    return max(b for _, b in prove_phases(machine, shards, keep_mode, device,
                                          model))


def shard_highwater_bytes(machine, shard, device) -> int:
    """One shard proved alone (keep mode `none`) on `device`: its modeled
    high-water."""
    return modeled_prove_bytes(machine, [shard], "none", device)


def _budget(limit: int) -> int:
    return int(max(limit - _RESERVE, limit // 4) * _HEADROOM)


def limit_for_budget(budget: int) -> int:
    """The device limit whose budget is `budget` (a cap to set with
    torch.cuda.set_per_process_memory_fraction)."""
    return int(budget / _HEADROOM) + _RESERVE + 1


def plan_shards(machine, queries, shard_config, device,
                limit_bytes: Optional[int] = None):
    """(shards, budget bytes). Honours an explicit shard_config or a
    SHARD_SIZE env var; otherwise halves the shard size from the default
    until the prove, keeping nothing in pass 1 (one shard: keeping its
    coefficients), fits the budget of `device`'s memory (or of a device
    of `limit_bytes`)."""
    from ..lair.execute import Shard, ShardingConfig, default_shard_size
    budget = _budget(limit_bytes or device_hbm_bytes(device))
    explicit = shard_config is not None or "SHARD_SIZE" in os.environ
    if explicit:
        return Shard(queries, 0, shard_config).shard(), budget
    size = default_shard_size()
    shards = Shard(queries, 0, ShardingConfig(size)).shard()
    floor = int(os.environ.get("LURK_TPU_MIN_SHARD_SIZE", str(1 << 16)))
    while size > floor:
        mode = "light" if len(shards) == 1 else "none"
        if modeled_prove_bytes(machine, shards, mode, device) <= budget:
            break
        size >>= 1
        smaller = Shard(queries, 0, ShardingConfig(size)).shard()
        if len(smaller) == len(shards):
            continue            # fewer rows than size: split changed nothing
        shards = smaller
    return shards, budget


def keep_rounds_fits(machine, shards, budget_bytes: int, device) -> bool:
    """True when pass 1 can keep every shard's committed round (mats,
    coefficients, LDE, trees) resident for pass 2."""
    return modeled_prove_bytes(machine, shards, "full",
                               device) <= budget_bytes


def keep_light_fits(machine, shards, budget_bytes: int, device) -> bool:
    """True when pass 1 can keep every shard's mats and coefficients (the
    LDE and trees are rebuilt from the coefficients in pass 2)."""
    return modeled_prove_bytes(machine, shards, "light",
                               device) <= budget_bytes


def keep_mode(machine, shards, budget_bytes: int, device) -> str:
    """Pass 1's keep mode: `full` where every shard's round fits, else
    `light` where its mats and coefficients fit, else `none`. One shard is
    never `none`: it would be committed twice in full."""
    if keep_rounds_fits(machine, shards, budget_bytes, device):
        return "full"
    if keep_light_fits(machine, shards, budget_bytes, device) or \
            len(shards) == 1:
        return "light"
    return "none"
