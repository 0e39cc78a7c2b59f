#!/usr/bin/env python3
"""Drive lurk_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA; print the card's name and power limit, and
     whether cpp/liblair.so loads;
  2. build: compile the CUDA kernels (nvcc, sm_90a), one nvcc for each
     source (csrc/poseidon2.cu, csrc/quotient.cu, csrc/open.cu), all at
     once;
  3. kernel vs plain: the kernel bit-equal to the plain PyTorch
     permutation at widths 16/24/32/40 (batch 2^16 and 2^16 + 3, chains of
     1 and 2) and to the scalar oracle poseidon/ref.py on a few states;
  4. hasher: hash_rows / compress_pairs on CUDA tensors bit-equal to the
     host path;
  5. golden: demo fib(1000) at FriConfig(1, 8, 2) proved on the card has
     the golden sha256 (the same bytes as lurk_tpu's host proof);
  6. the slice: demo fib at n = 2^20 - 8 at the production FriConfig()
     through machine.prove(..., device=True), as bench.py does: one
     shard, 19,726,546 padded cells, through the kernel, verified;
  7. throughput: w24 x 2^19 states, 64 chained permutations, kernel and
     plain version; the kernel's bound from its SASS instruction counts;
  8. Lurk goldens: the Lurk program golden.LURK_PROGRAM on the full Lurk
     machine (47 chips), every chip on the device path with device
     witness generation, at FriConfig(1, 8, 2): one shard with the golden
     sha256, then two shards in keep mode `none` with theirs; both verify;
  9. device witness: every chip of that program that lair/device_trace.py
     supports generates on the card the same trace as on the host, in one
     shard and in the first 3 shards at max_shard_size 64;
 10. full width: Lurk fib(100000) (benches/lurk_bench.py's program) at the
     production FriConfig() and ShardingConfig(max_shard_size=262144),
     through evaluate -> new_machine -> setup_cached -> machine.prove(...,
     device=True) -> machine.verify: 4 shards, 326,397,960 padded cells,
     through the kernel and device witness generation; cold and warm
     proofs byte-identical to the checked-in
     benches/artifacts/fib100k_4shard_proof.bin.gz; the warm prove's
     constraint_quotient, logup_perm_phi, open_eval, open_reduce and
     fri_fold launches equal plan_stats.py's count (one quotient launch
     per device chip, one perm launch per such chip with interactions, one
     open_eval per shard for all of its height groups, one open_reduce per
     height group of every round of every shard, one fri_fold per FRI
     layer above the host tail; phase 16 too);
 11. the REPL: one lurk_tpu_torch REPL at the CLI's default config
     (PRODUCTION_CONFIG) loads the demo corpus (golden.DEMO_FILES, `!(clear)`
     before each); every `!(prove)` runs on the card, every proof file
     `!(verify)`s to t and, where deterministic, has lurk_tpu's sha256; a
     second pass proves the corpus again warm;
 12. the CLI: `python -m lurk_tpu_torch load <file> --prove` on
     golden.CLI_PROGRAM (past 2^22 padded cells) exits 0 and writes the
     proof file with lurk_tpu's sha256;
 13. the microchain: `microchain.serve` on a daemon thread with its own
     REPL; the phase-11 REPL starts a chain, proves two transitions on the
     card and verifies the chain's history;
 14. compiled goldens: the compiled pipeline (core/eval_compiled.py, 43
     chips) proves golden.LURK_PROGRAM in one shard and in two (keep mode
     `none`) at FriConfig(1, 8, 2), every chip on the device path, and
     golden.CLI_PROGRAM (fib(1000)) at PRODUCTION_CONFIG with the default
     routing, all with device witness; each sha256 equals lurk_tpu's host
     proof's and each proof verifies; every compiled chip that
     lair/device_trace.py supports makes the host's trace on the card, as
     in phase 9;
 15. forced paths: the direct LURK_PROGRAM golden with every chip on the
     device path under LURK_TPU_GENERIC_PERM=0, LURK_TPU_QUOT=window and
     LURK_TPU_QUOT=mono (the per-chip DAG paths), each with
     GOLDEN_LURK_SHA256; a second proof on the default path and under
     LURK_TPU_QUOT=window, under torch.profiler, counts its device events;
 16. full scale, compiled: fib(100000) on the compiled machine at
     FriConfig() and ShardingConfig(max_shard_size=262144), 4 shards,
     218,659,792 padded cells, cold and warm; the result equals the direct
     pipeline's and the proof verifies;
 17. loam and narrow: the copies import without jax and a loam evaluation
     of fib(5) gives 8n;
 18. mesh blocks: over 4 slots on cuda:0 (and over every card when there
     are two or more), sharded_permute of w16 x 2^21 states equals
     permute_mont_cuda, sharded_leaf_hash of (2^22, 16) equals
     hasher.hash_rows, sharded_logup_sum and sharded_commit_step equal
     their single-device results, mesh_ntt / mesh_intt at 2^21 x 8 equal
     field/ntt.py's device_ntt and round-trip; with a second card, a
     launch there leaves torch.cuda.current_device() unchanged;
 19. mesh_prove: phase 10's fib(100000) machine, keys and queries proved
     by parallel/shard_prover.mesh_prove over 2 slots on cuda:0 (4 shards,
     so each slot recommits its shards), byte-identical to the checked-in
     proof, verified, mesh_cumulative_balance == (0, 0, 0, 0);
 20. the mesh commit: the same prove through machine.prove(...,
     device=True) with LURK_TPU_MESH_DEVICES naming 4 slots on cuda:0,
     LURK_TPU_MESH_COMMIT=1 and a budget under every shard's largest
     group, so each shard's big groups take parallel/ntt_mesh.mesh_lde;
     byte-identical to the checked-in proof;
 21. multi-process: two child processes (no jax) join over gloo on
     127.0.0.1 through parallel/multihost.initialize, both on cuda:0; each
     runs multihost_prove(..., device=True) of fib(100000) in 4 shards,
     proving shards p and p + 2, and returns the full proof, byte-identical
     to the checked-in proof;
 22. the default config: phase 10's fib(100000) through machine.prove(...,
     device=True) with no shard_config, so that stark/hbm.py plans its
     shards and keep mode for the whole card: cold and warm, byte-equal,
     verified;
 23. capped: the same prove in this process capped with
     torch.cuda.set_per_process_memory_fraction at three limits, under
     which the planner picks 4 shards in keep mode `full` (byte-identical
     to the checked-in proof), 4 in `light`, and 8 in `none` with the
     modeled prove at 0.8 of the budget or more;
 24. the reference's sum and lcs benches (benches/lurk_bench.py's
     sum_expr(100000) and lcs_expr()) evaluated and proved at the default
     config on the whole card, cold and warm, byte-equal, verified;
 25. the quotient kernels at full width: constraint_quotient and
     logup_perm_phi (stark/quotient_kernel.py) bit-equal to their plain
     versions on every chip of phase 10's shard 0 that runs on the
     device, at its full height, each timed with CUDA events (the
     kernel's launches alone, the wrapper's calls) beside its plain
     version and its bound, with its tile and the blocks an SM holds.
 26. the open kernels at full width: open_eval, open_reduce and fri_fold
     (stark/open_kernel.py) bit-equal to their plain versions at the
     shapes of phase 10's shard 0: every height group of its four rounds
     (plan_stats.open_groups) in one open_eval launch, an all-(p - 1)
     column of 2^15 + 3 rows, each group's open_reduce, and every FRI
     layer above the host tail as pair matrices; each timed with CUDA
     events (the kernel's launches alone, the wrapper's calls) beside its
     plain version, its bound (bytes over HBM against products at the
     tensor cores' exact rate) and the CUDA cores' operations bound.

Every prove of phases 10, 16 and 22-24 starts from an emptied allocator
cache and holds the memory model: the reserved peak is at most the
modeled prove, and the modeled prove at most 1.5 times the reserved peak.

Every proof path counts the launches of the six kernels
(poseidon2_permute, constraint_quotient, logup_perm_phi, open_eval,
open_reduce, fri_fold) from zero and fails if a kernel it runs never
launched. Prints the kernels' JSON line, then the device line last.
Every time is printed beside the card's name and power limit.
"""

import gzip
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SLICE_N = (1 << 20) - 8
SLICE_CELLS = 19_726_546
FIB100K_CODE = ("(letrec ((fib (lambda (n) (if (<= n 1) n "
                "(+ (fib (- n 1)) (fib (- (- n 1) 1))))))) (fib 100000))")
FIB100K_SHARD_SIZE = 262_144
FIB100K_SHARDS = 4
FIB100K_CELLS = 326_397_960
FIB100K_RESULT = "2754320626097736315"
COMPILED_FIB100K_CELLS = 218_659_792
LCS_RESULT = '"here mst beome nay o e eoe to the ti s  h connct et nor"'
SUM100K_RESULT = "4999950000"
FORCED_PATHS = ({"LURK_TPU_GENERIC_PERM": "0"}, {"LURK_TPU_QUOT": "window"},
                {"LURK_TPU_QUOT": "mono"})
# the forced path whose device events phase 15 counts beside the default
# path's (a profiled proof costs about 40 s of the profiler's processing)
PROFILED_PATH = {"LURK_TPU_QUOT": "window"}
MICROCHAIN_STATE = (
    "(letrec ((acc (lambda (total) (lambda (amount) (let ((total (+ total "
    "amount))) (cons total (commit (acc total)))))))) (cons 0 (commit (acc "
    "0))))")
FIB100K_ARTIFACT = ROOT / "benches" / "artifacts" / "fib100k_4shard_proof.bin.gz"
# phase 20's mesh-commit budget in LDE cells: under the largest group of
# every fib(100000) shard (40,894,464 LDE cells in shards 2 and 3)
MESH_COMMIT_CELLS = 1 << 25
# phase 21's child: joins the gloo group, evaluates fib(100000), proves its
# shards on cuda:0 with multihost_prove and prints one JSON line
MULTIHOST_CHILD = r'''
import hashlib, json, sys, time
import torch
from lurk_tpu_torch.core.eval_api import evaluate
from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
from lurk_tpu_torch.core.stark_machine import new_machine
from lurk_tpu_torch.lair.execute import ShardingConfig
from lurk_tpu_torch.parallel import multihost
from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.stark.open_kernel import fri_fold, open_eval, open_reduce
from lurk_tpu_torch.stark.quotient_kernel import (constraint_quotient,
                                                  logup_perm_phi)
from lurk_tpu_torch.utils import codec

pid, nproc, port, code, shard_size = sys.argv[1:6]
multihost.initialize(f"127.0.0.1:{port}", int(nproc), int(pid))
toplevel, zstore, _ = build_lurk_toplevel()
_, q = evaluate(toplevel, zstore, code)
machine = new_machine(toplevel, FriConfig())
pk, vk = machine.setup()
t0 = time.perf_counter()
proof = multihost.multihost_prove(machine, pk, q, Challenger(),
                                  ShardingConfig(int(shard_size)),
                                  device=True)
torch.cuda.synchronize()
dt = time.perf_counter() - t0
launches = {"poseidon2_permute": permute_mont_cuda.launches,
            "constraint_quotient": constraint_quotient.launches,
            "logup_perm_phi": logup_perm_phi.launches,
            "open_eval": open_eval.launches,
            "open_reduce": open_reduce.launches,
            "fri_fold": fri_fold.launches}
if not machine.verify(vk, proof, Challenger()):
    raise AssertionError("the proof does not verify")
if "jax" in sys.modules:
    raise AssertionError("jax was imported")
torch.distributed.destroy_process_group()
print(json.dumps({"pid": int(pid), "s": dt, "launches": launches,
                  "peak": torch.cuda.max_memory_allocated(),
                  "shards": len(proof.shard_proofs),
                  "sha256": hashlib.sha256(codec.encode(proof)).hexdigest()}))
'''
# H100 SXM data sheet: HBM3 at 3.35 TB/s; 1,979 TOP/s of dense int8 on the
# tensor cores (two operations a MAC), so a 31-bit product made exactly of
# 16 u8 x u8 MACs (open.cu's open_eval) at most this often
HBM_BYTES_PER_S = 3.35e12
EXACT_PRODUCTS_PER_S = 1979e12 / 2 / 16
P_FIELD = 2013265921


def _sync():
    import torch
    torch.cuda.synchronize()


# the kernels whose launches every path counts, by their JSON names
KERNELS = ("poseidon2_permute", "constraint_quotient", "logup_perm_phi",
           "open_eval", "open_reduce", "fri_fold")
OPEN_KERNELS = KERNELS[3:]


def _kernel_fns() -> dict:
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
    from lurk_tpu_torch.stark.open_kernel import (fri_fold, open_eval,
                                                  open_reduce)
    from lurk_tpu_torch.stark.quotient_kernel import (constraint_quotient,
                                                      logup_perm_phi)
    return dict(zip(KERNELS, (permute_mont_cuda, constraint_quotient,
                              logup_perm_phi, open_eval, open_reduce,
                              fri_fold)))


def _zero_counts() -> None:
    for fn in _kernel_fns().values():
        fn.launches = 0


def _counts() -> dict:
    return {k: fn.launches for k, fn in _kernel_fns().items()}


def _since(before: dict) -> dict:
    now = _counts()
    return {k: now[k] - before[k] for k in KERNELS}


def _add(*counts: dict) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in KERNELS}


def _launches(n: dict) -> str:
    return "kernel launches " + ", ".join(f"{k} {n[k]}" for k in KERNELS)


def _require(label: str, n: dict, kernels=KERNELS) -> None:
    """Fail unless every kernel of `kernels` launched in the run counted
    by `n`."""
    missing = [k for k in kernels if n[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: no launch of {missing} ({n})")


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, timed with CUDA events
    after one warm-up run."""
    import torch
    fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return float(out.stdout.split()[0]) * 1e6


# Issue model of one Hopper SM per clock: 4 sub-partitions each issue one
# warp instruction (128 thread-instructions); the FMA pipe (IMAD, IMUL and
# float multiply-adds) and the integer ALU pipe (IADD3, LOP3, SHF, ISETP,
# SEL, ...) each take 64 thread-instructions. IMAD.WIDE and IMAD.HI produce
# 64 bits and take two FMA-pipe slots. Uniform-datapath (U*) instructions,
# memory, constant loads and control are counted for issue only.
_FMA = ("IMAD", "IMUL", "FFMA", "FMUL", "FADD", "HFMA2", "IDP")
_OTHER = ("LD", "ST", "S2R", "S2UR", "BRA", "EXIT", "NOP", "BAR", "RET",
          "CALL", "MEMBAR", "DEPBAR", "WARPSYNC", "BSSY", "BSYNC", "U")


def _sass_counts(lib: Path, width: int) -> dict:
    """Per-thread pipe slots of perm_kernel<width, .> from cuobjdump -sass
    of the built library: the kernel is fully unrolled, so the static
    count is one permutation (plus the state's loads and stores)."""
    cuobjdump = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / \
        "bin" / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    counts = {"fma": 0, "alu": 0, "issue": 0}
    ops = {}
    inside = False
    for line in out.splitlines():
        if "Function :" in line:
            inside = f"perm_kernelILi{width}E" in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if not inside or m is None:
            continue
        op = m.group(1)
        ops[op] = ops.get(op, 0) + 1
        counts["issue"] += 1
        if op.startswith(_FMA):
            counts["fma"] += 2 if op.startswith(("IMAD.WIDE", "IMAD.HI")) \
                else 1
        elif not op.startswith(_OTHER):
            counts["alu"] += 1
    if counts["issue"] == 0:
        raise AssertionError(f"no SASS found for perm_kernel<{width}>")
    counts["top"] = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    return counts


def _perm_bound(counts: dict, width: int, n_perm: int, sms: int,
                clock_hz: float) -> tuple:
    """(bound ms, "bytes" | "operations") of n_perm permutations of
    `width` lanes: the state read once and written once over HBM, against
    the busiest issue resource at the card's maximum SM clock."""
    bytes_ms = 2 * 4 * width * n_perm / HBM_BYTES_PER_S * 1e3
    slots = max(counts["fma"] / 64, counts["alu"] / 64, counts["issue"] / 128)
    ops_ms = slots * n_perm / (sms * clock_hz) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
        (ops_ms, "operations")


def _prove_lurk_golden(dev, shard_size, want, machine_queries,
                       name: str = "Lurk proof", kernels=KERNELS):
    """Prove an evaluated Lurk program (machine_queries, from
    golden.lurk_machine) on the card and hold its sha256 to `want`;
    returns (seconds, kernel launches, the prove's stats). Every kernel
    of `kernels` must launch (fri_fold where the proof has an FRI layer
    above the host tail), and the open kernels as often as plan_stats.py
    counts."""
    from lurk_tpu_torch import plan_stats
    from lurk_tpu_torch.lair.execute import ShardingConfig
    from lurk_tpu_torch.stark import golden
    from lurk_tpu_torch.stark.challenger import Challenger
    _zero_counts()
    t0 = time.perf_counter()
    machine, vk, proof, digest = golden.lurk_proof(dev, shard_size,
                                                   machine_queries)
    _sync()
    dt = time.perf_counter() - t0
    launches = _counts()
    stats = machine.last_device_prove
    if digest != want:
        raise AssertionError(f"{name} (shard size {shard_size}) sha256 "
                             f"{digest} != golden {want}")
    if not machine.verify(vk, proof, Challenger()):
        raise AssertionError(f"{name} (shard size {shard_size}) does "
                             "not verify")
    planned = plan_stats.kernel_launches(
        machine, machine_queries[1],
        None if shard_size is None else ShardingConfig(shard_size))
    if any(launches[k] != planned[k] for k in OPEN_KERNELS):
        raise AssertionError(f"{name}: launches {launches}, plan_stats "
                             f"counts {planned}")
    _require(name, launches, [k for k in kernels
                              if k != "fri_fold" or planned[k]])
    if stats["device_witness_chips"] <= 0:
        raise AssertionError(f"{name}: no device-made witness")
    return dt, launches, stats


def lurk_goldens(dev, on: str) -> None:
    """Phases 8 and 9: the Lurk goldens on `dev` with every chip on the
    device path and device witness on, then device witness == host
    witness for every supported chip."""
    from lurk_tpu_torch.stark import golden, hbm
    from lurk_tpu_torch.stark.fri import FriConfig
    os.environ["LURK_TPU_DEVICE_CHIP_MIN_ROWS"] = "0"
    t0 = time.perf_counter()
    machine, q, shown = golden.lurk_machine(golden.LURK_PROGRAM,
                                            FriConfig(1, 8, 2))
    if shown != golden.LURK_RESULT:
        raise AssertionError(f"Lurk program evaluated to {shown}")
    print(f"Lurk program -> {shown} (toplevel + evaluate "
          f"{time.perf_counter() - t0:.3f}s) {on}")
    dt, n, stats = _prove_lurk_golden(dev, None, golden.GOLDEN_LURK_SHA256,
                                      (machine, q))
    if stats["shards"] != 1:
        raise AssertionError(f"one-shard golden ran {stats}")
    print(f"Lurk golden, one shard: sha256 matches, verified, {dt:.3f}s, "
          f"{_launches(n)}, {stats['device_witness_chips']} device-made "
          f"witnesses {on}")
    fits = (hbm.keep_rounds_fits, hbm.keep_light_fits)
    hbm.keep_rounds_fits = hbm.keep_light_fits = lambda *a: False
    try:
        dt, n, stats = _prove_lurk_golden(
            dev, golden.LURK_2SHARD_SIZE, golden.GOLDEN_LURK_2SHARD_SHA256,
            (machine, q))
    finally:
        hbm.keep_rounds_fits, hbm.keep_light_fits = fits
    if stats["shards"] != 2 or stats["keep_mode"] != "none":
        raise AssertionError(f"2-shard golden ran {stats}")
    print(f"Lurk golden, 2 shards, keep mode none: sha256 matches, "
          f"verified, {dt:.3f}s, {_launches(n)} {on}")

    # 9. device witness on the card == host witness
    print(f"device witness on the card == host witness "
          f"({_witness_parity(dev, machine, q)} chip traces)")
    del os.environ["LURK_TPU_DEVICE_CHIP_MIN_ROWS"]


def _witness_parity(dev, machine, q) -> int:
    """Every chip of `machine` that lair/device_trace.py supports makes on
    `dev` the same trace as on the host, in one shard and in the first 3
    shards at max_shard_size 64; returns the traces compared."""
    from lurk_tpu_torch.field import babybear as bb
    from lurk_tpu_torch.lair import device_trace
    from lurk_tpu_torch.lair.chips import chip_included
    from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
    from lurk_tpu_torch.lair.trace import FuncChip
    n_chips = 0
    for size in (None, 64):
        shards = Shard(q, 0, None if size is None
                       else ShardingConfig(size)).shard()[:3]
        for shard in shards:
            for chip in machine.chips:
                if not (isinstance(chip, FuncChip)
                        and chip_included(chip, shard)
                        and device_trace.supported(chip)):
                    continue
                got = device_trace.generate_trace_device(chip, shard, dev)
                want = np.asarray(chip.generate_trace(shard), np.uint64)
                if not np.array_equal(bb.to_numpy(got).astype(np.uint64),
                                      want):
                    raise AssertionError(f"device witness != host witness: "
                                         f"{chip.name} shard {shard.index} "
                                         f"(size {size})")
                n_chips += 1
    return n_chips


def compiled_goldens(dev, on: str) -> int:
    """Phase 14: the compiled pipeline's goldens on the card with device
    witness and default routing. Returns their kernel launches."""
    from lurk_tpu_torch.core.stark_machine import PRODUCTION_CONFIG
    from lurk_tpu_torch.stark import golden, hbm
    from lurk_tpu_torch.stark.fri import FriConfig
    total = {}
    lurk = golden.lurk_machine(golden.LURK_PROGRAM, FriConfig(1, 8, 2),
                               compiled=True)
    cli = golden.lurk_machine(golden.CLI_PROGRAM, PRODUCTION_CONFIG,
                              compiled=True)
    if lurk[2] != golden.LURK_RESULT or len(lurk[0].chips) != 43:
        raise AssertionError(f"compiled program evaluated to {lurk[2]} on "
                             f"{len(lurk[0].chips)} chips")
    fits = (hbm.keep_rounds_fits, hbm.keep_light_fits)
    # the small LURK_PROGRAM goldens put every chip on the device path (and
    # device witness), as phase 8 does; fib(1000) keeps the default routing
    for label, mq, size, want, shards in (
            ("LURK_PROGRAM, one shard, every chip on the device path", lurk,
             None, golden.COMPILED_LURK_SHA256, 1),
            ("LURK_PROGRAM, 2 shards, keep mode none, every chip on the "
             "device path", lurk, golden.LURK_2SHARD_SIZE,
             golden.COMPILED_LURK_2SHARD_SHA256, 2),
            (f"CLI_PROGRAM = {cli[2]} at PRODUCTION_CONFIG", cli, None,
             golden.COMPILED_CLI_SHA256, 1)):
        if mq is lurk:
            os.environ["LURK_TPU_DEVICE_CHIP_MIN_ROWS"] = "0"
        if size is not None:
            hbm.keep_rounds_fits = hbm.keep_light_fits = lambda *a: False
        try:
            dt, n, stats = _prove_lurk_golden(dev, size, want, mq[:2],
                                              f"compiled {label}")
        finally:
            hbm.keep_rounds_fits, hbm.keep_light_fits = fits
            os.environ.pop("LURK_TPU_DEVICE_CHIP_MIN_ROWS", None)
        if stats["shards"] != shards:
            raise AssertionError(f"compiled {label} ran {stats}")
        total = _add(total, n)
        cells = stats["device_witness_cells"] + stats["host_witness_cells"]
        print(f"compiled golden {label}: {cells} padded cells, "
              f"sha256 == lurk_tpu's {want}, verified, {dt:.3f}s, "
              f"{_launches(n)}, keep mode {stats['keep_mode']}, "
              f"{stats['device_witness_chips']} device-made witnesses {on}")
    print(f"compiled machine: device witness on the card == host witness "
          f"({_witness_parity(dev, lurk[0], lurk[1])} chip traces)")
    return total


def _device_events(prove) -> int:
    """Device events (kernels and copies) of one prove under
    torch.profiler, tracing the CUDA activity only (tracing host ops too
    made the event post-processing take minutes)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        prove()
        _sync()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def forced_paths(dev, on: str) -> int:
    """Phase 15: the direct LURK_PROGRAM golden with every chip on the
    device path, on the default path and under each of FORCED_PATHS;
    every proof has GOLDEN_LURK_SHA256. Returns the forced proofs' kernel
    launches."""
    from lurk_tpu_torch.stark import golden
    from lurk_tpu_torch.stark.fri import FriConfig
    os.environ["LURK_TPU_DEVICE_CHIP_MIN_ROWS"] = "0"
    mq = golden.lurk_machine(golden.LURK_PROGRAM, FriConfig(1, 8, 2))[:2]
    total = {}
    try:
        for env in ({},) + FORCED_PATHS:
            os.environ.update(env)
            # the DAG perm trace takes logup_perm_phi's place, the DAG
            # quotients constraint_quotient's
            kernels = [k for k in KERNELS if not (
                k == "logup_perm_phi" and "LURK_TPU_GENERIC_PERM" in env
                or k == "constraint_quotient" and "LURK_TPU_QUOT" in env)]
            try:
                label = " ".join(f"{k}={v}" for k, v in env.items()) or \
                    "default paths"
                dt, n, _ = _prove_lurk_golden(dev, None,
                                              golden.GOLDEN_LURK_SHA256, mq,
                                              f"Lurk golden ({label})",
                                              kernels)
                events = ""
                if env in ({}, PROFILED_PATH):
                    t0 = time.perf_counter()
                    n_events = _device_events(lambda: golden.lurk_proof(
                        dev, None, mq))
                    events = (f", {n_events} device events in a second "
                              f"proof under torch.profiler "
                              f"({time.perf_counter() - t0:.3f}s with the "
                              "profiler's processing)")
            finally:
                for k in env:
                    del os.environ[k]
            if env:
                total = _add(total, n)
            print(f"Lurk golden, every chip on the device path, {label}: "
                  f"sha256 == GOLDEN_LURK_SHA256, verified, {dt:.3f}s, "
                  f"{_launches(n)}{events} {on}")
    finally:
        del os.environ["LURK_TPU_DEVICE_CHIP_MIN_ROWS"]
    return total


def loam_and_narrow(on: str) -> None:
    """Phase 17: the loam and narrow copies import without jax here, and
    loam evaluates fib(5) (tests/test_loam.py's program) to 8n."""
    from lurk_tpu_torch import loam
    from lurk_tpu_torch.core.zstore import lurk_zstore
    from lurk_tpu_torch.poseidon import narrow
    t0 = time.perf_counter()
    zstore = lurk_zstore()
    src = ("(letrec ((fibonacci (lambda (n) (if (< n 2n) 1n "
           "(+ (fibonacci (- n 2n)) (fibonacci (- n 1n)))))))"
           " (fibonacci 5n))")
    inp = loam.WidePtr.from_zptr(zstore.read(src))
    want = loam.WidePtr.from_zptr(zstore.read("8n"))
    prog = loam.EvaluationProgram(zstore)
    prog.set_toplevel_input(inp, None)
    prog.run()
    if prog.output_exprs != [want]:
        raise AssertionError(f"loam fib(5) -> {prog.output_exprs}")
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    print(f"loam fib(5) = 8n in {time.perf_counter() - t0:.3f}s; narrow "
          f"chip w16 has {narrow.rounds(16)} rounds; no jax imported {on}")


def fib100k(dev, on: str, code: str, shard_size: int, want_shards: int,
            want_cells: int, want_sha, compiled: bool = False) -> int:
    """Phases 10 and 16: evaluate `code` with the direct (or compiled)
    pipeline, set up with the key cache in a temporary LURK_DIR, prove it
    twice (cold, warm) through machine.prove(..., device=True) at
    FriConfig() and ShardingConfig(shard_size), hold the result to
    FIB100K_RESULT and the proof to want_sha (when given; cold and warm
    always agree) and verify it. Returns the warm prove's kernel
    launches and (machine, pk, vk, queries, sharding config)."""
    import torch
    from lurk_tpu_torch import plan_stats
    from lurk_tpu_torch.core import eval_compiled, eval_direct
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair import native
    from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.stark.key_cache import setup_cached
    from lurk_tpu_torch.utils import codec
    if not native.native_available():
        raise AssertionError("fib(100000) needs the native interpreter "
                             "(cpp/liblair.so)")
    lurk_dir = tempfile.mkdtemp(prefix="lurk_dir_")
    os.environ["LURK_DIR"] = lurk_dir
    try:
        pipeline = eval_compiled if compiled else eval_direct
        toplevel, zstore, _ = pipeline.build_lurk_toplevel()
        machine = new_machine(toplevel, FriConfig())
        t0 = time.perf_counter()
        result, q = evaluate(toplevel, zstore, code)
        eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pk, vk = setup_cached(machine)
        setup_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(lurk_dir, ignore_errors=True)
        del os.environ["LURK_DIR"]
    cfg = ShardingConfig(max_shard_size=shard_size)
    cells = machine._trace_cells(q, cfg)
    n_shards = len(Shard(q, 0, cfg).shard())
    label = "compiled " if compiled else ""
    shown = zstore.fmt(result)
    print(f"{label}fib(100000) = {shown}: {len(machine.chips)} chips, eval "
          f"{eval_s:.3f}s, setup {setup_s:.3f}s, {n_shards} shards, {cells} "
          f"padded cells {on}")
    if shown != FIB100K_RESULT:
        raise AssertionError(f"fib(100000) evaluated to {shown}")
    if (n_shards, cells) != (want_shards, want_cells):
        raise AssertionError(f"{n_shards} shards / {cells} cells, expected "
                             f"{want_shards} / {want_cells}")
    runs = []
    for run in ("cold", "warm"):
        torch.cuda.empty_cache()
        _zero_counts()
        t0 = time.perf_counter()
        proof = machine.prove(pk, q, Challenger(), shard_config=cfg,
                              device=True)
        _sync()
        dt = time.perf_counter() - t0
        n = _counts()
        stats = machine.last_device_prove
        sha = hashlib.sha256(codec.encode(proof)).hexdigest()
        runs.append((dt, n, sha))
        print(f"{label}fib(100000) {run} prove: {dt:.3f}s "
              f"({cells / dt:.1f} cells/s), witness on the card "
              f"{stats['device_witness_s']:.3f}s for "
              f"{stats['device_witness_chips']} chips / "
              f"{stats['device_witness_cells']} cells, on the host "
              f"{stats['host_witness_s']:.3f}s for "
              f"{stats['host_witness_chips']} chips / "
              f"{stats['host_witness_cells']} cells, keep mode "
              f"{stats['keep_mode']}, {_memory(stats)}, {_launches(n)}, "
              f"sha256 {sha} {on}")
        _check_memory(f"{label}fib(100000) {run}", stats)
        _require(f"{label}fib(100000) {run}", n)
        if stats["device_witness_chips"] <= 0:
            raise AssertionError(f"{label}fib(100000): no device-made "
                                 "witness")
        if len(proof.shard_proofs) != want_shards:
            raise AssertionError(f"{len(proof.shard_proofs)} shards")
    planned = plan_stats.kernel_launches(machine, q, cfg)
    if any(runs[1][1][k] != v for k, v in planned.items()):
        raise AssertionError(f"{label}fib(100000): launches {runs[1][1]}, "
                             f"plan_stats counts {planned}")
    print(f"{label}fib(100000): the warm prove's constraint_quotient, "
          f"logup_perm_phi, open_eval, open_reduce and fri_fold launches "
          f"equal plan_stats.py's count {planned} {on}")
    if runs[0][2] != runs[1][2]:
        raise AssertionError(f"{label}fib(100000): cold and warm proofs "
                             "differ")
    if want_sha is not None and runs[1][2] != want_sha:
        raise AssertionError(f"fib(100000) proof sha256 {runs[1][2]} != "
                             f"the checked-in proof's {want_sha}")
    t0 = time.perf_counter()
    ok = machine.verify(vk, proof, Challenger())
    vt = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"{label}fib(100000) proof does not verify")
    held = "cold == warm" if want_sha is None else \
        f"== checked-in proof's {want_sha}"
    print(f"{label}fib(100000): proof sha256 {held}, verified in {vt:.3f}s "
          f"{on}")
    return runs[1][1], (machine, pk, vk, q, cfg), (toplevel, zstore, eval_s)


def _memory(stats) -> str:
    """The prove's modeled high-water against its measured peaks, and the
    phases that set them."""
    g = 2 ** 30
    peaks = stats["phase_peaks"]
    top = max(peaks, key=lambda p: p["allocated"])
    first = next(p for p in peaks
                 if p["reserved"] == stats["peak_reserved_bytes"])
    return (f"modeled prove {stats['modeled_prove_bytes'] / g:.2f} GiB vs "
            f"peak reserved {stats['peak_reserved_bytes'] / g:.2f} GiB "
            f"(reached in {first['phase']}), peak allocated "
            f"{stats['peak_allocated_bytes'] / g:.2f} GiB (in "
            f"{top['phase']}), modeled one shard "
            f"{stats['modeled_highwater_bytes'] / g:.2f} GiB, budget "
            f"{stats['budget_bytes'] / g:.2f} GiB")


def _check_memory(label: str, stats) -> None:
    """The memory model bounds the measured reserved peak from above, by
    no more than 1.5x; the phase peaks go to stdout as one JSON line."""
    print("phase peaks " + json.dumps({"proof": label, "phases": [
        [p["phase"], p["modeled"], p["reserved"], p["allocated"],
         p["resident"]] for p in stats["phase_peaks"]]}))
    reserved, modeled = stats["peak_reserved_bytes"], \
        stats["modeled_prove_bytes"]
    if not reserved <= modeled <= 1.5 * reserved:
        raise AssertionError(f"{label}: modeled {modeled} B against a "
                             f"reserved peak of {reserved} B")


def _default_prove(machine, pk, vk, q, label: str, on: str,
                   runs=("cold", "warm")):
    """Prove q at the default config (no shard_config) through
    machine.prove(..., device=True), once per run in `runs`, each after
    torch.cuda.empty_cache(); print each run's plan, seconds, memory
    against the model and kernel launches; hold the runs' proofs equal,
    the memory bounds and the proof to the verifier. Returns (sha256,
    the last run's launches and stats)."""
    import torch
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.utils import codec
    shas = []
    for run in runs:
        torch.cuda.empty_cache()
        _zero_counts()
        t0 = time.perf_counter()
        proof = machine.prove(pk, q, Challenger(), device=True)
        _sync()
        dt = time.perf_counter() - t0
        n = _counts()
        stats = machine.last_device_prove
        shas.append(hashlib.sha256(codec.encode(proof)).hexdigest())
        print(f"{label} {run} prove at the default config: "
              f"{stats['shards']} shard(s), keep mode {stats['keep_mode']}, "
              f"{dt:.3f}s, {_launches(n)}, {_memory(stats)}, sha256 "
              f"{shas[-1]} {on}")
        _check_memory(f"{label} {run} at the default config", stats)
        _require(f"{label} {run}", n)
        if len(proof.shard_proofs) != stats["shards"]:
            raise AssertionError(f"{label}: {len(proof.shard_proofs)} shard "
                                 "proofs")
    if len(set(shas)) != 1:
        raise AssertionError(f"{label}: the runs' proofs differ {shas}")
    t0 = time.perf_counter()
    if not machine.verify(vk, proof, Challenger()):
        raise AssertionError(f"{label} does not verify")
    print(f"{label}: verified in {time.perf_counter() - t0:.3f}s {on}")
    return shas[-1], n, stats


def _plan_under(machine, q, limit: int, dev):
    """(shards, keep mode) that device_prove plans on `dev` for a device
    limit."""
    from lurk_tpu_torch.stark import hbm
    shards, budget = hbm.plan_shards(machine, q, None, dev, limit_bytes=limit)
    return len(shards), hbm.keep_mode(machine, shards, budget, dev)


def _cap_for(machine, q, size: int, keep_mode: str, dev) -> int:
    """A device limit under which the planner picks `size`-row shards in
    `keep_mode`, with the modeled prove at 0.9 of its budget or above."""
    from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
    from lurk_tpu_torch.stark import hbm
    shards = Shard(q, 0, ShardingConfig(size)).shard()
    modeled = hbm.modeled_prove_bytes(machine, shards, keep_mode, dev)
    for share in (0.9, 0.95, 0.99, 1.0):
        limit = hbm.limit_for_budget(int(modeled / share))
        if _plan_under(machine, q, limit, dev) == (len(shards), keep_mode):
            return limit
    raise AssertionError(f"no device limit plans {len(shards)} shards in "
                         f"keep mode {keep_mode}")


def default_config_fib100k(on: str, mqs, eval_s: float, want_sha: str):
    """Phases 22 and 23: phase 10's fib(100000) machine, keys and queries
    (its evaluation took eval_s) proved at the default config, on the
    whole card (cold and warm), then
    in a process capped with torch.cuda.set_per_process_memory_fraction
    at limits under which the planner picks 4 shards in keep mode `full`,
    4 in `light` and 8 in `none`. Returns the launches of the whole-card
    warm prove and of the capped proves together."""
    import torch
    machine, pk, vk, q, _ = mqs
    print(f"fib(100000) at the default config: eval {eval_s:.3f}s (phase "
          f"10), {machine._trace_cells(q, None)} padded cells at the "
          f"default shard size {on}")
    _, launches, stats = _default_prove(machine, pk, vk, q, "fib(100000)",
                                        on)
    if stats["keep_mode"] != "full":
        raise AssertionError(f"fib(100000) on the whole card planned {stats}")
    total = torch.cuda.mem_get_info()[1]
    dev = torch.device("cuda", torch.cuda.current_device())
    capped = {}
    for size, keep_mode in ((1 << 18, "full"), (1 << 18, "light"),
                            (1 << 17, "none")):
        limit = _cap_for(machine, q, size, keep_mode, dev)
        label = (f"fib(100000) capped at {limit / 2**30:.2f} GiB "
                 f"({limit / total:.4f} of the card)")
        torch.cuda.empty_cache()
        torch.cuda.set_per_process_memory_fraction(limit / total)
        try:
            sha, n, stats = _default_prove(machine, pk, vk, q, label, on,
                                           runs=("warm",))
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0)
        capped = _add(capped, n)
        share = stats["modeled_prove_bytes"] / stats["budget_bytes"]
        want = (FIB100K_SHARDS if size == FIB100K_SHARD_SIZE else
                2 * FIB100K_SHARDS, keep_mode)
        if (stats["shards"], stats["keep_mode"]) != want or share < 0.8:
            raise AssertionError(f"{label}: planned {stats['shards']} "
                                 f"shards, keep mode {stats['keep_mode']}, "
                                 f"{share:.3f} of the budget; want {want}")
        if size == FIB100K_SHARD_SIZE and sha != want_sha:
            raise AssertionError(f"{label}: sha256 {sha} != the checked-in "
                                 f"proof's {want_sha}")
        print(f"{label}: {stats['shards']} shards, keep mode "
              f"{stats['keep_mode']}, modeled prove {share:.3f} of the "
              f"budget" + (", == checked-in proof"
                           if size == FIB100K_SHARD_SIZE else "") + f" {on}")
    return launches, capped


def default_config_benches(on: str, mqs, toplevel, zstore) -> dict:
    """Phase 24: the reference's sum and lcs benches
    (benches/lurk_bench.py's sum_expr(100000) and lcs_expr(), the
    arguments of benches/sum.rs and lcs.rs) evaluated on phase 10's
    toplevel and store and proved with its machine and keys at the
    default config on the whole card, cold and warm, each verified.
    Returns each bench's warm launches."""
    sys.path.insert(0, str(ROOT / "benches"))
    from lurk_bench import lcs_expr, sum_expr
    from lurk_tpu_torch.core.eval_api import evaluate
    machine, pk, vk, _, _ = mqs
    launches = {}
    for name, code, want in (("lcs", lcs_expr(), LCS_RESULT),
                             ("sum(100000)", sum_expr(100000),
                              SUM100K_RESULT)):
        t0 = time.perf_counter()
        result, q = evaluate(toplevel, zstore, code)
        eval_s = time.perf_counter() - t0
        shown = zstore.fmt(result)
        cells = machine._trace_cells(q, None)
        print(f"{name} = {shown}: eval {eval_s:.3f}s, {cells} padded cells "
              f"at the default shard size {on}")
        if shown != want:
            raise AssertionError(f"{name} evaluated to {shown}, not {want}")
        _, launches[name], _ = _default_prove(machine, pk, vk, q, name, on)
    return launches


def _proofs(lurk_dir: Path) -> set:
    return set((lurk_dir / "proofs").glob("*"))


class _TimedProves:
    """Wraps repl.prove_last_reduction, the one way a REPL proves: records
    each prove's padded main-trace cells, host seconds (ending in a device
    sync) and kernel launches."""

    def __init__(self, repl):
        self.repl = repl
        self.inner = repl.prove_last_reduction
        self.runs = []
        repl.prove_last_reduction = self

    def __call__(self):
        cells = self.repl.machine()._trace_cells(self.repl.queries, None)
        n0 = _counts()
        t0 = time.perf_counter()
        key = self.inner()
        _sync()
        self.runs.append((cells, time.perf_counter() - t0, _since(n0)))
        return key


def _load_demo(repl, timed, lurk_dir: Path, name: str):
    """Load demo/<name>.lurk into `repl` after `!(clear)`, with no proof in
    the cache; check every proof file it writes against lurk_tpu's sha256
    (where deterministic) and `!(verify)` it. Returns (seconds, kernel
    launches, proof files, the proves' (cells, seconds, launches))."""
    from lurk_tpu_torch.stark import golden
    for path in _proofs(lurk_dir):
        path.unlink()
    timed.runs.clear()
    repl.process("!(clear)")
    _zero_counts()
    t0 = time.perf_counter()
    repl.load_file(ROOT / "demo" / f"{name}.lurk")
    _sync()
    dt = time.perf_counter() - t0
    launches = _counts()
    got = {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
           for p in sorted(_proofs(lurk_dir))}
    if len(got) != len(timed.runs):
        raise AssertionError(f"{name}: {len(timed.runs)} proves, "
                             f"{len(got)} proof files")
    want = golden.DEMO_PROOF_SHA256.get(name)
    if want is not None and got != want:
        raise AssertionError(f"{name}: proof files {got} != lurk_tpu's "
                             f"{want}")
    for key in got:
        if repl.process(f'!(verify "{key}")') != repl.zstore.t:
            raise AssertionError(f"{name}: {key} does not verify")
    return dt, launches, got, list(timed.runs)


def repl_corpus(on: str, lurk_dir: Path):
    """Phase 11: the demo corpus through one REPL at PRODUCTION_CONFIG,
    cold then warm, then the smallest demo proof on the host prover and
    on the card in turns. Returns (the REPL, the cold pass's kernel
    launches)."""
    from lurk_tpu_torch.cli.repl import Repl
    from lurk_tpu_torch.stark import golden
    t0 = time.perf_counter()
    repl = Repl()
    timed = _TimedProves(repl)
    print(f"REPL at {repl.config}: built in {time.perf_counter() - t0:.3f}s "
          f"{on}")
    total = {}
    cells = {}
    for label in ("cold", "warm"):
        for name in golden.DEMO_FILES:
            dt, launches, got, runs = _load_demo(repl, timed, lurk_dir, name)
            if got:
                _require(name, launches, KERNELS[:1])
            if label == "cold":
                total = _add(total, launches)
            if len(runs) == 1 and name in golden.DEMO_PROOF_SHA256:
                cells[name] = runs[0][0]
            proves = ", ".join(f"{c} cells {s:.3f}s "
                               f"{n['poseidon2_permute']} Poseidon2 launches"
                               for c, s, n in runs) or "none"
            held = ("== lurk_tpu's" if name in golden.DEMO_PROOF_SHA256
                    else "not held (!(rand))" if got else "-")
            print(f"REPL {label} {name}.lurk: {dt:.3f}s, {len(got)} proofs "
                  f"({proves}), {_launches(launches)}, sha256 {held}, "
                  f"verified {on}")
    # the smallest demo proof: host prover (LURK_TPU_PROVE=host) against
    # the card, in turns
    name = min(cells, key=cells.get)
    for prover in ("host", "device", "device", "host"):
        if prover == "host":
            os.environ["LURK_TPU_PROVE"] = "host"
        try:
            _, launches, _, runs = _load_demo(repl, timed, lurk_dir, name)
        finally:
            os.environ.pop("LURK_TPU_PROVE", None)
        if (launches["poseidon2_permute"] > 0) != (prover == "device"):
            raise AssertionError(f"{prover} prover: {launches}")
        print(f"smallest demo proof ({name}.lurk, {runs[0][0]} cells) on "
              f"the {prover} prover: !(prove) {runs[0][1]:.3f}s, "
              f"{_launches(launches)}, sha256 == lurk_tpu's {on}")
    repl.prove_last_reduction = timed.inner
    return repl, total


def cli_load(on: str, lurk_dir: Path) -> int:
    """Phase 12: `python -m lurk_tpu_torch load <file> --prove` in a child
    process; returns its prove's kernel launches, which device_prove
    prints under LURK_TPU_PROVE_TIMING=1."""
    from lurk_tpu_torch.stark import golden
    src = lurk_dir / "cli_program.lurk"
    src.write_text(golden.CLI_PROGRAM)
    env = dict(os.environ, LURK_TPU_PROVE_TIMING="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(ROOT), os.environ.get("PYTHONPATH"))
                   if p))
    env.pop("LURK_TPU_PROVE", None)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "lurk_tpu_torch", "load",
                          str(src), "--prove"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"python -m lurk_tpu_torch load --prove exited "
                             f"{res.returncode}:\n{res.stdout}\n"
                             f"{res.stderr[-4000:]}")
    key = re.search(r'Proof key: "([0-9a-f]+)"', res.stdout).group(1)
    sha = hashlib.sha256((lurk_dir / "proofs" / key).read_bytes()).hexdigest()
    if (key, sha) != (golden.CLI_PROOF_KEY, golden.CLI_PROOF_SHA256):
        raise AssertionError(f"CLI proof {key} sha256 {sha} != lurk_tpu's "
                             f"{golden.CLI_PROOF_KEY} {golden.CLI_PROOF_SHA256}")
    found = re.findall(
        r"\[prove-timing\] device_prove: .* (\d+) Poseidon2 kernel "
        r"launches, (\d+) constraint_quotient launches, (\d+) "
        r"logup_perm_phi launches, (\d+) open_eval launches, (\d+) "
        r"open_reduce launches, (\d+) fri_fold launches", res.stderr)
    if len(found) != 1:
        raise AssertionError(f"CLI prove launches {found}")
    launches = dict(zip(KERNELS, map(int, found[0])))
    _require("CLI load --prove", launches, KERNELS[:1])
    timing = [l for l in res.stderr.splitlines()
              if l.startswith("[prove-timing]")]
    print("\n".join(f"  cli {l}" for l in timing))
    print(f"CLI load --prove fib(1000): exit 0 in {dt:.3f}s (process), "
          f"{_launches(launches)}, proof sha256 == lurk_tpu's {sha} {on}")
    return launches


def microchain_round_trip(on: str, repl) -> int:
    """Phase 13: a microchain server (its own REPL, verifying on the host)
    on a daemon thread; `repl` starts a chain and proves two transitions
    on the card. Returns the transitions' kernel launches."""
    import socket
    from lurk_tpu_torch.cli import microchain
    from lurk_tpu_torch.cli.repl import Repl
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    threading.Thread(target=microchain.serve, args=(Repl(), addr),
                     daemon=True).start()
    deadline = time.monotonic() + 60
    while True:
        try:
            socket.create_connection(("127.0.0.1", port)).close()
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.1)
    repl.process("!(clear)")
    repl.process(f"!(def s0 {MICROCHAIN_STATE})")
    repl.process(f'!(def id !(microchain-start "{addr}" s0))')
    _zero_counts()
    t0 = time.perf_counter()
    repl.process(f'!(defq s1 !(microchain-transition "{addr}" id s0 7))')
    repl.process(f'!(defq s2 !(microchain-transition "{addr}" id s1 10))')
    _sync()
    dt = time.perf_counter() - t0
    launches = _counts()
    _require("microchain transitions", launches, KERNELS[:1])
    total = repl.fmt(repl.process("(car s2)"))
    if total != "17":
        raise AssertionError(f"microchain state total {total} != 17")
    if repl.process(f'!(microchain-verify "{addr}" id)') != repl.zstore.t:
        raise AssertionError("microchain history does not verify")
    print(f"microchain: 2 transitions proved on the card and accepted in "
          f"{dt:.3f}s, {_launches(launches)}, history verified {on}")
    return launches


def _wall_ms(fn, reps: int = 1) -> float:
    """Mean host-clock milliseconds of fn() over reps runs, each ending in
    a synchronize of every card, after one warm-up run (the mesh paths
    span several devices, which one device's CUDA events do not)."""
    import torch
    fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return (time.perf_counter() - t0) * 1e3 / reps


def mesh_blocks(dev, on: str, rng) -> int:
    """Phase 18: the mesh blocks over 4 slots on `dev` (and over every card
    when there are two or more) against their single-device results.
    Returns the kernel launches of the sharded calls."""
    import torch
    from lurk_tpu_torch.field import babybear as bb
    from lurk_tpu_torch.field.ntt import device_ntt, intt
    from lurk_tpu_torch.parallel import mesh as pmesh
    from lurk_tpu_torch.parallel.ntt_mesh import mesh_intt, mesh_ntt
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_cuda, \
        permute_mont_cuda
    from lurk_tpu_torch.stark import hasher
    from lurk_tpu_torch.stark.device_prover import mod_tree_sum

    def rand(shape):
        return torch.from_numpy(rng.integers(0, bb.P, shape)
                                .astype(np.int32)).to(dev)

    states, mat = rand((1 << 21, 16)), rand((1 << 22, 16))
    phi, x = rand((1 << 22, 4)), rand((1 << 21, 8))
    want_perm = permute_cuda(states)
    want_hash = hasher.hash_rows(mat)
    want_fwd = device_ntt(x, 21, False).to(bb.I32)
    want_inv = intt(x)
    meshes = [(f"4 slots on {dev}", pmesh.Mesh([dev] * 4, ("shard",)))]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        meshes.append((f"{n_cards} cards", pmesh.make_mesh()))
        current = torch.cuda.current_device()
        other = torch.device("cuda", (current + 1) % n_cards)
        permute_mont_cuda(bb.to_mont(states[:1024].to(other).T).contiguous())
        torch.cuda.synchronize(other)
        if torch.cuda.current_device() != current:
            raise AssertionError("a launch on another card changed the "
                                 "current device")
        print(f"a launch on {other} left the current device cuda:{current}")
    launches = 0
    for label, mesh in meshes:
        checks = (
            ("sharded_permute w16 x 2^21",
             lambda: pmesh.sharded_permute(mesh, states), want_perm,
             lambda: permute_cuda(states)),
            ("sharded_leaf_hash (2^22, 16)",
             lambda: pmesh.sharded_leaf_hash(mesh, mat), want_hash,
             lambda: hasher.hash_rows(mat)),
            ("sharded_logup_sum (2^22, 4)",
             lambda: pmesh.sharded_logup_sum(mesh, phi),
             mod_tree_sum(phi, dim=0), lambda: mod_tree_sum(phi, dim=0)),
            ("sharded_commit_step (2^22, 16)",
             lambda: pmesh.sharded_commit_step(mesh, mat)[0], want_hash,
             None),
            ("mesh_ntt 2^21 x 8", lambda: mesh_ntt(mesh, x), want_fwd,
             lambda: device_ntt(x, 21, False)),
            ("mesh_intt 2^21 x 8", lambda: mesh_intt(mesh, x), want_inv,
             lambda: intt(x)))
        # the count covers the sharded calls only: each block's check run,
        # warm-up and timed run, the commit-step sum and the NTT round
        # trip; the one-device timings run after it is read
        permute_mont_cuda.launches = 0
        mesh_ms = []
        for name, run, want, _ in checks:
            if not torch.equal(run(), want):
                raise AssertionError(f"{name} over {label} != one device")
            mesh_ms.append(_wall_ms(run))
        total = pmesh.sharded_commit_step(mesh, mat)[1]
        if not torch.equal(total, mod_tree_sum(want_hash[:, :4], dim=0)):
            raise AssertionError(f"sharded_commit_step sum over {label}")
        if not torch.equal(mesh_intt(mesh, mesh_ntt(mesh, x)), x):
            raise AssertionError(f"mesh NTT round trip over {label}")
        n = permute_mont_cuda.launches
        launches += n
        for (name, _, _, single), ms in zip(checks, mesh_ms):
            times = f"{ms:.3f} ms"
            if single is not None:
                times += f" (one device {_wall_ms(single):.3f} ms)"
            print(f"{name} over {label} == one device: {times} {on}")
        print(f"mesh blocks over {label}: {n} kernel launches in the "
              f"sharded calls {on}")
    return launches


def mesh_prove_fib100k(dev, on: str, mqs, want_sha: str) -> int:
    """Phase 19: mesh_prove of phase 10's fib(100000) over 2 slots on
    `dev`. Returns its kernel launches."""
    import torch
    from lurk_tpu_torch.parallel import mesh as pmesh
    from lurk_tpu_torch.parallel.shard_prover import (
        mesh_cumulative_balance, mesh_prove)
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.utils import codec
    machine, pk, vk, q, cfg = mqs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    proof = mesh_prove(machine, pk, q, Challenger(), devices=[dev, dev],
                       shard_config=cfg)
    _sync()
    dt = time.perf_counter() - t0
    launches = _counts()
    sha = hashlib.sha256(codec.encode(proof)).hexdigest()
    if sha != want_sha:
        raise AssertionError(f"mesh_prove fib(100000) sha256 {sha} != the "
                             f"checked-in proof's {want_sha}")
    if not machine.verify(vk, proof, Challenger()):
        raise AssertionError("mesh_prove fib(100000) does not verify")
    balance = mesh_cumulative_balance(pmesh.Mesh([dev, dev], ("shard",)),
                                      proof.shard_proofs)
    if balance != (0, 0, 0, 0):
        raise AssertionError(f"mesh_prove: balance {balance}")
    _require("mesh_prove", launches)
    print(f"mesh_prove fib(100000), {len(proof.shard_proofs)} shards over 2 "
          f"slots on {dev}: {dt:.3f}s, {_launches(launches)}, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB, balance 0, == checked-in proof's {sha}, verified {on}")
    return launches


def mesh_commit_fib100k(dev, on: str, mqs, want_sha: str) -> int:
    """Phase 20: machine.prove(..., device=True) of phase 10's fib(100000)
    with the mesh commit over 4 slots on `dev`. Returns its kernel
    launches."""
    import torch
    from lurk_tpu_torch.parallel import ntt_mesh
    from lurk_tpu_torch.stark import device_prover
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.utils import codec
    machine, pk, vk, q, cfg = mqs
    env = {"LURK_TPU_MESH_DEVICES": ",".join([str(dev)] * 4),
           "LURK_TPU_MESH_COMMIT": "1",
           "LURK_TPU_MESH_COMMIT_CELLS": str(MESH_COMMIT_CELLS)}
    # groups through mesh_lde in each shard's main commit: pass 1 commits
    # every shard's main traces in shard order, the only dcommit calls
    # with finalize=False
    real_dcommit = device_prover.dcommit
    main_routed = []

    def counting_dcommit(matrices, device=None, finalize=True):
        c0 = ntt_mesh.mesh_lde.calls
        rnd = real_dcommit(matrices, device, finalize)
        if not finalize:
            main_routed.append(ntt_mesh.mesh_lde.calls - c0)
        return rnd

    os.environ.update(env)
    device_prover.dcommit = counting_dcommit
    try:
        torch.cuda.empty_cache()
        _zero_counts()
        calls = ntt_mesh.mesh_lde.calls
        t0 = time.perf_counter()
        proof = machine.prove(pk, q, Challenger(), shard_config=cfg,
                              device=True)
        _sync()
        dt = time.perf_counter() - t0
        launches = _counts()
        routed = ntt_mesh.mesh_lde.calls - calls
    finally:
        device_prover.dcommit = real_dcommit
        for k in env:
            del os.environ[k]
    sha = hashlib.sha256(codec.encode(proof)).hexdigest()
    shards = len(proof.shard_proofs)
    if sha != want_sha:
        raise AssertionError(f"mesh-commit fib(100000) sha256 {sha} != the "
                             f"checked-in proof's {want_sha}")
    if len(main_routed) != shards or min(main_routed) < 1:
        raise AssertionError(f"mesh commit: groups through mesh_lde by "
                             f"shard's main commit {main_routed} for {shards} "
                             "shards")
    _require("mesh commit", launches)
    if not machine.verify(vk, proof, Challenger()):
        raise AssertionError("mesh-commit fib(100000) does not verify")
    print(f"mesh commit fib(100000) over 4 slots on {dev}, budget "
          f"{MESH_COMMIT_CELLS} LDE cells: {routed} groups through mesh_lde "
          f"({shards} shards; main commits by shard {main_routed}), "
          f"{dt:.3f}s, {_launches(launches)}, peak device memory "
          f"{machine.last_device_prove['peak_allocated_bytes'] / 2**30:.2f} "
          f"GiB, == checked-in proof's {sha}, verified {on}")
    return launches


def multihost_fib100k(on: str, want_sha: str) -> int:
    """Phase 21: two child processes prove fib(100000) with
    multihost_prove over gloo, both on cuda:0. Returns their kernel
    launches together."""
    import socket
    import torch
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_CHILD, str(pid), "2", str(port),
         FIB100K_CODE, str(FIB100K_SHARD_SIZE)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    dt = time.perf_counter() - t0
    results = []
    for p, (out, err) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"multihost child exited {p.returncode}:\n"
                                 f"{out}\n{err[-4000:]}")
        results.append(json.loads(out.strip().splitlines()[-1]))
    for r in results:
        if r["sha256"] != want_sha or r["shards"] != FIB100K_SHARDS:
            raise AssertionError(f"multihost child {r}: expected "
                                 f"{FIB100K_SHARDS} shards, sha256 {want_sha}")
        _require(f"multihost process {r['pid']}", r["launches"])
        print(f"multihost process {r['pid']} of 2 on cuda:0 (shards "
              f"{r['pid']} and {r['pid'] + 2}): multihost_prove {r['s']:.3f}s, "
              f"{_launches(r['launches'])}, peak device memory "
              f"{r['peak'] / 2**30:.2f} GiB, full proof == checked-in "
              f"proof's {r['sha256']}, verified {on}")
    print(f"multihost fib(100000): both processes done in {dt:.3f}s "
          f"(process start, evaluation, setup, prove, verify) {on}")
    return _add(*(r["launches"] for r in results))


# Pipe-slot model of the field arithmetic of the quotient kernels, per thread:
# a multiply is one Montgomery product (IMAD.WIDE for a*b and for m*p, two
# FMA-pipe slots each, and IMAD for m: 5 slots), an add or subtract two
# integer-ALU slots (the add and a min). An extension multiply is 16
# products, 3 by W and 12 adds. The fewest operations for an extension
# inverse: three Frobenius maps (8 products by constants), two extension
# multiplies, the norm's c0 alone (5 products, 3 adds), an inverse in the
# base field (31 multiplies: no addition chain for p - 2 is shorter) and
# the scaling by it (4).
_MUL_SLOTS, _ADD_SLOTS = 5, 2
_EXT_MUL = (19, 12)
_EXT_INV = (8 + 2 * 19 + 5 + 31 + 4, 2 * 12 + 3)


def _weight_ops(w: np.ndarray) -> tuple:
    """(multiplies, adds) per row of the weighted sums of a (T, n[, 4])
    weight array, as this run's weights need them: a product for each
    weight other than 0 and +-1, an add for each nonzero one."""
    nz = w != 0
    return int((nz & (w != 1) & (w != P_FIELD - 1)).sum()), int(nz.sum())


def _quotient_ops(qi, rows: int) -> tuple:
    """(multiplies, adds) of constraint_quotient over `rows` LDE rows."""
    from lurk_tpu_torch.stark.constraint_vm import OP_MUL
    codes = qi.prog.ops[:, 0]
    muls = int((codes == OP_MUL).sum())
    adds = len(codes) - muls
    muls += 4 * qi.prog.n_cons            # the fold: ext * base, ext add
    adds += 4 * qi.prog.n_cons
    for w in (qi.plan["tw"], qi.plan["mw"]):    # fingerprints, multiplicities
        m, a = _weight_ops(w)
        muls, adds = muls + m, adds + a
    em, ea = _EXT_MUL
    muls += qi.nb * (3 * em + 8)          # lhs, weight; rhs by m0, m1
    adds += qi.nb * (3 * ea + 20)         # phi sums, rhs, lhs - rhs, fold
    muls += 3 * (em + 4)                  # the three running-sum terms
    adds += 3 * (ea + 4) + 16
    return rows * muls, rows * adds


def _perm_ops(plan_arrays, nb: int, rows: int) -> tuple:
    """(multiplies, adds) that logup_perm_phi's function needs over `rows`
    trace rows: the fingerprints and multiplicities; the inverses of the k
    fingerprints that vary by row as one batch over all rows (Montgomery's
    trick: 3 extension multiplies each and one extension inverse); one
    inverse of each constant nonzero fingerprint; each contribution scaled
    by its multiplicity; the pair sums."""
    t = _terms(plan_arrays["tw"]) > 0
    const = ~t & (plan_arrays["dconst"] != 0).any(axis=1)
    k, live = int(t.sum()), int((t | const).sum())
    muls, adds = 0, 4 * nb
    for w in (plan_arrays["tw"], plan_arrays["mw"]):
        m, a = _weight_ops(w)
        muls, adds = muls + m, adds + a
    muls, adds = rows * (muls + 4 * live), rows * adds
    batch = max(3 * (k * rows - 1), 0)
    n_inv = (k > 0) + int(const.sum())
    return (muls + batch * _EXT_MUL[0] + n_inv * _EXT_INV[0],
            adds + batch * _EXT_MUL[1] + n_inv * _EXT_INV[1])


def _terms(idx_w: np.ndarray) -> np.ndarray:
    """Nonzero-weight terms of each interaction of a (T, n[, 4]) weight
    array."""
    w = idx_w if idx_w.ndim == 3 else idx_w[..., None]
    return (w != 0).any(axis=2).sum(axis=0)


def _kernel_bound(n_bytes: int, muls: int, adds: int, sms: int,
                  clock_hz: float) -> tuple:
    """(bound ms, "bytes" | "operations"): the bytes over HBM against the
    busier of the FMA and ALU pipes (64 thread-instructions each per SM
    per clock) at the card's maximum SM clock."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    slots = max(muls * _MUL_SLOTS, adds * _ADD_SLOTS) / 64
    ops_ms = slots / (sms * clock_hz) * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else \
        (ops_ms, "operations")


def quotient_kernels_full_width(dev, on: str, mqs) -> dict:
    """Phase 25: constraint_quotient and logup_perm_phi against their plain
    versions on the card, bit for bit, on every chip of phase 10's shard 0
    (ShardingConfig(262144)) that the prover runs on the device, at its
    full height (eval_builtin_expr: 524,288 LDE rows), on random LDE and
    trace columns read in place from a wider matrix. Each chip's times
    (CUDA events): the kernel's launches on arguments packed once (their
    output held to the plain version's too), the wrapper's calls (packing
    and upload included, as a prove calls it)
    and the plain version's; its bound, its tile and the blocks an SM
    holds. Returns each kernel's totals over the shard's chips: ms (the
    kernel's), wrapper ms, plain ms, bound ms and what bounds it, the
    largest absolute error."""
    import torch
    from lurk_tpu_torch.lair.chips import chip_included
    from lurk_tpu_torch.lair.execute import Shard
    from lurk_tpu_torch.stark import device_prover as dp
    from lurk_tpu_torch.stark import quotient_kernel as qk
    machine, _, _, q, cfg = mqs
    shard = Shard(q, 0, cfg).shard()[0]
    pv = q.expect_public_values()
    rng = np.random.default_rng(25)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _max_sm_clock_hz()

    def ext():
        return tuple(int(v) for v in rng.integers(0, P_FIELD, 4))

    def columns(rows, widths):
        total = sum(widths) + 3 + (sum(widths) % 2 == 0)
        whole = torch.randint(0, P_FIELD, (rows, total), dtype=torch.int32,
                              device=dev)
        out, off = [], 1
        for w in widths:
            out.append(whole[:, off:off + w] if w else None)
            off += w
        return out

    tot = {k: dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, max_abs_err=0, chips=0) for k in KERNELS[1:3]}
    for chip in machine.chips:
        rows = chip.num_rows(shard) if chip_included(chip, shard) else 0
        if rows < dp._host_chip_min_rows():
            continue
        builder = machine.builder_for(chip)
        plan = dp.plan_for(builder)
        log_h = max(rows - 1, 0).bit_length()
        h, big = 1 << log_h, 2 << log_h
        nb = (len(builder.interactions) + 1) // 2
        main, prep, perm = columns(big, [builder.main_width,
                                         builder.preprocessed_width,
                                         4 * (nb + 1)])
        qi = dp.quotient_inputs(builder, main, prep, perm, pv, ext(), ext(),
                                ext(), ext(), log_h)
        got, want = qk.constraint_quotient(qi), qk.quotient_plain(qi)
        _sync()
        err = int((got.long() - want).abs().max())
        if not torch.equal(got.long(), want):
            raise AssertionError(f"constraint_quotient != plain on "
                                 f"{chip.name} ({big} LDE rows, max abs err "
                                 f"{err})")
        del got
        widths = builder.main_width + builder.preprocessed_width
        n_bytes = 4 * big * (widths + 4 * (nb + 1)) + 24 * big + 16 * big
        b_ms, b_by = _kernel_bound(n_bytes, *_quotient_ops(qi, big), sms,
                                   clock)
        args = qk.quotient_args(qi)
        smem = qk.quotient_smem_bytes(args["n_consts"], args["tile"],
                                      args["stride"], args["ld"],
                                      args["op_chunk"], args["max_folds"],
                                      args["rec_words"])
        tiles = (args["tile"], qk.resident_blocks("quotient", args["tile"],
                                                  smem, dev))
        k_ms = _event_ms(lambda: qk.launch_quotient(args), 5)
        _sync()
        if not torch.equal(args["out"].tensor.long(), want):
            raise AssertionError(f"constraint_quotient's timed launches != "
                                 f"plain on {chip.name}")
        w_ms = _event_ms(lambda: qk.constraint_quotient(qi), 3)
        p_ms = _event_ms(lambda: qk.quotient_plain(qi), 1)
        runs = [("constraint_quotient", big, k_ms, w_ms, p_ms, b_ms, b_by,
                 err, n_bytes, tiles)]
        del main, prep, perm, qi, args, want
        if builder.interactions and plan is not None:
            main, prep = columns(h, [builder.main_width,
                                     builder.preprocessed_width])
            a = dp._plan_arrays(plan, pv, ext(), ext(), pad_d_one=False,
                                n_keep=2 * nb)
            got = torch.empty((h, 4 * (nb + 1)), dtype=torch.int32,
                              device=dev)
            want = got.clone()
            qk.logup_perm_phi(got, main, prep, a, plan.n_inter_padded)
            qk.perm_phi_plain(want, main, prep, a, plan.n_inter_padded)
            _sync()
            err = int((got[:, :4 * nb].long() - want[:, :4 * nb].long())
                      .abs().max())
            if not torch.equal(got[:, :4 * nb], want[:, :4 * nb]):
                raise AssertionError(f"logup_perm_phi != plain on "
                                     f"{chip.name} ({h} rows, max abs err "
                                     f"{err})")
            n_bytes = 4 * h * widths + 16 * h * nb
            b_ms, b_by = _kernel_bound(n_bytes, *_perm_ops(a, nb, h), sms,
                                       clock)
            got.fill_(-1)
            args = qk.perm_args(got, main, prep, a)
            smem = qk.perm_smem_bytes(args["tile"], args["ld"],
                                      args["rec_words"])
            tiles = (args["tile"], qk.resident_blocks("perm", args["tile"],
                                                      smem, dev))
            k_ms = _event_ms(lambda: qk.launch_perm(args), 5)
            _sync()
            if not torch.equal(got[:, :4 * nb], want[:, :4 * nb]):
                raise AssertionError(f"logup_perm_phi's timed launches != "
                                     f"plain on {chip.name}")
            w_ms = _event_ms(lambda: qk.logup_perm_phi(
                got, main, prep, a, plan.n_inter_padded), 3)
            p_ms = _event_ms(lambda: qk.perm_phi_plain(
                want, main, prep, a, plan.n_inter_padded), 1)
            runs.append(("logup_perm_phi", h, k_ms, w_ms, p_ms, b_ms, b_by,
                         err, n_bytes, tiles))
            del main, prep, got, want, args
        for (name, n_rows, k_ms, w_ms, p_ms, b_ms, b_by, err, n_bytes,
             (tile, blocks)) in runs:
            t = tot[name]
            t["ms"] += k_ms
            t["wrapper_ms"] += w_ms
            t["plain_ms"] += p_ms
            t["bound_ms"] += b_ms
            t["bytes_ms"] += n_bytes / HBM_BYTES_PER_S * 1e3
            t["max_abs_err"] = max(t["max_abs_err"], err)
            t["chips"] += 1
            print(f"{name} == plain on {chip.name}, {n_rows} rows: kernel "
                  f"{k_ms:.4f} ms (wrapper {w_ms:.4f} ms), plain "
                  f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) = "
                  f"{b_ms / k_ms:.3f} of the kernel's time; {tile} rows a "
                  f"block, {blocks} blocks an SM {on}")
    for name, t in tot.items():
        t["bound_by"] = "bytes" if t.pop("bytes_ms") >= t["bound_ms"] \
            else "operations"
        print(f"{name} over shard 0's {t['chips']} device chips "
              f"({sms} SMs at {clock / 1e6:.0f} MHz): kernel {t['ms']:.4f} "
              f"ms (wrapper {t['wrapper_ms']:.4f} ms), plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms = "
              f"{t['bound_ms'] / t['ms']:.3f} of the kernel's time, max abs "
              f"err {t['max_abs_err']} {on}")
        del t["chips"]
    torch.cuda.empty_cache()
    return tot


def _open_ops(kind: str, rows: int, w: int, n: int, accumulate: bool
              ) -> tuple:
    """(bytes, base-field products, adds) of one open kernel's function at
    its shape: each input read once and each output written once; the
    least field operations (a product by each weight, power or inverse;
    the powers of z and the domain points by one product a row; the
    inverses of x - z as one Montgomery batch: 3 extension multiplies
    each)."""
    em, ea = _EXT_MUL
    if kind == "open_eval":          # rows = h
        n_bytes = 4 * rows * w + 16 * n * w
        muls = n * (4 * rows * w + em * rows)
        adds = n * (4 * rows * w + ea * rows)
    elif kind == "open_reduce":      # rows = H
        n_bytes = 4 * rows * w + 16 * n * w + 16 * rows * (1 + accumulate)
        muls = rows + n * rows * (4 * w + 3 * em + em) + _EXT_INV[0]
        adds = n * rows * (4 * w + 1 + 3 * ea + ea + 8) + _EXT_INV[1]
    else:                            # fri_fold, rows = n / 2 outputs
        n_bytes = 16 * rows * (3 + accumulate)
        muls = rows * (1 + 8 + em)
        adds = rows * (8 + ea + 4 + 4 * accumulate)
    return n_bytes, muls, adds


def _open_bound(ops: tuple, sms: int, clock_hz: float) -> dict:
    """The least time the card could take for the work of `ops` (bytes,
    products, adds), whatever computes it: the larger of the bytes over
    HBM and the products at the fastest exact rate (EXACT_PRODUCTS_PER_S:
    a 31-bit product as 16 u8 x u8 MACs on the tensor cores); beside it
    the operations bound on the CUDA cores (_kernel_bound's FMA and ALU
    slots, the yardstick of the quotient kernels), as cuda_core_ops_ms."""
    n_bytes, muls, adds = ops
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = muls / EXACT_PRODUCTS_PER_S * 1e3
    slots = max(muls * _MUL_SLOTS, adds * _ADD_SLOTS) / 64
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                cuda_core_ops_ms=slots / (sms * clock_hz) * 1e3)


def open_kernels_full_width(dev, on: str, mqs, odd_stride: bool = False
                            ) -> dict:
    """Phase 26: open_eval, open_reduce and fri_fold against their plain
    versions on the card, bit for bit, at the shapes of phase 10's shard
    0 (ShardingConfig(262144)): every height group of its four rounds
    (plan_stats.open_groups) in one open_eval_groups call, as
    device_open_rounds makes it, on random contiguous coefficient
    matrices (the layout dcommit gives them; with `odd_stride`, also
    held and timed on column slices of wider matrices, printed only),
    random points (zeta and zeta * g where the group has two), and an
    all-(p - 1) column of 2^15 + 3 rows at z = (p - 1, ...); random LDE
    columns read in place from wider matrices; each group's reduced
    openings (random weights and y_alpha) added into its height's
    codeword as device_open_rounds adds them; then every FRI layer above
    the host tail from the shard's largest height, its pair matrix folded
    into the next layer's, adding the codeword of the next height where
    there is one. Each call's times
    (CUDA events): the kernel's launches on arguments packed once (their
    output held to the plain version's too), the wrapper's calls and the
    plain version's; its bound and, on the printed lines only, the CUDA
    cores' operations bound. Returns each kernel's totals over the shard:
    ms, wrapper ms, plain ms, bound ms and what bounds it, the largest
    absolute error."""
    import torch
    from lurk_tpu_torch import plan_stats
    from lurk_tpu_torch.field import ext as ext_t
    from lurk_tpu_torch.field import babybear as bb
    from lurk_tpu_torch.stark import device_prover as dp
    from lurk_tpu_torch.stark import open_kernel as ok
    from lurk_tpu_torch.stark.fri import layer_shift
    machine, _, _, q, cfg = mqs
    groups = plan_stats.open_groups(machine, q, cfg)[0]
    rng = np.random.default_rng(26)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = _max_sm_clock_hz()

    def ext():
        return tuple(int(v) for v in rng.integers(0, P_FIELD, 4))

    def column(rows, w):
        whole = torch.randint(0, P_FIELD, (rows, w + 3 + (w % 2 == 0)),
                              dtype=torch.int32, device=dev)
        return whole[:, 1:1 + w]

    def held(name, got, want, label):
        err = int((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{name} != plain on {label} (max abs err "
                                 f"{err})")
        return err

    runs = []
    zeta = ext()
    egroups, labels = [], []
    for rnd, log_h, w, n in groups:
        g = bb.two_adic_generator_s(log_h) if log_h else 1
        egroups.append((torch.randint(0, P_FIELD, (1 << log_h, w),
                                      dtype=torch.int32, device=dev),
                        [zeta, ext_t.emul_s(zeta, (g, 0, 0, 0))][:n]))
        labels.append(f"{rnd} group of {1 << log_h} rows x {w} columns, "
                      f"{n} point(s)")
    # open_eval: every group at once, held group by group, on contiguous
    # coefficient matrices as dcommit makes them (with odd_stride, then on
    # column slices of wider matrices: the kernel's 4-byte copies)
    layouts = [("contiguous", egroups)]
    if odd_stride:
        layouts.append(("odd-stride slices",
                        [(column(int(c.shape[0]), int(c.shape[1])), zs)
                         for c, zs in egroups]))
    for layout, gs in layouts:
        want = ok.eval_groups_plain(gs)
        got = ok.open_eval_groups(gs)
        off, err = 0, 0
        for (coeffs, zs), label in zip(gs, labels):
            rows = len(zs) * int(coeffs.shape[1])
            err = max(err, held("open_eval", got[off:off + rows],
                                want[off:off + rows], f"{label} ({layout})"))
            off += rows
        args = ok.eval_args(gs)
        k_ms = _event_ms(lambda: ok.launch_eval(args), 5)
        _sync()
        held("open_eval's timed launches", args["out"].tensor, want,
             f"every group ({layout})")
        w_ms = _event_ms(lambda: ok.open_eval_groups(gs), 3)
        p_ms = _event_ms(lambda: ok.eval_groups_plain(gs), 1)
        ops = [_open_ops("open_eval", int(c.shape[0]), int(c.shape[1]),
                         len(zs), False) for c, zs in gs]
        run = ("open_eval", f"{len(gs)} groups in one launch, {layout} "
               f"({args['blocks']} blocks of {ok.EVAL_THREADS} threads)",
               k_ms, w_ms, p_ms, err, tuple(map(sum, zip(*ops))))
        if layout == "contiguous":
            runs.append(run)
        else:
            b = _open_bound(run[-1], sms, clock)
            print(f"open_eval == plain on shard 0's {run[1]}: kernel "
                  f"{k_ms:.4f} ms (wrapper {w_ms:.4f} ms), plain "
                  f"{p_ms:.4f} ms, bound {b['bound_ms']:.4f} ms = "
                  f"{b['bound_ms'] / k_ms:.3f} of the kernel's time {on}")
        del want, got, args
    del layouts
    worst = torch.full(((1 << 15) + 3, 3), P_FIELD - 1, dtype=torch.int32,
                       device=dev)[:, 1:2]
    wz = [(P_FIELD - 1,) * 4, (P_FIELD - 1, 0, 0, P_FIELD - 1)]
    held("open_eval", ok.open_eval(worst, wz), ok.eval_plain(worst, wz),
         "an all-(p - 1) column of 2^15 + 3 rows at z = (p - 1, ...)")
    print(f"open_eval == plain on an all-(p - 1) column of 2^15 + 3 rows "
          f"at z = (p - 1, ...) {on}")
    del worst
    # open_reduce, into the height's codeword where there is one
    ro = {}
    for (rnd, log_h, w, n), (_, zs), label in zip(groups, egroups, labels):
        big = 2 << log_h
        lde = column(big, w)
        weights = rng.integers(0, P_FIELD, (n, w, 4))
        ya = rng.integers(0, P_FIELD, (n, 4))
        base = ro.get(log_h + 1)
        copy = (lambda: None) if base is None else base.clone
        want = ok.reduce_plain(copy(), lde, zs, weights, ya)
        err = held("open_reduce", ok.open_reduce(copy(), lde, zs, weights,
                                                 ya), want, label)
        args = ok.reduce_args(copy(), lde, zs, weights, ya)
        k_ms = _event_ms(lambda: ok.launch_reduce(args), 5)
        _sync()
        # six launches: the codeword plus six times the group's openings
        expect = want if base is None else \
            (base.long() + 6 * (want.long() - base.long())) % P_FIELD
        held("open_reduce's timed launches", args["out"].tensor.long(),
             expect.long(), label)
        scratch = copy()
        w_ms = _event_ms(lambda: ok.open_reduce(scratch, lde, zs, weights,
                                                ya), 3)
        p_ms = _event_ms(lambda: ok.reduce_plain(base, lde, zs, weights,
                                                 ya), 1)
        runs.append(("open_reduce", label, k_ms, w_ms, p_ms, err,
                     _open_ops("open_reduce", big, w, n, base is not None)))
        ro[log_h + 1] = want
        del lde, args, scratch
    del egroups
    max_log = max(ro)
    floor = max(dp._fri_host_tail_log(), machine.config.log_blowup)
    for layer, log_n in enumerate(range(max_log, floor, -1)):
        label = f"FRI layer {layer} ({1 << log_n} rows)"
        pair = dp.pairs(column(1 << log_n, 4))
        add = ro.get(log_n - 1)
        beta, shift = ext(), layer_shift(max_log, layer)
        want = ok.fold_plain(pair, beta, shift, add)
        err = held("fri_fold", ok.fri_fold(pair, beta, shift, add), want,
                   label)
        args = ok.fold_args(pair, beta, shift, add)
        k_ms = _event_ms(lambda: ok.launch_fold(args), 5)
        _sync()
        held("fri_fold's timed launches", args["out"].tensor, want, label)
        w_ms = _event_ms(lambda: ok.fri_fold(pair, beta, shift, add), 3)
        p_ms = _event_ms(lambda: ok.fold_plain(pair, beta, shift, add), 1)
        runs.append(("fri_fold", label, k_ms, w_ms, p_ms, err,
                     _open_ops("fri_fold", 1 << (log_n - 1), 4, 1,
                               add is not None)))
    tot = {k: dict(ms=0.0, wrapper_ms=0.0, plain_ms=0.0, max_abs_err=0,
                   bound_ms=0.0) for k in OPEN_KERNELS}
    extra = {k: dict(calls=0, bytes_ms=0.0, ops_ms=0.0, cuda_core_ops_ms=0.0)
             for k in OPEN_KERNELS}
    for name, label, k_ms, w_ms, p_ms, err, ops in runs:
        b = _open_bound(ops, sms, clock)
        t = tot[name]
        t["ms"] += k_ms
        t["wrapper_ms"] += w_ms
        t["plain_ms"] += p_ms
        t["max_abs_err"] = max(t["max_abs_err"], err)
        t["bound_ms"] += b["bound_ms"]
        x = extra[name]
        x["calls"] += 1
        for key in ("bytes_ms", "ops_ms", "cuda_core_ops_ms"):
            x[key] += b[key]
        print(f"{name} == plain on shard 0's {label}: kernel {k_ms:.4f} ms "
              f"(wrapper {w_ms:.4f} ms), plain {p_ms:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']}) = "
              f"{b['bound_ms'] / k_ms:.3f} of the kernel's time, CUDA "
              f"cores' operations bound {b['cuda_core_ops_ms']:.4f} ms {on}")
    for name, t in tot.items():
        x = extra[name]
        t["bound_by"] = "bytes" if x["bytes_ms"] >= x["ops_ms"] \
            else "operations"
        print(f"{name} over shard 0's {x['calls']} calls ({sms} SMs at "
              f"{clock / 1e6:.0f} MHz): kernel {t['ms']:.4f} ms (wrapper "
              f"{t['wrapper_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) = "
              f"{t['bound_ms'] / t['ms']:.3f} of the kernel's time, CUDA "
              f"cores' operations bound {x['cuda_core_ops_ms']:.4f} ms, max "
              f"abs err {t['max_abs_err']} {on}")
    del ro
    torch.cuda.empty_cache()
    return tot


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    os.environ.setdefault("LURK_TPU_PROVE_TIMING", "1")

    from lurk_tpu_torch.field import babybear as bb
    from lurk_tpu_torch.lair import native
    from lurk_tpu_torch.poseidon import cuda_kernel, perm, ref
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
    from lurk_tpu_torch.stark import (golden, hasher, open_kernel,
                                      quotient_kernel)
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.utils import codec

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. device
    gpu = _gpu_line()
    on = f"[{gpu}]"
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"native liblair available: {native.native_available()}")

    # 2. build: one nvcc for each source, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(b.build, verbose=True)
                  for b in (cuda_kernel, quotient_kernel, open_kernel)]
        lib, qlib, olib = (f.result() for f in builds)
    print(f"build: {time.perf_counter() - t0:.3f}s {lib.name} {qlib.name} "
          f"{olib.name} {on}")
    torch.ones(1, device=dev)
    free, total = torch.cuda.mem_get_info(dev)
    outside = total - free - torch.cuda.memory_reserved(dev)
    print(f"device memory: {total} B in all, {outside} B outside the "
          f"caching allocator after start-up (context, kernel module) {on}")

    # 3. kernel vs plain version vs scalar oracle
    rng = np.random.default_rng(0)
    max_err = 0
    for width in cuda_kernel.WIDTHS:
        for batch in (1 << 16, (1 << 16) + 3):
            st = torch.from_numpy(rng.integers(0, bb.P, (width, batch))
                                  .astype(np.int32)).to(dev)
            for n_chain in (1, 2):
                got = permute_mont_cuda(st, n_chain)
                want = st
                for _ in range(n_chain):
                    want = perm.permute_mont(want)
                _sync()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"kernel != plain at width {width} batch {batch} "
                        f"n_chain {n_chain} (max abs err {err})")
            got1 = bb.from_mont(permute_mont_cuda(st)).cpu().numpy()
            canon = bb.from_mont(st).cpu().numpy()
            for col in (0, 1, batch - 1):
                want = ref.permute_s([int(v) for v in canon[:, col]])
                if [int(v) for v in got1[:, col]] != want:
                    raise AssertionError(f"kernel != ref.permute_s at width "
                                         f"{width} state {col}")
    print(f"kernel == plain == ref at widths {cuda_kernel.WIDTHS} "
          f"(max abs err {max_err})")
    # the main path's largest launch: the w16 leaf sponge over 2^21 rows
    st16 = torch.from_numpy(rng.integers(0, bb.P, (16, 1 << 21))
                            .astype(np.int32)).to(dev)
    k_ms = _event_ms(lambda: permute_mont_cuda(st16), 20)
    p_ms = _event_ms(lambda: perm.permute_mont(st16), 3)
    print(f"w16 x 2^21 permutation: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms {on}")

    # 4. hasher on the card vs the host path
    for w in (13, 18):
        mat = rng.integers(0, bb.P, (1 << 14, w), dtype=np.uint64)
        got = hasher.hash_rows(torch.from_numpy(mat.astype(np.int32)).to(dev))
        if not np.array_equal(bb.to_numpy(got), hasher._hash_rows_np(mat)):
            raise AssertionError(f"hash_rows on the card != host (w={w})")
    left = rng.integers(0, bb.P, (1 << 14, 8), dtype=np.uint64)
    right = rng.integers(0, bb.P, (1 << 14, 8), dtype=np.uint64)
    got = hasher.compress_pairs(
        torch.from_numpy(left.astype(np.int32)).to(dev),
        torch.from_numpy(right.astype(np.int32)).to(dev))
    if not np.array_equal(bb.to_numpy(got),
                          hasher._compress_pairs_np(left, right)):
        raise AssertionError("compress_pairs on the card != host")
    print("hasher on the card == host path (n=2^14, w in {13, 18})")

    # 5. golden small proof
    t0 = time.perf_counter()
    machine, vk, proof, digest = golden.fib_proof(dev)
    dt = time.perf_counter() - t0
    if digest != golden.GOLDEN_FIB1000_SHA256:
        raise AssertionError(f"golden fib(1000) proof sha256 {digest} != "
                             f"{golden.GOLDEN_FIB1000_SHA256}")
    if not machine.verify(vk, proof, Challenger()):
        raise AssertionError("golden fib(1000) proof does not verify")
    print(f"golden fib({golden.GOLDEN_N}) proof sha256 matches: {digest} "
          f"({dt:.3f}s incl. setup) {on}")

    # 6. the slice: demo fib 2^20 at the production config
    t0 = time.perf_counter()
    machine, q = golden.fib_machine(SLICE_N, FriConfig())
    pk, vk = machine.setup()
    cells = machine._trace_cells(q, None)
    print(f"slice setup (execute + keys): {time.perf_counter() - t0:.3f}s "
          f"{on}")
    if cells != SLICE_CELLS:
        raise AssertionError(f"padded cells {cells} != {SLICE_CELLS}")
    _zero_counts()
    t0 = time.perf_counter()
    proof = machine.prove(pk, q, Challenger(), device=True)
    _sync()
    cold = time.perf_counter() - t0
    launches = _counts()
    _require("the slice", launches)
    if len(proof.shard_proofs) != 1:
        raise AssertionError(f"{len(proof.shard_proofs)} shards, expected 1")
    cold_sha = hashlib.sha256(codec.encode(proof)).hexdigest()
    t0 = time.perf_counter()
    proof = machine.prove(pk, q, Challenger(), device=True)
    _sync()
    warm = time.perf_counter() - t0
    peak = machine.last_device_prove["peak_allocated_bytes"]
    sha = hashlib.sha256(codec.encode(proof)).hexdigest()
    if sha != cold_sha:
        raise AssertionError("cold and warm proofs differ")
    t0 = time.perf_counter()
    ok = machine.verify(vk, proof, Challenger())
    vt = time.perf_counter() - t0
    if not ok:
        raise AssertionError("fib 2^20 proof does not verify")
    print(f"slice fib({SLICE_N}) cells {cells}: prove cold {cold:.3f}s, "
          f"warm {warm:.3f}s ({cells / warm:.1f} cells/s), verify "
          f"{vt:.3f}s, peak device memory {peak / 2**30:.2f} GiB, "
          f"{_launches(launches)}, proof sha256 {sha} {on}")

    # 7. throughput at bench.py's shape
    iters = 64
    st24 = torch.from_numpy(rng.integers(0, bb.P, (24, 1 << 19))
                            .astype(np.int32)).to(dev)

    def plain_chain():
        x = st24
        for _ in range(iters):
            x = perm.permute_mont(x)
        return x

    k24 = _event_ms(lambda: permute_mont_cuda(st24, iters), 5)
    p24 = _event_ms(plain_chain, 1)
    hashes = (1 << 19) * iters
    print(f"w24 hashes/s: kernel {hashes / (k24 / 1e3):.1f}, plain "
          f"{hashes / (p24 / 1e3):.1f} {on}")

    # the kernel's bound from its SASS instruction counts by pipe
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = _max_sm_clock_hz()
    bounds = {}
    for width, n_perm, ms in ((16, 1 << 21, k_ms), (24, hashes, k24)):
        counts = _sass_counts(lib, width)
        b_ms, b_by = _perm_bound(counts, width, n_perm, sms, clock)
        bounds[width] = (b_ms, b_by)
        print(f"w{width} x {n_perm} permutations: SASS per thread {counts} "
              f"({sms} SMs at {clock / 1e6:.0f} MHz): bound {b_ms:.4f} ms "
              f"({b_by}), kernel {ms:.4f} ms = {b_ms / ms:.3f} of the bound "
              f"{on}")

    lurk_goldens(dev, on)
    fib_sha = hashlib.sha256(gzip.decompress(
        FIB100K_ARTIFACT.read_bytes())).hexdigest()
    fib_launches, fib_mqs, fib_pipeline = fib100k(
        dev, on, FIB100K_CODE, FIB100K_SHARD_SIZE, FIB100K_SHARDS,
        FIB100K_CELLS, fib_sha)

    # 11-13. the REPL, the CLI and the microchain, every proof on the card
    lurk_dir = Path(tempfile.mkdtemp(prefix="lurk_dir_"))
    os.environ["LURK_DIR"] = str(lurk_dir)
    try:
        repl, repl_launches = repl_corpus(on, lurk_dir)
        cli_launches = cli_load(on, lurk_dir)
        chain_launches = microchain_round_trip(on, repl)
    finally:
        del os.environ["LURK_DIR"]
        shutil.rmtree(lurk_dir, ignore_errors=True)

    # 14-17. this slice: the compiled pipeline, the forced DAG paths, loam
    marks = [("phases 1-13", time.perf_counter())]
    compiled_launches = compiled_goldens(dev, on)
    marks.append(("phase 14", time.perf_counter()))
    forced_launches = forced_paths(dev, on)
    marks.append(("phase 15", time.perf_counter()))
    compiled_fib_launches, _, _ = fib100k(dev, on, FIB100K_CODE,
                                          FIB100K_SHARD_SIZE, FIB100K_SHARDS,
                                          COMPILED_FIB100K_CELLS, None,
                                          compiled=True)
    marks.append(("phase 16", time.perf_counter()))
    loam_and_narrow(on)
    marks.append(("phase 17", time.perf_counter()))

    # 18-21. this slice: the mesh blocks, mesh_prove, the mesh commit and
    # multi-process proving, with every slot on this card
    card = torch.device("cuda", torch.cuda.current_device())
    mesh_block_launches = mesh_blocks(card, on, rng)
    marks.append(("phase 18", time.perf_counter()))
    mesh_prove_launches = mesh_prove_fib100k(card, on, fib_mqs, fib_sha)
    marks.append(("phase 19", time.perf_counter()))
    mesh_commit_launches = mesh_commit_fib100k(card, on, fib_mqs, fib_sha)
    marks.append(("phase 20", time.perf_counter()))
    multihost_launches = multihost_fib100k(on, fib_sha)
    marks.append(("phase 21", time.perf_counter()))

    # 22-24. this slice: the default config, planned by the memory model
    default_launches, capped_launches = default_config_fib100k(
        on, fib_mqs, fib_pipeline[2], fib_sha)
    marks.append(("phases 22-23", time.perf_counter()))
    bench_launches = default_config_benches(on, fib_mqs, *fib_pipeline[:2])
    marks.append(("phase 24", time.perf_counter()))

    # 25. this slice: the quotient kernels at full width
    quotient = quotient_kernels_full_width(dev, on, fib_mqs)
    marks.append(("phase 25", time.perf_counter()))

    # 26. this slice: the open kernels at full width
    opening = open_kernels_full_width(dev, on, fib_mqs)
    marks.append(("phase 26", time.perf_counter()))
    del fib_mqs, fib_pipeline
    print("wall seconds: " + ", ".join(
        f"{label} {t - prev:.1f}" for (label, t), prev in
        zip(marks, [t_start] + [t for _, t in marks[:-1]])) + f" {on}")

    by_path = {"demo_fib_2^20": launches,
               "lurk_fib100000": fib_launches,
               "repl_demo_corpus": repl_launches,
               "cli_load": cli_launches,
               "microchain": chain_launches,
               "compiled_goldens": compiled_launches,
               "forced_dag_paths": forced_launches,
               "compiled_fib100000": compiled_fib_launches,
               "mesh_blocks": {"poseidon2_permute": mesh_block_launches},
               "mesh_prove_fib100000": mesh_prove_launches,
               "mesh_commit_fib100000": mesh_commit_launches,
               "multihost_fib100000": multihost_launches,
               "lurk_fib100000_default_config": default_launches,
               "lurk_fib100000_capped": capped_launches,
               "lurk_lcs_default_config": bench_launches["lcs"],
               "lurk_sum100000_default_config":
                   bench_launches["sum(100000)"]}
    kernels = [{
        "name": "poseidon2_permute",
        "route": "cuda",
        "source": "lurk_tpu_torch/csrc/poseidon2.cu",
        "replaces": "lurk_tpu/poseidon/tpu_kernel.py:132",
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bounds[16][0],
        "bound_by": bounds[16][1],
    }, {
        "name": "constraint_quotient",
        "route": "cuda",
        "source": "lurk_tpu_torch/csrc/quotient.cu",
        "replaces": "lurk_tpu/stark/device_prover.py:1299",
        **quotient["constraint_quotient"],
    }, {
        "name": "logup_perm_phi",
        "route": "cuda",
        "source": "lurk_tpu_torch/csrc/quotient.cu",
        "replaces": "lurk_tpu/stark/device_prover.py:933",
        **quotient["logup_perm_phi"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "lurk_tpu_torch/csrc/open.cu",
        "replaces": f"lurk_tpu/stark/device_prover.py:{line}",
        **opening[name],
    } for name, line in (("open_eval", 1605), ("open_reduce", 1677),
                         ("fri_fold", 1742))]
    for k in kernels:
        name = k["name"]
        k["launches"] = fib_launches[name]
        k["launches_by_path"] = {path: n[name] for path, n in by_path.items()
                                 if name in n}
        k["library_ms"] = None
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
