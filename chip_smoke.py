#!/usr/bin/env python3
"""Drive lurk_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):
  1. device: require CUDA; print the card's name and power limit, and
     whether cpp/liblair.so loads;
  2. build: compile the Poseidon2 CUDA kernel (nvcc, sm_90a);
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
     benches/artifacts/fib100k_4shard_proof.bin.gz;
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
     card and verifies the chain's history.

Prints the kernels' JSON line, then the device line last. Every time is
printed beside the card's name and power limit.
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
MICROCHAIN_STATE = (
    "(letrec ((acc (lambda (total) (lambda (amount) (let ((total (+ total "
    "amount))) (cons total (commit (acc total)))))))) (cons 0 (commit (acc "
    "0))))")
FIB100K_ARTIFACT = ROOT / "benches" / "artifacts" / "fib100k_4shard_proof.bin.gz"
# H100 SXM data sheet: HBM3 at 3.35 TB/s
HBM_BYTES_PER_S = 3.35e12


def _sync():
    import torch
    torch.cuda.synchronize()


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


def _prove_lurk_golden(dev, shard_size, want, machine_queries):
    """Prove golden.LURK_PROGRAM on the card and hold its sha256 to
    `want`; returns (seconds, kernel launches, the prove's stats)."""
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
    from lurk_tpu_torch.stark import golden
    from lurk_tpu_torch.stark.challenger import Challenger
    permute_mont_cuda.launches = 0
    t0 = time.perf_counter()
    machine, vk, proof, digest = golden.lurk_proof(dev, shard_size,
                                                   machine_queries)
    _sync()
    dt = time.perf_counter() - t0
    launches = permute_mont_cuda.launches
    stats = machine.last_device_prove
    if digest != want:
        raise AssertionError(f"Lurk proof (shard size {shard_size}) sha256 "
                             f"{digest} != golden {want}")
    if not machine.verify(vk, proof, Challenger()):
        raise AssertionError(f"Lurk proof (shard size {shard_size}) does "
                             "not verify")
    if launches <= 0 or stats["device_witness_chips"] <= 0:
        raise AssertionError(f"Lurk golden: {launches} kernel launches, "
                             f"{stats['device_witness_chips']} device-made "
                             "witnesses")
    return dt, launches, stats


def lurk_goldens(dev, on: str) -> None:
    """Phases 8 and 9: the Lurk goldens on `dev` with every chip on the
    device path and device witness on, then device witness == host
    witness for every supported chip."""
    from lurk_tpu_torch.field import babybear as bb
    from lurk_tpu_torch.lair import device_trace
    from lurk_tpu_torch.lair.chips import chip_included
    from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
    from lurk_tpu_torch.lair.trace import FuncChip
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
          f"{n} kernel launches, {stats['device_witness_chips']} device-made "
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
          f"verified, {dt:.3f}s, {n} kernel launches {on}")

    # 9. device witness on the card == host witness
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
    print(f"device witness on the card == host witness ({n_chips} chip "
          "traces)")
    del os.environ["LURK_TPU_DEVICE_CHIP_MIN_ROWS"]


def fib100k(dev, on: str, code: str, shard_size: int, want_shards: int,
            want_cells: int, want_sha: str) -> int:
    """Phase 10: evaluate `code`, set up with the key cache in a temporary
    LURK_DIR, prove it twice (cold, warm) through machine.prove(...,
    device=True) at FriConfig() and ShardingConfig(shard_size), hold the
    proof to want_sha and verify it. Returns the warm prove's kernel
    launches."""
    import torch
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair import native
    from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
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
        toplevel, zstore, _ = build_lurk_toplevel()
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
    print(f"fib(100000) = {zstore.fmt(result)}: eval {eval_s:.3f}s, setup "
          f"{setup_s:.3f}s, {n_shards} shards, {cells} padded cells {on}")
    if (n_shards, cells) != (want_shards, want_cells):
        raise AssertionError(f"{n_shards} shards / {cells} cells, expected "
                             f"{want_shards} / {want_cells}")
    runs = []
    for label in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        permute_mont_cuda.launches = 0
        t0 = time.perf_counter()
        proof = machine.prove(pk, q, Challenger(), shard_config=cfg,
                              device=True)
        _sync()
        dt = time.perf_counter() - t0
        n = permute_mont_cuda.launches
        stats = machine.last_device_prove
        sha = hashlib.sha256(codec.encode(proof)).hexdigest()
        peak = torch.cuda.max_memory_allocated()
        runs.append((dt, n, sha))
        print(f"fib(100000) {label} prove: {dt:.3f}s "
              f"({cells / dt:.1f} cells/s), witness on the card "
              f"{stats['device_witness_s']:.3f}s for "
              f"{stats['device_witness_chips']} chips / "
              f"{stats['device_witness_cells']} cells, on the host "
              f"{stats['host_witness_s']:.3f}s for "
              f"{stats['host_witness_chips']} chips / "
              f"{stats['host_witness_cells']} cells, keep mode "
              f"{stats['keep_mode']}, peak device memory "
              f"{peak / 2**30:.2f} GiB vs modeled shard high-water "
              f"{stats['modeled_highwater_bytes'] / 2**30:.2f} GiB (budget "
              f"{stats['budget_bytes'] / 2**30:.2f} GiB), kernel launches "
              f"{n}, sha256 {sha} {on}")
        if n <= 0 or stats["device_witness_chips"] <= 0:
            raise AssertionError(f"fib(100000): {n} kernel launches, "
                                 f"{stats['device_witness_chips']} "
                                 "device-made witnesses")
        if len(proof.shard_proofs) != want_shards:
            raise AssertionError(f"{len(proof.shard_proofs)} shards")
    if runs[0][2] != runs[1][2]:
        raise AssertionError("fib(100000): cold and warm proofs differ")
    if runs[1][2] != want_sha:
        raise AssertionError(f"fib(100000) proof sha256 {runs[1][2]} != "
                             f"the checked-in proof's {want_sha}")
    t0 = time.perf_counter()
    ok = machine.verify(vk, proof, Challenger())
    vt = time.perf_counter() - t0
    if not ok:
        raise AssertionError("fib(100000) proof does not verify")
    print(f"fib(100000): proof sha256 == checked-in proof's {want_sha}, "
          f"verified in {vt:.3f}s {on}")
    return runs[1][1]


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
        from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
        cells = self.repl.machine()._trace_cells(self.repl.queries, None)
        n0 = permute_mont_cuda.launches
        t0 = time.perf_counter()
        key = self.inner()
        _sync()
        self.runs.append((cells, time.perf_counter() - t0,
                          permute_mont_cuda.launches - n0))
        return key


def _load_demo(repl, timed, lurk_dir: Path, name: str):
    """Load demo/<name>.lurk into `repl` after `!(clear)`, with no proof in
    the cache; check every proof file it writes against lurk_tpu's sha256
    (where deterministic) and `!(verify)` it. Returns (seconds, kernel
    launches, proof files, the proves' (cells, seconds, launches))."""
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
    from lurk_tpu_torch.stark import golden
    for path in _proofs(lurk_dir):
        path.unlink()
    timed.runs.clear()
    repl.process("!(clear)")
    permute_mont_cuda.launches = 0
    t0 = time.perf_counter()
    repl.load_file(ROOT / "demo" / f"{name}.lurk")
    _sync()
    dt = time.perf_counter() - t0
    launches = permute_mont_cuda.launches
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
    total = 0
    cells = {}
    for label in ("cold", "warm"):
        for name in golden.DEMO_FILES:
            dt, launches, got, runs = _load_demo(repl, timed, lurk_dir, name)
            if got and launches <= 0:
                raise AssertionError(f"{name}: no kernel launch")
            if label == "cold":
                total += launches
            if len(runs) == 1 and name in golden.DEMO_PROOF_SHA256:
                cells[name] = runs[0][0]
            proves = ", ".join(f"{c} cells {s:.3f}s {n} launches"
                               for c, s, n in runs) or "none"
            held = ("== lurk_tpu's" if name in golden.DEMO_PROOF_SHA256
                    else "not held (!(rand))" if got else "-")
            print(f"REPL {label} {name}.lurk: {dt:.3f}s, {len(got)} proofs "
                  f"({proves}), {launches} kernel launches, sha256 {held}, "
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
        if (launches > 0) != (prover == "device"):
            raise AssertionError(f"{prover} prover: {launches} launches")
        print(f"smallest demo proof ({name}.lurk, {runs[0][0]} cells) on "
              f"the {prover} prover: !(prove) {runs[0][1]:.3f}s, {launches} "
              f"kernel launches, sha256 == lurk_tpu's {on}")
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
    launches = [int(n) for n in re.findall(
        r"\[prove-timing\] device_prove: .* (\d+) Poseidon2 kernel launches",
        res.stderr)]
    if len(launches) != 1 or launches[0] <= 0:
        raise AssertionError(f"CLI prove launches {launches}")
    timing = [l for l in res.stderr.splitlines()
              if l.startswith("[prove-timing]")]
    print("\n".join(f"  cli {l}" for l in timing))
    print(f"CLI load --prove fib(1000): exit 0 in {dt:.3f}s (process), "
          f"{launches[0]} kernel launches, proof sha256 == lurk_tpu's "
          f"{sha} {on}")
    return launches[0]


def microchain_round_trip(on: str, repl) -> int:
    """Phase 13: a microchain server (its own REPL, verifying on the host)
    on a daemon thread; `repl` starts a chain and proves two transitions
    on the card. Returns the transitions' kernel launches."""
    import socket
    from lurk_tpu_torch.cli import microchain
    from lurk_tpu_torch.cli.repl import Repl
    from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
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
    permute_mont_cuda.launches = 0
    t0 = time.perf_counter()
    repl.process(f'!(defq s1 !(microchain-transition "{addr}" id s0 7))')
    repl.process(f'!(defq s2 !(microchain-transition "{addr}" id s1 10))')
    _sync()
    dt = time.perf_counter() - t0
    launches = permute_mont_cuda.launches
    if launches <= 0:
        raise AssertionError("microchain transitions: no kernel launch")
    total = repl.fmt(repl.process("(car s2)"))
    if total != "17":
        raise AssertionError(f"microchain state total {total} != 17")
    if repl.process(f'!(microchain-verify "{addr}" id)') != repl.zstore.t:
        raise AssertionError("microchain history does not verify")
    print(f"microchain: 2 transitions proved on the card and accepted in "
          f"{dt:.3f}s, {launches} kernel launches, history verified {on}")
    return launches


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
    from lurk_tpu_torch.stark import golden, hasher
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.utils import codec

    dev = torch.device("cuda")

    # 1. device
    gpu = _gpu_line()
    on = f"[{gpu}]"
    print(gpu)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"native liblair available: {native.native_available()}")

    # 2. build
    t0 = time.perf_counter()
    lib = cuda_kernel.build(verbose=True)
    print(f"build: {time.perf_counter() - t0:.3f}s {lib.name} {on}")

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
    permute_mont_cuda.launches = 0
    t0 = time.perf_counter()
    proof = machine.prove(pk, q, Challenger(), device=True)
    _sync()
    cold = time.perf_counter() - t0
    launches = permute_mont_cuda.launches
    if launches <= 0:
        raise AssertionError("the slice never launched the Poseidon2 kernel")
    if len(proof.shard_proofs) != 1:
        raise AssertionError(f"{len(proof.shard_proofs)} shards, expected 1")
    cold_sha = hashlib.sha256(codec.encode(proof)).hexdigest()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    proof = machine.prove(pk, q, Challenger(), device=True)
    _sync()
    warm = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
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
          f"kernel launches {launches}, proof sha256 {sha} {on}")

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
    fib_launches = fib100k(dev, on, FIB100K_CODE, FIB100K_SHARD_SIZE,
                           FIB100K_SHARDS, FIB100K_CELLS,
                           hashlib.sha256(gzip.decompress(
                               FIB100K_ARTIFACT.read_bytes())).hexdigest())

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

    print(json.dumps({"kernels": [{
        "name": "poseidon2_permute",
        "route": "cuda",
        "source": "lurk_tpu_torch/csrc/poseidon2.cu",
        "replaces": "lurk_tpu/poseidon/tpu_kernel.py:132",
        "launches": fib_launches,
        "launches_by_path": {"demo_fib_2^20": launches,
                             "lurk_fib100000": fib_launches,
                             "repl_demo_corpus": repl_launches,
                             "cli_load": cli_launches,
                             "microchain": chain_launches},
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": bounds[16][0],
        "bound_by": bounds[16][1],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
