"""prove_bench: warm Lurk proofs of lurk_tpu_torch on one CUDA card.

    python3 -m prove_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

A proving service with one client that proves back to back (a closed loop
of concurrency 1). The cell's file, prove_bench/workloads/<cell>.json,
names its configuration (prove_bench/configs/<config>.json: the Lurk
program, the toplevel, the FriConfig) and its sharding; the seed draws the
inputs of two different statements of the program
(prove_bench/inputs.py). Set-up builds the toplevel, evaluates the program
on both, makes the machine and its keys and proves each statement once,
cold. The window then starts whole proves of
`StarkMachine.prove(pk, queries, Challenger(), shard_config, device=True)`,
the two statements in turn, each ending in `torch.cuda.synchronize()`,
until `--seconds` have passed, and finishes the one in flight.

With --trace 0 the last line of stdout carries the end-to-end metrics:
prove_s (the window's seconds over the proofs it completed),
peak_device_gib (the card's reserved memory after the window; the
allocator never gives memory back in a prove, so this is the peak of every
prove in the process) and setup_s (process start to the end of the cold
prove). With --trace 1 the window runs under torch.profiler (CUDA
activity) with the program's `[prove-timing]` stamps on, and the line
carries the per-layer metrics, each read by prove_bench/metrics/<name>.py.

`correct` holds when the program's verifying key is the one exported from
lurk_tpu (prove_bench/configs/vk_<toplevel>.json), every proof of a
statement, the cold one included, has the same bytes, and for each
statement the first proof of the window holds the result that the
configuration's plain reference (prove_bench/configs/<config>.py)
computes, the plain verifier (prove_bench/reference/) finds no fault in it
and, where the cell names one, its sha256 equals that of lurk_tpu's proof
of the same statement. Each number compared is printed beside its limit, last on
stderr and last in the result line.

Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for, and if the JAX package, JAX or flax is
loaded in this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
CHECKOUT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "lurk_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BREAKDOWN_ROWS = 10


class BenchError(Exception):
    pass


def banned_modules(names) -> list:
    """The modules among `names` whose top-level name (before the first
    dot) is exactly one of BANNED: lurk_tpu_torch passes, lurk_tpu.x and
    jaxlib.y do not."""
    return sorted(n for n in names if n.split(".", 1)[0] in BANNED)


def _check_modules(when: str) -> None:
    found = banned_modules(list(sys.modules))
    if found:
        raise BenchError(f"{when}: loaded {', '.join(found[:10])}")


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError:
        raise BenchError(f"no file {path}") from None


def load_cell(name: str, bench: Path = BENCH):
    """(workload, configuration, the configuration's plain reference module)
    of the cell `name`, found by name under `bench`."""
    if not NAME.match(name):
        raise BenchError(f"bad cell name {name!r}")
    workload = _json(bench / "workloads" / f"{name}.json")
    config_name = workload["config"]
    if not NAME.match(config_name):
        raise BenchError(f"bad configuration name {config_name!r}")
    config = _json(bench / "configs" / f"{config_name}.json")
    ref_path = bench / "configs" / f"{config_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"prove_bench_config_{config_name.replace('.', '_')}", ref_path)
    reference = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reference)
    return workload, config, reference


def load_metric(name: str, bench: Path = BENCH):
    """The reader of the per-layer metric `name`:
    prove_bench/metrics/<name>.py's `read(trace)`."""
    if not NAME.match(name):
        raise BenchError(f"bad metric name {name!r}")
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        raise BenchError(f"no reader {path}")
    spec = importlib.util.spec_from_file_location(
        f"prove_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_entries(workload_name: str, trace: bool,
                   bench_json: Path = CHECKOUT / "BENCHMARK.json") -> list:
    """BENCHMARK.json's end-to-end (trace 0) or per-layer (trace 1)
    metrics that this cell reports."""
    spec = _json(bench_json)
    out = []
    for m in spec["per_layer" if trace else "end_to_end"]:
        cells = m.get("workloads")
        if cells is None or workload_name in cells:
            out.append(m)
    return out


def _caches() -> None:
    """The key cache (LURK_DIR) at a fixed path under the run's own cache
    home; the program builds its nvcc libraries into the checkout's
    build/lurk_tpu_torch/ (lurk_tpu_torch/utils/cuda_build.py)."""
    home = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    os.environ["LURK_DIR"] = os.path.join(home, "prove_bench", "lurk")


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read"


def _usage() -> tuple:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime, r.ru_stime


def _limits_line(checks: list) -> str:
    return "; ".join(f"{name} {value} (limit {limit})"
                     for name, value, limit in checks)


def require_cards(chips: int) -> None:
    """Raise unless this machine has `chips` CUDA cards: the benchmark
    never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"{torch.cuda.device_count()} CUDA device(s), the "
                         f"cell asks for {chips}")


def run(args, bench: Path = BENCH, bench_json: Path = CHECKOUT /
        "BENCHMARK.json", device: str = "cuda:0") -> dict:
    """One run of a cell on `device`; main() has checked for the cards (a
    test drives the rest of a run on the CPU)."""
    workload, config, reference = load_cell(args.workload, bench)
    chips = int(workload.get("chips", 1))
    if args.trace:
        os.environ["LURK_TPU_PROVE_TIMING"] = "1"
    import torch
    from . import inputs, work
    from .reference import verifier as plain
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair.execute import ShardingConfig
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.stark.key_cache import setup_cached
    from lurk_tpu_torch.utils import codec
    if config["toplevel"] == "direct":
        from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    elif config["toplevel"] == "compiled":
        from lurk_tpu_torch.core.eval_compiled import build_lurk_toplevel
    else:
        raise BenchError(f"unknown toplevel {config['toplevel']!r}")
    key = _key(config, bench)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # set-up
    statements = inputs.statements(config, workload, args.seed)
    toplevel, zstore, _ = build_lurk_toplevel()
    t = time.perf_counter()
    queries = [evaluate(toplevel, zstore, inputs.program(config, s))[1]
               for s in statements]
    eval_s = time.perf_counter() - t
    machine = new_machine(toplevel, FriConfig(**config["fri"]))
    pk, vk = setup_cached(machine)
    shard_size = workload.get("max_shard_size")
    shard_config = None if shard_size is None else ShardingConfig(shard_size)

    def prove(k):
        proof = machine.prove(pk, queries[k], Challenger(),
                              shard_config=shard_config,
                              device=True if cuda else device)
        sync()
        return proof

    proofs = [[prove(k)] for k in range(len(statements))]   # cold
    setup_s = time.perf_counter() - T0
    _check_modules("after set-up")

    # the window: the statements in turn
    window = []
    stats = []
    stamps = prof = None
    with contextlib.ExitStack() as stack:
        if args.trace:
            from .trace import StampLog
            stamps = StampLog(sys.stderr)
            prof = stack.enter_context(torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]))
            stack.enter_context(contextlib.redirect_stderr(stamps))
        gc0 = gc.get_stats()[2]["collections"]
        use0 = _usage()
        w0 = time.perf_counter()
        walls = []
        while True:
            k = len(window) % len(statements)
            window.append(prove(k))
            proofs[k].append(window[-1])
            stats.append(dict(machine.last_device_prove))
            elapsed = time.perf_counter() - w0
            walls.append(elapsed - sum(walls))
            if elapsed >= args.seconds:
                break
    gc2 = gc.get_stats()[2]["collections"] - gc0
    use = [b - a for a, b in zip(use0, _usage())]
    reserved = torch.cuda.memory_reserved(dev) if cuda else 0
    _check_modules("after the window")
    n = len(window)
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else dev.type, "count": chips,
                   "memory_peak_bytes": int(reserved)}
    trace = None
    if args.trace:
        from .trace import Trace
        events = _device_events(prof, torch)
        trace = Trace(proofs=n, wall_s=elapsed, t0=w0, events=events,
                      stamps=stamps.lines, stats=stats,
                      shapes=[work.shard_matrices(p, key)
                              for p in window], eval_s=eval_s)
        device_info.update(busy_s=trace.busy_s(), window_s=elapsed)
        del prof
        print(f"trace read in {time.perf_counter() - w0 - elapsed:.3f} s, "
              f"{len(events)} device events", file=sys.stderr)

    # correctness, once the window has closed and its memory been read
    del window
    checks, failed = _correctness(proofs, statements, reference, workload,
                                  config, key, vk, codec, plain, device)
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": sum(map(len, proofs)), "failed": failed}
    if args.trace:
        metrics = {}
        for m in metric_entries(args.workload, True, bench_json):
            value = load_metric(m["name"], bench)(trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = _breakdown(trace)
    else:
        e2e = {"prove_s": elapsed / n, "peak_device_gib": reserved / 2 ** 30,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metric_entries(args.workload, False, bench_json)}
    out.update(metrics=metrics, device=device_info,
               checks={name: {"value": v, "limit": lim}
                       for name, v, lim in checks})
    card = _card() if cuda else "cpu"
    print(f"prove_bench {args.workload} seed {args.seed}: statements "
          f"{'; '.join(_short(s) for s in statements)}, {n} proofs in the "
          f"window, {elapsed:.3f} s (each: "
          f"{', '.join(f'{w:.3f}' for w in walls)}), set-up {setup_s:.3f} s, "
          f"{gc2} full collections [{card}]", file=sys.stderr)
    print("host in the window: {} CPUs, {} torch threads; user {:.3f} s, "
          "system {:.3f} s".format(len(os.sched_getaffinity(0)),
                                   torch.get_num_threads(), *use),
          file=sys.stderr)
    _check_modules("before the result")
    print(_limits_line(checks), file=sys.stderr)
    return out


def _device_events(prof, torch) -> list:
    """(name, start, end) of every device event, in seconds from the
    profiler's start, read from kineto's records (building the profiler's
    own event list takes about a minute for a few fib(100000) proves)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), (e.start_ns() - t0) / 1e9,
             (e.start_ns() + e.duration_ns() - t0) / 1e9)
            for e in res.events() if e.device_type() == cuda]


def _short(inputs: dict) -> str:
    return ", ".join(f"{k}={str(v)[:24]!r}" for k, v in inputs.items())


VK_FIELDS = ("prep_chip_names", "prep_widths", "prep_log_heights",
             "prep_roots")


def _key(config: dict, bench: Path):
    """The plain verifier's key: lurk_tpu's verifying key and the
    configuration's AIR, both as exported data, nothing of the program."""
    from .reference.verifier import Key, load_air
    air, n_pv = load_air(bench / "configs" / f"air_{config['toplevel']}"
                         ".json.gz")
    vk = _json(bench / "configs" / f"vk_{config['toplevel']}.json")
    return Key([tuple(r) for r in vk["prep_roots"]],
               list(vk["prep_chip_names"]), list(vk["prep_widths"]),
               list(vk["prep_log_heights"]), n_pv, air)


def vk_mismatch(vk, key) -> int:
    """How many of the program's verifying key's fields differ from the
    exported key's."""
    def plain(f, obj):
        v = getattr(obj, f)
        return [tuple(int(x) for x in r) for r in v] if f == "prep_roots" \
            else [x if isinstance(x, str) else int(x) for x in v]
    return sum(plain(f, vk) != plain(f, key) for f in VK_FIELDS)


def _correctness(proofs, statements, reference, workload, config, key, vk,
                 codec, plain, device) -> tuple:
    """(name, value, limit) of every number compared, and the proofs that
    failed. Each limit is 0: the comparisons are exact. For each statement
    the first proof of the window is checked in full and every other proof
    of it, the cold one included, against its bytes."""
    t = time.perf_counter()
    digests = [[hashlib.sha256(codec.encode(p)).hexdigest() for p in ps]
               for ps in proofs]
    spent = {"encode": time.perf_counter() - t, "plain verifier": 0.0}
    fri = plain.Fri(**config["fri"])
    lurk_tpu = workload.get("lurk_tpu_proofs", {})
    bad = wrong = faults = mismatch = anchored = 0
    for inputs, ps, ds in zip(statements, proofs, digests):
        first, d1 = ps[min(1, len(ps) - 1)], ds[min(1, len(ds) - 1)]
        bad += sum(d != d1 for d in ds)
        tag, digest = reference.result(inputs)
        pv = [int(v) for v in first.public_values]
        wrong += not (len(pv) >= 40 and pv[24] == tag and
                      tuple(pv[32:40]) == tuple(digest))
        t = time.perf_counter()
        found = plain.verify(first, key, fri, device=device)
        spent["plain verifier"] += time.perf_counter() - t
        for f in found:
            print(f"plain verifier, {_short(inputs)}: {f}", file=sys.stderr)
        faults += len(found)
        want = lurk_tpu.get(json.dumps(inputs, sort_keys=True))
        if want is not None:
            anchored += 1
            mismatch += d1 != want
    print("correctness seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in spent.items()), file=sys.stderr)
    checks = [("bad_proofs", bad, 0),
              ("vk_mismatch", vk_mismatch(vk, key), 0),
              ("result_mismatch", wrong, 0),
              ("plain_verifier_faults", faults, 0)]
    if anchored:
        checks.append(("lurk_tpu_proof_mismatch", mismatch, 0))
    if any(v > lim for _, v, lim in checks[1:]):
        return checks, sum(map(len, proofs))
    return checks, bad


def _breakdown(trace) -> dict:
    by_name: dict = {}
    for name, s, e in trace.events:
        by_name[name] = by_name.get(name, 0.0) + e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
    idle = sorted(trace.idle_by_phase().items(),
                  key=lambda kv: -kv[1])[:BREAKDOWN_ROWS]
    return {"device_ops": [[k[:120], v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m prove_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        workload, _, _ = load_cell(args.workload)
        require_cards(int(workload.get("chips", 1)))
        _caches()
        out = run(args)
    except BenchError as e:
        print(f"prove_bench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
