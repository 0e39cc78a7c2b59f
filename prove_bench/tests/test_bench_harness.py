"""The harness on the CPU: cells, configurations and metrics found by name,
the result line, the JAX check, no fallback without a card, and runs of a
small cell with the control and each planted fault coming out not
correct."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from prove_bench import control, run as bench

BENCH = Path(bench.__file__).resolve().parent
ROOT = BENCH.parent
# 8 bits of proof of work: a proof ground at half of them passes the full
# check with probability 2^-4, and this test's proof (seed 3) does not
SMALL_FRI = {"log_blowup": 1, "num_queries": 8, "pow_bits": 8}


def small_bench(tmp_path: Path, shard=None) -> Path:
    """A bench directory with one small cell, `small.fib`: Lurk fib(n), n in
    [20, 30], at FriConfig(1, 8, 8), written as a later change would add a
    cell: a workload file and a configuration file with its reference."""
    b = tmp_path / "bench"
    (b / "workloads").mkdir(parents=True)
    (b / "configs").mkdir()
    config = json.loads((BENCH / "configs" / "lurk_fib100k.json").read_text())
    config.update(inputs={"n": 25}, fri=SMALL_FRI)
    (b / "configs" / "small_fib.json").write_text(json.dumps(config))
    shutil.copy(BENCH / "configs" / "lurk_fib100k.py",
                b / "configs" / "small_fib.py")
    shutil.copy(BENCH / "configs" / "air_direct.json.gz", b / "configs")
    shutil.copy(BENCH / "configs" / "vk_direct.json", b / "configs")
    (b / "workloads" / "small.fib.json").write_text(json.dumps({
        "config": "small_fib", "chips": 1, "max_shard_size": shard,
        "draw": {"n": {"kind": "int", "lo": 20, "hi": 30}},
        "upstream_every": 8, "why": "a test"}))
    shutil.copytree(BENCH / "metrics", b / "metrics")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (b / "BENCHMARK.json").write_text(json.dumps(spec))
    return b


def small_run(b: Path, seed=3, trace=0, case=None):
    args = SimpleNamespace(workload="small.fib", seed=seed, seconds=0.01,
                           trace=trace)
    kw = dict(bench=b, bench_json=b / "BENCHMARK.json", device="cpu")
    if case is None:
        return bench.run(args, **kw)
    return control.run_case(case, "small.fib", seed, 0.01, **kw)


def test_cell_found_by_name(tmp_path):
    b = small_bench(tmp_path)
    workload, config, reference = bench.load_cell("small.fib", b)
    assert workload["config"] == "small_fib"
    assert config["inputs"] == {"n": 25}
    assert reference.result({"n": 10})[0] == 0
    with pytest.raises(bench.BenchError):
        bench.load_cell("no.such.cell", b)
    with pytest.raises(bench.BenchError):
        bench.load_cell("../escape", b)


def test_metric_found_by_name(tmp_path):
    b = small_bench(tmp_path)
    (b / "metrics" / "proofs.count.py").write_text(
        "def read(trace):\n    return trace.proofs\n")
    assert bench.load_metric("proofs.count", b)(SimpleNamespace(proofs=3)) \
        == 3


def test_every_listed_piece_exists():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in spec["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for c in spec["configs"]:
        assert (ROOT / c["file"]).exists()
        assert (ROOT / c["file"]).with_suffix(".py").exists()
    for w in spec["workloads"]:
        workload, _, _ = bench.load_cell(w["name"])
        assert workload["config"] == w["config"]
        assert len(w["why"]) <= 200


@pytest.mark.parametrize("name,banned", [
    ("lurk_tpu_torch", False), ("lurk_tpu_torch.stark.machine", False),
    ("lurk_tpu", True), ("lurk_tpu.x", True), ("jax", True),
    ("jaxlib.y", True), ("flax.linen", True), ("jaxtyping", False),
    ("prove_bench.run", False)])
def test_jax_check(name, banned):
    assert bench.banned_modules([name]) == ([name] if banned else [])


def test_sources_import_no_jax_nor_old_benches():
    """Every module of the harness imports only the stdlib, numpy, torch,
    lurk_tpu_torch and itself, and names none of the old benchmark
    files."""
    allowed = {"numpy", "torch", "lurk_tpu_torch", "prove_bench"}
    for path in BENCH.rglob("*.py"):
        text = path.read_text()
        for node in ast.walk(ast.parse(text)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module]
            for n in names:
                top = n.split(".")[0]
                assert top in allowed or top in sys.stdlib_module_names \
                    or top in ("pytest",), (path, n)
        if path.parent.name != "tests":
            for old in ("chip_smoke", "prove_turns", "benches/", "bench.py",
                        "BENCH_"):
                assert f'"{old}' not in text and f"'{old}" not in text, \
                    (path, old)


def test_no_card_exits_nonzero():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "prove_bench.run",
                          "--workload", "fib100k.shard262144", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_alone_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and prove_bench/ holds no
    program: the run fails before any result."""
    shutil.copytree(BENCH, tmp_path / "prove_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "prove_bench.run",
                          "--workload", "lcs.whole_card", "--seed", "5",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert out.stdout == ""


def test_small_run_is_correct(tmp_path, capsys):
    out = small_run(small_bench(tmp_path))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    # two statements, each proved cold and at least one in the window
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert {"bad_proofs", "vk_mismatch", "result_mismatch",
            "plain_verifier_faults"} <= set(out["checks"])
    assert set(out["metrics"]) == {"prove_s", "peak_device_gib", "setup_s"}
    assert all(c["limit"] == 0 for c in out["checks"].values())
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("bad_proofs 0 (limit 0)")
    assert not bench.banned_modules(list(sys.modules))


def test_statements_differ_and_repeat():
    from prove_bench import inputs
    workload, config, _ = bench.load_cell("fib100k.shard262144")
    for seed in (8, 9, 2 ** 31 + 5, 3 << 40):
        got = inputs.statements(config, workload, seed)
        assert len(got) == inputs.STATEMENTS == 2
        assert got[0] != got[1]
        assert got == inputs.statements(config, workload, seed)
        assert all(99000 <= s["n"] <= 100000 for s in got)
        assert (got[0] == config["inputs"]) == (seed % 8 == 0)
    workload, config, _ = bench.load_cell("lcs.whole_card")
    a, b = inputs.statements(config, workload, 11)
    assert a != b and sorted(a["a"]) == sorted(config["inputs"]["a"])


def test_vk_mismatch_counts_each_field():
    key = bench._key({"toplevel": "direct"}, BENCH)
    vk = SimpleNamespace(prep_chip_names=list(key.prep_chip_names),
                         prep_widths=list(key.prep_widths),
                         prep_log_heights=list(key.prep_log_heights),
                         prep_roots=[list(r) for r in key.prep_roots])
    assert bench.vk_mismatch(vk, key) == 0
    vk.prep_roots[0][3] += 1
    assert bench.vk_mismatch(vk, key) == 1
    vk.prep_log_heights = [17]
    assert bench.vk_mismatch(vk, key) == 2


@pytest.mark.parametrize("case,shard,check", [
    ("fewer_queries", None, "plain_verifier_faults"),
    ("weaker_pow", None, "plain_verifier_faults"),
    ("other_statement", None, "result_mismatch"),
    ("stale_proof", None, "result_mismatch"),
    ("half_left_out", None, "plain_verifier_faults"),
    ("half_left_out", 256, "plain_verifier_faults"),
    ("answer_altered", None, "plain_verifier_faults")])
def test_control_and_faults_are_not_correct(tmp_path, case, shard, check):
    out = small_run(small_bench(tmp_path, shard=shard), case=case)
    assert out["correct"] is False
    assert out["checks"][check]["value"] > 0, out["checks"]
    assert out["failed"] == out["attempted"]


@pytest.mark.cuda
def test_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "prove_bench.run",
                          "--workload", "lcs.whole_card", "--seed", "9",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
