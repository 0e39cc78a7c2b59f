"""The sum100k.whole_card cell on the CPU at a small size: lurk_sum100k's
plain reference against the program's evaluation, the device prover with
the hasher chips' device witness against the host prover and the plain
verifier, the `hasher_rows` counter, and the hasher_witness_s reader."""

import json
from pathlib import Path

import pytest

from prove_bench import inputs as bench_inputs
from prove_bench import run as bench
from prove_bench.reference import verifier as V
from prove_bench.trace import Trace

CELL = "sum100k.whole_card"


def _short_list(seed: int, n: int = 40) -> dict:
    """The cell's inputs over a tail of n - 1 numbers: the head drawn as
    the cell draws it, the tail 1 .. n - 1 as upstream's."""
    workload, config, _ = bench.load_cell(CELL)
    x = bench_inputs.draw(config, workload, seed)["x"]
    return {"x": x, "tail": " ".join(str(i) for i in range(1, n))}


def _evaluated(inp: dict):
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    _, config, _ = bench.load_cell(CELL)
    toplevel, zstore, _ = build_lurk_toplevel()
    result, queries = evaluate(toplevel, zstore,
                               bench_inputs.program(config, inp))
    return toplevel, result, queries


def test_config_is_upstreams_list():
    _, config, ref = bench.load_cell(CELL)
    assert config["inputs"]["x"] == 0
    assert config["inputs"]["tail"].split() == [str(i)
                                                for i in range(1, 100000)]
    assert ref.result(config["inputs"]) == \
        (0, tuple((4999950000 >> (8 * i)) & 0xFF for i in range(8)))


def test_statements_draw_the_head():
    workload, config, _ = bench.load_cell(CELL)
    for seed in (8, 9, 2 ** 31 + 5, 3 << 40):
        got = bench_inputs.statements(config, workload, seed)
        assert got[0] != got[1]
        assert all(0 <= s["x"] <= 99999 and s["tail"] ==
                   config["inputs"]["tail"] for s in got)
        assert (got[0] == config["inputs"]) == (seed % 8 == 0)


@pytest.mark.parametrize("inp", [
    _short_list(3), _short_list(2 ** 31 + 11),
    {"x": 2 ** 64 - 1, "tail": "1 2 3"}], ids=["seed3", "seed2e31", "wraps"])
def test_result_reference_matches_evaluation(inp):
    _, ref = bench.load_cell(CELL)[1:]
    _, result, queries = _evaluated(inp)
    pv = queries.expect_public_values()
    assert (result.tag, tuple(result.digest)) == ref.result(inp)
    assert (pv[24], tuple(pv[32:40])) == ref.result(inp)


def test_device_witness_proof_is_the_host_proof(monkeypatch):
    """sum of a 40-element list proved on CPU tensors with every chip on
    the device path, hash4 and ingress witnesses made by device_trace:
    the host prover's bytes, no fault under the exported key, and the
    hash4 chip's rows in the `hasher_rows` counter."""
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.lair.execute import Shard
    from lurk_tpu_torch.stark import spans
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.utils import codec
    monkeypatch.setenv("LURK_TPU_DEVICE_WITNESS", "1")
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", "0")
    toplevel, _, queries = _evaluated(_short_list(5))
    machine = new_machine(toplevel, FriConfig(1, 8, 2))
    pk, vk = machine.setup()
    shard = Shard(queries, 0, None).shard()[0]
    rows = {c.name: c.num_rows(shard) for c in machine.chips
            if c.name in ("Func[hash4]", "Func[ingress]")}
    assert rows["Func[hash4]"] == 65 and rows["Func[ingress]"] > 0

    spans.enable(True)
    try:
        proof = machine.prove(pk, queries, Challenger(), device="cpu")
    finally:
        spans.enable(None)
    stats = machine.last_device_prove
    assert stats["device_witness_chips"] > 0
    assert stats["counters"]["hasher_rows"] == rows["Func[hash4]"]
    hasher = [r for r in stats["spans"] if r["name"] == "witness.hasher"]
    assert len(hasher) == 1
    assert stats["spans"][hasher[0]["parent"]]["name"] == "witness.device"

    host = machine.prove(pk, queries, Challenger(), device=False)
    assert codec.encode(proof) == codec.encode(host)
    key = bench._key({"toplevel": "direct"}, bench.BENCH)
    assert bench.vk_mismatch(vk, key) == 0
    assert V.verify(proof, key, V.Fri(1, 8, 2), device="cpu") == []


def _row(name, parent, start, end, exclusive, shard=0):
    return {"name": name, "shard": shard, "parent": parent,
            "start_ns": int(start * 1e9), "end_ns": int(end * 1e9),
            "exclusive_s": exclusive}


def _prove(k: float, hasher: bool = False) -> dict:
    """One prove's stats; with hasher=True its witness.device span holds a
    witness.hasher span of 0.25 k seconds, an upload inside it."""
    rows = [_row("prove", None, 0, 10, 0.1 * k, shard=None),
            _row("witness+upload", 0, 0, 4, 0.05 * k),
            _row("witness.device", 1, 1, 3, 1.0 * k)]
    if hasher:
        rows += [_row("witness.hasher", 2, 1.0, 1.0 + 0.25 * k, 0.05 * k),
                 _row("witness.upload", 3, 1.1, 1.2, 0.1)]
    return {"shards": 1, "host_witness_s": 0.5 * k, "spans": rows,
            "counters": {"h2d_bytes": int(k * 2 ** 30)}}


def _trace(stats) -> Trace:
    return Trace(proofs=len(stats), wall_s=20.0, t0=0.0, events=[],
                 stamps=[], stats=stats, shapes=[], eval_s=0.0)


def test_hasher_witness_s_reads_the_spans_with_their_uploads():
    read = bench.load_metric("hasher_witness_s")
    # inclusive seconds 0.125 and 0.375: the mean is 0.25
    assert read(_trace([_prove(0.5, True), _prove(1.5, True)])) == \
        pytest.approx(0.25)
    # a prove without the hasher path counts as zero seconds
    assert read(_trace([_prove(1.0, True), _prove(1.0)])) == \
        pytest.approx(0.125)


def test_hasher_witness_s_without_spans_reads_nothing():
    read = bench.load_metric("hasher_witness_s")
    assert read(_trace([_prove(1.0), _prove(2.0)])) is None
    assert read(_trace([{"shards": 1, "host_witness_s": 0.5}])) is None
    assert read(_trace([])) is None


def test_hasher_witness_s_is_listed_for_the_sum_cell():
    spec = json.loads((Path(bench.CHECKOUT) / "BENCHMARK.json").read_text())
    (m,) = [m for m in spec["per_layer"] if m["name"] == "hasher_witness_s"]
    assert m["workloads"] == [CELL] and m["moves"] == "prove_s"
    assert (m["source"], m["layer"], m["unit"], m["better"]) == \
        ("program_span", "witness", "s", "lower")
