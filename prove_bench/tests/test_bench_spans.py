"""The readers of the program's recorded spans and counters on synthetic
traces: the mean over the traced proves of each, and nothing (None) from a
program that records no spans."""

import json
from pathlib import Path

import pytest

from prove_bench import run as bench
from prove_bench.trace import Trace

READERS = ("witness_upload_s", "witness_device_host_s", "h2d_gib",
           "host_path_s", "fri_host_s", "gc_pause_s", "untraced_s")


def _row(name, parent, start, end, exclusive, shard=0):
    return {"name": name, "shard": shard, "parent": parent,
            "start_ns": int(start * 1e9), "end_ns": int(end * 1e9),
            "exclusive_s": exclusive}


def _prove(k: float) -> dict:
    """One prove's stats: its spans' exclusive seconds scale with k."""
    rows = [_row("prove", None, 0, 10, 0.1 * k, shard=None),
            _row("witness+upload", 0, 0, 4, 0.05 * k),
            _row("witness.host", 1, 0, 1, 0.5 * k),
            _row("witness.upload", 2, 0.5, 0.9, 0.4 * k),
            _row("witness.device", 1, 1, 3, 1.0 * k),
            _row("witness.upload", 4, 2, 2.5, 0.5 * k),
            _row("gc", 4, 2.6, 2.7, 0.1 * k),
            _row("perm.host", 0, 4, 5, 1.0 * k),
            _row("quotient.host", 0, 5, 6, 2.0 * k),
            _row("open+fri", 0, 6, 9.9, 0.01 * k),
            _row("fri.tail", 9, 6, 7, 0.7 * k),
            _row("fri.pow", 9, 7, 8, 0.3 * k),
            _row("gc", 9, 8, 8.2, 0.2 * k)]
    return {"shards": 1, "host_witness_s": 0.5 * k, "spans": rows,
            "counters": {"h2d_bytes": int(k * 2 ** 30), "d2h_bytes": 8}}


def _trace(stats) -> Trace:
    return Trace(proofs=len(stats), wall_s=20.0, t0=0.0, events=[],
                 stamps=[], stats=stats, shapes=[], eval_s=0.0)


@pytest.mark.parametrize("name,want", [
    ("witness_upload_s", 0.9), ("witness_device_host_s", 1.0),
    ("h2d_gib", 1.0), ("host_path_s", 3.0), ("fri_host_s", 1.0),
    ("gc_pause_s", 0.3), ("untraced_s", 0.1)])
def test_reader_takes_the_mean_over_proves(name, want):
    # proves at k = 0.5 and 1.5: the mean is the value at k = 1
    read = bench.load_metric(name)
    assert read(_trace([_prove(0.5), _prove(1.5)])) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_reads_nothing(name):
    """A program that records no spans (a parent tree): every prove's stats
    lack them, and the reader returns None instead of raising."""
    read = bench.load_metric(name)
    assert read(_trace([{"shards": 1, "host_witness_s": 0.5}])) is None
    assert read(_trace([])) is None


def test_readers_are_listed_for_both_cells():
    spec = json.loads((Path(bench.CHECKOUT) / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in spec["workloads"]]
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in READERS:
        m = listed[name]
        assert m["workloads"] == cells and m["moves"] == "prove_s"
        assert m["better"] == "lower"
        assert m["source"] == ("program_counter" if name == "h2d_gib"
                               else "program_span")
