"""The prove's recorder (lurk_tpu_torch/stark/spans.py) on the CPU: off, a
prove leaves no trace of it; on, proves keep their bytes, spans nest, the
leaves cover the root, and the copy counters equal the bytes the copy
helpers moved, the same in two proves. The machine is
tests/test_torch_nonaffine.py's toy (two chips of 16 rows: a prove takes
a fraction of a second), on the device path or, with the host-path
threshold at its default, on the host path; the full Lurk machine's
recorded proof is held to its golden in tests/test_torch_lurk_prover.py.
"""

import gc
import re

import pytest
import torch

from lurk_tpu_torch.air import symbolic
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.lair.demo import demo_toplevel
from lurk_tpu_torch.lair.execute import QueryRecord, execute_by_name
from lurk_tpu_torch.stark import spans
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.stark.machine import StarkMachine
from lurk_tpu_torch.utils import codec
from tests.test_torch_nonaffine import MulChip, _queries

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

STAMP = re.compile(r"^\[prove-timing\] (shard\d+ )?(\S+): (\d+\.\d{6})s$")


@pytest.fixture
def recorder():
    """Switch the recorder on for the test and back to the environment's
    choice after it."""
    spans.enable(True)
    yield
    spans.enable(None)


def _toy():
    q = _queries(demo_toplevel, QueryRecord, execute_by_name)
    x0 = q.expect_public_values()[0]
    machine = StarkMachine([MulChip(symbolic, k, x0)
                            for k in ("send", "receive")], 2,
                           FriConfig(1, 8, 2))
    pk, _ = machine.setup()
    return machine, pk, q


def _prove(machine, pk, q) -> bytes:
    return codec.encode(machine.prove(pk, q, Challenger(), device="cpu"))


def check_nesting(rows, cover=0.95):
    """Every span lies inside its parent, a parent comes before its
    children, one root `prove`; the root's children cover `cover` of it;
    exclusive seconds are never negative. Returns the root."""
    (root,) = [r for r in rows if r["parent"] is None]
    assert root["name"] == "prove" and rows[0] is root
    for i, r in enumerate(rows[1:], 1):
        p = rows[r["parent"]]
        assert r["parent"] < i
        assert p["start_ns"] <= r["start_ns"] <= r["end_ns"] <= p["end_ns"]
        assert r["exclusive_s"] >= 0
    total = (root["end_ns"] - root["start_ns"]) / 1e9
    assert root["exclusive_s"] <= (1 - cover) * total
    return root


def tally_copies(monkeypatch) -> dict:
    """Wrap the copy helpers of field/babybear.py; returns the bytes they
    moved each way."""
    moved = {"h2d_bytes": 0, "d2h_bytes": 0}
    upload, to_numpy = bb.upload, bb.to_numpy

    def counted_upload(a, device):
        t = upload(a, device)
        moved["h2d_bytes"] += t.nbytes
        return t

    def counted_to_numpy(t):
        moved["d2h_bytes"] += t.nbytes
        return to_numpy(t)

    monkeypatch.setattr(bb, "upload", counted_upload)
    monkeypatch.setattr(bb, "to_numpy", counted_to_numpy)
    return moved


def test_off_leaves_no_trace(monkeypatch):
    monkeypatch.delenv("LURK_TPU_PROVE_TIMING", raising=False)
    spans.enable(None)
    assert not spans.enabled()
    callbacks = list(gc.callbacks)
    machine, pk, q = _toy()
    _prove(machine, pk, q)
    assert gc.callbacks == callbacks
    assert not {"spans", "counters", "clock"} & set(machine.last_device_prove)
    assert spans.span("x", shard=0) is spans.span("y", each=True)
    spans.count("h2d_bytes", 1)                  # outside a prove: nothing
    assert not spans.recording()


@pytest.mark.parametrize("min_rows,host_chips", [("0", 0), ("4096", 2)])
def test_recorded_proves(monkeypatch, recorder, capsys, min_rows,
                         host_chips):
    """The toy's two chips on the device path (threshold 0) or both on the
    host path (threshold 2^12): the recorded proof is the unrecorded one,
    spans nest and cover the root, every span prints a stamp line, and two
    proves count the bytes the copy helpers moved, the same each time."""
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", min_rows)
    machine, pk, q = _toy()
    spans.enable(False)
    plain = _prove(machine, pk, q)      # warms the device tables' caches
    spans.enable(True)
    callbacks = list(gc.callbacks)
    capsys.readouterr()
    counts = []
    for _ in range(2):
        with monkeypatch.context() as mp:
            moved = tally_copies(mp)
            assert _prove(machine, pk, q) == plain
        stats = machine.last_device_prove
        assert stats["counters"] == moved
        assert moved["h2d_bytes"] > 0 and moved["d2h_bytes"] > 0
        counts.append(moved)
    assert counts[0] == counts[1]
    assert gc.callbacks == callbacks
    assert stats["host_path_chips"] == [host_chips]
    rows = stats["spans"]
    check_nesting(rows)
    names = {r["name"] for r in rows}
    side = "host" if host_chips else "device"
    assert {"plan", "prep", "witness+upload", "witness.host",
            "witness.upload", "main.commit", "roots", f"perm.{side}",
            "cums", "perm.commit", f"quotient.{side}", "quotient.commit",
            "points", "open+fri", "open.eval", "open.host", "open.reduce",
            "fri.commit", "fri.tail", "fri.pow", "queries"} <= names
    # per-span counters add up to the prove's
    for key in ("h2d_bytes", "d2h_bytes"):
        assert sum(r.get(key, 0) for r in rows) == stats["counters"][key]
    pc, wall = stats["clock"]
    assert isinstance(pc, int) and wall <= rows[0]["start_ns"]
    # one line a span name and shard (each=True spans summed), the second
    # prove's lines after the first's
    lines = [l for l in capsys.readouterr().err.splitlines()
             if l.startswith("[prove-timing]") and "device_prove:" not in l]
    assert all(STAMP.match(l) for l in lines), lines
    ends = [i for i, l in enumerate(lines)
            if l.startswith("[prove-timing] prove: ")]
    assert len(ends) == 2 and ends[1] == len(lines) - 1
    second = lines[ends[0] + 1:]
    got: dict = {}
    for m in map(STAMP.match, second):
        got[m.group(2)] = got.get(m.group(2), 0.0) + float(m.group(3))
    assert "gc" not in got
    for name in names - {"gc"}:
        want = sum((r["end_ns"] - r["start_ns"]) / 1e9 for r in rows
                   if r["name"] == name)
        assert got[name] == pytest.approx(want, abs=1e-5 * len(rows))


def test_recorder_alone(recorder, capsys):
    """The recorder without a machine: shard inheritance, exclusive
    seconds, each=True spans summed into one line printed when the next
    span without it opens, collector pauses as `gc` spans that print no
    line, counters per span, and record_function ranges under the
    profiler."""
    class Machine:
        last_device_prove = {}

    spans.enable(True, ranges=True)
    gc.disable()          # the only collections: gc.collect(0) below
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with spans.prove(Machine):
                with spans.prove(Machine):      # nested: records nothing
                    pass
                with spans.span("outer", shard=3):
                    for _ in range(3):
                        with spans.span("item", each=True):
                            spans.count("h2d_bytes", 5)
                            gc.collect(0)
                    with spans.span("inner"):
                        spans.count("d2h_bytes", 7)
    finally:
        gc.enable()
    stats = Machine.last_device_prove
    rows = stats["spans"]
    check_nesting(rows, cover=0.5)
    assert [(r["name"], r["shard"]) for r in rows if r["name"] != "gc"] == \
        [("prove", None), ("outer", 3), ("item", 3), ("item", 3),
         ("item", 3), ("inner", 3)]
    pauses = [r for r in rows if r["name"] == "gc"]
    assert len(pauses) == 3 and all(rows[r["parent"]]["name"] == "item"
                                    for r in pauses)
    items = [r for r in rows if r["name"] == "item"]
    for r in items:
        kids = sum(p["end_ns"] - p["start_ns"] for p in pauses
                   if rows[p["parent"]] is r)
        assert r["exclusive_s"] == pytest.approx(
            (r["end_ns"] - r["start_ns"] - kids) / 1e9)
    assert [r.get("h2d_bytes") for r in items] == [5, 5, 5]
    assert stats["counters"] == {"h2d_bytes": 15, "d2h_bytes": 7}
    err = [l for l in capsys.readouterr().err.splitlines()
           if l.startswith("[prove-timing]")]
    assert [STAMP.match(l).group(1, 2) for l in err] == [
        ("shard3 ", "item"), ("shard3 ", "inner"), ("shard3 ", "outer"),
        (None, "prove")]
    assert float(STAMP.match(err[0]).group(3)) == pytest.approx(
        sum(r["end_ns"] - r["start_ns"] for r in items) / 1e9, abs=3e-6)
    ranges = {e.name for e in prof.events()}
    assert {"prove", "outer", "item", "inner"} <= ranges
    assert not spans.recording()
