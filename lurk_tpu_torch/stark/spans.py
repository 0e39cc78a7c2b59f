"""The prove's recorder: named spans, copy counters and collector pauses of
one StarkMachine.prove on the device path, on the profiler's clock.

The switch is LURK_TPU_PROVE_TIMING=1, or `enable(True)`. Off, `span()`
and `count()` test one module global and return: no clock is read and
nothing is allocated. On, StarkMachine.prove opens the root span `prove`
around device_prove (`prove(machine)`) and records, until it returns:

- every span: its name, shard, parent, start and end in time.time_ns()
  nanoseconds (the clock torch.profiler's events carry) and its exclusive
  seconds, the part of it that no child span holds;
- `count(name, n)`: the bytes copied host -> device (`h2d_bytes`) and
  device -> host (`d2h_bytes`) by field/babybear.py's helpers and the
  kernels' argument uploads, per span and per prove;
- the Python collector's pauses, as spans named `gc` (a gc.callbacks entry
  that is registered only while a recorded prove runs);
- one (time.perf_counter_ns(), time.time_ns()) pair, read back to back,
  to carry the spans to a perf_counter clock.

It leaves them in machine.last_device_prove: "spans" (a list of dicts, a
parent before its children), "counters" and "clock". Each span prints to
stderr when it ends as `[prove-timing] shard<i> <name>: <seconds>s` (no
`shard<i> ` without a shard). A span opened with each=True is one of many
under its parent (a chip, a copy, a collection): it prints once instead,
its seconds summed with those of its name and shard, when the nearest span
above it without each=True ends or another span without each=True opens
under that one. A `gc` span prints no line (its seconds stay in its
parent's): there are tens a prove, and the stamps' readers walk every line
for every idle gap. A span without a shard takes its parent's.

One prove records at a time in a process. With `enable(True,
ranges=True)` every span also enters torch.profiler.record_function under
its name, so that a profile with CPU activity shows the spans over the
kernels, on the same clock.

`PhasePeaks` is the prove's memory stamp: the device's allocated and
reserved peaks of each phase, on or off.
"""

from __future__ import annotations

import contextlib
import gc
import os
import sys
import time
from typing import List, Optional, Tuple

_switch: Optional[bool] = None    # enable()'s choice; None: the environment's
_ranges = False                   # enter record_function for each span
_rec: Optional["_Recorder"] = None   # the prove being recorded


def enable(on: Optional[bool] = True, ranges: bool = False) -> None:
    """Record later proves (on=True) or not (False), whatever
    LURK_TPU_PROVE_TIMING says; None gives the choice back to it. With
    ranges=True each span also enters torch.profiler.record_function."""
    global _switch, _ranges
    _switch, _ranges = on, bool(ranges)


def enabled() -> bool:
    if _switch is not None:
        return _switch
    return os.environ.get("LURK_TPU_PROVE_TIMING", "0") == "1"


def recording() -> bool:
    """True inside a recorded prove."""
    return _rec is not None


_NULL = contextlib.nullcontext()


def span(name: str, shard: Optional[int] = None, each: bool = False):
    """`with span(name, shard=i):` records the block as a span of the
    prove being recorded; outside one it does nothing."""
    if _rec is None:
        return _NULL
    return _Span(_rec, name, shard, each)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` of the innermost open span and of the
    prove being recorded; outside one it does nothing."""
    if _rec is not None:
        _rec.add(name, n)


@contextlib.contextmanager
def prove(machine):
    """`with prove(machine):` around one prove: the root span `prove`,
    whose record lands in machine.last_device_prove when the block ends
    without an exception. Does nothing when the switch is off or a prove
    is already being recorded."""
    global _rec
    if _rec is not None or not enabled():
        yield
        return
    rec = _rec = _Recorder()
    gc.callbacks.append(_on_gc)
    try:
        with _Span(rec, "prove", None, False):
            yield
    finally:
        gc.callbacks.remove(_on_gc)
        _rec = None
    stats = getattr(machine, "last_device_prove", None)
    if isinstance(stats, dict):
        stats.update(rec.result())


def _line(name: str, shard: Optional[int], ns: int) -> None:
    where = "" if shard is None else f"shard{shard} "
    print(f"[prove-timing] {where}{name}: {ns / 1e9:.6f}s",
          file=sys.stderr, flush=True)


# a row of _Recorder.rows
NAME, SHARD, PARENT, START, END, CHILD_NS, COUNTS, EACH = range(8)


class _Recorder:
    def __init__(self):
        self.rows: List[list] = []
        self.stack: List[int] = []
        self.counters: dict = {}
        self.summed: dict = {}        # row -> {(name, shard): ns} to print
        self.gc_start = 0
        self.clock = (time.perf_counter_ns(), time.time_ns())

    def open(self, name: str, shard, each: bool) -> int:
        parent = self.stack[-1] if self.stack else None
        if shard is None and parent is not None:
            shard = self.rows[parent][SHARD]
        if not each:
            self._flush(self._anchor(parent))
        row = [name, shard, parent, time.time_ns(), 0, 0, None, each]
        # a collection may add its row while this one is made: index after
        self.rows.append(row)
        idx = len(self.rows) - 1
        self.stack.append(idx)
        return idx

    def close(self, idx: int) -> None:
        end = time.time_ns()
        self.stack.pop()
        row = self.rows[idx]
        row[END] = end
        self._closed(row, idx, end - row[START])

    def closed_child(self, name: str, start: int, end: int) -> None:
        """A span that has already ended, as a child of the innermost open
        span: a collector pause, recorded but not printed."""
        parent = self.stack[-1]
        self.rows.append([name, self.rows[parent][SHARD], parent, start, end,
                          0, None, None])
        self._closed(self.rows[-1], len(self.rows) - 1, end - start)

    def _anchor(self, idx):
        """The nearest span without each=True, from row idx up."""
        while idx is not None and self.rows[idx][EACH]:
            idx = self.rows[idx][PARENT]
        return idx

    def _flush(self, anchor) -> None:
        """Print the summed lines of the each=True spans below `anchor`."""
        if anchor in self.summed:
            for (name, shard), total in self.summed.pop(anchor).items():
                _line(name, shard, total)

    def _closed(self, row: list, idx: int, ns: int) -> None:
        parent = row[PARENT]
        if parent is not None:
            self.rows[parent][CHILD_NS] += ns
        if row[EACH] is None:         # a collector pause prints no line
            return
        if not row[EACH]:
            self._flush(idx)
            _line(row[NAME], row[SHARD], ns)
            return
        acc = self.summed.setdefault(self._anchor(parent), {})
        key = (row[NAME], row[SHARD])
        acc[key] = acc.get(key, 0) + ns

    def add(self, name: str, n: int) -> None:
        self.counters[name] = self.counters.get(name, 0) + n
        row = self.rows[self.stack[-1]]
        if row[COUNTS] is None:
            row[COUNTS] = {}
        row[COUNTS][name] = row[COUNTS].get(name, 0) + n

    def result(self) -> dict:
        spans = []
        for r in self.rows:
            d = {"name": r[NAME], "shard": r[SHARD], "parent": r[PARENT],
                 "start_ns": r[START], "end_ns": r[END],
                 "exclusive_s": (r[END] - r[START] - r[CHILD_NS]) / 1e9}
            d.update(r[COUNTS] or {})
            spans.append(d)
        return {"spans": spans, "counters": dict(self.counters),
                "clock": self.clock}


class _Span:
    __slots__ = ("rec", "name", "shard", "each", "idx", "range")

    def __init__(self, rec: _Recorder, name: str, shard, each: bool):
        self.rec, self.name, self.shard, self.each = rec, name, shard, each
        self.range = None

    def __enter__(self):
        if _ranges:
            import torch
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.idx = self.rec.open(self.name, self.shard, self.each)
        return self

    def __exit__(self, *exc):
        self.rec.close(self.idx)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _on_gc(phase: str, info: dict) -> None:
    rec = _rec
    if rec is None or not rec.stack:
        return
    if phase == "start":
        rec.gc_start = time.time_ns()
    elif rec.gc_start:
        rec.closed_child("gc", rec.gc_start, time.time_ns())
        rec.gc_start = 0


class PhasePeaks:
    """Device-memory peaks of a prove's phases on a CUDA device: at each
    stamp, the allocated and reserved peaks since the previous stamp (the
    allocator's peak counters are reset there) and the allocated memory
    left. Allocations happen when an op is dispatched, so a phase's peak
    is that of the ops dispatched in it. Records nothing on the CPU."""

    def __init__(self, device):
        import torch
        self.device = device if device.type == "cuda" else None
        self.peaks: List[Tuple[str, int, int, int]] = []
        if self.device is not None:
            torch.cuda.reset_peak_memory_stats(self.device)

    def stamp(self, phase: str) -> None:
        d = self.device
        if d is None:
            return
        import torch
        self.peaks.append((phase, torch.cuda.max_memory_allocated(d),
                           torch.cuda.max_memory_reserved(d),
                           torch.cuda.memory_allocated(d)))
        torch.cuda.reset_peak_memory_stats(d)
