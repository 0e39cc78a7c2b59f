"""What a traced run records: the device events of the profiled proves and
the host's `[prove-timing]` stamps, with the arithmetic that reduces them.

`busy_us` is lurk_tpu_torch/profile_prove.py's `_busy_us`; `phases` is
scripts/prove_turns.py's `_phases` (copied; both read nothing else).
"""

from __future__ import annotations

import io
import re
import time
from dataclasses import dataclass
from typing import List, Tuple

STAMP = re.compile(r"^\[prove-timing\] (.+?): ([\d.]+)s")


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def phase_name(label: str) -> str:
    """A stamp's phase without its shard ("shard3 witness+upload" is
    "witness+upload")."""
    return re.sub(r"^shard\d+ ", "", label.strip())


def phases(log: str) -> dict:
    """Seconds by phase from device_prove's [prove-timing] lines, summed
    over the shards."""
    out: dict = {}
    for label, sec in re.findall(r"^\[prove-timing\] (.+?): ([\d.]+)s",
                                 log, re.M):
        key = phase_name(label)
        out[key] = out.get(key, 0.0) + float(sec)
    return out


class StampLog(io.TextIOBase):
    """A stand-in for stderr during a traced window: keeps each
    `[prove-timing]` line with the host clock at which it was written and
    passes every other line on to `through`."""

    def __init__(self, through):
        self.through = through
        self.lines: List[Tuple[float, str]] = []
        self._buf = ""

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            if line.startswith("[prove-timing]"):
                self.lines.append((time.perf_counter(), line))
            else:
                self.through.write(line + "\n")
        return len(s)


@dataclass
class Trace:
    """A traced window: `proofs` whole proves in `wall_s` seconds of host
    clock, from `t0` (perf_counter) on; the device events (name, start,
    end) in seconds from `t0`; the stamps (perf_counter, line); each
    prove's `last_device_prove`; the shapes of each prove's shards
    (work.shard_matrices); and the set-up's evaluation seconds."""
    proofs: int
    wall_s: float
    t0: float
    events: List[Tuple[str, float, float]]
    stamps: List[Tuple[float, str]]
    stats: List[dict]
    shapes: list
    eval_s: float

    def kernel_s(self, key: str) -> float:
        return sum(e - s for name, s, e in self.events if key in name)

    def busy_s(self) -> float:
        return busy_us((s, e) for _, s, e in self.events)

    def stamp_intervals(self) -> List[Tuple[float, float, str]]:
        """(start, end, phase) of each stamp, in seconds from t0: a stamp
        written at t after d seconds covers [t - d, t]."""
        out = []
        for t, line in self.stamps:
            m = STAMP.match(line)
            if m:
                d = float(m.group(2))
                out.append((t - self.t0 - d, t - self.t0, phase_name(
                    m.group(1))))
        return out

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The intervals of the window in which no device event ran."""
        gaps, end = [], 0.0
        for _, s, e in sorted(self.events, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.wall_s > end:
            gaps.append((end, self.wall_s))
        return gaps

    def idle_by_phase(self) -> dict:
        """Idle seconds of the window by the phase the host was in (the
        stamp whose interval holds them; the innermost, shortest, where
        stamps nest), "between proves" outside every stamp."""
        spans = sorted(self.stamp_intervals(), key=lambda x: x[1] - x[0])
        out: dict = {}
        for a, b in self.idle_gaps():
            cuts = sorted({a, b} | {t for s, e, _ in spans for t in (s, e)
                                    if a < t < b})
            for lo, hi in zip(cuts, cuts[1:]):
                mid = (lo + hi) / 2
                name = next((p for s, e, p in spans if s <= mid <= e),
                            "between proves")
                out[name] = out.get(name, 0.0) + hi - lo
        return out
