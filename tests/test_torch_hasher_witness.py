"""The hasher chips' device witness (lair/device_trace.py's
_hasher_trace_device) on the CPU: the hash4 chip's trace of a small Lurk
sum at 33 rows, just past a power of two, equals FuncChip.generate_trace
cell for cell, and a recorded prove would see it as one `witness.hasher`
span with its rows in the `hasher_rows` counter."""

import numpy as np
import torch

from lurk_tpu_torch.core.eval_api import evaluate
from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
from lurk_tpu_torch.core.stark_machine import new_machine
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.lair import device_trace
from lurk_tpu_torch.lair.execute import Shard
from lurk_tpu_torch.stark import spans
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

# upstream benches/sum.rs's program on an 8-element list: 33 hash4 rows
SUM8 = ("(letrec ((sum (lambda (l) (if l (+ (car l) (sum (cdr l))) 0))))"
        " (sum '(5 1 2 3 4 5 6 7)))")


class _Holder:
    last_device_prove: dict


def test_hasher_trace_device_matches_host_and_is_recorded():
    toplevel, zstore, _ = build_lurk_toplevel()
    result, queries = evaluate(toplevel, zstore, SUM8)
    assert zstore.fmt(result) == "33"
    machine = new_machine(toplevel, FriConfig(1, 8, 2))
    shard = Shard(queries, 0, None).shard()[0]
    chip = next(c for c in machine.chips if c.name == "Func[hash4]")
    rows = chip.num_rows(shard)
    assert rows == 33
    width = device_trace._hasher_width(chip)
    assert width == 32

    holder = _Holder()
    holder.last_device_prove = {}
    spans.enable(True)
    try:
        with spans.prove(holder):
            got = device_trace._hasher_trace_device(chip, shard, width,
                                                    torch.device("cpu"))
    finally:
        spans.enable(None)

    want = np.asarray(chip.generate_trace(shard), np.uint64)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert want.shape == (64, chip.width)
    assert np.array_equal(bb.to_numpy(got).astype(np.uint64), want)

    stats = holder.last_device_prove
    assert stats["counters"]["hasher_rows"] == rows
    by_name = {}
    for r in stats["spans"]:
        by_name.setdefault(r["name"], []).append(r)
    (hasher,) = by_name["witness.hasher"]
    assert hasher["hasher_rows"] == rows
    root = stats["spans"].index(by_name["prove"][0])
    assert hasher["parent"] == root
    # the streams' copies stay upload spans, inside the hasher's
    uploads = by_name["witness.upload"]
    assert uploads and all(stats["spans"][u["parent"]] is hasher
                           for u in uploads)
