"""A machine whose interactions are not affine: lurk_tpu_torch's device
prover (torch tensors on the CPU) takes the per-chip DAG paths on its own
and must emit lurk_tpu's host proof byte for byte.

Two toy chips of 16 rows: `Mul[send]` holds (x, y), sends [x*y] with
multiplicity 1 and steps x by one per row from the public value x0;
`Mul[receive]` holds (x, y, z), constrains z = x*y and receives [z] with
multiplicity 1. The sender has no affine plan (logup/affine.py), so its
perm trace is device_perm_trace_dev and its quotient the windowed DAG
path; the receiver keeps the plan and the constraint VM. The windowed
quotient is run with its window above the chips' 32-row LDE and below it
(so rot=1 reads cross windows and wrap around), and LURK_TPU_QUOT=mono
puts both chips on the monolithic path.
"""

import functools

import numpy as np
import pytest
import torch

from lurk_tpu.air import symbolic as j_symbolic
from lurk_tpu.lair.demo import demo_toplevel as j_demo
from lurk_tpu.lair.execute import QueryRecord as JQueryRecord
from lurk_tpu.lair.execute import execute_by_name as j_execute
from lurk_tpu.stark.challenger import Challenger as JChallenger
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu.stark.machine import StarkMachine as JStarkMachine
from lurk_tpu.utils import codec as jcodec
from lurk_tpu_torch.air import symbolic
from lurk_tpu_torch.field.babybear import P
from lurk_tpu_torch.lair.demo import demo_toplevel
from lurk_tpu_torch.lair.execute import QueryRecord, execute_by_name
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.device_prover import device_prove
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.stark.machine import StarkMachine
from lurk_tpu_torch.utils import codec

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

ROWS = 16


class MulChip:
    """A toy chip over `sym` (lurk_tpu's or the port's air.symbolic)."""

    def __init__(self, sym, kind: str, x0: int):
        self.sym = sym
        self.kind = kind
        self.name = f"Mul[{kind}]"
        self.width = 2 if kind == "send" else 3
        xs = np.arange(x0, x0 + ROWS, dtype=np.uint64)
        ys = (np.arange(ROWS, dtype=np.uint64) * 7919 + 13) % P
        cols = [xs, ys] if kind == "send" else [xs, ys, xs * ys % P]
        self.trace = np.stack(cols, axis=1)

    def num_rows(self, shard) -> int:
        return ROWS

    def included(self, shard) -> bool:
        return shard.index == 0

    def generate_preprocessed_trace(self):
        return None

    def generate_trace(self, shard) -> np.ndarray:
        return self.trace.copy()

    def build_air(self):
        b = self.sym.SymbolicBuilder(main_width=self.width,
                                     num_public_values=2)
        x, y = b.local(0), b.local(1)
        if self.kind == "send":
            with b.when_first_row():
                b.assert_eq(x, b.public_value(0))
            with b.when_transition():
                b.assert_eq(b.next(0), x + 1)
            b.send([x * y], 1)
        else:
            b.assert_eq(b.local(2), x * y)
            b.receive([b.local(2)], 1)
        return b


def _queries(demo, record, execute):
    tl = demo()
    q = record(tl)
    execute(tl, "factorial", [3], q)
    return q


@functools.lru_cache(maxsize=None)
def _lurk_tpu_host_proof() -> bytes:
    q = _queries(j_demo, JQueryRecord, j_execute)
    x0 = q.expect_public_values()[0]
    chips = [MulChip(j_symbolic, k, x0) for k in ("send", "receive")]
    machine = JStarkMachine(chips, 2, JFriConfig(1, 8, 2))
    pk, _ = machine.setup()
    return jcodec.encode(machine.prove(pk, q, JChallenger(), device=False))


@pytest.mark.parametrize("quot,window", [("vm", dp._QUOT_WIN), ("vm", 8),
                                         ("mono", dp._QUOT_WIN)])
def test_non_affine_machine_matches_lurk_tpu(monkeypatch, quot, window):
    monkeypatch.setenv("LURK_TPU_QUOT", quot)
    monkeypatch.setattr(dp, "_QUOT_WIN", window)
    q = _queries(demo_toplevel, QueryRecord, execute_by_name)
    x0 = q.expect_public_values()[0]
    chips = [MulChip(symbolic, k, x0) for k in ("send", "receive")]
    machine = StarkMachine(chips, 2, FriConfig(1, 8, 2))
    send, receive = (machine.builder_for(c) for c in chips)
    assert dp.plan_for(send) is None and dp.plan_for(receive) is not None
    calls = []
    for name in ("device_perm_trace_dev", "device_quotient_chunk_windowed",
                 "_device_quotient_chunk_mono"):
        fn = getattr(dp, name)
        monkeypatch.setattr(dp, name, lambda *a, _n=name, _f=fn:
                            calls.append(_n) or _f(*a))
    pk, vk = machine.setup()
    proof = device_prove(machine, pk, q, Challenger(), device="cpu")
    want = {"vm": ["device_perm_trace_dev", "device_quotient_chunk_windowed"],
            "mono": ["device_perm_trace_dev", "_device_quotient_chunk_mono",
                     "_device_quotient_chunk_mono"]}[quot]
    assert calls == want
    data = codec.encode(proof)
    assert data == _lurk_tpu_host_proof()
    assert machine.verify(vk, codec.decode(data), Challenger())


def test_dag_perm_trace_matches_lurk_tpu_host_trace():
    """device_perm_trace (the DAG perm trace, cumulative sum on the host)
    equals lurk_tpu's build_permutation_trace for the non-affine sender, and
    gives the lone all-zero running-sum column to a chip without
    interactions."""
    from lurk_tpu.logup.trace import build_permutation_trace
    r, gamma = (1, 2, 3, 4), (5, 6, 7, 8)
    send = MulChip(symbolic, "send", 3)
    silent = symbolic.SymbolicBuilder(main_width=2)
    silent.assert_zero(silent.local(0))
    j_silent = j_symbolic.SymbolicBuilder(main_width=2)
    j_silent.assert_zero(j_silent.local(0))
    for builder, j_builder in ((send.build_air(),
                               MulChip(j_symbolic, "send", 3).build_air()),
                              (silent, j_silent)):
        want, want_cum = build_permutation_trace(j_builder, send.trace, None,
                                                 [3, 6], r, gamma)
        got, cum = dp.device_perm_trace(
            builder, torch.from_numpy(send.trace.astype(np.int32)), None,
            [3, 6], r, gamma)
        np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
        assert cum == want_cum
    assert want_cum == (0, 0, 0, 0)
