"""lurk_tpu_torch's device prover on its per-chip DAG paths, forced by
lurk_tpu's env vars, on demo factorial(6) at FriConfig(1, 8, 2) (as
tests/test_device_prover.py forces lurk_tpu's): torch tensors on the CPU,
every chip on the device path (conftest's
LURK_TPU_DEVICE_CHIP_MIN_ROWS=0). Each proof must be byte-identical to
lurk_tpu's host proof and verify.

- LURK_TPU_GENERIC_PERM=0 with LURK_TPU_QUOT=window: every perm trace from
  the interaction DAG (device_perm_trace_dev) and every quotient from the
  windowed DAG path; the 2^17-row LDE of the bytes chip spans four
  windows, the other chips' LDEs lie inside one;
- LURK_TPU_QUOT=mono: every quotient from the monolithic DAG path.

Each proof costs about 20 CPU-seconds (mostly the bytes chip's commits),
so this file holds two tests: pytest-xdist's file scheduler (largest files
first) then starts it after the suite's long files.
"""

import functools

import pytest
import torch

from lurk_tpu.lair.chips import build_lair_chip_vector as j_chips
from lurk_tpu.lair.demo import demo_toplevel as j_demo
from lurk_tpu.lair.execute import QueryRecord as JQueryRecord
from lurk_tpu.lair.execute import execute_by_name as j_execute
from lurk_tpu.lair.trace import FuncChip as JFuncChip
from lurk_tpu.stark.challenger import Challenger as JChallenger
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu.stark.machine import StarkMachine as JStarkMachine
from lurk_tpu.utils import codec as jcodec
from lurk_tpu_torch.lair.chips import build_lair_chip_vector
from lurk_tpu_torch.lair.demo import demo_toplevel
from lurk_tpu_torch.lair.execute import QueryRecord, execute_by_name
from lurk_tpu_torch.lair.trace import FuncChip
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.device_prover import device_prove
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.stark.machine import StarkMachine
from lurk_tpu_torch.utils import codec

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

FORCED = {
    "dag_perm_window": ({"LURK_TPU_GENERIC_PERM": "0",
                         "LURK_TPU_QUOT": "window"},
                        {"device_perm_trace_dev",
                         "device_quotient_chunk_windowed"}),
    "mono": ({"LURK_TPU_QUOT": "mono"},
             {"device_perm_trace_plan", "_device_quotient_chunk_mono"}),
}
SPIED = ("device_perm_trace_plan", "device_perm_trace_dev",
         "device_quotient_chunk_vm", "device_quotient_chunk_windowed",
         "_device_quotient_chunk_mono")


@functools.lru_cache(maxsize=None)
def _lurk_tpu_host_proof() -> bytes:
    tl = j_demo()
    q = JQueryRecord(tl)
    j_execute(tl, "factorial", [6], q)
    machine = JStarkMachine(j_chips(JFuncChip.from_name("factorial", tl)),
                            len(q.expect_public_values()),
                            JFriConfig(1, 8, 2))
    pk, _ = machine.setup()
    return jcodec.encode(machine.prove(pk, q, JChallenger(), device=False))


@functools.lru_cache(maxsize=None)
def _port():
    """(machine, pk, vk, queries); cached, so the second case reuses the
    machine's committed device prep round."""
    tl = demo_toplevel()
    q = QueryRecord(tl)
    execute_by_name(tl, "factorial", [6], q)
    machine = StarkMachine(build_lair_chip_vector(
        FuncChip.from_name("factorial", tl)), len(q.expect_public_values()),
        FriConfig(1, 8, 2))
    return (machine,) + machine.setup() + (q,)


@pytest.mark.parametrize("case", sorted(FORCED))
def test_forced_dag_path_matches_lurk_tpu(monkeypatch, case):
    env, want_paths = FORCED[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    machine, pk, vk, q = _port()
    paths = set()
    for name in SPIED:
        fn = getattr(dp, name)
        monkeypatch.setattr(dp, name, lambda *a, _n=name, _f=fn:
                            paths.add(_n) or _f(*a))
    data = codec.encode(device_prove(machine, pk, q, Challenger(),
                                     device="cpu"))
    assert paths == want_paths
    assert data == _lurk_tpu_host_proof()
    assert machine.verify(vk, codec.decode(data), Challenger())
