"""The slice at small size: lurk_tpu_torch's device prover (torch tensors
on the CPU, asked for with device="cpu"; every chip forced through the
device path by conftest's LURK_TPU_DEVICE_CHIP_MIN_ROWS=0) against
lurk_tpu's host prover.

For factorial(5), fib(7) and fib(1000) at FriConfig(1, 8, 2) the encoded
proofs must be byte-identical; the port's verifier must accept its proof
and reject a tampered opening; both packages' setup must give the same VK
roots; and the port's proof, decoded by lurk_tpu's codec, must verify
under lurk_tpu's verifier.

Each proof costs tens of CPU-seconds, so this file holds two tests:
pytest-xdist's file scheduler (largest files first) then starts it after
the suite's long files instead of ahead of them.
"""

import functools

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
from lurk_tpu_torch.field.babybear import P
from lurk_tpu_torch.lair.chips import build_lair_chip_vector
from lurk_tpu_torch.lair.demo import demo_toplevel
from lurk_tpu_torch.lair.execute import QueryRecord, execute_by_name
from lurk_tpu_torch.lair.trace import FuncChip
from lurk_tpu_torch.poseidon.cuda_kernel import permute_mont_cuda
from lurk_tpu_torch.stark import hbm
from lurk_tpu_torch.stark.device_prover import device_prove
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.stark.machine import StarkMachine
from lurk_tpu_torch.utils import codec

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

STATEMENTS = [("factorial", 5), ("fib", 7), ("fib", 1000)]


@functools.lru_cache(maxsize=None)
def _lurk_tpu_host(entry, arg):
    tl = j_demo()
    q = JQueryRecord(tl)
    j_execute(tl, entry, [arg], q)
    machine = JStarkMachine(j_chips(JFuncChip.from_name(entry, tl)),
                            len(q.expect_public_values()),
                            JFriConfig(1, 8, 2))
    pk, vk = machine.setup()
    return machine, vk, machine.prove(pk, q, JChallenger(), device=False)


@functools.lru_cache(maxsize=None)
def _port(entry, arg):
    """(machine, pk, vk, queries); cached, so a statement's machine keeps
    its committed device prep round across tests."""
    tl = demo_toplevel()
    q = QueryRecord(tl)
    execute_by_name(tl, entry, [arg], q)
    machine = StarkMachine(build_lair_chip_vector(FuncChip.from_name(entry,
                                                                     tl)),
                           len(q.expect_public_values()), FriConfig(1, 8, 2))
    pk, vk = machine.setup()
    return machine, pk, vk, q


def test_device_proofs_match_lurk_tpu():
    for entry, arg in STATEMENTS:
        jmachine, jvk, jproof = _lurk_tpu_host(entry, arg)
        machine, pk, vk, q = _port(entry, arg)
        data = codec.encode(device_prove(machine, pk, q, Challenger(),
                                         device="cpu"))
        at = f"{entry}({arg})"

        # byte-identical to lurk_tpu's host proof
        assert data == jcodec.encode(jproof), at
        # setup gives the same verifying key in both packages
        assert [tuple(int(x) for x in r) for r in vk.prep_roots] == \
            [tuple(int(x) for x in r) for r in jvk.prep_roots], at
        assert (vk.prep_chip_names, vk.prep_widths,
                vk.prep_log_heights) == (jvk.prep_chip_names,
                                         jvk.prep_widths,
                                         jvk.prep_log_heights), at
        # the port's verifier accepts the proof, rejects a tampered opening
        assert machine.verify(vk, codec.decode(data), Challenger()), at
        tampered = codec.decode(data)
        opening = \
            tampered.shard_proofs[0].pcs_proof.query_openings[0][1][0][1]
        row = list(opening.rows[0])
        row[0] = (int(row[0]) + 1) % P
        opening.rows[0] = row
        assert not machine.verify(vk, tampered, Challenger()), at
        # decoded by lurk_tpu's codec, it verifies under lurk_tpu's verifier
        assert jmachine.verify(jvk, jcodec.decode(data), JChallenger()), at


def test_keep_light_and_device_fri_folds_bit_exact(monkeypatch):
    """Keep-light (mats + coefficients kept, LDE and trees rebuilt from the
    coefficients) with every FRI layer folded and committed on the device
    (no host tail) gives lurk_tpu's proof bytes."""
    machine, pk, vk, q = _port("factorial", 5)
    monkeypatch.setattr(hbm, "keep_rounds_fits", lambda *a: False)
    monkeypatch.setattr(hbm, "keep_light_fits", lambda *a: True)
    monkeypatch.setenv("LURK_TPU_FRI_HOST_TAIL_LOG", "0")
    proof = device_prove(machine, pk, q, Challenger(), device="cpu")
    _, _, jproof = _lurk_tpu_host("factorial", 5)
    assert codec.encode(proof) == jcodec.encode(jproof)
    assert permute_mont_cuda.launches == 0      # no card: plain version
