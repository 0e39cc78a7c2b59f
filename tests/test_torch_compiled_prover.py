"""The compiled Lurk pipeline proved by lurk_tpu_torch: the 43-chip
machine of core/eval_compiled.py (copied from lurk_tpu), the port's device
prover on CPU tensors (every chip forced through the device path by
conftest's LURK_TPU_DEVICE_CHIP_MIN_ROWS=0, device witness forced on),
against lurk_tpu's host prover, at FriConfig(1, 8, 2).

golden.LURK_PROGRAM's one-shard proof must be byte-identical to lurk_tpu's
host proof, whose sha256 is the golden that chip_smoke.py holds the card
to; and the port's device witness must equal its host witness for every
compiled chip that lair/device_trace.py supports.

A proof costs tens of CPU-seconds, so this file holds two tests:
pytest-xdist's file scheduler (largest files first) then starts it after
the suite's long files instead of ahead of them.
"""

import functools
import hashlib

import numpy as np
import torch

from lurk_tpu.core.eval_api import evaluate as j_evaluate
from lurk_tpu.core.eval_compiled import build_lurk_toplevel as j_build
from lurk_tpu.core.stark_machine import new_machine as j_new_machine
from lurk_tpu.stark.challenger import Challenger as JChallenger
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu.utils import codec as jcodec
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.lair import device_trace
from lurk_tpu_torch.lair.chips import chip_included
from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
from lurk_tpu_torch.lair.trace import FuncChip
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.utils import codec

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _port_machine():
    machine, q, shown = golden.lurk_machine(golden.LURK_PROGRAM,
                                            FriConfig(1, 8, 2), compiled=True)
    assert shown == golden.LURK_RESULT
    assert len(machine.chips) == 43
    return machine, q


def _lurk_tpu_host_proof() -> bytes:
    tl, zs, _ = j_build()
    _, q = j_evaluate(tl, zs, golden.LURK_PROGRAM)
    machine = j_new_machine(tl, JFriConfig(1, 8, 2))
    pk, _ = machine.setup()
    return jcodec.encode(machine.prove(pk, q, JChallenger(), device=False))


def test_compiled_proof_matches_lurk_tpu(monkeypatch):
    monkeypatch.setenv("LURK_TPU_DEVICE_WITNESS", "1")
    machine, vk, proof, digest = golden.lurk_proof("cpu", None,
                                                   _port_machine())
    stats = machine.last_device_prove
    assert stats["shards"] == 1 and stats["keep_mode"] == "full"
    assert stats["device_witness_chips"] >= 20
    data = codec.encode(proof)
    assert data == _lurk_tpu_host_proof()
    assert digest == hashlib.sha256(data).hexdigest() == \
        golden.COMPILED_LURK_SHA256
    assert machine.verify(vk, codec.decode(data), Challenger())


def test_compiled_device_witness_equals_host_witness():
    """In one shard and in the first 3 shards at max_shard_size 64."""
    machine, q = _port_machine()
    checked = set()
    for size in (None, 64):
        shards = Shard(q, 0, None if size is None
                       else ShardingConfig(size)).shard()[:3]
        for shard in shards:
            for chip in machine.chips:
                if not (isinstance(chip, FuncChip)
                        and chip_included(chip, shard)
                        and device_trace.supported(chip)):
                    continue
                got = device_trace.generate_trace_device(
                    chip, shard, torch.device("cpu"))
                want = np.asarray(chip.generate_trace(shard), np.uint64)
                np.testing.assert_array_equal(
                    bb.to_numpy(got).astype(np.uint64), want,
                    err_msg=f"{chip.name} shard {shard.index} size {size}")
                checked.add(chip.name)
    assert len(checked) >= 20, sorted(checked)
