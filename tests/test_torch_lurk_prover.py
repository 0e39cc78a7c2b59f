"""Lurk proofs on the full Lurk machine (47 chips): lurk_tpu_torch's device
prover (torch tensors on the CPU, every chip forced through the device
path by conftest's LURK_TPU_DEVICE_CHIP_MIN_ROWS=0, device witness forced
on) against lurk_tpu's host prover, at FriConfig(1, 8, 2).

The program is golden.LURK_PROGRAM. Its one-shard proof and its two-shard
proof (ShardingConfig(max_shard_size=128), keep mode `none`: every shard
recommitted from its witness) must be byte-identical to lurk_tpu's host
proofs, whose sha256 are the goldens that chip_smoke.py holds the card to.

Each proof costs tens of CPU-seconds, so this file holds two tests:
pytest-xdist's file scheduler (largest files first) then starts it after
the suite's long files instead of ahead of them.
"""

import functools
import hashlib

import torch

from lurk_tpu.core.eval_api import evaluate as j_evaluate
from lurk_tpu.core.eval_direct import build_lurk_toplevel as j_build
from lurk_tpu.core.stark_machine import new_machine as j_new_machine
from lurk_tpu.lair.execute import ShardingConfig as JShardingConfig
from lurk_tpu.stark.challenger import Challenger as JChallenger
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu.utils import codec as jcodec
from lurk_tpu_torch.lair.execute import Shard
from lurk_tpu_torch.stark import golden, hbm, spans
from lurk_tpu_torch.stark.challenger import Challenger
from lurk_tpu_torch.stark.fri import FriConfig
from lurk_tpu_torch.utils import codec
from tests.test_torch_spans import check_nesting, tally_copies

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _lurk_tpu_machine():
    tl, zs, _ = j_build()
    _, q = j_evaluate(tl, zs, golden.LURK_PROGRAM)
    machine = j_new_machine(tl, JFriConfig(1, 8, 2))
    pk, _ = machine.setup()
    return machine, pk, q


def _lurk_tpu_host_proof(shard_size=None) -> bytes:
    machine, pk, q = _lurk_tpu_machine()
    cfg = None if shard_size is None else JShardingConfig(shard_size)
    return jcodec.encode(machine.prove(pk, q, JChallenger(), shard_config=cfg,
                                       device=False))


@functools.lru_cache(maxsize=None)
def _port_machine():
    machine, q, shown = golden.lurk_machine(golden.LURK_PROGRAM,
                                            FriConfig(1, 8, 2))
    assert shown == golden.LURK_RESULT
    return machine, q


def test_one_shard_device_witness_proof_matches_lurk_tpu(monkeypatch):
    """Proved with the recorder on (stark/spans.py): the bytes are the
    golden's, the spans nest and cover the prove, the copy counters equal
    the bytes the copy helpers moved, and `hasher_rows` counts the hasher
    chips' rows."""
    monkeypatch.setenv("LURK_TPU_DEVICE_WITNESS", "1")
    moved = tally_copies(monkeypatch)
    spans.enable(True)
    try:
        machine, vk, proof, digest = golden.lurk_proof("cpu", None,
                                                       _port_machine())
    finally:
        spans.enable(None)
    stats = machine.last_device_prove
    assert stats["shards"] == 1 and stats["keep_mode"] == "full"
    assert stats["device_witness_chips"] >= 16
    shard = Shard(_port_machine()[1], 0, None).shard()[0]
    hashers = sum(c.num_rows(shard) for c in machine.chips
                  if c.name in ("Func[hash3]", "Func[hash4]", "Func[hash5]"))
    counters = dict(stats["counters"])
    assert counters.pop("hasher_rows") == hashers > 0
    assert counters == moved
    rows = stats["spans"]
    check_nesting(rows)
    names = {r["name"] for r in rows}
    assert {"witness.host", "witness.device", "witness.upload",
            "witness.hasher"} <= names
    # the witness phase is its leaves
    (phase,) = [r for r in rows if r["name"] == "witness+upload"]
    assert phase["exclusive_s"] <= 0.05 * (phase["end_ns"] -
                                           phase["start_ns"]) / 1e9
    data = codec.encode(proof)
    assert data == _lurk_tpu_host_proof()
    assert digest == hashlib.sha256(data).hexdigest() == \
        golden.GOLDEN_LURK_SHA256
    assert machine.verify(vk, codec.decode(data), Challenger())


def test_two_shards_keep_none_proof_matches_lurk_tpu(monkeypatch):
    """Keep mode `none`: pass 2 recommits every shard from its witness,
    regenerating the device-made traces."""
    monkeypatch.setenv("LURK_TPU_DEVICE_WITNESS", "1")
    monkeypatch.setattr(hbm, "keep_rounds_fits", lambda *a: False)
    monkeypatch.setattr(hbm, "keep_light_fits", lambda *a: False)
    machine, _, proof, digest = golden.lurk_proof(
        "cpu", golden.LURK_2SHARD_SIZE, _port_machine())
    stats = machine.last_device_prove
    assert stats["shards"] == 2 and stats["keep_mode"] == "none"
    assert stats["device_witness_chips"] > 0
    assert codec.encode(proof) == \
        _lurk_tpu_host_proof(golden.LURK_2SHARD_SIZE)
    assert digest == golden.GOLDEN_LURK_2SHARD_SHA256
