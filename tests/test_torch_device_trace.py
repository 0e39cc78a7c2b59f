"""Device witness generation in lurk_tpu_torch against lurk_tpu's host
trace generation.

lurk_tpu_torch.lair.device_trace on CPU tensors must reproduce lurk_tpu's
FuncChip.generate_trace cell for cell for every chip it supports, and the
torch Poseidon2 witness (poseidon/witness.py::populate_batch_device) must
equal lurk_tpu's numpy populate_batch. Exact comparisons; inputs from the
Lurk program golden.LURK_PROGRAM and from numpy seeds.
"""

import functools

import numpy as np
import pytest
import torch

from lurk_tpu.core.eval_api import evaluate as j_evaluate
from lurk_tpu.core.eval_direct import build_lurk_toplevel as j_build
from lurk_tpu.lair.chips import build_lair_chip_vector as j_chips
from lurk_tpu.lair.execute import Shard as JShard
from lurk_tpu.lair.execute import ShardingConfig as JShardingConfig
from lurk_tpu.lair.trace import FuncChip as JFuncChip
from lurk_tpu.poseidon import witness as j_witness
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.lair import device_trace
from lurk_tpu_torch.lair.chips import chip_included
from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
from lurk_tpu_torch.lair.trace import FuncChip
from lurk_tpu_torch.poseidon import witness
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _evaluated():
    jtl, jzs, _ = j_build()
    _, jq = j_evaluate(jtl, jzs, golden.LURK_PROGRAM)
    j_by_name = {c.name: c
                 for c in j_chips(JFuncChip.from_name("lurk_main", jtl))}
    machine, q, shown = golden.lurk_machine(golden.LURK_PROGRAM,
                                            FriConfig(1, 8, 2))
    assert shown == golden.LURK_RESULT
    return jq, j_by_name, machine.chips, q


@pytest.mark.parametrize("shard_size", [None, 64])
def test_device_trace_matches_lurk_tpu_host_trace(shard_size):
    jq, j_by_name, chips, q = _evaluated()
    cfg = None if shard_size is None else ShardingConfig(shard_size)
    jcfg = None if shard_size is None else JShardingConfig(shard_size)
    shards = Shard(q, 0, cfg).shard()
    jshards = JShard(jq, 0, jcfg).shard()
    assert len(shards) == len(jshards) and (shard_size is None) == \
        (len(shards) == 1)
    names = set()
    for shard, jshard in list(zip(shards, jshards))[:3]:
        for chip in chips:
            if not (isinstance(chip, FuncChip) and chip_included(chip, shard)
                    and device_trace.supported(chip)):
                continue
            got = device_trace.generate_trace_device(chip, shard, "cpu")
            assert got.dtype == torch.int32
            want = np.asarray(j_by_name[chip.name].generate_trace(jshard),
                              np.uint64)
            got = bb.to_numpy(got).astype(np.uint64)
            assert got.shape == want.shape, (chip.name, shard.index)
            bad = np.argwhere(got != want)
            assert not len(bad), (chip.name, shard.index, bad[:3])
            names.add(chip.func.name)
    for want in ("eval", "eval_builtin_expr", "apply", "eval_binop_num",
                 "env_lookup", "hash4"):
        assert want in names


@pytest.mark.parametrize("width", [24, 32, 40])
def test_populate_batch_device_matches_lurk_tpu(width):
    rng = np.random.default_rng(width)
    x = rng.integers(0, bb.P, (300, width), dtype=np.uint64)
    x[0, :] = bb.P - 1
    x[1, :] = 0
    j_wit, j_res = j_witness.populate_batch(width, x)
    wit, res = witness.populate_batch_device(
        width, torch.from_numpy(x.astype(np.int64)).to(torch.int32))
    assert wit.shape == (300, 8 + witness.num_cols(width))
    np.testing.assert_array_equal(bb.to_numpy(wit), j_wit)
    np.testing.assert_array_equal(bb.to_numpy(res), j_res)
