"""The plain reference against the program on the CPU: Poseidon2, the
configurations' results, the AIR exported as data, and the plain verifier
on a small Lurk proof, whole and with one constraint changed."""

import copy
import gzip
import json
import random
from pathlib import Path

import pytest
import torch

from prove_bench.reference import poseidon2, verifier as V
from prove_bench.run import load_cell

BENCH = Path(__file__).resolve().parents[1]
AIR = BENCH / "configs" / "air_direct.json.gz"


@pytest.mark.parametrize("width", [16, 32])
def test_poseidon2(width):
    from lurk_tpu_torch.poseidon.ref import permute_s
    rng = random.Random(width)
    states = [[rng.randrange(2013265921) for _ in range(width)]
              for _ in range(3)]
    got = poseidon2.permute(torch.tensor(states)).tolist()
    assert got == [permute_s(s) for s in states]
    assert [poseidon2.permute_ints(s) for s in states] == got


def test_lcs_reference_is_upstreams():
    _, config, ref = load_cell("lcs.whole_card")
    a, b = config["inputs"]["a"], config["inputs"]["b"]
    assert ref.lcs(a, b) == \
        "here mst beome nay o e eoe to the ti s  h connct et nor"
    from lurk_tpu_torch.core.zstore import ZStore
    z = ZStore().intern_string("here mst")
    assert ref.result({"a": "here mst", "b": "here mst"}) == \
        (z.tag, tuple(z.digest))


@pytest.mark.parametrize("cell,inputs", [
    ("fib100k.shard262144", {"n": 95}),
    ("lcs.whole_card", {"a": "abcbdab", "b": "bdcaba"})])
def test_result_reference_matches_evaluation(cell, inputs):
    from lurk_tpu_torch.core.eval_api import evaluate
    from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
    from prove_bench.inputs import program
    _, config, ref = load_cell(cell)
    toplevel, zstore, _ = build_lurk_toplevel()
    result, queries = evaluate(toplevel, zstore, program(config, inputs))
    pv = queries.expect_public_values()
    assert (result.tag, tuple(result.digest)) == ref.result(inputs)
    assert (pv[24], tuple(pv[32:40])) == ref.result(inputs)


def test_air_is_the_ports():
    from prove_bench.tools.export_air import export
    with gzip.open(AIR, "rt") as f:
        data = json.load(f)
    port = export("direct", package="lurk_tpu_torch")
    assert data["num_public_values"] == port["num_public_values"]
    assert data["chips"] == port["chips"]


@pytest.fixture(scope="module")
def lurk_proof():
    """A small Lurk proof of the port and the plain verifier's key, built
    from the exported data as a run builds it; the port's own key beside
    them."""
    from lurk_tpu_torch.stark import golden
    from prove_bench.run import _key
    _, vk, proof, _ = golden.lurk_proof("cpu")
    return proof, _key({"toplevel": "direct"}, BENCH), vk


def test_vk_is_the_ports(lurk_proof):
    from prove_bench.run import vk_mismatch
    _, key, vk = lurk_proof
    assert vk_mismatch(vk, key) == 0
    assert key.prep_chip_names == ["Bytes"]


def test_plain_verifier_accepts(lurk_proof):
    proof, key, _ = lurk_proof
    assert V.verify(proof, key, V.Fri(1, 8, 2)) == []


def test_plain_verifier_checks_each_constraint(lurk_proof):
    """A chip whose first constraint is off by one fails at zeta."""
    proof, key, _ = lurk_proof
    name = proof.shard_proofs[0].chip_proofs[1].name
    air = copy.deepcopy(key.air)
    chip = air[name]
    chip["nodes"] += [["c", 1], ["+", chip["constraints"][0],
                                 len(chip["nodes"])]]
    chip["constraints"][0] = len(chip["nodes"]) - 1
    bad = copy.copy(key)
    bad.air = air
    assert V.verify(proof, bad, V.Fri(1, 8, 2)) == [
        f"shard 0 chip {name}: the constraints at zeta do not match the "
        "quotient"]
