"""lurk_tpu_torch on a CUDA card: the Poseidon2 kernel against its plain
PyTorch version, the hasher's device path against the host path, the
golden proof, and a default-config prove in a process capped to the
memory the planner's model asks for. Every test skips without a card.

This file imports no jax (the card's machine has none), so it runs there
without tests/conftest.py:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs come from numpy seeds. Tolerances are exact.
"""

import numpy as np
import pytest
import torch

from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.poseidon import perm, ref
from lurk_tpu_torch.poseidon.cuda_kernel import WIDTHS, permute_mont_cuda
from lurk_tpu_torch.stark import golden, hasher

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("width", WIDTHS)
def test_kernel_matches_plain_and_oracle(cuda, width):
    rng = np.random.default_rng(width)
    for batch in (1 << 12, (1 << 12) + 3, 1):
        st = torch.from_numpy(rng.integers(0, bb.P, (width, batch))
                              .astype(np.int32)).to(cuda)
        for n_chain in (1, 2):
            before = permute_mont_cuda.launches
            got = permute_mont_cuda(st, n_chain)
            assert permute_mont_cuda.launches == before + 1
            want = st
            for _ in range(n_chain):
                want = perm.permute_mont(want)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
        col = bb.from_mont(st[:, :1]).cpu().numpy()[:, 0]
        out = bb.from_mont(permute_mont_cuda(st)[:, :1]).cpu().numpy()[:, 0]
        assert [int(x) for x in out] == ref.permute_s([int(x) for x in col])


def test_kernel_rejects_non_contiguous(cuda):
    st = torch.zeros((8, 16), dtype=torch.int32, device=cuda).T
    with pytest.raises(ValueError):
        permute_mont_cuda(st)


@pytest.mark.parametrize("w", [0, 13, 18])
def test_hasher_on_card_matches_host(cuda, w):
    rng = np.random.default_rng(w)
    mat = rng.integers(0, bb.P, (1000, w), dtype=np.uint64)
    got = hasher.hash_rows(torch.from_numpy(mat.astype(np.int32)).to(cuda))
    np.testing.assert_array_equal(bb.to_numpy(got), hasher._hash_rows_np(mat))
    left, right = mat[:, :8], mat[::-1, :8]
    if w >= 8:
        got = hasher.compress_pairs(
            torch.from_numpy(left.astype(np.int32)).to(cuda),
            torch.from_numpy(np.ascontiguousarray(right).astype(np.int32))
            .to(cuda))
        np.testing.assert_array_equal(bb.to_numpy(got),
                                      hasher._compress_pairs_np(left, right))


def test_golden_proof_on_card(cuda):
    from lurk_tpu_torch.stark.challenger import Challenger
    before = permute_mont_cuda.launches
    machine, vk, proof, digest = golden.fib_proof(cuda)
    assert permute_mont_cuda.launches > before
    assert digest == golden.GOLDEN_FIB1000_SHA256
    assert machine.verify(vk, proof, Challenger())


def test_capped_default_config_prove_stays_inside_the_model(cuda):
    """Demo fib 2^20 at the default config in a process capped by
    set_per_process_memory_fraction at a limit whose budget the modeled
    prove fills to 0.9: no OOM, the proof verifies, and the reserved peak
    stays under the model."""
    from lurk_tpu_torch.stark import hbm
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    cuda = torch.device("cuda", torch.cuda.current_device())
    machine, q = golden.fib_machine((1 << 20) - 8, FriConfig())
    pk, vk = machine.setup()
    shards, _ = hbm.plan_shards(machine, q, device=cuda)
    modeled = hbm.modeled_prove_bytes(machine, shards, "full")
    limit = hbm.limit_for_budget(int(modeled / 0.9))
    total = torch.cuda.mem_get_info(cuda)[1]
    torch.cuda.empty_cache()
    torch.cuda.set_per_process_memory_fraction(limit / total, cuda)
    try:
        proof = machine.prove(pk, q, Challenger(), device=True)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, cuda)
    stats = machine.last_device_prove
    assert (stats["shards"], stats["keep_mode"]) == (1, "full")
    assert stats["modeled_prove_bytes"] >= 0.8 * stats["budget_bytes"]
    assert stats["peak_reserved_bytes"] <= stats["modeled_prove_bytes"]
    assert machine.verify(vk, proof, Challenger())
