"""The compiled Lurk pipeline in lurk_tpu_torch (core/compile.py,
core/eval_compiled.py, copied from lurk_tpu) against lurk_tpu's: every
program of tests/test_eval_compiled.py evaluates to the same printed
result in the same number of iterations, and lurk_tpu_torch's key cache
serves the compiled machine (43 chips) and the direct one (47) from one
LURK_DIR."""

import copy
import functools

import pytest
import torch

from lurk_tpu.core import eval_api as j_eval_api
from lurk_tpu.core import eval_compiled as j_eval_compiled
from lurk_tpu_torch.core import eval_api, eval_compiled
from tests.test_eval_compiled import CASES

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _toplevels():
    return (j_eval_compiled.build_lurk_toplevel(),
            eval_compiled.build_lurk_toplevel())


def _run(api, toplevel_zstore, src):
    tl, zstore, _ = toplevel_zstore
    zs = copy.deepcopy(zstore)
    res, q = api.evaluate(tl, zs, src, use_native=False)
    return zs.fmt(res), api.num_iterations(tl, q)


@pytest.mark.parametrize("src,want", CASES)
def test_compiled_eval_matches_lurk_tpu(src, want):
    theirs, mine = _toplevels()
    got = _run(eval_api, mine, src)
    assert got == _run(j_eval_api, theirs, src)
    if want is not None:
        assert got[0] == want


def test_compiled_and_direct_machines_share_one_lurk_dir(monkeypatch,
                                                        tmp_path):
    """setup_cached keys on what setup's output depends on (the config,
    the public-value count, every preprocessed chip's name and matrix).
    The two machines differ only in chips without a preprocessed trace, so
    in one LURK_DIR they share one entry, and each gets the keys of its
    own uncached setup() from it."""
    from lurk_tpu_torch.core import eval_direct
    from lurk_tpu_torch.core.stark_machine import new_machine
    from lurk_tpu_torch.stark import key_cache
    from lurk_tpu_torch.stark.fri import FriConfig
    monkeypatch.setenv("LURK_DIR", str(tmp_path))
    machines = [new_machine(pipeline.build_lurk_toplevel()[0],
                            FriConfig(1, 8, 2))
                for pipeline in (eval_compiled, eval_direct)]
    assert [len(m.chips) for m in machines] == [43, 47]
    for m in machines:
        _, vk = m.setup()
        for _ in range(2):                  # written, then read back
            _, cached = key_cache.setup_cached(m)
            assert cached == vk
    assert len([p for p in tmp_path.rglob("*") if p.is_file()]) == 1
