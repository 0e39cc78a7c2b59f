"""The Lurk language in lurk_tpu_torch against lurk_tpu: evaluation, the
toplevel and machine it builds, and the key cache.

Each expression evaluates (native interpreter when cpp/liblair.so loads)
to the same printed result and the same ZStore pointer (tag and Poseidon2
digest) in both packages; build_lurk_toplevel gives the same funcs and
new_machine the same chips; keys that lurk_tpu's setup_cached writes load
in the port. Exact comparisons.
"""

import functools

import pytest
import torch

from lurk_tpu.core.eval_api import evaluate as j_evaluate
from lurk_tpu.core.eval_direct import build_lurk_toplevel as j_build
from lurk_tpu.core.stark_machine import new_machine as j_new_machine
from lurk_tpu.stark import key_cache as j_key_cache
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu_torch.core.eval_api import evaluate
from lurk_tpu_torch.core.eval_direct import build_lurk_toplevel
from lurk_tpu_torch.core.stark_machine import new_machine
from lurk_tpu_torch.stark import golden, key_cache
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

PROGRAMS = [
    golden.LURK_PROGRAM,                                   # (12 . 92)
    '(strcons (car "xyz") (cdr "abc"))',                   # string ops
    "(+ (* 3u64 7u64) (- 100u64 58u64))",                  # u64 arithmetic
    "(let ((c (commit 123))) (cons (open c) (secret c)))",  # commit/open
    "(letrec ((f (lambda (n acc) (if (= n 0) acc (f (- n 1) (* acc n))))))"
    " (f 10 1))",                                          # letrec
    "(car (/ 1 0))",                                       # evaluation error
]


@functools.lru_cache(maxsize=None)
def _toplevels():
    return j_build(), build_lurk_toplevel()


@pytest.mark.parametrize("code", PROGRAMS)
def test_evaluate_matches_lurk_tpu(code):
    (jtl, jzs, _), (tl, zs, _) = _toplevels()
    jres, jq = j_evaluate(jtl, jzs, code)
    res, q = evaluate(tl, zs, code)
    assert zs.fmt(res) == jzs.fmt(jres)
    assert (int(res.tag), tuple(int(x) for x in res.digest)) == \
        (int(jres.tag), tuple(int(x) for x in jres.digest))
    assert q.expect_public_values() == jq.expect_public_values()


def test_toplevel_and_machine_match_lurk_tpu():
    (jtl, _, _), (tl, _, _) = _toplevels()
    assert [f.name for f in tl.funcs] == [f.name for f in jtl.funcs]
    jm = j_new_machine(jtl, JFriConfig(1, 8, 2))
    m = new_machine(tl, FriConfig(1, 8, 2))
    assert len(m.chips) == 47
    assert [(c.name, c.width) for c in m.chips] == \
        [(c.name, c.width) for c in jm.chips]
    assert m.num_public_values == jm.num_public_values


def test_keys_written_by_lurk_tpu_load_in_the_port(tmp_path, monkeypatch):
    """lurk_tpu's setup_cached writes the keys under LURK_DIR; the port's
    setup_cached finds them under the same content key, loads them without
    a setup, and their VK equals a fresh port setup's."""
    monkeypatch.setenv("LURK_DIR", str(tmp_path))
    monkeypatch.delenv("LURK_TPU_KEY_CACHE", raising=False)
    (jtl, _, _), (tl, _, _) = _toplevels()
    jm = j_new_machine(jtl, JFriConfig(1, 8, 2))
    m = new_machine(tl, FriConfig(1, 8, 2))
    j_key_cache.setup_cached(jm)
    assert key_cache.machine_setup_key(m) == \
        j_key_cache.machine_setup_key(jm)
    assert len(list((tmp_path / "keys").iterdir())) == 1
    fresh_pk, fresh_vk = m.setup()

    def no_setup():
        raise AssertionError("the cached keys were not used")

    monkeypatch.setattr(m, "setup", no_setup)
    pk, vk = key_cache.setup_cached(m)
    assert [tuple(r) for r in vk.prep_roots] == \
        [tuple(r) for r in fresh_vk.prep_roots]
    assert (vk.prep_chip_names, vk.prep_widths, vk.prep_log_heights) == \
        (fresh_vk.prep_chip_names, fresh_vk.prep_widths,
         fresh_vk.prep_log_heights)
    assert pk.prep_round.roots == fresh_pk.prep_round.roots
