"""The plain constraint quotient (stark/quotient_kernel.quotient_plain)
against lurk_tpu's jitted _vm_fn + _pq_fn on JAX's CPU backend, on every
plan chip of golden.LURK_PROGRAM's direct machine that
tests/test_torch_quotient_kernel.py does not run them on, with the same
inputs and helpers (random LDE slices at an odd row stride, holding 0, 1,
p - 1 and values past 2^30). Exact.
"""

import pytest

import test_torch_quotient_kernel as base


@pytest.mark.parametrize("name", base.OTHER_PLAN_CHIPS)
def test_quotient_plain_matches_lurk_tpu_on(name):
    base.test_quotient_plain_matches_lurk_tpu(name)
