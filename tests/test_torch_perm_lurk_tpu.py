"""The plain LogUp perm trace (stark/device_prover.device_perm_trace_plan on
CPU tensors) against lurk_tpu's jitted _generic_perm_fn on JAX's CPU
backend, on every plan chip of golden.LURK_PROGRAM's direct machine that
tests/test_torch_quotient_kernel.py does not run it on, with the same
inputs and helpers. Exact.
"""

import pytest

import test_torch_quotient_kernel as base


@pytest.mark.parametrize("name", base.OTHER_PLAN_CHIPS)
def test_perm_plain_matches_lurk_tpu_on(name):
    base.test_perm_plain_matches_lurk_tpu(name)
