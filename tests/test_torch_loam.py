"""lurk_tpu_torch's copies of loam/ (the Datalog evaluator) and
poseidon/narrow.py (the one-row-per-round Poseidon2 chip) against
lurk_tpu's on the same inputs: the same evaluation outputs and
distillation summary, the same narrow traces and AIR."""

import numpy as np
import pytest
import torch

from lurk_tpu import loam as j_loam
from lurk_tpu.core.zstore import lurk_zstore as j_lurk_zstore
from lurk_tpu.poseidon import narrow as j_narrow
from lurk_tpu_torch import loam
from lurk_tpu_torch.core.zstore import lurk_zstore
from lurk_tpu_torch.field.babybear import P
from lurk_tpu_torch.poseidon import narrow
from tests.test_loam import _fibonacci

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

PROGRAMS = [
    ("(+ 1n 2n)", "3n"),
    ("(let ((x 9n)(y 10n)) y)", "10n"),
    ("(letrec ((y 9n) (x (+ 1n 1n))) x)", "2n"),
    ("(car (cons 1n 2n))", "1n"),
    ("(eq (cons 1n 2n) (quote (1n . 2n)))", "t"),
    ("((lambda (x y) (+ x y)) 3n 4n)", "7n"),
    (_fibonacci(5), "8n"),
]


def _evaluate(pkg, zstore_fn, src):
    zstore = zstore_fn()
    inp = pkg.WidePtr.from_zptr(zstore.read(src))
    prog = pkg.EvaluationProgram(zstore)
    prog.set_toplevel_input(inp, None)
    prog.run()
    return prog, zstore


@pytest.mark.parametrize("src,out", PROGRAMS)
def test_loam_evaluation_matches_lurk_tpu(src, out):
    prog, zstore = _evaluate(loam, lurk_zstore, src)
    j_prog, _ = _evaluate(j_loam, j_lurk_zstore, src)
    assert prog.output_exprs == j_prog.output_exprs == \
        [loam.WidePtr.from_zptr(zstore.read(out))]


def test_loam_distillation_and_allocation_match_lurk_tpu():
    def summary(pkg, zstore_fn):
        prog, _ = _evaluate(pkg, zstore_fn, "(let ((a (cons 1n 2n)) "
                            "(b (cons 1n 2n))) (eq a b))")
        vm = prog.export_memory()
        s = pkg.DistillationSummary(0.9)
        vm.report_sizes(s)
        vm.distill(pkg.DistillationOptions()).report_sizes(s)
        return s.lines()

    lines = summary(loam, lurk_zstore)
    assert lines[0].startswith("Distillation summary")
    assert lines == summary(j_loam, j_lurk_zstore)

    def map_double(pkg, zstore_fn):
        zstore = zstore_fn()
        inp, want = (pkg.WidePtr.from_zptr(zstore.read(src)) for src in
                     ("((1n . 2n) . (2n . 4n))", "((2n . 4n) . (4n . 8n))"))
        prog = pkg.AllocationProgram(zstore)
        prog.set_input(inp)
        prog.run()
        return prog.output_exprs, want

    got, want = map_double(loam, lurk_zstore)
    assert got == [want]
    assert got == map_double(j_loam, j_lurk_zstore)[0]


@pytest.mark.parametrize("width", [16, 24])
def test_narrow_chip_matches_lurk_tpu(width):
    inputs = np.random.default_rng(width).integers(
        0, P, size=(3, width), dtype=np.uint64)
    trace = narrow.generate_trace(width, inputs)
    np.testing.assert_array_equal(trace,
                                  j_narrow.generate_trace(width, inputs))
    mine, theirs = narrow.build_air(width), j_narrow.build_air(width)
    assert trace.shape[1] == mine.main_width
    assert trace.shape[0] >= 3 * (narrow.rounds(width) + 1)
    assert (mine.main_width, len(mine.constraints)) == \
        (theirs.main_width, len(theirs.constraints))
    assert repr(mine.constraints) == repr(theirs.constraints)
