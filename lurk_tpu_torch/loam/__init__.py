"""Loam: a relational (Datalog) Lurk evaluator.

Rebuild of the reference's feature-gated research layer
(/root/reference/src/loam/ + loam-macros/): Lurk evaluation expressed as
a monotone rule program over content-addressed relations, plus memory
distillation that dedupes the virtual allocations of a first pass and a
second-pass program that re-evaluates against the distilled memory.

The ascent/`loam!` macro machinery of the reference is replaced by the
plain-Python engine in `engine.py`; hashing side effects are batched
per fixpoint round through the native Poseidon2 kernel.
"""

from .allocation import Allocator
from .engine import Program, Relation, LatticeRelation
from .evaluation import DistilledEvaluationProgram, EvaluationProgram
from .map_double import AllocationProgram
from .memory import (DistillationOptions, DistillationSummary, Memory,
                     Store, VirtualMemory, VPtr, PPtr,
                     generate_lisp_program)
from .types import Ptr, PtrEq, WidePtr, Wide, widen, lurk_sym_index

__all__ = [
    "Allocator", "AllocationProgram", "DistillationOptions",
    "DistillationSummary", "DistilledEvaluationProgram",
    "EvaluationProgram", "LatticeRelation", "Memory", "PPtr", "Program",
    "Ptr", "PtrEq", "Relation", "Store", "VPtr", "VirtualMemory", "Wide",
    "WidePtr", "generate_lisp_program", "lurk_sym_index", "widen",
]
