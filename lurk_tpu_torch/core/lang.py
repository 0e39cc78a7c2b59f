"""User extension API: coroutines + gadgets (reference: src/core/lang.rs)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from .symbol import Symbol


@dataclass
class Coroutine:
    """A Lair function callable from Lurk by symbol.

    lurk_arity: number of (tag, ptr) Lurk arguments; uses_env: whether the
    evaluation environment is appended to the call; func_expr: the FuncE
    (input size must be 2*lurk_arity + uses_env, output size 2).
    """
    lurk_arity: int
    uses_env: bool
    func_expr: object

    def __post_init__(self):
        assert self.func_expr.output_size == 2, \
            f"Output size of {self.func_expr.name} is not 2"
        from ..lair.expr import total_size
        input_size = total_size(self.func_expr.input_params)
        assert input_size == 2 * self.lurk_arity + int(self.uses_env), \
            f"Input size mismatch for {self.func_expr.name}"


@dataclass
class Lang:
    """Coroutines indexed by the Lurk symbol that triggers them, plus extra
    extern gadgets merged into the chip map."""
    coroutines: Dict[Symbol, Coroutine] = field(default_factory=dict)
    gadgets: Dict[str, object] = field(default_factory=dict)

    @staticmethod
    def empty() -> "Lang":
        return Lang()
