"""CLI glue for the OCaml frontend (meta commands `!(load-ocaml)` and
`!(load-ocaml-expr)`; reference: src/core/cli/meta.rs:1439-1467).

The actual frontend - ocamlc driver, Lambda IR grammar, Lurk transform -
lives in lurk_tpu.ocaml (reference: src/ocaml/).
"""

from __future__ import annotations

from pathlib import Path

from ..ocaml import (compile_and_transform_single_file, ocamlc_available,
                     compile_single_file_contents)

__all__ = ["ocamlc_available", "compile_single_file_contents",
           "compile_and_load_file"]


def compile_and_load_file(repl, path: Path, run: bool):
    expr = compile_and_transform_single_file(repl.zstore, repl.state,
                                             Path(path))
    if run:
        return repl.handle_non_meta(expr)
    return expr
