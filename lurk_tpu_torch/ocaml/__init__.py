"""OCaml frontend: compile OCaml to Lurk through ocamlc's Lambda IR.

Reference: /root/reference/src/ocaml/ - `ocamlc -dlambda` prints the
compiler's Lambda intermediate representation; a dedicated grammar parses
it (parser.py, port of parser/syntax.rs) and a transform lowers it to
Lurk data (compile.py, port of compile.rs). Wired to the REPL's
`!(load-ocaml)` / `!(load-ocaml-expr)` meta commands.
"""

from .syntax import LambdaSyntax
from .parser import parse_syntax, LambdaParseError
from .compile import (compile_single_file_contents, ocamlc_available,
                      transform_lambda, transform_lambda_program,
                      compile_and_transform_single_file)

__all__ = [
    "LambdaSyntax", "parse_syntax", "LambdaParseError",
    "compile_single_file_contents", "ocamlc_available",
    "transform_lambda", "transform_lambda_program",
    "compile_and_transform_single_file",
]
