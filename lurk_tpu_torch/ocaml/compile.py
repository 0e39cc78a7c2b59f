"""Lambda IR -> Lurk transform + ocamlc driver.

Reference: /root/reference/src/ocaml/compile.rs. `ocamlc -dlambda
-dno-unique-ids -warn-error +a -c` prints the Lambda IR on stderr; the
transform lowers each IR node to Lurk data interned in the ZStore, and
the program wrapper adds a `!=` helper binding (the one Lambda primitive
with no direct Lurk builtin that the transform emits by name).
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path

from ..core.state import BUILTIN_SYMBOLS
from ..core.symbol import builtin_sym, user_sym, Symbol
from .parser import parse_syntax
from .syntax import LambdaSyntax


def ocamlc_available() -> bool:
    return shutil.which("ocamlc") is not None


def compile_single_file_contents(source: str, file_name: str) -> str:
    """Run ocamlc on `source`, return the Lambda IR (stderr). The flags
    turn warnings into errors so stderr is pure IR (compile.rs:52-85)."""
    if not ocamlc_available():
        raise RuntimeError(
            "`ocamlc` not found - the OCaml frontend requires an OCaml "
            "installation (same external requirement as the reference)")
    if "." not in file_name:
        raise RuntimeError(f"Filenames must end in .ml: {file_name}")
    with tempfile.TemporaryDirectory() as tmp:
        tmp_path = Path(tmp) / file_name
        tmp_path.write_text(source)
        res = subprocess.run(
            ["ocamlc", "-dlambda", "-dno-unique-ids", "-warn-error", "+a",
             "-c", str(tmp_path)],
            capture_output=True, text=True, cwd=tmp)
        if res.returncode != 0:
            raise RuntimeError(f"Compilation failed: {res.stderr}")
        return res.stderr


# -- transform (compile.rs:88-239) -------------------------------------------

def _intern_user(zstore, state, name: str):
    sym = state.intern(name)
    return zstore.intern_symbol(sym)


def transform_lambda_program(zstore, state, expr: LambdaSyntax):
    """Wrap the transformed program in a `let` binding the `!=` helper
    (compile.rs:88-117)."""
    eq = zstore.intern_symbol(builtin_sym("eq"))
    not_eq = _intern_user(zstore, state, "!=")
    lam = zstore.intern_symbol(builtin_sym("lambda"))
    arg_a = _intern_user(zstore, state, "a")
    arg_b = _intern_user(zstore, state, "b")
    bin_args = zstore.intern_list([arg_a, arg_b])
    if_ = zstore.intern_symbol(builtin_sym("if"))
    eq_cond = zstore.intern_list([eq, arg_a, arg_b])
    not_eq_body = zstore.intern_list([if_, eq_cond, zstore.nil, zstore.t])
    not_eq_lambda = zstore.intern_list([lam, bin_args, not_eq_body])
    not_eq_bind = zstore.intern_list([not_eq, not_eq_lambda])
    bindings = zstore.intern_list([not_eq_bind])
    let_ = zstore.intern_symbol(builtin_sym("let"))
    result = transform_lambda(zstore, state, expr)
    return zstore.intern_list([let_, bindings, result])


def transform_lambda(zstore, state, expr: LambdaSyntax):
    """Lower one Lambda IR node to Lurk data (compile.rs:120-239)."""
    k = expr.kind
    if k == "ident":
        return _intern_user(zstore, state, expr.args[0])
    if k == "int":
        neg, i = expr.args
        if neg:
            minus = zstore.intern_symbol(builtin_sym("-"))
            return zstore.intern_list(
                [minus, zstore.intern_u64(0), zstore.intern_u64(i)])
        return zstore.intern_u64(i)
    if k == "float":
        # floats are unsupported: emit `(fail)` so a program still builds
        fail = zstore.intern_symbol(builtin_sym("fail"))
        return zstore.intern_list([fail])
    if k == "char":
        return zstore.intern_char(expr.args[0])
    if k == "string":
        return zstore.intern_string(expr.args[0])
    if k == "setglobal":
        return transform_lambda(zstore, state, expr.args[1])
    if k == "seq":
        begin = zstore.intern_symbol(builtin_sym("begin"))
        xs = [transform_lambda(zstore, state, x) for x in expr.args[0]]
        return zstore.intern_list([begin] + xs)
    if k in ("record", "makeblock"):
        tag, xs = expr.args
        lst = zstore.intern_symbol(builtin_sym("list"))
        vals = [lst, zstore.intern_u64(tag)]
        vals.extend(transform_lambda(zstore, state, x) for x in xs)
        return zstore.intern_list(vals)
    if k in ("let", "letrec"):
        binds, body = expr.args
        head = zstore.intern_symbol(builtin_sym(k))
        bind_ptrs = []
        for var, val in binds:
            v = transform_lambda(zstore, state, var)
            b = transform_lambda(zstore, state, val)
            bind_ptrs.append(zstore.intern_list([v, b]))
        return zstore.intern_list(
            [head, zstore.intern_list(bind_ptrs),
             transform_lambda(zstore, state, body)])
    if k == "function":
        args, body = expr.args
        lam = zstore.intern_symbol(builtin_sym("lambda"))
        arg_ptrs = zstore.intern_list(
            [transform_lambda(zstore, state, a) for a in args])
        return zstore.intern_list(
            [lam, arg_ptrs, transform_lambda(zstore, state, body)])
    if k == "apply":
        func, args = expr.args
        items = [transform_lambda(zstore, state, func)]
        items.extend(transform_lambda(zstore, state, a) for a in args)
        return zstore.intern_list(items)
    if k == "fallback_primitive":
        prim, args = expr.args
        # `==` can compare non-integers too -> eq; `mod` -> %
        prim = {"==": "eq", "mod": "%"}.get(prim, prim)
        if prim in BUILTIN_SYMBOLS:
            sym = builtin_sym(prim)
        else:
            sym = user_sym(prim)
        items = [zstore.intern_symbol(sym)]
        items.extend(transform_lambda(zstore, state, a) for a in args)
        return zstore.intern_list(items)
    if k == "fallback_literal":
        sym = Symbol(user_sym(expr.args[0]).path, keyword=True)
        return zstore.intern_symbol(sym)
    raise AssertionError(f"unknown LambdaSyntax kind: {k}")


def compile_and_transform_single_file(zstore, state, path: Path):
    """File -> ocamlc -> Lambda IR -> Lurk ZPtr (compile.rs:21-35)."""
    path = Path(path)
    ir = compile_single_file_contents(path.read_text(), path.name)
    lam = parse_syntax(ir)
    return transform_lambda_program(zstore, state, lam)
