"""High-level evaluation API: read -> run lurk_main -> fetch result.

Mirrors the REPL's reduce path (reference: src/core/cli/repl.rs:266,467-511):
inject the ZStore's hash preimages into the query record so `preimg(hash4/5)`
in ingress works without re-execution, execute `lurk_main`, then memoize the
result DAG from the inverse query maps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import os

from ..lair.execute import QueryRecord, execute_by_name
from .zstore import ZPtr, ZStore, DIGEST_SIZE


def native_enabled() -> bool:
    """True if the C++ interpreter is built and not disabled via
    LURK_TPU_NATIVE=0."""
    if os.environ.get("LURK_TPU_NATIVE", "1") == "0":
        return False
    from ..lair.native import native_available
    return native_available()


_NATIVE_CACHE: dict = {}


def get_native_toplevel(toplevel):
    """Cached NativeToplevel handle for a compiled python Toplevel."""
    from ..lair.native import NativeToplevel
    nt = _NATIVE_CACHE.get(id(toplevel))
    if nt is None or nt.toplevel is not toplevel:
        nt = NativeToplevel(toplevel)
        _NATIVE_CACHE[id(toplevel)] = nt
    return nt


def execute_main(toplevel, name: str, args, queries: QueryRecord,
                 use_native: Optional[bool] = None, dbg_func_idx=None):
    """Run a toplevel entry function: native C++ interpreter when built
    (decoding into columnar query maps), python interpreter otherwise.

    On a native runtime error, re-executes in python so the user sees the
    interpreter's formatted bail message (errors are rare; the rerun is the
    diagnostic path, not the hot path).
    """
    if use_native is None:
        use_native = native_enabled()
    if use_native:
        nt = get_native_toplevel(toplevel)
        try:
            return nt.execute(toplevel.func_index[name], list(args), queries)
        except RuntimeError:
            pass  # fall through: reproduce the error with python diagnostics
    return execute_by_name(toplevel, name, list(args), queries,
                           dbg_func_idx=dbg_func_idx)


def prepare_queries(toplevel, zstore: ZStore,
                    queries: Optional[QueryRecord] = None) -> QueryRecord:
    if queries is None:
        queries = QueryRecord(toplevel)
    queries.inject_inv_queries("hash3", zstore.hashes3.items())
    queries.inject_inv_queries("hash4", zstore.hashes4.items())
    queries.inject_inv_queries("hash5", zstore.hashes5.items())
    return queries


def evaluate_zptr(toplevel, zstore: ZStore, expr: ZPtr,
                  env_digest: Tuple[int, ...] = (0,) * DIGEST_SIZE,
                  queries: Optional[QueryRecord] = None,
                  use_native: Optional[bool] = None):
    """Run lurk_main on `expr`; returns (result ZPtr, queries)."""
    queries = prepare_queries(toplevel, zstore, queries)
    args = ((expr.tag,) + (0,) * 7 + tuple(expr.digest) + tuple(env_digest))
    out = execute_main(toplevel, "lurk_main", list(args), queries,
                       use_native=use_native)
    result = ZPtr(int(out[0]), tuple(int(x) for x in out[8:16]))
    # reconstruct the result's DAG so it can be displayed
    hash4_idx = toplevel.func_index["hash4"]
    hash5_idx = toplevel.func_index["hash5"]
    zstore.memoize_dag(result.tag, result.digest,
                       queries.inv_func_queries[hash4_idx],
                       queries.inv_func_queries[hash5_idx])
    return result, queries


def evaluate(toplevel, zstore: ZStore, code: str, state=None,
             env_digest: Tuple[int, ...] = (0,) * DIGEST_SIZE,
             queries: Optional[QueryRecord] = None,
             use_native: Optional[bool] = None):
    """Read and evaluate Lurk source; returns (result ZPtr, queries)."""
    expr = zstore.read(code, state)
    return evaluate_zptr(toplevel, zstore, expr, env_digest, queries,
                         use_native)


def num_iterations(toplevel, queries: QueryRecord) -> int:
    """The REPL's `[N iterations]` metric: number of memoized eval queries."""
    return len(queries.func_queries[toplevel.func_index["eval"]])
