"""The 39 REPL meta commands (reference: src/core/cli/meta.rs).

Each command is a MetaCmd{name, summary, info, format, example, returns, run};
`run(repl, args, path)` receives the interned argument list as a ZPtr.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict

from ..core.state import Package
from ..core.symbol import builtin_sym
from ..core.tag import Tag
from ..core.zstore import ZPtr, DIGEST_SIZE
from ..stark.challenger import Challenger
from .data import (CommData, LurkData, ProtocolProof, commits_dir, dump_data,
                   load_data, proofs_dir)


class MetaError(Exception):
    pass


@dataclass
class MetaCmd:
    name: str
    summary: str
    format: str
    run: Callable
    info: tuple = ()
    example: tuple = ()
    returns: str = ""


def _take(repl, args: ZPtr, n: int):
    elts, improper = repl.zstore.fetch_list(args)
    if improper is not None or len(elts) != n:
        raise MetaError(f"Expected {n} arguments")
    return elts


def _car_cdr(repl, args: ZPtr):
    if args == repl.zstore.nil:
        return repl.zstore.nil, repl.zstore.nil
    return repl.zstore.fetch_tuple11(args)


def _validate_binding_symbol(repl, zptr: ZPtr):
    if zptr.tag in (Tag.Builtin, Tag.Coroutine):
        return
    if zptr.tag == Tag.Sym and zptr.digest not in (
            repl.zstore.nil.digest, repl.zstore.t.digest):
        return
    raise MetaError(f"Illegal binding: {repl.fmt(zptr)}")


def _validate_path_type(repl, zptr: ZPtr):
    if zptr.tag != Tag.Str:
        raise MetaError("Path must be a string")


def _reduce_or_fail(repl, expr: ZPtr) -> ZPtr:
    val, _ = repl.reduce_aux(expr)
    if val.tag == Tag.Err:
        raise MetaError(f"Reduction error: {repl.fmt(val)}")
    return val


def _digest_hex(digest) -> str:
    from ..core.zstore import _digest_to_biguint_hex
    return _digest_to_biguint_hex(digest)[2:]


# ---------------------------------------------------------------------------
# assertions
# ---------------------------------------------------------------------------

def _m_assert(repl, args, path):
    (expr,) = _take(repl, args, 1)
    val = _reduce_or_fail(repl, expr)
    if val == repl.zstore.nil:
        raise MetaError(f"assert failed: {repl.fmt(expr)} evaluates to nil")
    return repl.zstore.t


def _m_assert_eq(repl, args, path):
    a, b = _take(repl, args, 2)
    va = _reduce_or_fail(repl, a)
    vb = _reduce_or_fail(repl, b)
    if va != vb:
        raise MetaError(
            f"assert-eq failed: {repl.fmt(va)} != {repl.fmt(vb)}")
    return repl.zstore.t


def _m_assert_error(repl, args, path):
    (expr,) = _take(repl, args, 1)
    val, _ = repl.reduce_aux(expr)
    if val.tag != Tag.Err:
        raise MetaError(f"assert-error failed: got {repl.fmt(val)}")
    return repl.zstore.t


def _m_assert_emitted(repl, args, path):
    expected_expr, expr = _take(repl, args, 2)
    expected = _reduce_or_fail(repl, expected_expr)
    repl.memoize_dag(expected)
    result, _ = repl.reduce_aux(expr)
    if result.tag == Tag.Err:
        raise MetaError(f"Reduction error: {repl.fmt(result)}")
    emitted = repl.manual_egression_many(
        [(int(e[0]), int(e[1])) for e in repl.queries.emitted])
    emitted_z = repl.zstore.intern_list(emitted)
    if expected != emitted_z:
        raise MetaError(
            f"assert-emitted failed. Expected {repl.fmt(expected)} "
            f"but got {repl.fmt(emitted_z)}")
    return repl.zstore.t


# ---------------------------------------------------------------------------
# environment management
# ---------------------------------------------------------------------------

def _m_load(repl, args, path):
    (file_name,) = _take(repl, args, 1)
    _validate_path_type(repl, file_name)
    repl.load_file(Path(path) / repl.zstore.fetch_string(file_name))
    return repl.zstore.t


def _m_defq(repl, args, path):
    sym, val = _take(repl, args, 2)
    _validate_binding_symbol(repl, sym)
    repl.bind(sym, val)
    return sym


def _m_def(repl, args, path):
    sym, expr = _take(repl, args, 2)
    _validate_binding_symbol(repl, sym)
    val = _reduce_or_fail(repl, expr)
    repl.memoize_dag(val)
    repl.bind(sym, val)
    return sym


def _m_defrec(repl, args, path):
    elts = _take(repl, args, 2)
    sym = elts[0]
    z = repl.zstore
    letrec = z.intern_symbol(builtin_sym("letrec"))
    bindings = z.intern_list([args])
    current_env = z.intern_list([z.intern_symbol(builtin_sym("current-env"))])
    expr = z.intern_list([letrec, bindings, current_env])
    out, _ = repl.reduce_aux(expr)
    if out.tag != Tag.Env:
        raise MetaError(f"Reduction resulted in {repl.fmt(out)}")
    repl.env = out
    return sym


def _m_update(repl, args, path):
    sym, fun = _take(repl, args, 2)
    _validate_binding_symbol(repl, sym)
    expr = repl.zstore.intern_list([fun, sym])
    res = _reduce_or_fail(repl, expr)
    repl.bind(sym, res)
    return sym


def _m_clear(repl, args, path):
    repl.env = repl.zstore.intern_empty_env()
    return repl.zstore.t


def _m_set_env(repl, args, path):
    (env_expr,) = _take(repl, args, 1)
    env, _ = repl.reduce_aux(env_expr)
    if env.tag != Tag.Env:
        raise MetaError("Value must be an environment")
    repl.env = env
    return repl.zstore.t


def _m_erase_from_env(repl, args, path):
    repl.memoize_env_dag()
    args_vec, _ = repl.zstore.fetch_list(args)
    pairs = [(v, val) for v, val in repl.zstore.fetch_env(repl.env)
             if v not in args_vec]
    repl.env = repl.zstore.intern_empty_env()
    for var, val in reversed(pairs):
        repl.bind(var, val)
    return repl.zstore.t


# ---------------------------------------------------------------------------
# commitments
# ---------------------------------------------------------------------------

def _persist_comm_data(repl, secret, payload: ZPtr) -> ZPtr:
    repl.memoize_dag(payload)
    comm_data = CommData.new(secret, payload, repl.zstore)
    comm = comm_data.commit(repl.zstore)
    dump_data(comm_data, commits_dir() / _digest_hex(comm.digest))
    return comm


def _hide(repl, secret, payload_expr: ZPtr) -> ZPtr:
    payload, _ = repl.reduce_aux(payload_expr)
    if payload.tag == Tag.Err:
        raise MetaError(f"Payload reduction error: {repl.fmt(payload)}")
    return _persist_comm_data(repl, secret, payload)


def _m_hide(repl, args, path):
    secret_expr, payload_expr = _take(repl, args, 2)
    secret, _ = repl.reduce_aux(secret_expr)
    if secret.tag != Tag.BigNum:
        raise MetaError("Secret must reduce to a bignum")
    return _hide(repl, secret.digest, payload_expr)


def _m_rand(repl, args, path):
    if args != repl.zstore.nil:
        raise MetaError("No arguments are accepted")
    from .data import random_field_digest
    return repl.zstore.intern_big_num(random_field_digest())


def _m_commit(repl, args, path):
    (payload_expr,) = _take(repl, args, 1)
    return _hide(repl, (0,) * DIGEST_SIZE, payload_expr)


def _fetch_comm_data(repl, digest) -> ZPtr:
    comm_data = load_data(commits_dir() / _digest_hex(digest))
    payload = comm_data.payload
    # stricter than the reference (meta.rs:455-462 loads unchecked): the
    # commits dir can hold files from untrusted parties, so the payload
    # DAG must be consistent and the data must actually hash to the
    # commitment being opened
    if comm_data.zdag.is_flawed(repl.zstore):
        raise MetaError("Flawed commitment data")
    from .data import CommData
    if tuple(CommData.hash(comm_data.secret, payload, repl.zstore)) \
            != tuple(digest):
        raise MetaError("Commitment data does not match the digest")
    comm_data.populate_zstore(repl.zstore)
    # make the preimage available for open/preimg
    preimg = tuple(comm_data.secret) + payload.flatten()
    repl.zstore.hash3(preimg)
    return payload


def _m_open(repl, args, path):
    (expr,) = _take(repl, args, 1)
    result, _ = repl.reduce_aux(expr)
    if result.tag not in (Tag.BigNum, Tag.Comm):
        raise MetaError("Expected a commitment or a BigNum")
    return _fetch_comm_data(repl, result.digest)


# ---------------------------------------------------------------------------
# calls and chains
# ---------------------------------------------------------------------------

def _eval_then_quote(repl, args: ZPtr) -> ZPtr:
    args_vec, _ = repl.zstore.fetch_list(args)
    quoted = []
    for arg in list(args_vec):
        red, _ = repl.reduce_aux(arg)
        if red.tag == Tag.Err:
            raise MetaError(f"Error when evaluating argument {repl.fmt(arg)}")
        repl.memoize_dag(red)
        quoted.append(repl.zstore.intern_quoted(red))
    return repl.zstore.intern_list(quoted)


def _call(repl, call_expr: ZPtr, env: ZPtr):
    if call_expr == repl.zstore.nil:
        raise MetaError("Missing callable object")
    callable_, call_args = repl.zstore.fetch_tuple11(call_expr)
    callable_, _ = repl.reduce_aux(callable_)
    if callable_.tag in (Tag.BigNum, Tag.Comm):
        inv3 = repl.queries.get_inv_queries("hash3")
        if tuple(callable_.digest) not in inv3:
            _fetch_comm_data(repl, callable_.digest)
    call_args = _eval_then_quote(repl, call_args)
    call_expr = repl.zstore.intern_cons(callable_, call_args)
    return repl.handle_non_meta_with_env(call_expr, env), call_args


def _m_call(repl, args, path):
    res, _ = _call(repl, args, repl.env)
    return res


def _persist_chain_comm(repl, cons: ZPtr):
    if cons.tag != Tag.Cons:
        raise MetaError("Chain result must be a pair")
    _, next_callable = repl.zstore.fetch_tuple11(cons)
    if next_callable.tag in (Tag.Comm, Tag.BigNum):
        inv3 = repl.queries.get_inv_queries("hash3")
        preimg = inv3.get(tuple(next_callable.digest))
        assert preimg is not None, "Preimage must be known"
        secret = tuple(preimg[:DIGEST_SIZE])
        payload = ZPtr.from_flat_data(preimg[DIGEST_SIZE:])
        _persist_comm_data(repl, secret, payload)


def _m_chain(repl, args, path):
    env = repl.zstore.intern_empty_env()
    cons, _ = _call(repl, args, env)
    _persist_chain_comm(repl, cons)
    return cons


def _transition_call(repl, current_state_expr: ZPtr, call_args: ZPtr):
    current_state, _ = repl.reduce_aux(current_state_expr)
    if current_state.tag != Tag.Cons:
        raise MetaError("Current state must reduce to a pair")
    repl.memoize_dag(current_state)
    _, callable_ = repl.zstore.fetch_tuple11(current_state)
    call_expr = repl.zstore.intern_cons(callable_, call_args)
    env = repl.zstore.intern_empty_env()
    return _call(repl, call_expr, env)


def _m_transition(repl, args, path):
    current_state_expr, call_args = _car_cdr(repl, args)
    cons, _ = _transition_call(repl, current_state_expr, call_args)
    _persist_chain_comm(repl, cons)
    return cons


# ---------------------------------------------------------------------------
# packages
# ---------------------------------------------------------------------------

def _m_defpackage(repl, args, path):
    name_z, _rest = _car_cdr(repl, args)
    if name_z.tag == Tag.Str:
        name = repl.state.intern(repl.zstore.fetch_string(name_z))
    elif name_z.tag == Tag.Sym:
        name = repl.zstore.fetch_symbol(name_z)
    else:
        raise MetaError("Package name must be a string or a symbol")
    name_zptr = repl.zstore.intern_symbol(name)
    repl.state.add_package(Package(name))
    return name_zptr


def _m_import(repl, args, path):
    symbols, _pkg = _car_cdr(repl, args)
    if symbols.tag == Tag.Sym:
        repl.state.get_current_package().import_symbols(
            [repl.zstore.fetch_symbol(symbols)])
    else:
        elts, _ = repl.zstore.fetch_list(symbols)
        repl.state.get_current_package().import_symbols(
            [repl.zstore.fetch_symbol(s) for s in elts])
    return repl.zstore.t


def _m_in_package(repl, args, path):
    (arg,) = _take(repl, args, 1)
    if arg.tag == Tag.Str:
        name = repl.state.intern(repl.zstore.fetch_string(arg))
        repl.state.set_current_package(name)
    elif arg.tag == Tag.Sym:
        repl.state.set_current_package(repl.zstore.fetch_symbol(arg))
    else:
        raise MetaError(f"Expected string or symbol. Got {repl.fmt(arg)}")
    return repl.zstore.t


# ---------------------------------------------------------------------------
# data persistence
# ---------------------------------------------------------------------------

def _m_dump_expr(repl, args, path):
    expr, path_z = _take(repl, args, 2)
    _validate_path_type(repl, path_z)
    result = _reduce_or_fail(repl, expr)
    path_str = repl.zstore.fetch_string(path_z)
    repl.memoize_dag(result)
    dump_data(LurkData.new(result, repl.zstore), path_str)
    print(f"Data persisted on file `{path_str}`")
    return result


def _m_load_expr(repl, args, path):
    (path_z,) = _take(repl, args, 1)
    _validate_path_type(repl, path_z)
    path_str = repl.zstore.fetch_string(path_z)
    lurk_data = load_data(path_str)
    # stricter than the reference (meta.rs:736-754 populates unchecked):
    # a flawed/malformed DAG from disk must not enter the live zstore
    if lurk_data.is_flawed(repl.zstore):
        raise MetaError(f"Flawed Lurk data in `{path_str}`")
    return lurk_data.interned(repl.zstore)


# ---------------------------------------------------------------------------
# proving and protocols
# ---------------------------------------------------------------------------

def _m_prove(repl, args, path):
    if args != repl.zstore.nil:
        (expr,) = _take(repl, args, 1)
        repl.handle_non_meta(expr)
    proof_key = repl.prove_last_reduction()
    return repl.zstore.intern_string(proof_key)


def _load_cached_proof(proof_key: str):
    p = proofs_dir() / proof_key
    if not p.exists():
        raise MetaError("Proof not found")
    return load_data(p)


def _load_cached_proof_with_repl(repl, args):
    (proof_key_expr,) = _take(repl, args, 1)
    key_z, _ = repl.reduce_aux(proof_key_expr)
    if key_z.tag != Tag.Str:
        raise MetaError("Proof key must be a string")
    proof_key = repl.zstore.fetch_string(key_z)
    return proof_key, _load_cached_proof(proof_key)


def _m_verify(repl, args, path):
    proof_key, cached = _load_cached_proof_with_repl(repl, args)
    same_version = cached.crypto_proof.has_same_verifier_version()
    machine = repl.machine()
    _, vk = repl.machine_keys()
    mp = cached.into_machine_proof()
    if machine.verify(vk, mp, Challenger()):
        print(f'✓ Proof "{proof_key}" verified')
        return repl.zstore.t
    msg = f'✗ Proof "{proof_key}" failed on verification'
    if not same_version:
        msg += "\nWarning: proof was created for a different verifier version"
    raise MetaError(msg)


def _m_inspect(repl, args, path):
    _, cached = _load_cached_proof_with_repl(repl, args)
    cached.zdag.populate_zstore(repl.zstore)
    print(f"Expr: {repl.fmt(cached.expr)}\n"
          f"Env: {repl.fmt(cached.env)}\n"
          f"Result: {repl.fmt(cached.result)}")
    expr_env = repl.zstore.intern_cons(cached.expr, cached.env)
    return repl.zstore.intern_cons(expr_env, cached.result)


def _m_defprotocol(repl, args, path):
    name, rest = _car_cdr(repl, args)
    vars_, rest = _car_cdr(repl, rest)
    body, props = _car_cdr(repl, rest)
    _validate_binding_symbol(repl, name)
    if vars_.tag != Tag.Cons and vars_ != repl.zstore.nil:
        raise MetaError("Protocol vars must be a list")
    empty_str = repl.zstore.intern_string("")
    prop_elts, _ = repl.zstore.fetch_list(props)
    prop_map = {}
    for i in range(0, len(prop_elts) - 1, 2):
        k = prop_elts[i]
        if k.tag != Tag.Key:
            raise MetaError("Property name must be a keyword")
        kname = repl.zstore.fetch_symbol_path(k)[-1]
        prop_map[kname] = prop_elts[i + 1]
    lang = prop_map.get("lang", repl.zstore.nil)
    description = prop_map.get("description", empty_str)
    if description.tag != Tag.Str:
        raise MetaError("Invalid value for property description")
    protocol = repl.zstore.intern_list([vars_, body, lang, description])
    repl.bind(name, protocol)
    return name


def _get_vars_vec_and_body(repl, protocol: ZPtr):
    elts, improper = repl.zstore.fetch_list(protocol)
    if improper is not None or len(elts) < 2:
        raise MetaError("Malformed protocol")
    vars_vec, improper = repl.zstore.fetch_list(elts[0])
    if improper is not None:
        raise MetaError("Malformed protocol: vars must be a list")
    return list(vars_vec), elts[1]


def _get_claim_and_predicate(repl, vars_vec, args_vec_reduced, body):
    env = repl.zstore.intern_empty_env()
    for var, arg in zip(vars_vec, args_vec_reduced):
        env = repl.zstore.intern_env(var, arg, env)
    io_data, _ = repl.reduce_aux_with_env(body, env)
    if io_data.tag != Tag.Cons:
        raise MetaError("Protocol body must return a pair")
    repl.memoize_dag(io_data)
    claim, predicate = repl.zstore.fetch_tuple11(io_data)
    if claim == repl.zstore.nil:
        raise MetaError("Pre-verification predicate rejected the input")
    if claim.tag != Tag.Cons:
        raise MetaError("Malformed protocol claim")
    return claim, predicate


def _post_verify_check(repl, predicate: ZPtr):
    if predicate != repl.zstore.nil:
        call = repl.zstore.intern_list([predicate])
        empty_env = repl.zstore.intern_empty_env()
        result, _ = repl.reduce_aux_with_env(call, empty_env)
        if result == repl.zstore.nil:
            raise MetaError("Post-verification predicate rejected the input")


def _m_prove_protocol(repl, args, path):
    protocol_expr, rest = _car_cdr(repl, args)
    path_z, args_list = _car_cdr(repl, rest)
    _validate_path_type(repl, path_z)
    path_str = repl.zstore.fetch_string(path_z)
    protocol = _reduce_or_fail(repl, protocol_expr)
    vars_vec, body = _get_vars_vec_and_body(repl, protocol)
    args_vec, _ = repl.zstore.fetch_list(args_list)
    if len(args_vec) != len(vars_vec):
        raise MetaError(
            f"Mismatching arity. Protocol requires {len(vars_vec)} arguments "
            f"but {len(args_vec)} were provided")
    args_reduced = []
    for arg in list(args_vec):
        red, _ = repl.reduce_aux(arg)
        if red.tag == Tag.Err:
            raise MetaError("Error when evaluating a protocol argument")
        repl.memoize_dag(red)
        args_reduced.append(red)
    claim, predicate = _get_claim_and_predicate(repl, vars_vec, args_reduced,
                                                body)
    _post_verify_check(repl, predicate)
    expr_env, expected_result = repl.zstore.fetch_tuple11(claim)
    if expr_env.tag != Tag.Cons:
        raise MetaError("Malformed protocol claim")
    expr, env = repl.zstore.fetch_tuple11(expr_env)
    result = repl.reduce_with_env(expr, env)
    repl.memoize_dag(result)
    if result != expected_result:
        raise MetaError("Mismatch between result and expected result")
    proof_key = repl.prove_last_reduction()
    cached = _load_cached_proof(proof_key)
    args_z = repl.zstore.intern_list(args_reduced)
    protocol_proof = ProtocolProof.new(cached.crypto_proof, args_z,
                                       repl.zstore)
    dump_data(protocol_proof, path_str)
    print(f"Protocol proof saved on file `{path_str}`")
    return repl.zstore.intern_string(proof_key)


def _m_verify_protocol(repl, args, path):
    protocol_expr, path_z = _take(repl, args, 2)
    _validate_path_type(repl, path_z)
    path_str = repl.zstore.fetch_string(path_z)
    protocol = _reduce_or_fail(repl, protocol_expr)
    vars_vec, body = _get_vars_vec_and_body(repl, protocol)
    pp = load_data(path_str)
    if pp.args.is_flawed(repl.zstore):
        raise MetaError("Arguments contain flawed data")
    args_z = pp.args.interned(repl.zstore)
    args_vec, improper = repl.zstore.fetch_list(args_z)
    if improper is not None:
        raise MetaError("Arguments must be a list")
    if len(args_vec) != len(vars_vec):
        raise MetaError("Mismatching arity")
    claim, predicate = _get_claim_and_predicate(repl, vars_vec,
                                                list(args_vec), body)
    expr_env, result = repl.zstore.fetch_tuple11(claim)
    if expr_env.tag != Tag.Cons:
        raise MetaError("Malformed protocol claim")
    expr, env = repl.zstore.fetch_tuple11(expr_env)
    same_version = pp.crypto_proof.has_same_verifier_version()
    mp = pp.crypto_proof.into_machine_proof(expr, env, result)
    machine = repl.machine()
    _, vk = repl.machine_keys()
    if not machine.verify(vk, mp, Challenger()):
        msg = "Proof verification failed"
        if not same_version:
            msg += "\nWarning: proof was created for a different verifier version"
        raise MetaError(msg)
    _post_verify_check(repl, predicate)
    print("Proof accepted by the protocol")
    return repl.zstore.t


# ---------------------------------------------------------------------------
# debug + help + microchain + ocaml
# ---------------------------------------------------------------------------

def _m_debug(repl, args, path):
    """Interactive viewer over the eval call tree (reference:
    src/core/cli/debug.rs + repl.rs:350-430). On a TTY: arrow keys
    navigate, Left/Right jump within a depth, Space/Backspace jump
    between breakpoints, q quits. Non-interactively: prints the
    formatted entries."""
    import sys
    from .debug import debug_mode, format_debug_data
    entries = repl.queries.debug_data.entries
    if args != repl.zstore.nil:
        (expr,) = _take(repl, args, 1)
        prev = repl.use_native
        repl.use_native = False  # debug entries only exist on the python path
        try:
            repl.handle_non_meta(expr)
        finally:
            repl.use_native = prev
        entries = repl.queries.debug_data.entries
    if not entries:
        print("(no debug entries recorded; rerun as !(debug <expr>))")
        return repl.zstore.t
    if sys.stdin.isatty() and sys.stdout.isatty():
        debug_mode(format_debug_data(repl))
    else:
        # format only what will be printed (egression per entry is not free)
        data = format_debug_data(repl, limit=500)
        for e in data.entries:
            print(e.formatted)
        if len(entries) > 500:
            print(f"... ({len(entries) - 500} more entries)")
    return repl.zstore.t


def _m_help(repl, args, path):
    cmds = repl.meta_cmds
    if args != repl.zstore.nil:
        (arg,) = _take(repl, args, 1)
        if arg.tag not in (Tag.Sym, Tag.Builtin):
            raise MetaError("Argument must be a symbol")
        name = repl.zstore.fetch_symbol_path(arg)[-1]
        cmd = cmds.get(name)
        if cmd is None:
            raise MetaError("Unknown meta command")
        print(f"{cmd.name} - {cmd.summary}")
        for line in cmd.info:
            print(f"    {line}")
        print(f"  Format: {cmd.format}")
        for e in cmd.example:
            print(f"    {e}")
        if cmd.returns:
            print(f"  Returns: {cmd.returns}")
    else:
        print("Available commands:")
        for name in sorted(cmds):
            print(f"  {name} - {cmds[name].summary}")
    return repl.zstore.t


def _m_microchain_start(repl, args, path):
    from .microchain import client_start
    addr_z, state_expr = _car_cdr(repl, args)
    addr = repl.zstore.fetch_string(addr_z)
    (state_expr,) = repl.zstore.fetch_list(state_expr)[0] or [state_expr]
    state, _ = repl.reduce_aux(state_expr)
    repl.memoize_dag(state)
    id_digest = client_start(repl, addr, state)
    return repl.zstore.intern_big_num(id_digest)


def _m_microchain_get_genesis(repl, args, path):
    from .microchain import client_get_genesis
    addr_z, id_expr = _take(repl, args, 2)
    addr = repl.zstore.fetch_string(addr_z)
    id_z, _ = repl.reduce_aux(id_expr)
    return client_get_genesis(repl, addr, id_z.digest)


def _m_microchain_get_state(repl, args, path):
    from .microchain import client_get_state
    addr_z, id_expr = _take(repl, args, 2)
    addr = repl.zstore.fetch_string(addr_z)
    id_z, _ = repl.reduce_aux(id_expr)
    return client_get_state(repl, addr, id_z.digest)


def _m_microchain_transition(repl, args, path):
    from .microchain import client_transition
    addr_z, rest = _car_cdr(repl, args)
    id_expr, state_and_args = _car_cdr(repl, rest)
    addr = repl.zstore.fetch_string(addr_z)
    id_z, _ = repl.reduce_aux(id_expr)
    return client_transition(repl, addr, id_z.digest, state_and_args)


def _m_microchain_verify(repl, args, path):
    from .microchain import client_verify
    addr_z, id_expr = _take(repl, args, 2)
    addr = repl.zstore.fetch_string(addr_z)
    id_z, _ = repl.reduce_aux(id_expr)
    client_verify(repl, addr, id_z.digest)
    return repl.zstore.t


def _m_load_ocaml(repl, args, path):
    from .ocaml import compile_and_load_file
    (file_z,) = _take(repl, args, 1)
    _validate_path_type(repl, file_z)
    file_name = repl.zstore.fetch_string(file_z)
    compile_and_load_file(repl, Path(path) / file_name, run=True)
    return repl.zstore.t


def _m_load_ocaml_expr(repl, args, path):
    from .ocaml import compile_and_load_file
    (file_z,) = _take(repl, args, 1)
    _validate_path_type(repl, file_z)
    file_name = repl.zstore.fetch_string(file_z)
    return compile_and_load_file(repl, Path(path) / file_name, run=False)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def build_meta_cmds() -> Dict[str, MetaCmd]:
    cmds = [
        MetaCmd("assert", "Asserts that an expression doesn't reduce to nil.",
                "!(assert <expr>)", _m_assert),
        MetaCmd("assert-eq", "Asserts that two expressions evaluate to the same value.",
                "!(assert-eq <expr1> <expr2>)", _m_assert_eq),
        MetaCmd("assert-error", "Asserts that a reduction error happens.",
                "!(assert-error <expr>)", _m_assert_error),
        MetaCmd("assert-emitted", "Asserts that the expected values are emitted.",
                "!(assert-emitted <expr1> <expr2>)", _m_assert_emitted),
        MetaCmd("debug", "Prints the eval call tree of the last reduction.",
                "!(debug <expr>?)", _m_debug),
        MetaCmd("load", "Load Lurk expressions from a file.",
                "!(load <string>)", _m_load),
        MetaCmd("defq", "Extends env with a non-evaluated expression.",
                "!(defq <symbol> <value>)", _m_defq),
        MetaCmd("def", "Extends env with a non-recursive binding.",
                "!(def <symbol> <expr>)", _m_def),
        MetaCmd("defrec", "Extends env with a recursive binding.",
                "!(defrec <symbol> <expr>)", _m_defrec),
        MetaCmd("update", "Updates an env variable by applying it to a function.",
                "!(update <symbol> <function_expr>)", _m_update),
        MetaCmd("clear", "Resets the current environment to be empty.",
                "!(clear)", _m_clear),
        MetaCmd("set-env", "Sets the env to the result of evaluating the argument.",
                "!(set-env <expr>)", _m_set_env),
        MetaCmd("erase-from-env", "Erases bindings for the provided variables.",
                "!(erase-from-env <var1> <var2> ...)", _m_erase_from_env),
        MetaCmd("hide", "Persists a hiding commitment.",
                "!(hide <secret_expr> <payload_expr>)", _m_hide),
        MetaCmd("rand", "Creates a random big num for secrets.",
                "!(rand)", _m_rand),
        MetaCmd("commit", "Persists a commitment.",
                "!(commit <payload_expr>)", _m_commit),
        MetaCmd("open", "Fetches a persisted commitment and prints the payload.",
                "!(open <comm>)", _m_open),
        MetaCmd("call", "Applies arguments, quoted, to a callable object.",
                "!(call <callable> <arg1_expr> ...)", _m_call),
        MetaCmd("chain", "Chains a callable object.",
                "!(chain <callable> <arg1_expr> ...)", _m_chain),
        MetaCmd("transition", "Chains a callable object and returns the next state.",
                "!(transition <state_expr> <call_args>)", _m_transition),
        MetaCmd("defpackage", "Adds a package to the state.",
                "!(defpackage <string|symbol>)", _m_defpackage),
        MetaCmd("import", "Import a single or several packages.",
                "!(import <string|package> ...)", _m_import),
        MetaCmd("in-package", "Set the current package.",
                "!(in-package <string|symbol>)", _m_in_package),
        MetaCmd("dump-expr", "Evaluates an expression and dumps the result.",
                "!(dump-expr <expr> <string>)", _m_dump_expr),
        MetaCmd("load-expr", "Loads Lurk data from the file system.",
                "!(load-expr <string>)", _m_load_expr),
        MetaCmd("defprotocol", "Defines a protocol.",
                "!(defprotocol <symbol> <vars> <body> options...)",
                _m_defprotocol),
        MetaCmd("help", "Prints a help message.",
                "!(help <symbol>?)", _m_help),
        MetaCmd("prove", "Prove a Lurk reduction, persist and print the key.",
                "!(prove <expr>?)", _m_prove),
        MetaCmd("verify", "Verifies a Lurk reduction proof.",
                "!(verify <string>)", _m_verify),
        MetaCmd("inspect", "Prints a proof claim.",
                "!(inspect <string>)", _m_inspect),
        MetaCmd("prove-protocol", "Creates a proof for a protocol.",
                "!(prove-protocol <protocol> <string> args...)",
                _m_prove_protocol),
        MetaCmd("verify-protocol", "Verifies a proof for a protocol.",
                "!(verify-protocol <protocol> <string>)", _m_verify_protocol),
        MetaCmd("microchain-start", "Starts a new microchain.",
                "!(microchain-start <addr> <state>)", _m_microchain_start),
        MetaCmd("microchain-get-genesis", "Gets a microchain's genesis state.",
                "!(microchain-get-genesis <addr> <id>)",
                _m_microchain_get_genesis),
        MetaCmd("microchain-get-state", "Gets a microchain's current state.",
                "!(microchain-get-state <addr> <id>)", _m_microchain_get_state),
        MetaCmd("microchain-transition",
                "Proves a state transition and sends it to a microchain server.",
                "!(microchain-transition <addr> <id> <state> args...)",
                _m_microchain_transition),
        MetaCmd("microchain-verify", "Verifies a microchain's transition history.",
                "!(microchain-verify <addr> <id>)", _m_microchain_verify),
        MetaCmd("load-ocaml", "Compiles an OCaml file to Lurk and runs it.",
                "!(load-ocaml <string>)", _m_load_ocaml),
        MetaCmd("load-ocaml-expr", "Compiles an OCaml file to a Lurk expression.",
                "!(load-ocaml-expr <string>)", _m_load_ocaml_expr),
    ]
    return {c.name: c for c in cmds}
