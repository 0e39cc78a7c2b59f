"""The compiled-pipeline Lurk evaluator (35 Lair functions).

Faithful port of reference: src/core/eval_compiled.rs. The pipeline is
ingress -> compile -> convert_data -> eval -> deconvert_data -> egress
(eval_compiled.rs:129-157); the evaluator dispatches on compiled opcode
tags (`CompOp`) and runtime value tags (`CompVal`) instead of re-parsing
builtin symbols on every reduction.
"""

from __future__ import annotations

from ..lair.dsl import FuncBuilder
from ..lair.expr import CaseType
from ..lair.toplevel import Toplevel
from .chipset import lurk_chip_map
from .compile import CompOp, CompVal, compile_funcs
from .ingress import SymbolsDigests, preallocate_symbols, ingress, egress
from . import misc
from .tag import Tag, InternalTag, EvalErr
from .zstore import lurk_zstore

_UNOPS = (int(CompOp.Car), int(CompOp.Cdr), int(CompOp.Atom),
          int(CompOp.Open), int(CompOp.Secret), int(CompOp.U64),
          int(CompOp.Char), int(CompOp.Comm), int(CompOp.Bignum),
          int(CompOp.Emit))
_BINOPS = (int(CompOp.MkCons), int(CompOp.MkStrcons), int(CompOp.Eq),
           int(CompOp.TypeEq), int(CompOp.Begin), int(CompOp.Hide))
_NUMOPS = (int(CompOp.Add), int(CompOp.Sub), int(CompOp.Mul),
           int(CompOp.Div), int(CompOp.Mod), int(CompOp.Less),
           int(CompOp.LessEq), int(CompOp.Great), int(CompOp.GreatEq),
           int(CompOp.NumEq))


def lurk_main():
    """Reference: eval_compiled.rs:129-157."""
    b = FuncBuilder("lurk_main", [("full_expr_tag", 8), ("expr_digest", 8),
                                  ("env_digest", 8)], 16, partial=True)
    full_expr_tag = b.input("full_expr_tag")
    expr_digest = b.input("expr_digest")
    env_digest = b.input("env_digest")
    b.call("preallocate_symbols", out_sizes=())
    expr_tag, expr = b.call("ingress", full_expr_tag, expr_digest,
                            out_sizes=(1, 1))
    padding = b.array([0] * 7)
    env_tag = b.const(Tag.Env)
    full_env_tag, = b.split([env_tag, padding], [8])
    _env_tag, env = b.call("ingress", full_env_tag, env_digest,
                           out_sizes=(1, 1))
    cexpr_tag, cexpr = b.call("compile", expr_tag, expr, out_sizes=(1, 1))
    cenv_tag, cenv = b.call("convert_data", env_tag, env, out_sizes=(1, 1))

    def env_err(bb):
        rt, rd = bb.call("egress", cenv_tag, cenv, out_sizes=(1, 8))
        ft, = bb.split([rt, padding], [8])
        bb.ret(ft, rd)

    def cont(bb):
        cval_tag, cval = bb.call("eval", cexpr_tag, cexpr, cenv,
                                 out_sizes=(1, 1))
        val_tag, val = bb.call("deconvert_data", cval_tag, cval,
                               out_sizes=(1, 1))
        vt, vd = bb.call("egress", val_tag, val, out_sizes=(1, 8))
        ft, = bb.split([vt, padding], [8])
        bb.ret(ft, vd)
    b.match(cenv_tag, [(int(Tag.Err), env_err)], default=cont)
    return b.build()


def eval_func(digests):
    """Reference: eval_compiled.rs:159-237."""
    b = FuncBuilder("eval", ["expr_tag", "expr", "env"], 2, partial=True)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")
    env = b.input("env")

    def self_eval(bb):
        bb.ret(expr_tag, expr)

    def sym_case(bb):
        expr_digest, = bb.load(expr, [8])
        res_tag, res = bb.call("env_lookup", expr_tag, expr_digest, env,
                               out_sizes=(1, 1))

        def fix_case(b2):
            # fixed points are closed: evaluate in the empty environment
            null_env = b2.const(0)
            rt, r = b2.call("eval", res_tag, res, null_env,
                            out_sizes=(1, 1))
            b2.ret(rt, r)

        def other(b2):
            b2.ret(res_tag, res)
        bb.match(res_tag, [(int(CompVal.Fix), fix_case)], default=other)

    def fix_case_outer(bb):
        body_tag, body, binds, mutual_env = bb.load(expr, [1, 1, 1, 1])
        ext_env, = bb.call("extend_env_with_mutuals", binds, binds,
                           mutual_env, out_sizes=(1,))
        rt, r = bb.call("eval", body_tag, body, ext_env, out_sizes=(1, 1))
        bb.ret(rt, r)

    def mkthunk(bb):
        cbody_tag, cbody = bb.load(expr, [1, 1])
        tag = bb.const(CompVal.Thunk)
        ptr = bb.store(cbody_tag, cbody, env)
        bb.ret(tag, ptr)

    def mkfun(bb):
        var_tag, var, cbody_tag, cbody = bb.load(expr, [1, 1, 1, 1])
        tag = bb.const(CompVal.Fun)
        ptr = bb.store(var_tag, var, cbody_tag, cbody, env)
        bb.ret(tag, ptr)

    def mkrestfun(bb):
        var_tag, var, cbody_tag, cbody = bb.load(expr, [1, 1, 1, 1])
        tag = bb.const(CompVal.RestFun)
        ptr = bb.store(var_tag, var, cbody_tag, cbody, env)
        bb.ret(tag, ptr)

    def app_case(bb):
        head_tag, head, args_tag, args = bb.load(expr, [1, 1, 1, 1])
        fun_tag, fun = bb.call("eval", head_tag, head, env,
                               out_sizes=(1, 1))
        vt, v = bb.call("apply", fun_tag, fun, args_tag, args, env,
                        out_sizes=(1, 1))
        bb.ret(vt, v)

    def unop_case(bb):
        vt, v = bb.call("eval_unop", expr_tag, expr, env, out_sizes=(1, 1))
        bb.ret(vt, v)

    def binop_case(bb):
        vt, v = bb.call("eval_binop", expr_tag, expr, env,
                        out_sizes=(1, 1))
        bb.ret(vt, v)

    def numop_case(bb):
        vt, v = bb.call("eval_binop_num", expr_tag, expr, env,
                        out_sizes=(1, 1))
        bb.ret(vt, v)

    def misc_case(bb):
        vt, v = bb.call("eval_op_misc", expr_tag, expr, env,
                        out_sizes=(1, 1))
        bb.ret(vt, v)

    self_tags = (int(CompVal.Fun), int(CompVal.Thunk), int(CompVal.RestFun),
                 int(Tag.U64), int(Tag.Num), int(Tag.BigNum), int(Tag.Comm),
                 int(Tag.Char), int(Tag.Str), int(Tag.Key), int(Tag.Fun),
                 int(Tag.Cons), int(Tag.Env), int(Tag.Err),
                 int(InternalTag.T), int(InternalTag.Nil))
    b.match(expr_tag, [
        (self_tags, (self_eval, CaseType.CONSTRAINED)),
        ((int(Tag.Builtin), int(Tag.Sym), int(Tag.Coroutine)),
         (sym_case, CaseType.CONSTRAINED)),
        (int(CompVal.Fix), (fix_case_outer, CaseType.CONSTRAINED)),
        (int(CompOp.MkThunk), (mkthunk, CaseType.CONSTRAINED)),
        (int(CompOp.MkFun), (mkfun, CaseType.CONSTRAINED)),
        (int(CompOp.MkRestFun), (mkrestfun, CaseType.CONSTRAINED)),
        (int(CompOp.App), (app_case, CaseType.CONSTRAINED)),
        (_UNOPS, (unop_case, CaseType.UNCONSTRAINED)),
        (_BINOPS, (binop_case, CaseType.UNCONSTRAINED)),
        (_NUMOPS, (numop_case, CaseType.UNCONSTRAINED)),
    ], default=misc_case, default_case_type=CaseType.UNCONSTRAINED)
    return b.build()


def apply_func(digests):
    """Reference: eval_compiled.rs:239-302."""
    b = FuncBuilder("apply", ["fun_tag", "fun", "args_tag", "args", "env"],
                    2, partial=True)
    fun_tag = b.input("fun_tag")
    fun = b.input("fun")
    args_tag = b.input("args_tag")
    args = b.input("args")
    env = b.input("env")

    def fun_case(bb):
        param_tag, param, body_tag, body, fun_env = bb.load(
            fun, [1, 1, 1, 1, 1])

        def no_args(b2):
            b2.ret(fun_tag, fun)

        def mkcons_args(b2):
            arg_tag0, arg0, ra_tag, ra = b2.load(args, [1, 1, 1, 1])
            arg_tag, arg = b2.call("eval", arg_tag0, arg0, env,
                                   out_sizes=(1, 1))

            def arg_err(b3):
                b3.ret(arg_tag, arg)

            def cont(b3):
                ext_env = b3.store(param_tag, param, arg_tag, arg, fun_env)
                head_tag, head = b3.call("eval", body_tag, body, ext_env,
                                         out_sizes=(1, 1))

                def done(b4):
                    b4.ret(head_tag, head)

                def more(b4):
                    rt, r = b4.call("apply", head_tag, head, ra_tag, ra,
                                    env, out_sizes=(1, 1))
                    b4.ret(rt, r)
                b3.match(ra_tag, [(int(InternalTag.Nil), done)],
                         default=more)
            b2.match(arg_tag, [(int(Tag.Err), arg_err)], default=cont)
        bb.match(args_tag, [
            (int(InternalTag.Nil), no_args),
            (int(CompOp.MkCons), mkcons_args)])

    def restfun_case(bb):
        param_tag, param, body_tag, body, fun_env = bb.load(
            fun, [1, 1, 1, 1, 1])
        al_tag, al = bb.call("eval", args_tag, args, env, out_sizes=(1, 1))

        def err_case(b2):
            b2.ret(al_tag, al)

        def cont(b2):
            ext_env = b2.store(param_tag, param, al_tag, al, fun_env)
            rt, r = b2.call("eval", body_tag, body, ext_env,
                            out_sizes=(1, 1))
            b2.ret(rt, r)
        bb.match(al_tag, [(int(Tag.Err), err_case)], default=cont)

    def thunk_case(bb):
        body_tag, body, thunk_env = bb.load(fun, [1, 1, 1])
        val_tag, val = bb.call("eval", body_tag, body, thunk_env,
                               out_sizes=(1, 1))

        def done(b2):
            b2.ret(val_tag, val)

        def more(b2):
            rt, r = b2.call("apply", val_tag, val, args_tag, args, env,
                            out_sizes=(1, 1))
            b2.ret(rt, r)
        bb.match(args_tag, [(int(InternalTag.Nil), done)], default=more)

    def err_case(bb):
        bb.ret(fun_tag, fun)

    def non_func(bb):
        err_tag = bb.const(Tag.Err)
        err = bb.const(EvalErr.ApplyNonFunc)
        bb.ret(err_tag, err)

    b.match(fun_tag, [
        (int(CompVal.Fun), fun_case),
        (int(CompVal.RestFun), restfun_case),
        (int(CompVal.Thunk), thunk_case),
        (int(Tag.Err), err_case)], default=non_func)
    return b.build()


def eval_unop(digests):
    """Reference: eval_compiled.rs:304-446."""
    b = FuncBuilder("eval_unop", ["expr_tag", "expr", "env"], 2,
                    partial=True)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")
    env = b.input("env")

    def unop(bb):
        arg_tag0, arg0 = bb.load(expr, [1, 1])
        arg_tag, arg = bb.call("eval", arg_tag0, arg0, env,
                               out_sizes=(1, 1))

        def arg_err(b2):
            b2.ret(arg_tag, arg)

        def cont(b2):
            err_tag = b2.const(Tag.Err)
            nil_tag = b2.const(InternalTag.Nil)
            nil = b2.const(digests.lurk_symbol_ptr("nil"))

            def _car_cdr(b3, take_car):
                def cons_arg(b4):
                    car_tag, car, cdr_tag, cdr = b4.load(arg, [1, 1, 1, 1])
                    if take_car:
                        b4.ret(car_tag, car)
                    else:
                        b4.ret(cdr_tag, cdr)

                def nil_arg(b4):
                    b4.ret(nil_tag, nil)

                def str_arg(b4):
                    def nonempty(b5):
                        car_tag, car, cdr_tag, cdr = b5.load(
                            arg, [1, 1, 1, 1])
                        if take_car:
                            b5.ret(car_tag, car)
                        else:
                            b5.ret(cdr_tag, cdr)

                    def empty(b5):
                        b5.ret(nil_tag, nil)
                    b4.if_(arg, nonempty, empty)

                def not_cons(b4):
                    err = b4.const(EvalErr.NotCons)
                    b4.ret(err_tag, err)
                b3.match(arg_tag, [
                    (int(Tag.Cons), cons_arg),
                    (int(InternalTag.Nil), nil_arg),
                    (int(Tag.Str), str_arg)], default=not_cons)

            def car_case(b3):
                _car_cdr(b3, True)

            def cdr_case(b3):
                _car_cdr(b3, False)

            def atom_case(b3):
                def cons_arg(b4):
                    t_tag = b4.const(InternalTag.T)
                    t = b4.const(digests.lurk_symbol_ptr("t"))
                    b4.ret(t_tag, t)

                def other(b4):
                    b4.ret(nil_tag, nil)
                b3.match(arg_tag, [(int(Tag.Cons), cons_arg)],
                         default=other)

            def open_secret(b3):
                def comm_arg(b4):
                    comm_hash, = b4.load(arg, [8])
                    from .zstore import _digest_to_biguint_hex
                    secret, tag, padding, arg_digest = b4.preimg(
                        "hash3", comm_hash, out_sizes=(8, 1, 7, 8),
                        fmt=lambda vals: "Preimage not found for "
                        f"#{_digest_to_biguint_hex(vals[:8])}")

                    def open_case(b5):
                        full_tag, = b5.split([tag, padding], [8])
                        rt, r = b5.call("ingress", full_tag, arg_digest,
                                        out_sizes=(1, 1))
                        b5.ret(rt, r)

                    def secret_case(b5):
                        ptr = b5.store(secret)
                        bn_tag = b5.const(Tag.BigNum)
                        b5.ret(bn_tag, ptr)
                    b4.match(expr_tag, [
                        (int(CompOp.Open), open_case),
                        (int(CompOp.Secret), secret_case)])

                def cant_open(b4):
                    err = b4.const(EvalErr.CantOpen)
                    b4.ret(err_tag, err)
                b3.match(arg_tag, [
                    ((int(Tag.Comm), int(Tag.BigNum)), comm_arg)],
                    default=cant_open)

            def u64_case(b3):
                def u64_arg(b4):
                    b4.ret(arg_tag, arg)

                def char_arg(b4):
                    bytes_, = b4.load(arg, [4])
                    padding = b4.array([0] * 4)
                    val = b4.store(bytes_, padding)
                    vt = b4.const(Tag.U64)
                    b4.ret(vt, val)

                def cant(b4):
                    err = b4.const(EvalErr.CantCastToU64)
                    b4.ret(err_tag, err)
                b3.match(arg_tag, [
                    (int(Tag.U64), u64_arg),
                    (int(Tag.Char), char_arg)], default=cant)

            def emit_case(b3):
                b3.emit(arg_tag, arg)
                b3.ret(arg_tag, arg)

            def comm_case(b3):
                def bignum_arg(b4):
                    ct = b4.const(Tag.Comm)
                    b4.ret(ct, arg)

                def comm_arg(b4):
                    b4.ret(arg_tag, arg)

                def cant(b4):
                    err = b4.const(EvalErr.CantCastToComm)
                    b4.ret(err_tag, err)
                b3.match(arg_tag, [
                    (int(Tag.BigNum), bignum_arg),
                    (int(Tag.Comm), comm_arg)], default=cant)

            def char_case(b3):
                def char_arg(b4):
                    b4.ret(arg_tag, arg)

                def u64_arg(b4):
                    bytes_, _ignored = b4.load(arg, [4, 4])
                    ptr = b4.store(bytes_)
                    ct = b4.const(Tag.Char)
                    b4.ret(ct, ptr)

                def cant(b4):
                    err = b4.const(EvalErr.CantCastToChar)
                    b4.ret(err_tag, err)
                b3.match(arg_tag, [
                    (int(Tag.Char), char_arg),
                    (int(Tag.U64), u64_arg)], default=cant)

            b2.match(expr_tag, [
                (int(CompOp.Car), car_case),
                (int(CompOp.Cdr), cdr_case),
                (int(CompOp.Atom), atom_case),
                ((int(CompOp.Open), int(CompOp.Secret)), open_secret),
                (int(CompOp.U64), u64_case),
                (int(CompOp.Emit), emit_case),
                (int(CompOp.Comm), comm_case),
                (int(CompOp.Char), char_case)])
        bb.match(arg_tag, [(int(Tag.Err), arg_err)], default=cont)
    b.match(expr_tag, [(_UNOPS, unop)])
    return b.build()


def eval_binop(digests):
    """Reference: eval_compiled.rs:448-541."""
    b = FuncBuilder("eval_binop", ["expr_tag", "expr", "env"], 2,
                    partial=True)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")
    env = b.input("env")

    def binop(bb):
        e1_tag, e1, e2_tag, e2 = bb.load(expr, [1, 1, 1, 1])
        v1_tag, v1 = bb.call("eval", e1_tag, e1, env, out_sizes=(1, 1))

        def err1(b2):
            b2.ret(v1_tag, v1)

        def cont(b2):
            v2_tag, v2 = b2.call("eval", e2_tag, e2, env, out_sizes=(1, 1))

            def err2(b3):
                b3.ret(v2_tag, v2)

            def cont2(b3):
                def mkcons(b4):
                    ct = b4.const(Tag.Cons)
                    ptr = b4.store(v1_tag, v1, v2_tag, v2)
                    b4.ret(ct, ptr)

                def mkstrcons(b4):
                    err_tag = b4.const(Tag.Err)
                    char_tag = b4.const(Tag.Char)
                    str_tag = b4.const(Tag.Str)
                    strcons = b4.store(v1_tag, v1, v2_tag, v2)
                    not_char = b4.sub(v1_tag, char_tag)
                    not_str = b4.sub(v2_tag, str_tag)

                    def bad_char(b5):
                        err = b5.const(EvalErr.NotChar)
                        b5.ret(err_tag, err)

                    def check_str(b5):
                        def bad_str(b6):
                            err = b6.const(EvalErr.NotString)
                            b6.ret(err_tag, err)

                        def ok(b6):
                            b6.ret(str_tag, strcons)
                        b5.if_(not_str, bad_str, ok)
                    b4.if_(not_char, bad_char, check_str)

                def begin(b4):
                    b4.ret(v2_tag, v2)

                def hide(b4):
                    err_tag = b4.const(Tag.Err)

                    def bignum_secret(b5):
                        secret, = b5.load(v1, [8])
                        vt, vd = b5.call("egress", v2_tag, v2,
                                         out_sizes=(1, 8))
                        padding = b5.array([0] * 7)
                        comm_hash, = b5.call("hash3", secret, vt, padding,
                                             vd, out_sizes=(8,))
                        comm_ptr = b5.store(comm_hash)
                        comm_tag = b5.const(Tag.Comm)
                        b5.ret(comm_tag, comm_ptr)

                    def not_bignum(b5):
                        err = b5.const(EvalErr.NotBigNum)
                        b5.ret(err_tag, err)
                    b4.match(v1_tag, [(int(Tag.BigNum), bignum_secret)],
                             default=not_bignum)

                def eq(b4):
                    is_eq, = b4.call("equal_inner", v1_tag, v1, v2_tag, v2,
                                     out_sizes=(1,))

                    def eq_t(b5):
                        t_tag = b5.const(InternalTag.T)
                        t = b5.const(digests.lurk_symbol_ptr("t"))
                        b5.ret(t_tag, t)

                    def eq_nil(b5):
                        nil_tag = b5.const(InternalTag.Nil)
                        nil = b5.const(digests.lurk_symbol_ptr("nil"))
                        b5.ret(nil_tag, nil)
                    b4.if_(is_eq, eq_t, eq_nil)

                def type_eq(b4):
                    type_not_eq = b4.sub(v1_tag, v2_tag)

                    # NOTE: mirrors the reference exactly, including its
                    # inverted truth value (eval_compiled.rs:525-535
                    # returns t when the tags *differ*)
                    def ne(b5):
                        t_tag = b5.const(InternalTag.T)
                        t = b5.const(digests.lurk_symbol_ptr("t"))
                        b5.ret(t_tag, t)

                    def same(b5):
                        nil_tag = b5.const(InternalTag.Nil)
                        nil = b5.const(digests.lurk_symbol_ptr("nil"))
                        b5.ret(nil_tag, nil)
                    b4.if_(type_not_eq, ne, same)

                b3.match(expr_tag, [
                    (int(CompOp.MkCons), mkcons),
                    (int(CompOp.MkStrcons), mkstrcons),
                    (int(CompOp.Begin), begin),
                    (int(CompOp.Hide), hide),
                    (int(CompOp.Eq), eq),
                    (int(CompOp.TypeEq), type_eq)])
            b2.match(v2_tag, [(int(Tag.Err), err2)], default=cont2)
        bb.match(v1_tag, [(int(Tag.Err), err1)], default=cont)
    b.match(expr_tag, [(_BINOPS, binop)])
    return b.build()


def eval_binop_num(digests):
    """Reference: eval_compiled.rs:543-713."""
    b = FuncBuilder("eval_binop_num", ["expr_tag", "expr", "env"], 2,
                    partial=True)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")
    env = b.input("env")

    def numop(bb):
        err_tag = bb.const(Tag.Err)
        num_tag = bb.const(Tag.Num)
        u64_tag = bb.const(Tag.U64)
        err_div_zero = bb.const(EvalErr.DivByZero)
        nil = bb.const(digests.lurk_symbol_ptr("nil"))
        nil_tag = bb.const(InternalTag.Nil)
        t = bb.const(digests.lurk_symbol_ptr("t"))
        t_tag = bb.const(InternalTag.T)

        e1_tag, e1, e2_tag, e2 = bb.load(expr, [1, 1, 1, 1])
        v1_tag, v1 = bb.call("eval", e1_tag, e1, env, out_sizes=(1, 1))

        def err1(b2):
            b2.ret(v1_tag, v1)

        def cont(b2):
            v2_tag, v2 = b2.call("eval", e2_tag, e2, env, out_sizes=(1, 1))

            def err2(b3):
                b3.ret(v2_tag, v2)

            def cont2(b3):
                tags, = b3.split([v1_tag, v2_tag], [2])

                def ret_bool(b4, res, true_first):
                    def yes(b5):
                        if true_first:
                            b5.ret(t_tag, t)
                        else:
                            b5.ret(nil_tag, nil)

                    def no(b5):
                        if true_first:
                            b5.ret(nil_tag, nil)
                        else:
                            b5.ret(t_tag, t)
                    b4.if_(res, yes, no)

                def u64_u64(b4):
                    def add_(b5):
                        res, = b5.call("u64_add", v1, v2, out_sizes=(1,))
                        b5.ret(u64_tag, res)

                    def sub_(b5):
                        res, = b5.call("u64_sub", v1, v2, out_sizes=(1,))
                        b5.ret(u64_tag, res)

                    def mul_(b5):
                        res, = b5.call("u64_mul", v1, v2, out_sizes=(1,))
                        b5.ret(u64_tag, res)

                    def divmod_(b5):
                        is_zero, = b5.call("u64_iszero", v2, out_sizes=(1,))

                        def zero(b6):
                            b6.ret(err_tag, err_div_zero)

                        def nonzero(b6):
                            quot, rem = b6.call("u64_divrem", v1, v2,
                                                out_sizes=(1, 1))

                            def div_case(b7):
                                b7.ret(u64_tag, quot)

                            def mod_case(b7):
                                b7.ret(u64_tag, rem)
                            b6.match(expr_tag, [
                                (int(CompOp.Div), div_case),
                                (int(CompOp.Mod), mod_case)])
                        b5.if_(is_zero, zero, nonzero)

                    def less(b5):
                        res, = b5.call("u64_lessthan", v1, v2,
                                       out_sizes=(1,))
                        ret_bool(b5, res, True)

                    def greateq(b5):
                        res, = b5.call("u64_lessthan", v1, v2,
                                       out_sizes=(1,))
                        ret_bool(b5, res, False)

                    def great(b5):
                        res, = b5.call("u64_lessthan", v2, v1,
                                       out_sizes=(1,))
                        ret_bool(b5, res, True)

                    def lesseq(b5):
                        res, = b5.call("u64_lessthan", v2, v1,
                                       out_sizes=(1,))
                        ret_bool(b5, res, False)

                    def numeq(b5):
                        res, = b5.call("digest_equal", v1, v2,
                                       out_sizes=(1,))
                        ret_bool(b5, res, True)
                    b4.match(expr_tag, [
                        (int(CompOp.Add), add_),
                        (int(CompOp.Sub), sub_),
                        (int(CompOp.Mul), mul_),
                        ((int(CompOp.Div), int(CompOp.Mod)), divmod_),
                        (int(CompOp.Less), less),
                        (int(CompOp.GreatEq), greateq),
                        (int(CompOp.Great), great),
                        (int(CompOp.LessEq), lesseq),
                        (int(CompOp.NumEq), numeq)])

                def num_num(b4):
                    def add_(b5):
                        res = b5.add(v1, v2)
                        b5.ret(num_tag, res)

                    def sub_(b5):
                        res = b5.sub(v1, v2)
                        b5.ret(num_tag, res)

                    def mul_(b5):
                        res = b5.mul(v1, v2)
                        b5.ret(num_tag, res)

                    def div_(b5):
                        def zero(b6):
                            b6.ret(err_tag, err_div_zero)

                        def nonzero(b6):
                            res = b6.div(v1, v2)
                            b6.ret(num_tag, res)
                        b5.if_(v2, nonzero, zero)

                    def numeq(b5):
                        diff = b5.sub(v1, v2)

                        def ne(b6):
                            b6.ret(nil_tag, nil)

                        def same(b6):
                            b6.ret(t_tag, t)
                        b5.if_(diff, ne, same)

                    def not_u64(b5):
                        err = b5.const(EvalErr.NotU64)
                        b5.ret(err_tag, err)
                    b4.match(expr_tag, [
                        (int(CompOp.Add), add_),
                        (int(CompOp.Sub), sub_),
                        (int(CompOp.Mul), mul_),
                        (int(CompOp.Div), div_),
                        (int(CompOp.NumEq), numeq),
                        ((int(CompOp.Mod), int(CompOp.Less),
                          int(CompOp.Great), int(CompOp.LessEq),
                          int(CompOp.GreatEq)), not_u64)])

                def big_big(b4):
                    def less(b5):
                        res, = b5.call("big_num_lessthan", v1, v2,
                                       out_sizes=(1,))
                        ret_bool(b5, res, True)

                    def greateq(b5):
                        res, = b5.call("big_num_lessthan", v1, v2,
                                       out_sizes=(1,))
                        ret_bool(b5, res, False)

                    def great(b5):
                        res, = b5.call("big_num_lessthan", v2, v1,
                                       out_sizes=(1,))
                        ret_bool(b5, res, True)

                    def lesseq(b5):
                        res, = b5.call("big_num_lessthan", v2, v1,
                                       out_sizes=(1,))
                        ret_bool(b5, res, False)

                    def numeq(b5):
                        res, = b5.call("digest_equal", v2, v1,
                                       out_sizes=(1,))
                        ret_bool(b5, res, True)

                    def invalid(b5):
                        err = b5.const(EvalErr.InvalidArg)
                        b5.ret(err_tag, err)
                    b4.match(expr_tag, [
                        (int(CompOp.Less), less),
                        (int(CompOp.GreatEq), greateq),
                        (int(CompOp.Great), great),
                        (int(CompOp.LessEq), lesseq),
                        (int(CompOp.NumEq), numeq),
                        ((int(CompOp.Add), int(CompOp.Sub),
                          int(CompOp.Mul), int(CompOp.Div),
                          int(CompOp.Mod)), invalid)])

                def invalid_args(b4):
                    err = b4.const(EvalErr.InvalidArg)
                    b4.ret(err_tag, err)
                b3.match_many(tags, [
                    ((int(Tag.U64), int(Tag.U64)), u64_u64),
                    ((int(Tag.Num), int(Tag.Num)), num_num),
                    ((int(Tag.BigNum), int(Tag.BigNum)), big_big)],
                    default=invalid_args)
            b2.match(v2_tag, [(int(Tag.Err), err2)], default=cont2)
        bb.match(v1_tag, [(int(Tag.Err), err1)], default=cont)
    b.match(expr_tag, [(_NUMOPS, numop)])
    return b.build()


def eval_op_misc(digests):
    """Reference: eval_compiled.rs:715-808."""
    b = FuncBuilder("eval_op_misc", ["expr_tag", "expr", "env"], 2,
                    partial=True)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")
    env = b.input("env")

    def empty_env(bb):
        env_tag = bb.const(Tag.Env)
        null = bb.const(0)
        bb.ret(env_tag, null)

    def current_env(bb):
        env_tag = bb.const(Tag.Env)
        bb.ret(env_tag, env)

    def quote(bb):
        rt, r = bb.load(expr, [1, 1])
        bb.ret(rt, r)

    def fail(bb):
        zero = bb.const(0)
        one = bb.const(1)
        bb.assert_eq(zero, one,
                     fmt=lambda a, b_: "Explicit fail encountered")
        bb.ret(zero, zero)

    def let_case(bb):
        param_tag, param, val_tag0, val0, body_tag, body = bb.load(
            expr, [1, 1, 1, 1, 1, 1])
        val_tag, val = bb.call("eval", val_tag0, val0, env,
                               out_sizes=(1, 1))

        def err_case(b2):
            b2.ret(val_tag, val)

        def cont(b2):
            ext_env = b2.store(param_tag, param, val_tag, val, env)
            rt, r = b2.call("eval", body_tag, body, ext_env,
                            out_sizes=(1, 1))
            b2.ret(rt, r)
        bb.match(val_tag, [(int(Tag.Err), err_case)], default=cont)

    def letrec_case(bb):
        binds, body_tag, body = bb.load(expr, [1, 1, 1])
        ext_env, = bb.call("extend_env_with_mutuals", binds, binds, env,
                           out_sizes=(1,))
        rt, r = bb.call("eval_mutual_bindings", env, ext_env,
                        out_sizes=(1, 1))

        def err_case(b2):
            b2.ret(rt, r)

        def cont(b2):
            rt2, r2 = b2.call("eval", body_tag, body, ext_env,
                              out_sizes=(1, 1))
            b2.ret(rt2, r2)
        bb.match(rt, [(int(Tag.Err), err_case)], default=cont)

    def if_case(bb):
        b_tag0, b0, t_tag, tb, f_tag, fb = bb.load(expr,
                                                   [1, 1, 1, 1, 1, 1])
        b_tag, bv = bb.call("eval", b_tag0, b0, env, out_sizes=(1, 1))

        def nil_case(b2):
            rt, r = b2.call("eval", f_tag, fb, env, out_sizes=(1, 1))
            b2.ret(rt, r)

        def err_case(b2):
            b2.ret(b_tag, bv)

        def truthy(b2):
            rt, r = b2.call("eval", t_tag, tb, env, out_sizes=(1, 1))
            b2.ret(rt, r)
        bb.match(b_tag, [
            (int(InternalTag.Nil), nil_case),
            (int(Tag.Err), err_case)], default=truthy)

    def todo(bb):
        err_tag = bb.const(Tag.Err)
        err = bb.const(EvalErr.Todo)
        bb.ret(err_tag, err)

    b.match(expr_tag, [
        (int(CompOp.EmptyEnv), empty_env),
        (int(CompOp.CurrentEnv), current_env),
        (int(CompOp.Quote), quote),
        (int(CompOp.Fail), fail),
        (int(CompOp.Let), let_case),
        (int(CompOp.Letrec), letrec_case),
        (int(CompOp.If), if_case),
        ((int(CompOp.App), int(CompOp.Apply), int(CompOp.And),
          int(CompOp.Or), int(CompOp.Not), int(CompOp.Eval),
          int(CompOp.Breakpoint)), todo),
        ((int(CompOp.Eqq), int(CompOp.TypeEqq)), todo)])
    return b.build()


def equal_inner():
    """Reference: eval_compiled.rs:810-885."""
    b = FuncBuilder("equal_inner", ["a_tag", "a", "b_tag", "b"], 1)
    a_tag = b.input("a_tag")
    a = b.input("a")
    b_tag = b.input("b_tag")
    bv = b.input("b")
    not_eq_tag = b.sub(a_tag, b_tag)
    zero = b.const(0)
    one = b.const(1)

    def tags_differ(bb):
        bb.ret(zero)

    def tags_same(bb):
        not_eq = bb.sub(a, bv)

        def ptr_eq(b2):
            b2.ret(one)

        def ptr_ne(b2):
            def num_case(b3):
                b3.ret(zero)

            def char_case(b3):
                a_bytes, = b3.load(a, [4])
                b_bytes, = b3.load(bv, [4])
                diff = b3.sub(a_bytes, b_bytes)

                def d(b4):
                    b4.ret(zero)

                def s(b4):
                    b4.ret(one)
                b3.if_(diff, d, s)

            def digest_case(b3):
                a_digest, = b3.load(a, [8])
                b_digest, = b3.load(bv, [8])
                diff = b3.sub(a_digest, b_digest)

                def d(b4):
                    b4.ret(zero)

                def s(b4):
                    b4.ret(one)
                b3.if_(diff, d, s)

            def str_case(b3):
                a_and_b = b3.mul(a, bv)

                def nonzero(b4):
                    a_fst, a_snd = b4.load(a, [2, 2])
                    b_fst, b_snd = b4.load(bv, [2, 2])
                    fst_eq, = b4.call("equal_inner", a_fst, b_fst,
                                      out_sizes=(1,))
                    snd_eq, = b4.call("equal_inner", a_snd, b_snd,
                                      out_sizes=(1,))
                    eq = b4.mul(fst_eq, snd_eq)
                    b4.ret(eq)

                def zero_ptr(b4):
                    b4.ret(zero)
                b3.if_(a_and_b, nonzero, zero_ptr)

            def cons_case(b3):
                a_fst, a_snd = b3.load(a, [2, 2])
                b_fst, b_snd = b3.load(bv, [2, 2])
                fst_eq, = b3.call("equal_inner", a_fst, b_fst,
                                  out_sizes=(1,))
                snd_eq, = b3.call("equal_inner", a_snd, b_snd,
                                  out_sizes=(1,))
                eq = b3.mul(fst_eq, snd_eq)
                b3.ret(eq)

            def env_case(b3):
                a_and_b = b3.mul(a, bv)

                def nonzero(b4):
                    a_fst, a_snd, a_trd = b4.load(a, [2, 2, 1])
                    b_fst, b_snd, b_trd = b4.load(bv, [2, 2, 1])
                    fst_eq, = b4.call("equal_inner", a_fst, b_fst,
                                      out_sizes=(1,))
                    snd_eq, = b4.call("equal_inner", a_snd, b_snd,
                                      out_sizes=(1,))
                    # a_tag is Tag::Env for both sides
                    trd_eq, = b4.call("equal_inner", a_tag, a_trd,
                                      a_tag, b_trd, out_sizes=(1,))
                    eq = b4.mul(fst_eq, snd_eq)
                    eq = b4.mul(eq, trd_eq)
                    b4.ret(eq)

                def zero_ptr(b4):
                    b4.ret(zero)
                b3.if_(a_and_b, nonzero, zero_ptr)

            def closure_case(b3):
                b3.ret(zero)

            b2.match(a_tag, [
                (int(Tag.Num), num_case),
                (int(Tag.Char), char_case),
                ((int(Tag.Key), int(Tag.Sym), int(Tag.Builtin),
                  int(Tag.Coroutine), int(Tag.U64), int(Tag.BigNum),
                  int(Tag.Comm)), digest_case),
                (int(Tag.Str), str_case),
                (int(Tag.Cons), cons_case),
                (int(Tag.Env), env_case),
                ((int(CompVal.RestFun), int(CompVal.Fun),
                  int(CompVal.Fix), int(CompVal.Thunk)), closure_case)])
        bb.if_(not_eq, ptr_ne, ptr_eq)
    b.if_(not_eq_tag, tags_differ, tags_same)
    return b.build()


def env_lookup():
    """Reference: eval_compiled.rs:887-908."""
    b = FuncBuilder("env_lookup", [("x_tag_digest", 9), "env"], 2)
    x_tag_digest = b.input("x_tag_digest")
    env = b.input("env")

    def nonzero(bb):
        y_tag, y, val_tag, val, tail_env = bb.load(env, [1, 1, 1, 1, 1])
        y_digest, = bb.load(y, [8])
        y_tag_digest, = bb.split([y_tag, y_digest], [9])
        not_eq = bb.sub(x_tag_digest, y_tag_digest)

        def differ(b2):
            rt, r = b2.call("env_lookup", x_tag_digest, tail_env,
                            out_sizes=(1, 1))
            b2.ret(rt, r)

        def same(b2):
            b2.ret(val_tag, val)
        bb.if_(not_eq, differ, same)

    def zero(bb):
        err_tag = bb.const(Tag.Err)
        err = bb.const(EvalErr.UnboundVar)
        bb.ret(err_tag, err)
    b.if_(env, nonzero, zero)
    return b.build()


def extend_env_with_mutuals():
    """Reference: eval_compiled.rs:910-925."""
    b = FuncBuilder("extend_env_with_mutuals",
                    ["binds", "mutual_binds", "mutual_env"], 1)
    binds = b.input("binds")
    mutual_binds = b.input("mutual_binds")
    mutual_env = b.input("mutual_env")

    def nonzero(bb):
        var_tag, var, expr_tag, expr, binds2 = bb.load(binds,
                                                       [1, 1, 1, 1, 1])
        ext_env, = bb.call("extend_env_with_mutuals", binds2, mutual_binds,
                           mutual_env, out_sizes=(1,))
        fix_tag = bb.const(CompVal.Fix)
        fix = bb.store(expr_tag, expr, mutual_binds, mutual_env)
        res_env = bb.store(var_tag, var, fix_tag, fix, ext_env)
        bb.ret(res_env)

    def zero(bb):
        bb.ret(mutual_env)
    b.if_(binds, nonzero, zero)
    return b.build()


def eval_mutual_bindings():
    """Reference: eval_compiled.rs:927-957."""
    b = FuncBuilder("eval_mutual_bindings", ["init_env", "ext_env"], 2,
                    partial=True)
    init_env = b.input("init_env")
    ext_env = b.input("ext_env")
    not_eq = b.sub(ext_env, init_env)

    def done(bb):
        env_tag = bb.const(Tag.Env)
        bb.ret(env_tag, init_env)

    def step(bb):
        _vt, _v, val_tag, val, ext2 = bb.load(ext_env, [1, 1, 1, 1, 1])
        fix_tag = bb.const(CompVal.Fix)
        # safety: letrec bindings must be fixed points
        bb.assert_eq(fix_tag, val_tag)
        null_env = bb.const(0)
        rt, r = bb.call("eval", val_tag, val, null_env, out_sizes=(1, 1))

        def err_case(b2):
            b2.ret(rt, r)

        def cont(b2):
            rt2, r2 = b2.call("eval_mutual_bindings", init_env, ext2,
                              out_sizes=(1, 1))
            b2.ret(rt2, r2)
        bb.match(rt, [(int(Tag.Err), err_case)], default=cont)
    b.if_(not_eq, step, done)
    return b.build()


def native_lurk_funcs(digests, coroutines=None):
    """Reference: eval_compiled.rs:38-85 - order is part of the protocol."""
    return [
        lurk_main(),
        preallocate_symbols(digests),
        misc.hash3(),
        misc.hash4(),
        misc.hash5(),
        misc.u64_add(),
        misc.u64_sub(),
        misc.u64_mul(),
        misc.u64_divrem(),
        misc.u64_lessthan(),
        misc.u64_iszero(),
        misc.digest_equal(),
        misc.big_num_lessthan(),
        ingress(digests),
        egress(digests),
        *compile_funcs(digests),
        eval_func(digests),
        apply_func(digests),
        eval_unop(digests),
        eval_binop(digests),
        eval_binop_num(digests),
        eval_op_misc(digests),
        extend_env_with_mutuals(),
        eval_mutual_bindings(),
        env_lookup(),
        equal_inner(),
    ]


def build_lurk_toplevel(lang=None):
    """Compiled-pipeline toplevel (reference: eval_compiled.rs:89-127)."""
    coroutines = lang.coroutines if lang is not None else {}
    gadgets = lang.gadgets if lang is not None else {}
    lang_symbols = set(coroutines.keys())
    zstore = lurk_zstore(lang_symbols)
    digests = SymbolsDigests(zstore, sorted(lang_symbols,
                                            key=lambda s: s.path))
    funcs = native_lurk_funcs(digests, coroutines)
    names = {f.name for f in funcs}
    for coroutine in coroutines.values():
        fe = coroutine.func_expr
        assert fe.name not in names, \
            f"Name conflict with native function {fe.name}"
        funcs.append(fe)
        names.add(fe.name)
    chip_map = lurk_chip_map(gadgets)
    toplevel = Toplevel(funcs, chip_map)
    return toplevel, zstore, lang_symbols
