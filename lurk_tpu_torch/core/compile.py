"""The Lurk compiler: AST -> compact opcode form (the alternative
"compiled" evaluation pipeline).

Faithful port of reference: src/core/compile.rs. `Op` opcodes live at
0x1000+, runtime `Val`s at 0x10000+ (compile.rs:14-106); `compile` lowers
builtin application forms into dedicated opcode nodes, `convert_data` /
`deconvert_data` translate runtime values (funs, envs, fixpoints) between
the direct and compiled representations.

One deliberate divergence: the reference's `convert_data` reads environment
entries as 4-wide tuples (compile.rs:930) while ingress, `env_lookup` and
`deconvert_data` all use the 5-wide (var_tag, var, val_tag, val, env)
layout - a latent width mismatch that breaks conversion of non-empty
environments. Here `convert_data` uses the 5-wide layout consistently.
"""

from __future__ import annotations

from enum import IntEnum

from ..lair.dsl import FuncBuilder
from .tag import Tag, InternalTag, EvalErr


class CompOp(IntEnum):
    """Compiled opcodes (reference: compile.rs:16-72)."""
    If = 0x00001000
    Let = 0x00001001
    Letrec = 0x00001002
    MkFun = 0x00001003
    MkThunk = 0x00001004
    MkRestFun = 0x00001005
    App = 0x00001006
    Apply = 0x00001007
    Eq = 0x00001008
    Eqq = 0x00001009
    TypeEq = 0x0000100A
    TypeEqq = 0x0000100B
    NumEq = 0x0000100C
    And = 0x0000100D
    Or = 0x0000100E
    Not = 0x0000100F
    Add = 0x00001010
    Sub = 0x00001011
    Mul = 0x00001012
    Div = 0x00001013
    Mod = 0x00001014
    Less = 0x00001015
    LessEq = 0x00001016
    Great = 0x00001017
    GreatEq = 0x00001018
    MkCons = 0x00001019
    Car = 0x0000101A
    Cdr = 0x0000101B
    Atom = 0x0000101C
    MkStrcons = 0x0000101D
    Hide = 0x0000101E
    Open = 0x0000101F
    Secret = 0x00001020
    Eval = 0x00001021
    Quote = 0x00001022
    CurrentEnv = 0x00001023
    EmptyEnv = 0x00001024
    U64 = 0x00001025
    Char = 0x00001026
    Comm = 0x00001027
    Bignum = 0x00001028
    Emit = 0x00001029
    Begin = 0x0000102A
    Fail = 0x0000102B
    Breakpoint = 0x0000102C


class CompVal(IntEnum):
    """Compiled runtime values (reference: compile.rs:87-93)."""
    Fun = 0x00010000
    Thunk = 0x00010001
    RestFun = 0x00010002
    Fix = 0x00010003


# symbol name -> opcode (reference: compile.rs:427-598 symbol_to_op)
SYMBOL_TO_OP = {
    "list": CompOp.MkCons, "lambda": CompOp.MkFun, "atom": CompOp.Atom,
    "apply": CompOp.Apply, "begin": CompOp.Begin, "car": CompOp.Car,
    "cdr": CompOp.Cdr, "char": CompOp.Char, "commit": CompOp.Hide,
    "comm": CompOp.Comm, "bignum": CompOp.Bignum, "cons": CompOp.MkCons,
    "current-env": CompOp.CurrentEnv, "emit": CompOp.Emit,
    "empty-env": CompOp.EmptyEnv, "eval": CompOp.Eval, "eq": CompOp.Eq,
    "eqq": CompOp.Eqq, "type-eq": CompOp.TypeEq, "type-eqq": CompOp.TypeEqq,
    "hide": CompOp.Hide, "if": CompOp.If, "let": CompOp.Let,
    "letrec": CompOp.Letrec, "u64": CompOp.U64, "open": CompOp.Open,
    "quote": CompOp.Quote, "secret": CompOp.Secret,
    "strcons": CompOp.MkStrcons, "+": CompOp.Add, "-": CompOp.Sub,
    "*": CompOp.Mul, "/": CompOp.Div, "%": CompOp.Mod, "=": CompOp.NumEq,
    "<": CompOp.Less, ">": CompOp.Great, "<=": CompOp.LessEq,
    ">=": CompOp.GreatEq, "breakpoint": CompOp.Breakpoint,
    "fail": CompOp.Fail,
}


def symbol_to_op(digests):
    """Reference: compile.rs:427-600."""
    b = FuncBuilder("symbol_to_op", ["builtin"], 1)
    builtin = b.input("builtin")
    branches = []
    for name, op in SYMBOL_TO_OP.items():
        def case(bb, op=op):
            tag = bb.const(int(op))
            bb.ret(tag)
        branches.append((digests.builtin_symbol_ptr(name), case))
    b.match(builtin, branches)
    return b.build()


def compile_fn(digests):
    """Reference: compile.rs:108-425."""
    b = FuncBuilder("compile", ["expr_tag", "expr"], 2, invertible=True)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")
    err_tag = b.const(Tag.Err)
    invalid_form = b.const(EvalErr.InvalidForm)

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def check_compiled(bb, tag, val, cont):
        """match tag { Err => return }; cont"""
        def err_case(b2):
            b2.ret(tag, val)
        bb.match(tag, [(int(Tag.Err), err_case)], default=cont)

    def case_cons(bb):
        nil_tag = bb.const(InternalTag.Nil)
        cons_tag = bb.const(Tag.Cons)
        head_tag, head, rest_tag, rest = bb.load(expr, [1, 1, 1, 1])

        def builtin_head(b2):
            op, = b2.call("symbol_to_op", head)

            def zero_elts(b3):
                rest_not_nil = b3.sub(rest_tag, nil_tag)

                def ok(b4):
                    null = b4.const(0)
                    b4.ret(op, null)
                b3.if_(rest_not_nil, ret_err, ok)

            def one_elt(b3):
                rest_not_cons = b3.sub(rest_tag, cons_tag)

                def cont(b4):
                    arg_tag, arg, rest2_tag, _r = b4.load(rest, [1, 1, 1, 1])
                    rest_not_nil = b4.sub(rest2_tag, nil_tag)

                    def cont2(b5):
                        cexpr_tag, cexpr = b5.call("compile", arg_tag, arg,
                                                   out_sizes=(1, 1))

                        def cont3(b6):
                            def commit_case(b7):
                                # commit = hide with the zero secret
                                bignum_content = b7.array([0] * 8)
                                bignum = b7.store(bignum_content)
                                bignum_tag = b7.const(Tag.BigNum)
                                ptr = b7.store(bignum_tag, bignum,
                                               cexpr_tag, cexpr)
                                b7.ret(op, ptr)

                            def dflt(b7):
                                ptr = b7.store(cexpr_tag, cexpr)
                                b7.ret(op, ptr)
                            b6.match(head, [
                                (digests.builtin_symbol_ptr("commit"),
                                 commit_case)], default=dflt)
                        check_compiled(b5, cexpr_tag, cexpr, cont3)
                    b4.if_(rest_not_nil, ret_err, cont2)
                b3.if_(rest_not_cons, ret_err, cont)

            def two_elts(b3):
                rest_not_cons = b3.sub(rest_tag, cons_tag)

                def cont(b4):
                    fst_tag, fst, r2_tag, r2 = b4.load(rest, [1, 1, 1, 1])
                    r2_not_cons = b4.sub(r2_tag, cons_tag)

                    def cont2(b5):
                        snd_tag, snd, r3_tag, _r3 = b5.load(r2, [1, 1, 1, 1])
                        r3_not_nil = b5.sub(r3_tag, nil_tag)

                        def cont3(b6):
                            cfst_tag, cfst = b6.call("compile", fst_tag, fst,
                                                     out_sizes=(1, 1))

                            def cont4(b7):
                                csnd_tag, csnd = b7.call(
                                    "compile", snd_tag, snd, out_sizes=(1, 1))

                                def cont5(b8):
                                    ptr = b8.store(cfst_tag, cfst,
                                                   csnd_tag, csnd)
                                    b8.ret(op, ptr)
                                check_compiled(b7, csnd_tag, csnd, cont5)
                            check_compiled(b6, cfst_tag, cfst, cont4)
                        b5.if_(r3_not_nil, ret_err, cont3)
                    b4.if_(r2_not_cons, ret_err, cont2)
                b3.if_(rest_not_cons, ret_err, cont)

            def variadic(b3):
                u64_tag = b3.const(Tag.U64)
                o = b3.const(0)

                def nil_case(b4):
                    def zero_id(b5):
                        zero = b5.store(o, o, o, o, o, o, o, o)
                        b5.ret(u64_tag, zero)

                    def one_id(b5):
                        i = b5.const(1)
                        one = b5.store(i, o, o, o, o, o, o, o)
                        b5.ret(u64_tag, one)

                    def begin_id(b5):
                        nil = b5.const(digests.lurk_symbol_ptr("nil"))
                        b5.ret(nil_tag, nil)
                    b4.match(head, [
                        (tuple(digests.builtin_symbol_ptr(s)
                               for s in ("+", "-", "*")), zero_id),
                        (tuple(digests.builtin_symbol_ptr(s)
                               for s in ("/", "%")), one_id),
                        (digests.builtin_symbol_ptr("begin"), begin_id),
                    ])

                def cons_case(b4):
                    init_tag, init, r_tag, r = b4.load(rest, [1, 1, 1, 1])
                    cinit_tag, cinit = b4.call("compile", init_tag, init,
                                               out_sizes=(1, 1))

                    def cont(b5):
                        res_tag, res = b5.call(
                            "compile_fold_left", op, cinit_tag, cinit,
                            r_tag, r, out_sizes=(1, 1))
                        b5.ret(res_tag, res)
                    check_compiled(b4, cinit_tag, cinit, cont)
                b3.match(rest_tag, [
                    (int(InternalTag.Nil), nil_case),
                    (int(Tag.Cons), cons_case)], default=ret_err)

            def relational(b3):
                res_tag, res = b3.call("compile_fold_rel", op, rest_tag,
                                       rest, out_sizes=(1, 1))
                b3.ret(res_tag, res)

            def list_form(b3):
                nil = b3.const(digests.lurk_symbol_ptr("nil"))
                res_tag, res = b3.call("compile_fold_right", op, nil_tag,
                                       nil, rest_tag, rest, out_sizes=(1, 1))
                b3.ret(res_tag, res)

            def binder_forms(b3):
                rest_not_cons = b3.sub(rest_tag, cons_tag)

                def cont(b4):
                    fst_tag, fst, r2_tag, r2 = b4.load(rest, [1, 1, 1, 1])
                    r2_not_cons = b4.sub(r2_tag, cons_tag)

                    def cont2(b5):
                        snd_tag, snd, r3_tag, _r3 = b5.load(r2, [1, 1, 1, 1])
                        r3_not_nil = b5.sub(r3_tag, nil_tag)

                        def cont3(b6):
                            cbody_tag, cbody = b6.call(
                                "compile", snd_tag, snd, out_sizes=(1, 1))

                            def cont4(b7):
                                def lambda_case(b8):
                                    rt, r = b8.call(
                                        "compile_lambda", fst_tag, fst,
                                        cbody_tag, cbody, out_sizes=(1, 1))
                                    b8.ret(rt, r)

                                def let_case(b8):
                                    rt, r = b8.call(
                                        "compile_let", fst_tag, fst,
                                        cbody_tag, cbody, out_sizes=(1, 1))
                                    b8.ret(rt, r)

                                def letrec_case(b8):
                                    def empty_binds(b9):
                                        b9.ret(cbody_tag, cbody)

                                    def nonempty(b9):
                                        binds_tag, binds = b9.call(
                                            "compile_mutual_binds",
                                            fst_tag, fst, out_sizes=(1, 1))

                                        def cont5(b10):
                                            ptr = b10.store(binds, cbody_tag,
                                                            cbody)
                                            b10.ret(op, ptr)
                                        check_compiled(b9, binds_tag, binds,
                                                       cont5)
                                    b8.match(fst_tag, [
                                        (int(InternalTag.Nil), empty_binds)],
                                        default=nonempty)
                                b7.match(head, [
                                    (digests.builtin_symbol_ptr("lambda"),
                                     lambda_case),
                                    (digests.builtin_symbol_ptr("let"),
                                     let_case),
                                    (digests.builtin_symbol_ptr("letrec"),
                                     letrec_case)])
                            check_compiled(b6, cbody_tag, cbody, cont4)
                        b5.if_(r3_not_nil, ret_err, cont3)
                    b4.if_(r2_not_cons, ret_err, cont2)
                b3.if_(rest_not_cons, ret_err, cont)

            def quote_form(b3):
                rest_not_cons = b3.sub(rest_tag, cons_tag)

                def cont(b4):
                    arg_tag, arg, r2_tag, _r2 = b4.load(rest, [1, 1, 1, 1])
                    r2_not_nil = b4.sub(r2_tag, nil_tag)

                    def cont2(b5):
                        cexpr_tag, cexpr = b5.call("convert_data", arg_tag,
                                                   arg, out_sizes=(1, 1))

                        def cont3(b6):
                            tag = b6.const(CompOp.Quote)
                            ptr = b6.store(cexpr_tag, cexpr)
                            b6.ret(tag, ptr)
                        check_compiled(b5, cexpr_tag, cexpr, cont3)
                    b4.if_(r2_not_nil, ret_err, cont2)
                b3.if_(rest_not_cons, ret_err, cont)

            def eval_form(b3):
                rest_not_cons = b3.sub(rest_tag, cons_tag)

                def cont(b4):
                    arg_tag, arg, r2_tag, r2 = b4.load(rest, [1, 1, 1, 1])
                    cexpr_tag, cexpr = b4.call("compile", arg_tag, arg,
                                               out_sizes=(1, 1))

                    def cont2(b5):
                        tag = b5.const(CompOp.Eval)

                        def no_env(b6):
                            env_tag = b6.const(Tag.Env)
                            env = b6.const(0)
                            ptr = b6.store(cexpr_tag, cexpr, env_tag, env)
                            b6.ret(tag, ptr)

                        def with_env(b6):
                            e_tag, e, r3_tag, _r3 = b6.load(r2, [1, 1, 1, 1])
                            r3_not_nil = b6.sub(r3_tag, nil_tag)

                            def cont3(b7):
                                ce_tag, ce = b7.call("compile", e_tag, e,
                                                     out_sizes=(1, 1))

                                def cont4(b8):
                                    ptr = b8.store(cexpr_tag, cexpr,
                                                   ce_tag, ce)
                                    b8.ret(tag, ptr)
                                check_compiled(b7, ce_tag, ce, cont4)
                            b6.if_(r3_not_nil, ret_err, cont3)
                        b5.match(r2_tag, [
                            (int(InternalTag.Nil), no_env),
                            (int(Tag.Cons), with_env)], default=ret_err)
                    check_compiled(b4, cexpr_tag, cexpr, cont2)
                b3.if_(rest_not_cons, ret_err, cont)

            def if_form(b3):
                rest_not_cons = b3.sub(rest_tag, cons_tag)

                def cont(b4):
                    c_tag, c, r2_tag, r2 = b4.load(rest, [1, 1, 1, 1])
                    cc_tag, cc = b4.call("compile", c_tag, c,
                                         out_sizes=(1, 1))

                    def cont2(b5):
                        r2_not_cons = b5.sub(r2_tag, cons_tag)

                        def cont3(b6):
                            tb_tag, tb, r3_tag, r3 = b6.load(r2,
                                                             [1, 1, 1, 1])
                            ctb_tag, ctb = b6.call("compile", tb_tag, tb,
                                                   out_sizes=(1, 1))

                            def cont4(b7):
                                tag = b7.const(CompOp.If)

                                def no_else(b8):
                                    nil = b8.const(
                                        digests.lurk_symbol_ptr("nil"))
                                    ptr = b8.store(cc_tag, cc, ctb_tag, ctb,
                                                   nil_tag, nil)
                                    b8.ret(tag, ptr)

                                def with_else(b8):
                                    fb_tag, fb, r4_tag, _r4 = b8.load(
                                        r3, [1, 1, 1, 1])
                                    r4_not_nil = b8.sub(r4_tag, nil_tag)

                                    def cont5(b9):
                                        cfb_tag, cfb = b9.call(
                                            "compile", fb_tag, fb,
                                            out_sizes=(1, 1))

                                        def cont6(b10):
                                            ptr = b10.store(
                                                cc_tag, cc, ctb_tag, ctb,
                                                cfb_tag, cfb)
                                            b10.ret(tag, ptr)
                                        check_compiled(b9, cfb_tag, cfb,
                                                       cont6)
                                    b8.if_(r4_not_nil, ret_err, cont5)
                                b7.match(r3_tag, [
                                    (int(InternalTag.Nil), no_else),
                                    (int(Tag.Cons), with_else)],
                                    default=ret_err)
                            check_compiled(b6, ctb_tag, ctb, cont4)
                        b5.if_(r2_not_cons, ret_err, cont3)
                    check_compiled(b4, cc_tag, cc, cont2)
                b3.if_(rest_not_cons, ret_err, cont)

            def breakpoint_form(b3):
                # TODO in the reference too (compile.rs:396-399)
                b3.ret(err_tag, invalid_form)

            bp = digests.builtin_symbol_ptr
            b2.match(head, [
                (tuple(bp(s) for s in ("current-env", "empty-env", "fail")),
                 zero_elts),
                (tuple(bp(s) for s in (
                    "car", "cdr", "u64", "char", "atom", "emit", "commit",
                    "comm", "open", "secret", "bignum")), one_elt),
                (tuple(bp(s) for s in (
                    "apply", "cons", "strcons", "hide", "eq", "eqq",
                    "type-eq", "type-eqq")), two_elts),
                (tuple(bp(s) for s in ("begin", "+", "-", "*", "/", "%")),
                 variadic),
                (tuple(bp(s) for s in ("=", "<", ">", "<=", ">=")),
                 relational),
                (bp("list"), list_form),
                (tuple(bp(s) for s in ("lambda", "let", "letrec")),
                 binder_forms),
                (bp("quote"), quote_form),
                (bp("eval"), eval_form),
                (bp("if"), if_form),
                (bp("breakpoint"), breakpoint_form),
            ])

        def app_head(b2):
            chead_tag, chead = b2.call("compile", head_tag, head,
                                       out_sizes=(1, 1))

            def cont(b3):
                nil = b3.const(digests.lurk_symbol_ptr("nil"))
                mkcons = b3.const(CompOp.MkCons)
                cargs_tag, cargs = b3.call(
                    "compile_fold_right", mkcons, nil_tag, nil, rest_tag,
                    rest, out_sizes=(1, 1))
                app = b3.const(CompOp.App)
                ptr = b3.store(chead_tag, chead, cargs_tag, cargs)
                b3.ret(app, ptr)
            check_compiled(b2, chead_tag, chead, cont)

        bb.match(head_tag, [(int(Tag.Builtin), builtin_head)],
                 default=app_head)

    def case_convert(bb):
        ct, c = bb.call("convert_data", expr_tag, expr, out_sizes=(1, 1))
        bb.ret(ct, c)

    def dflt(bb):
        bb.ret(expr_tag, expr)

    b.match(expr_tag, [
        (int(Tag.Cons), case_cons),
        ((int(Tag.Env), int(Tag.Fix), int(Tag.Fun), int(Tag.Builtin)),
         case_convert)], default=dflt)
    return b.build()


def compile_lambda(digests):
    """Reference: compile.rs:602-670."""
    b = FuncBuilder("compile_lambda",
                    ["vars_tag", "vars", "cbody_tag", "cbody"], 2,
                    invertible=True)
    vars_tag = b.input("vars_tag")
    vars_ = b.input("vars")
    cbody_tag = b.input("cbody_tag")
    cbody = b.input("cbody")
    err_tag = b.const(Tag.Err)
    invalid_form = b.const(EvalErr.InvalidForm)

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def nil_case(bb):
        tag = bb.const(CompOp.MkThunk)
        ptr = bb.store(cbody_tag, cbody)
        bb.ret(tag, ptr)

    def cons_case(bb):
        var_tag, var, rv_tag, rv = bb.load(vars_, [1, 1, 1, 1])

        def sym_case(b2):
            rest_sym = b2.const(digests.lurk_symbol_ptr("&rest"))
            is_not_rest = b2.sub(var, rest_sym)

            def normal_var(b3):
                def last_var(b4):
                    ptr = b4.store(var_tag, var, cbody_tag, cbody)
                    tag = b4.const(CompOp.MkFun)
                    b4.ret(tag, ptr)

                def more_vars(b4):
                    fb_tag, fb = b4.call("compile_lambda", rv_tag, rv,
                                         cbody_tag, cbody, out_sizes=(1, 1))

                    def err_case(b5):
                        b5.ret(fb_tag, fb)

                    def cont(b5):
                        ptr = b5.store(var_tag, var, fb_tag, fb)
                        tag = b5.const(CompOp.MkFun)
                        b5.ret(tag, ptr)
                    b4.match(fb_tag, [(int(Tag.Err), err_case)],
                             default=cont)
                b3.match(rv_tag, [(int(InternalTag.Nil), last_var)],
                         default=more_vars)

            def rest_var(b3):
                def rv_nil(b4):
                    b4.ret(err_tag, invalid_form)

                def rv_cons(b4):
                    v2_tag, v2, rv2_tag, _rv2 = b4.load(rv, [1, 1, 1, 1])

                    def v2_sym(b5):
                        nil_tag = b5.const(InternalTag.Nil)
                        rv2_not_nil = b5.sub(rv2_tag, nil_tag)

                        def cont(b6):
                            ptr = b6.store(v2_tag, v2, cbody_tag, cbody)
                            tag = b6.const(CompOp.MkRestFun)
                            b6.ret(tag, ptr)
                        b5.if_(rv2_not_nil, ret_err, cont)
                    b4.match(v2_tag, [
                        ((int(Tag.Sym), int(Tag.Builtin),
                          int(Tag.Coroutine)), v2_sym)], default=ret_err)
                b3.match(rv_tag, [
                    (int(InternalTag.Nil), rv_nil),
                    (int(Tag.Cons), rv_cons)], default=ret_err)
            b2.if_(is_not_rest, normal_var, rest_var)
        bb.match(var_tag, [
            ((int(Tag.Sym), int(Tag.Builtin), int(Tag.Coroutine)),
             sym_case)], default=ret_err)
    b.match(vars_tag, [
        (int(InternalTag.Nil), nil_case),
        (int(Tag.Cons), cons_case)], default=ret_err)
    return b.build()


def compile_let(digests):
    """Reference: compile.rs:672-726."""
    b = FuncBuilder("compile_let",
                    ["binds_tag", "binds", "cbody_tag", "cbody"], 2)
    binds_tag = b.input("binds_tag")
    binds = b.input("binds")
    cbody_tag = b.input("cbody_tag")
    cbody = b.input("cbody")
    err_tag = b.const(Tag.Err)
    invalid_form = b.const(EvalErr.InvalidForm)

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def nil_case(bb):
        bb.ret(cbody_tag, cbody)

    def cons_case(bb):
        cons_tag = bb.const(Tag.Cons)
        nil_tag = bb.const(InternalTag.Nil)
        bind_tag, bind, rb_tag, rb = bb.load(binds, [1, 1, 1, 1])
        bind_not_cons = bb.sub(bind_tag, cons_tag)

        def cont(b2):
            var_tag, var, r_tag, r = b2.load(bind, [1, 1, 1, 1])
            r_not_cons = b2.sub(r_tag, cons_tag)

            def cont2(b3):
                val_tag, val, r2_tag, _r2 = b3.load(r, [1, 1, 1, 1])
                r2_not_nil = b3.sub(r2_tag, nil_tag)

                def cont3(b4):
                    def sym_case(b5):
                        cval_tag, cval = b5.call("compile", val_tag, val,
                                                 out_sizes=(1, 1))

                        def err1(b6):
                            b6.ret(cval_tag, cval)

                        def cont4(b6):
                            lb_tag, lb = b6.call("compile_let", rb_tag, rb,
                                                 cbody_tag, cbody,
                                                 out_sizes=(1, 1))

                            def err2(b7):
                                b7.ret(lb_tag, lb)

                            def cont5(b7):
                                ptr = b7.store(var_tag, var, cval_tag, cval,
                                               lb_tag, lb)
                                let_op = b7.const(CompOp.Let)
                                b7.ret(let_op, ptr)
                            b6.match(lb_tag, [(int(Tag.Err), err2)],
                                     default=cont5)
                        b5.match(cval_tag, [(int(Tag.Err), err1)],
                                 default=cont4)
                    b4.match(var_tag, [
                        ((int(Tag.Sym), int(Tag.Builtin),
                          int(Tag.Coroutine)), sym_case)], default=ret_err)
                b3.if_(r2_not_nil, ret_err, cont3)
            b2.if_(r_not_cons, ret_err, cont2)
        bb.if_(bind_not_cons, ret_err, cont)
    b.match(binds_tag, [
        (int(InternalTag.Nil), nil_case),
        (int(Tag.Cons), cons_case)], default=ret_err)
    return b.build()


def compile_mutual_binds(digests):
    """Reference: compile.rs:728-787."""
    b = FuncBuilder("compile_mutual_binds", ["binds_tag", "binds"], 2)
    binds_tag = b.input("binds_tag")
    binds = b.input("binds")
    err_tag = b.const(Tag.Err)
    env_tag = b.const(Tag.Env)
    invalid_form = b.const(EvalErr.InvalidForm)

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def nil_case(bb):
        cbinds = bb.const(0)
        bb.ret(env_tag, cbinds)

    def cons_case(bb):
        cons_tag = bb.const(Tag.Cons)
        binding_tag, binding, bs_tag, bs = bb.load(binds, [1, 1, 1, 1])
        binding_not_cons = bb.sub(binding_tag, cons_tag)

        def cont(b2):
            var_tag, var, r_tag, r = b2.load(binding, [1, 1, 1, 1])
            r_not_cons = b2.sub(r_tag, cons_tag)

            def cont2(b3):
                e_tag, e, r2_tag, _r2 = b3.load(r, [1, 1, 1, 1])
                nil_tag = b3.const(InternalTag.Nil)
                r2_not_nil = b3.sub(r2_tag, nil_tag)

                def cont3(b4):
                    def sym_case(b5):
                        ce_tag, ce = b5.call("compile", e_tag, e,
                                             out_sizes=(1, 1))

                        def err1(b6):
                            b6.ret(ce_tag, ce)

                        def cont4(b6):
                            cb_tag, cb = b6.call("compile_mutual_binds",
                                                 bs_tag, bs,
                                                 out_sizes=(1, 1))

                            def err2(b7):
                                b7.ret(cb_tag, cb)

                            def cont5(b7):
                                cbinds = b7.store(var_tag, var, ce_tag, ce,
                                                  cb)
                                b7.ret(env_tag, cbinds)
                            b6.match(cb_tag, [(int(Tag.Err), err2)],
                                     default=cont5)
                        b5.match(ce_tag, [(int(Tag.Err), err1)],
                                 default=cont4)
                    b4.match(var_tag, [
                        ((int(Tag.Sym), int(Tag.Builtin),
                          int(Tag.Coroutine)), sym_case)], default=ret_err)
                b3.if_(r2_not_nil, ret_err, cont3)
            b2.if_(r_not_cons, ret_err, cont2)
        bb.if_(binding_not_cons, ret_err, cont)
    b.match(binds_tag, [
        (int(InternalTag.Nil), nil_case),
        (int(Tag.Cons), cons_case)], default=ret_err)
    return b.build()


def compile_fold_right(digests):
    """Reference: compile.rs:789-825."""
    b = FuncBuilder("compile_fold_right",
                    ["op", "init_tag", "init", "exprs_tag", "exprs"], 2)
    op = b.input("op")
    init_tag = b.input("init_tag")
    init = b.input("init")
    exprs_tag = b.input("exprs_tag")
    exprs = b.input("exprs")
    err_tag = b.const(Tag.Err)
    invalid_form = b.const(EvalErr.InvalidForm)

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def nil_case(bb):
        bb.ret(init_tag, init)

    def cons_case(bb):
        val_tag, val, r_tag, r = bb.load(exprs, [1, 1, 1, 1])
        cval_tag, cval = bb.call("compile", val_tag, val, out_sizes=(1, 1))

        def err1(b2):
            b2.ret(cval_tag, cval)

        def cont(b2):
            def last(b3):
                ptr = b3.store(cval_tag, cval, init_tag, init)
                b3.ret(op, ptr)

            def more(b3):
                rb_tag, rb = b3.call("compile_fold_right", op, init_tag,
                                     init, r_tag, r, out_sizes=(1, 1))

                def err2(b4):
                    b4.ret(rb_tag, rb)

                def cont2(b4):
                    ptr = b4.store(cval_tag, cval, rb_tag, rb)
                    b4.ret(op, ptr)
                b3.match(rb_tag, [(int(Tag.Err), err2)], default=cont2)
            b2.match(r_tag, [(int(InternalTag.Nil), last)], default=more)
        bb.match(cval_tag, [(int(Tag.Err), err1)], default=cont)
    b.match(exprs_tag, [
        (int(InternalTag.Nil), nil_case),
        (int(Tag.Cons), cons_case)], default=ret_err)
    return b.build()


def compile_fold_left(digests):
    """Reference: compile.rs:818-848."""
    b = FuncBuilder("compile_fold_left",
                    ["op", "acc_tag", "acc", "exprs_tag", "exprs"], 2)
    op = b.input("op")
    acc_tag = b.input("acc_tag")
    acc = b.input("acc")
    exprs_tag = b.input("exprs_tag")
    exprs = b.input("exprs")
    err_tag = b.const(Tag.Err)
    invalid_form = b.const(EvalErr.InvalidForm)

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def nil_case(bb):
        bb.ret(acc_tag, acc)

    def cons_case(bb):
        val_tag, val, r_tag, r = bb.load(exprs, [1, 1, 1, 1])
        cval_tag, cval = bb.call("compile", val_tag, val, out_sizes=(1, 1))

        def err1(b2):
            b2.ret(cval_tag, cval)

        def cont(b2):
            new_acc = b2.store(acc_tag, acc, cval_tag, cval)

            def last(b3):
                b3.ret(op, new_acc)

            def more(b3):
                rt, r_ = b3.call("compile_fold_left", op, op, new_acc,
                                 r_tag, r, out_sizes=(1, 1))
                b3.ret(rt, r_)
            b2.match(r_tag, [(int(InternalTag.Nil), last)], default=more)
        bb.match(cval_tag, [(int(Tag.Err), err1)], default=cont)
    b.match(exprs_tag, [
        (int(InternalTag.Nil), nil_case),
        (int(Tag.Cons), cons_case)], default=ret_err)
    return b.build()


def compile_fold_rel(digests):
    """Reference: compile.rs:850-905."""
    b = FuncBuilder("compile_fold_rel", ["op", "exprs_tag", "exprs"], 2)
    op = b.input("op")
    exprs_tag = b.input("exprs_tag")
    exprs = b.input("exprs")
    err_tag = b.const(Tag.Err)
    invalid_form = b.const(EvalErr.InvalidForm)
    t_tag = b.const(InternalTag.T)
    t = b.const(digests.lurk_symbol_ptr("t"))

    def ret_err(bb):
        bb.ret(err_tag, invalid_form)

    def nil_case(bb):
        bb.ret(t_tag, t)

    def cons_case(bb):
        a_tag, a, r_tag, r = bb.load(exprs, [1, 1, 1, 1])
        ca_tag, ca = bb.call("compile", a_tag, a, out_sizes=(1, 1))

        def err1(b2):
            b2.ret(ca_tag, ca)

        def cont(b2):
            def one_elt(b3):
                b3.ret(t_tag, t)

            def pair(b3):
                b_tag, bv, r2_tag, r2 = b3.load(r, [1, 1, 1, 1])
                cb_tag, cb = b3.call("compile", b_tag, bv, out_sizes=(1, 1))

                def err2(b4):
                    b4.ret(cb_tag, cb)

                def cont2(b4):
                    op_body = b4.store(ca_tag, ca, cb_tag, cb)

                    def last(b5):
                        b5.ret(op, op_body)

                    def more(b5):
                        rb_tag, rb = b5.call("compile_fold_rel", op,
                                             r2_tag, r2, out_sizes=(1, 1))

                        def err3(b6):
                            b6.ret(rb_tag, rb)

                        def cont3(b6):
                            ptr = b6.store(op, op_body, rb_tag, rb)
                            and_ = b6.const(CompOp.And)
                            b6.ret(and_, ptr)
                        b5.match(rb_tag, [(int(Tag.Err), err3)],
                                 default=cont3)
                    b4.match(r2_tag, [(int(InternalTag.Nil), last)],
                             default=more)
                b3.match(cb_tag, [(int(Tag.Err), err2)], default=cont2)
            b2.match(r_tag, [
                (int(InternalTag.Nil), one_elt),
                (int(Tag.Cons), pair)], default=ret_err)
        bb.match(ca_tag, [(int(Tag.Err), err1)], default=cont)
    b.match(exprs_tag, [
        (int(InternalTag.Nil), nil_case),
        (int(Tag.Cons), cons_case)], default=ret_err)
    return b.build()


def convert_data(digests):
    """Reference: compile.rs:907-1005 (env entries 5-wide here; see module
    docstring)."""
    b = FuncBuilder("convert_data", ["expr_tag", "expr"], 2)
    expr_tag = b.input("expr_tag")
    expr = b.input("expr")

    def cons_case(bb):
        car_tag, car, cdr_tag, cdr = bb.load(expr, [1, 1, 1, 1])
        ccar_tag, ccar = bb.call("convert_data", car_tag, car,
                                 out_sizes=(1, 1))

        def err1(b2):
            b2.ret(ccar_tag, ccar)

        def cont(b2):
            ccdr_tag, ccdr = b2.call("convert_data", cdr_tag, cdr,
                                     out_sizes=(1, 1))

            def err2(b3):
                b3.ret(ccdr_tag, ccdr)

            def cont2(b3):
                cons_tag = b3.const(Tag.Cons)
                # the reference stores the *original* children here
                # (compile.rs:925): nested funs inside quoted data stay
                # unconverted - mirrored faithfully
                ptr = b3.store(car_tag, car, cdr_tag, cdr)
                b3.ret(cons_tag, ptr)
            b2.match(ccdr_tag, [(int(Tag.Err), err2)], default=cont2)
        bb.match(ccar_tag, [(int(Tag.Err), err1)], default=cont)

    def env_case(bb):
        def empty(b2):
            b2.ret(expr_tag, expr)

        def nonempty(b2):
            var_tag, var, val_tag, val, env = b2.load(expr, [1, 1, 1, 1, 1])
            cval_tag, cval = b2.call("convert_data", val_tag, val,
                                     out_sizes=(1, 1))

            def err1(b3):
                b3.ret(cval_tag, cval)

            def cont(b3):
                env_tag = b3.const(Tag.Env)
                cenv_tag, cenv = b3.call("convert_data", env_tag, env,
                                         out_sizes=(1, 1))

                def err2(b4):
                    b4.ret(cenv_tag, cenv)

                def cont2(b4):
                    ptr = b4.store(var_tag, var, cval_tag, cval, cenv)
                    b4.ret(env_tag, ptr)
                b3.match(cenv_tag, [(int(Tag.Err), err2)], default=cont2)
            b2.match(cval_tag, [(int(Tag.Err), err1)], default=cont)
        bb.if_(expr, nonempty, empty)

    def fun_case(bb):
        vars_tag, vars_, body_tag, body, env = bb.load(expr,
                                                       [1, 1, 1, 1, 1])
        env_tag = bb.const(Tag.Env)
        cenv_tag, cenv = bb.call("convert_data", env_tag, env,
                                 out_sizes=(1, 1))

        def err1(b2):
            b2.ret(cenv_tag, cenv)

        def env_ok(b2):
            builtin_tag = b2.const(Tag.Builtin)
            lam = b2.const(digests.builtin_symbol_ptr("lambda"))
            nil_tag = b2.const(InternalTag.Nil)
            nil = b2.const(digests.lurk_symbol_ptr("nil"))
            cons_tag = b2.const(Tag.Cons)
            cons1 = b2.store(body_tag, body, nil_tag, nil)
            cons2 = b2.store(vars_tag, vars_, cons_tag, cons1)
            lam_ptr = b2.store(builtin_tag, lam, cons_tag, cons2)
            mkfun_tag, mkfun = b2.call("compile", cons_tag, lam_ptr,
                                       out_sizes=(1, 1))

            def err2(b3):
                b3.ret(mkfun_tag, mkfun)

            def fun_res(b3):
                var_tag, var, cbody_tag, cbody = b3.load(mkfun,
                                                         [1, 1, 1, 1])
                tag = b3.const(CompVal.Fun)
                ptr = b3.store(var_tag, var, cbody_tag, cbody, cenv)
                b3.ret(tag, ptr)

            def thunk_res(b3):
                cbody_tag, cbody = b3.load(mkfun, [1, 1])
                tag = b3.const(CompVal.Thunk)
                ptr = b3.store(cbody_tag, cbody, cenv)
                b3.ret(tag, ptr)
            b2.match(mkfun_tag, [
                (int(Tag.Err), err2),
                (int(CompOp.MkFun), fun_res),
                (int(CompOp.MkThunk), thunk_res)])
        bb.match(cenv_tag, [
            (int(Tag.Err), err1),
            (int(Tag.Env), env_ok)])

    def fix_case(bb):
        body_tag, body, env = bb.load(expr, [1, 1, 1])
        cbody_tag, cbody = bb.call("compile", body_tag, body,
                                   out_sizes=(1, 1))

        def err1(b2):
            b2.ret(cbody_tag, cbody)

        def cont(b2):
            env_tag = b2.const(Tag.Env)
            cenv_tag, cenv = b2.call("convert_data", env_tag, env,
                                     out_sizes=(1, 1))

            def err2(b3):
                b3.ret(cenv_tag, cenv)

            def cont2(b3):
                tag = b3.const(CompVal.Fix)
                ptr = b3.store(cbody_tag, cbody, cenv)
                b3.ret(tag, ptr)
            b2.match(cenv_tag, [(int(Tag.Err), err2)], default=cont2)
        bb.match(cbody_tag, [(int(Tag.Err), err1)], default=cont)

    def dflt(bb):
        bb.ret(expr_tag, expr)

    b.match(expr_tag, [
        (int(Tag.Cons), cons_case),
        (int(Tag.Env), env_case),
        (int(Tag.Fun), fun_case),
        (int(Tag.Fix), fix_case)], default=dflt)
    return b.build()


def deconvert_data(digests):
    """Reference: compile.rs:1007-1088."""
    b = FuncBuilder("deconvert_data", ["cexpr_tag", "cexpr"], 2)
    cexpr_tag = b.input("cexpr_tag")
    cexpr = b.input("cexpr")

    def cons_case(bb):
        ccar_tag, ccar, ccdr_tag, ccdr = bb.load(cexpr, [1, 1, 1, 1])
        car_tag, car = bb.call("deconvert_data", ccar_tag, ccar,
                               out_sizes=(1, 1))
        cdr_tag, cdr = bb.call("deconvert_data", ccdr_tag, ccdr,
                               out_sizes=(1, 1))
        tag = bb.const(Tag.Cons)
        ptr = bb.store(car_tag, car, cdr_tag, cdr)
        bb.ret(tag, ptr)

    def env_case(bb):
        def empty(b2):
            b2.ret(cexpr_tag, cexpr)

        def nonempty(b2):
            var_tag, var, cval_tag, cval, cenv = b2.load(cexpr,
                                                         [1, 1, 1, 1, 1])
            val_tag, val = b2.call("deconvert_data", cval_tag, cval,
                                   out_sizes=(1, 1))
            env_tag = b2.const(Tag.Env)
            _et, env = b2.call("deconvert_data", env_tag, cenv,
                               out_sizes=(1, 1))
            ptr = b2.store(var_tag, var, val_tag, val, env)
            b2.ret(env_tag, ptr)
        bb.if_(cexpr, nonempty, empty)

    def _fun_like(bb, mk_op):
        var_tag, var, cbody_tag, cbody, cenv = bb.load(cexpr,
                                                       [1, 1, 1, 1, 1])
        env_tag = bb.const(Tag.Env)
        _et, env = bb.call("deconvert_data", env_tag, cenv,
                           out_sizes=(1, 1))
        mkfun_tag = bb.const(mk_op)
        mkfun = bb.store(var_tag, var, cbody_tag, cbody)
        vars_tag, vars_, cb_tag, cb = bb.preimg(
            "compile_lambda", mkfun_tag, mkfun, out_sizes=(1, 1, 1, 1))
        body_tag, body = bb.preimg("compile", cb_tag, cb,
                                   out_sizes=(1, 1))
        tag = bb.const(Tag.Fun)
        ptr = bb.store(vars_tag, vars_, body_tag, body, env)
        bb.ret(tag, ptr)

    def fun_case(bb):
        _fun_like(bb, CompOp.MkFun)

    def restfun_case(bb):
        _fun_like(bb, CompOp.MkRestFun)

    def thunk_case(bb):
        cbody_tag, cbody, cenv = bb.load(cexpr, [1, 1, 1])
        body_tag, body = bb.preimg("compile", cbody_tag, cbody,
                                   out_sizes=(1, 1))
        env_tag = bb.const(Tag.Env)
        _et, env = bb.call("deconvert_data", env_tag, cenv,
                           out_sizes=(1, 1))
        tag = bb.const(Tag.Fun)
        nil_tag = bb.const(InternalTag.Nil)
        nil = bb.const(digests.lurk_symbol_ptr("nil"))
        ptr = bb.store(nil_tag, nil, body_tag, body, env)
        bb.ret(tag, ptr)

    def fix_case(bb):
        cbody_tag, cbody, cenv = bb.load(cexpr, [1, 1, 1])
        body_tag, body = bb.preimg("compile", cbody_tag, cbody,
                                   out_sizes=(1, 1))
        env_tag = bb.const(Tag.Env)
        _et, env = bb.call("deconvert_data", env_tag, cenv,
                           out_sizes=(1, 1))
        tag = bb.const(Tag.Fix)
        ptr = bb.store(body_tag, body, env)
        bb.ret(tag, ptr)

    def atom_case(bb):
        bb.ret(cexpr_tag, cexpr)

    b.match(cexpr_tag, [
        (int(Tag.Cons), cons_case),
        (int(Tag.Env), env_case),
        (int(CompVal.Fun), fun_case),
        (int(CompVal.RestFun), restfun_case),
        (int(CompVal.Thunk), thunk_case),
        (int(CompVal.Fix), fix_case),
        # Tag.BigNum added relative to the reference's list
        # (compile.rs:1081-1082), which cannot deconvert big-num results
        # (e.g. from `secret`) at all
        ((int(InternalTag.T), int(InternalTag.Nil), int(Tag.Sym),
          int(Tag.Num), int(Tag.Str), int(Tag.Char), int(Tag.Comm),
          int(Tag.U64), int(Tag.Key), int(Tag.Err), int(Tag.Builtin),
          int(Tag.BigNum)), atom_case)])
    return b.build()


def compile_funcs(digests):
    """Reference: compile.rs:1090-1103."""
    return [
        compile_fn(digests),
        symbol_to_op(digests),
        compile_lambda(digests),
        compile_let(digests),
        compile_mutual_binds(digests),
        compile_fold_right(digests),
        compile_fold_left(digests),
        compile_fold_rel(digests),
        convert_data(digests),
        deconvert_data(digests),
    ]


def build_compile_toplevel_native():
    """Standalone compiler toplevel (reference: compile.rs:1105-1112)."""
    from ..lair.toplevel import Toplevel
    from .ingress import SymbolsDigests
    from .zstore import lurk_zstore
    zstore = lurk_zstore()
    digests = SymbolsDigests(zstore)
    return Toplevel(compile_funcs(digests), {}), zstore, digests
