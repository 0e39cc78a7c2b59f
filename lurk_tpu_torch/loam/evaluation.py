"""Loam relational Lurk evaluator.

Reference: /root/reference/src/loam/evaluation.rs (EvaluationProgram, the
`ascent!` program with ~90 rules) and distilled_evaluation.rs (the
second-pass program over distilled memory). The rules below are a
1:1 port of the reference's rule set - same relation names, same
signal/final split, same dispatch classes - expressed against the
engine in engine.py.

Architecture note: the reference duplicates every evaluation rule
between the two programs because ascent macros cannot share rule sets;
here the eval/ingress/egress rules live once in `_LurkEvalRules` and the
two programs differ only in their memory rules (allocating lattices vs.
imported distilled relations), which is the actual semantic difference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from ..core.tag import Tag
from .allocation import Allocator
from .engine import Program
from .memory import (Memory, VirtualMemory, VPtr, initial_builtin_addr,
                     initial_builtin_relation, initial_symbol_addr,
                     initial_symbol_relation, initial_tag_relation)
from .types import Ptr, PtrEq, WidePtr, ptr_eq_join, widen

_ERR = Ptr(Tag.Err, 0)


class _LurkEvalRules(Program):
    """Shared relations + evaluation rules of both Loam programs.

    NOTE: the Allocator snapshots the ZStore's hash caches at
    construction (the reference's `import_zstore`); intern every input
    expression BEFORE constructing the program, or re-run
    `self.allocator.import_zstore(zstore)` after further interning -
    ingress can only unhash digests the allocator has seen."""

    def __init__(self, zstore):
        super().__init__()
        self.zstore = zstore
        self.allocator = Allocator()
        self.allocator.import_zstore(zstore)

        # -- shared relations (evaluation.rs:219-264) -----------------
        self.relation("tag", initial_tag_relation())      # (short, wide)
        self.relation("ptr_value")                        # (ptr, value)
        self.relation("toplevel_input")                   # (expr, env)
        self.relation("output_expr")                      # (wide-ptr,)
        self.relation("input_ptr")                        # (expr, env)
        self.relation("output_ptr")                       # (ptr,)
        self.relation("hash4")                            # (a,b,c,d)
        self.relation("unhash4")                          # (digest,)
        self.relation("hash4_rel")                        # (a,b,c,d,digest)
        self.relation("hash5")                            # (a,b,c,d,e)
        self.relation("unhash5")                          # (digest,)
        self.relation("hash5_rel")                        # (a..e,digest)
        self.relation("egress")                           # (ptr,)
        self.relation("ingress")                          # (ptr,)
        self.relation("alloc")                            # (tag, value)
        self.relation("cons")                             # (car, cdr)
        self.relation("thunk")                            # (body, env)
        self.relation("fun")                              # (args, body, env)
        self.relation("cons_rel")                         # (car, cdr, cons)
        self.relation("fun_rel")                          # (args,body,env,fun)
        self.relation("thunk_rel")                        # (body, env, thunk)
        # -- eval relations (evaluation.rs:512-540 etc.) ---------------
        self.relation("eval_input")                       # (expr, env)
        self.relation("eval")                             # (expr, env, out)
        self.relation("lookup0")                          # (outer, var, env)
        self.relation("lookup")                           # (var, outer, val)
        self.relation("eq")                               # (a, b, PtrEq)
        self.relation("eq_rel")                           # (a, b, bool)
        self.relation("eq_cont1")
        self.relation("eq_cont2")
        self.relation("eq_cont3")
        self.relation("eq_rel_cont1")
        self.relation("eq_rel_tuple2_cont")
        self.relation("eq_rel_tuple3_cont")
        self.relation("cons_cont1")
        self.relation("cons_cont2")
        self.relation("car_cdr_cont1")
        self.relation("car_cdr_cont2")
        self.relation("atom_cont1")
        self.relation("quote_cont1")
        self.relation("fun_call")
        self.relation("maybe_fun_call")
        self.relation("bind_parse")
        self.relation("rec_bind_parse")
        self.relation("bind")
        self.relation("bind_cont1")
        self.relation("bind_cont2")
        self.relation("bind_cont3")
        self.relation("lambda_cont1")
        self.relation("lambda_cont2")
        self.relation("fold")
        self.relation("fold_right")
        self.relation("bool_fold0")
        self.relation("bool_fold")

    # -- convenience joins -------------------------------------------------

    def _cons_of(self, ptr) -> Optional[Tuple[Ptr, Ptr]]:
        rows = self.by("cons_rel", 2).get((ptr,))
        return (rows[0][0], rows[0][1]) if rows else None

    def _fun_of(self, ptr):
        rows = self.by("fun_rel", 3).get((ptr,))
        return rows[0][:3] if rows else None

    def _thunk_of(self, ptr):
        rows = self.by("thunk_rel", 2).get((ptr,))
        return rows[0][:2] if rows else None

    def _evals_of(self, expr, env) -> List[Ptr]:
        rows = self.by("eval", 0, 1).get((expr, env))
        return [r[2] for r in rows] if rows else []

    # -- batched hashing (flush hook) ---------------------------------------

    def flush(self):
        """Materialize hash4_rel/hash5_rel for all pending hash4/hash5
        tuples with one batched Poseidon2 call each (TPU-native batching;
        the reference hashes per-tuple inside the rule)."""
        todo4 = [row for row in self._rels["hash4"]
                 if not self.by("hash4_rel", 0, 1, 2, 3).get(row)]
        if todo4:
            digests = self.allocator.hash_rows_batch(todo4)
            for row, d in zip(todo4, digests):
                self.add("hash4_rel", *row, d)
        todo5 = [row for row in self._rels["hash5"]
                 if not self.by("hash5_rel", 0, 1, 2, 3, 4).get(row)]
        if todo5:
            digests = self.allocator.hash_rows_batch(todo5)
            for row, d in zip(todo5, digests):
                self.add("hash5_rel", *row, d)

    # ========================================================================
    # Ingress path (evaluation.rs:425-465)
    # ========================================================================

    def rule_ingress_toplevel(self):
        tag_by_wide = self.by("tag", 1)
        for expr, env in self._rels["toplevel_input"]:
            for (t,) in [r[:1] for r in tag_by_wide.get((expr.tag,), [])]:
                self.add("alloc", t, expr.value)
            for (t,) in [r[:1] for r in tag_by_wide.get((env.tag,), [])]:
                self.add("alloc", t, env.value)

    def rule_input_ptr(self):
        pv_by_value = self.by("ptr_value", 1)
        for expr, env in self._rels["toplevel_input"]:
            for expr_ptr, _ in pv_by_value.get((expr.value,), []):
                if expr_ptr.tag != expr.ptr_tag():
                    continue
                for env_ptr, _ in pv_by_value.get((env.value,), []):
                    if env_ptr.tag != env.ptr_tag():
                        continue
                    self.add("ingress", expr_ptr)
                    self.add("input_ptr", expr_ptr, env_ptr)

    def rule_ingress_unhash(self):
        pv = self.by("ptr_value", 0)
        for (ptr,) in self._rels["ingress"]:
            if ptr.is_cons() or ptr.is_thunk():
                for _, digest in pv.get((ptr,), []):
                    self.add("unhash4", digest)
            elif ptr.is_fun():
                for _, digest in pv.get((ptr,), []):
                    self.add("unhash5", digest)

    def rule_unhash4_rel(self):
        for (digest,) in self._rels["unhash4"]:
            if digest in self.allocator.preimage_cache:
                a, b, c, d = self.allocator.unhash4(digest)
                self.add("hash4_rel", a, b, c, d, digest)

    def rule_alloc_unhashed4(self):
        h4_by_digest = self.by("hash4_rel", 4)
        tag_by_wide = self.by("tag", 1)
        for (digest,) in self._rels["unhash4"]:
            for a, b, c, d, _ in h4_by_digest.get((digest,), []):
                for x_tag, _ in tag_by_wide.get((a,), []):
                    for y_tag, _ in tag_by_wide.get((c,), []):
                        self.add("alloc", x_tag, b)
                        self.add("alloc", y_tag, d)

    def rule_unhash5_rel(self):
        for (digest,) in self._rels["unhash5"]:
            if digest in self.allocator.preimage_cache:
                a, b, c, d, e = self.allocator.unhash5(digest)
                self.add("hash5_rel", a, b, c, d, e, digest)

    def rule_alloc_unhashed5(self):
        h5_by_digest = self.by("hash5_rel", 5)
        tag_by_wide = self.by("tag", 1)
        for (digest,) in self._rels["unhash5"]:
            for a, b, c, d, e, _ in h5_by_digest.get((digest,), []):
                for x_tag, _ in tag_by_wide.get((a,), []):
                    for y_tag, _ in tag_by_wide.get((c,), []):
                        self.add("alloc", x_tag, b)
                        self.add("alloc", y_tag, d)
                        self.add("alloc", int(Tag.Cons), e)

    # ========================================================================
    # Egress path (evaluation.rs:467-510)
    # ========================================================================

    def rule_egress_output(self):
        for (ptr,) in self._rels["output_ptr"]:
            self.add("egress", ptr)

    def rule_egress_children(self):
        for (ptr,) in self._rels["egress"]:
            c = self._cons_of(ptr)
            if c:
                self.add("egress", c[0])
                self.add("egress", c[1])
            f = self._fun_of(ptr)
            if f:
                for child in f:
                    self.add("egress", child)

    def rule_egress_atom_values(self):
        for (ptr,) in self._rels["egress"]:
            if ptr.is_num() or ptr.is_err():
                self.add("ptr_value", ptr, widen(ptr.addr))

    def rule_output_expr(self):
        pv = self.by("ptr_value", 0)
        for (ptr,) in self._rels["output_ptr"]:
            for _, value in pv.get((ptr,), []):
                self.add("output_expr", WidePtr(ptr.wide_tag(), value))

    def rule_egress_hash(self):
        pv = self.by("ptr_value", 0)

        def val(p):
            rows = pv.get((p,), [])
            return rows[0][1] if rows else None

        for (ptr,) in self._rels["egress"]:
            c = self._cons_of(ptr)
            if c:
                cv, dv = val(c[0]), val(c[1])
                if cv is not None and dv is not None:
                    self.add("hash4", c[0].wide_tag(), cv,
                             c[1].wide_tag(), dv)
            t = self._thunk_of(ptr)
            if t:
                bv, ev = val(t[0]), val(t[1])
                if bv is not None and ev is not None:
                    self.add("hash4", t[0].wide_tag(), bv,
                             t[1].wide_tag(), ev)
            f = self._fun_of(ptr)
            if f:
                av, bv, ev = val(f[0]), val(f[1]), val(f[2])
                if av is not None and bv is not None and ev is not None:
                    self.add("hash5", f[0].wide_tag(), av,
                             f[1].wide_tag(), bv, ev)

    # ========================================================================
    # eval dispatch (evaluation.rs:512-546)
    # ========================================================================

    def rule_eval_input_from_input_ptr(self):
        for expr, env in self._rels["input_ptr"]:
            self.add("eval_input", expr, env)

    def rule_eval_self_evaluating(self):
        for expr, env in self._rels["eval_input"]:
            if expr.is_num() or expr.is_nil():
                self.add("eval", expr, env, expr)

    # -- sym lookup (evaluation.rs:548-610) ---------------------------------

    def rule_lookup_start(self):
        for expr, env in self._rels["eval_input"]:
            if expr.is_sym():
                self.add("ingress", env)
                self.add("lookup0", env, expr, env)

    def rule_lookup_step(self):
        for outer_env, var, env in self._rels["lookup0"]:
            if env.is_nil():
                self.add("eval", var, outer_env, _ERR)  # unbound variable
                continue
            c = self._cons_of(env)
            if not c:
                continue
            binding, tail = c
            self.add("ingress", binding)
            b = self._cons_of(binding)
            if not b:
                continue
            bound_var, value = b
            if bound_var == var:
                self.add("lookup", var, outer_env, value)
                if not value.is_thunk():
                    self.add("eval", var, outer_env, value)
            else:
                self.add("ingress", tail)
                self.add("lookup0", outer_env, var, tail)

    def rule_lookup_thunk(self):
        # looked-up value is a thunk: evaluate its body in its closed env
        # extended with a self-binding (evaluation.rs:588-610)
        for var, outer_env, value in self._rels["lookup"]:
            t = self._thunk_of(value)
            if not t:
                continue
            body, closed_env = t
            nb = self._cons_of_pair(var, value)
            if nb is None:
                self.add("cons", var, value)
                continue
            ext = self._cons_of_pair(nb, closed_env)
            if ext is None:
                self.add("cons", nb, closed_env)
                continue
            self.add("eval_input", body, ext)
            for result in self._evals_of(body, ext):
                self.add("eval", var, outer_env, result)

    def _cons_of_pair(self, car, cdr) -> Optional[Ptr]:
        rows = self.by("cons_rel", 0, 1).get((car, cdr))
        return rows[0][2] if rows else None

    # -- cons-expr dispatch ---------------------------------------------------

    def rule_eval_cons_ingress(self):
        for expr, env in self._rels["eval_input"]:
            if expr.is_cons():
                self.add("ingress", expr)

    # -- eq op (evaluation.rs:612-725) ---------------------------------------

    def rule_eq_parse(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if c and c[0].is_eq_op():
                self.add("ingress", c[1])
                self.add("eq_cont1", expr, env, c[1])

    def rule_eq_args(self):
        for expr, env, tail in self._rels["eq_cont1"]:
            c = self._cons_of(tail)
            if not c:
                continue
            arg1, rest = c
            self.add("ingress", rest)
            self.add("eval_input", arg1, env)
            c2 = self._cons_of(rest)
            if c2 and c2[1].is_nil():
                self.add("eval_input", c2[0], env)
                self.add("eq_cont2", expr, env, arg1, c2[0])

    def rule_eq_evaled(self):
        for expr, env, arg1, arg2 in self._rels["eq_cont2"]:
            for e1 in self._evals_of(arg1, env):
                for e2 in self._evals_of(arg2, env):
                    self.add("eq_cont3", expr, env, e1, e2)

    def rule_eq_query(self):
        eq_rel_by = self.by("eq_rel", 0, 1)
        for expr, env, e1, e2 in self._rels["eq_cont3"]:
            self.add("eq", e1, e2, e1.is_eq(e2))
            for row in eq_rel_by.get((e1, e2), []):
                self.add("eval", expr, env, Ptr.lurk_bool(row[2]))

    def rule_eq_rel_base(self):
        for a, b, is_eq in self._rels["eq"]:
            if is_eq == PtrEq.Equal:
                self.add("eq_rel", a, b, True)
            elif is_eq == PtrEq.NotEqual:
                self.add("eq_rel", a, b, False)
            else:
                self.add("ingress", a)
                self.add("ingress", b)
                self.add("eq_rel_cont1", a, b, a.tag)

    def rule_eq_rel_match(self):
        for a, b, tag in self._rels["eq_rel_cont1"]:
            if tag == Tag.Cons:
                ca, cb = self._cons_of(a), self._cons_of(b)
                if ca and cb:
                    is_eq = ptr_eq_join(ca[0].is_eq(cb[0]),
                                        ca[1].is_eq(cb[1]))
                    self.add("eq_rel_tuple2_cont", a, b, ca[0], ca[1],
                             cb[0], cb[1], is_eq)
            elif tag == Tag.Fun:
                fa, fb = self._fun_of(a), self._fun_of(b)
                if fa and fb:
                    is_eq = ptr_eq_join(
                        ptr_eq_join(fa[0].is_eq(fb[0]), fa[1].is_eq(fb[1])),
                        fa[2].is_eq(fb[2]))
                    self.add("eq_rel_tuple3_cont", a, b, fa[0], fa[1], fa[2],
                             fb[0], fb[1], fb[2], is_eq)
            elif tag == Tag.Fix:
                ta, tb = self._thunk_of(a), self._thunk_of(b)
                if ta and tb:
                    is_eq = ptr_eq_join(ta[0].is_eq(tb[0]),
                                        ta[1].is_eq(tb[1]))
                    self.add("eq_rel_tuple2_cont", a, b, ta[0], ta[1],
                             tb[0], tb[1], is_eq)

    def rule_eq_rel_tuple2(self):
        eq_rel_by = self.by("eq_rel", 0, 1)
        for a, b, x1, y1, x2, y2, is_eq in self._rels["eq_rel_tuple2_cont"]:
            if is_eq == PtrEq.Equal:
                self.add("eq_rel", a, b, True)
            elif is_eq == PtrEq.NotEqual:
                self.add("eq_rel", a, b, False)
            else:
                self.add("eq", x1, x2, x1.is_eq(x2))
                self.add("eq", y1, y2, y1.is_eq(y2))
                for rx in eq_rel_by.get((x1, x2), []):
                    for ry in eq_rel_by.get((y1, y2), []):
                        self.add("eq_rel", a, b, rx[2] and ry[2])

    def rule_eq_rel_tuple3(self):
        eq_rel_by = self.by("eq_rel", 0, 1)
        for row in self._rels["eq_rel_tuple3_cont"]:
            a, b, x1, y1, z1, x2, y2, z2, is_eq = row
            if is_eq == PtrEq.Equal:
                self.add("eq_rel", a, b, True)
            elif is_eq == PtrEq.NotEqual:
                self.add("eq_rel", a, b, False)
            else:
                self.add("eq", x1, x2, x1.is_eq(x2))
                self.add("eq", y1, y2, y1.is_eq(y2))
                self.add("eq", z1, z2, z1.is_eq(z2))
                for rx in eq_rel_by.get((x1, x2), []):
                    for ry in eq_rel_by.get((y1, y2), []):
                        for rz in eq_rel_by.get((z1, z2), []):
                            self.add("eq_rel", a, b,
                                     rx[2] and ry[2] and rz[2])

    # -- cons op (evaluation.rs:727-766) --------------------------------------

    def rule_cons_parse(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if c and c[0].is_cons_op():
                self.add("ingress", c[1])
                self.add("cons_cont1", expr, env, c[1])

    def rule_cons_args(self):
        for expr, env, tail in self._rels["cons_cont1"]:
            c = self._cons_of(tail)
            if not c:
                continue
            car, rest = c
            self.add("eval_input", car, env)
            self.add("ingress", rest)
            c2 = self._cons_of(rest)
            if c2 and c2[1].is_nil():
                self.add("eval_input", c2[0], env)
                self.add("cons_cont2", expr, env, car, c2[0])

    def rule_cons_eval(self):
        for expr, env, car, cdr in self._rels["cons_cont2"]:
            for ecar in self._evals_of(car, env):
                for ecdr in self._evals_of(cdr, env):
                    self.add("cons", ecar, ecdr)
                    made = self._cons_of_pair(ecar, ecdr)
                    if made is not None:
                        self.add("eval", expr, env, made)

    # -- car/cdr op (evaluation.rs:768-800) ------------------------------------

    def rule_car_cdr_parse(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if c and c[0].is_car_cdr():
                self.add("ingress", c[1])
                self.add("car_cdr_cont1", expr, env, c[1], c[0].is_car())

    def rule_car_cdr_eval(self):
        for expr, env, tail, is_car in self._rels["car_cdr_cont1"]:
            c = self._cons_of(tail)
            if c and c[1].is_nil():
                self.add("car_cdr_cont2", expr, env, c[0], is_car)
                self.add("eval_input", c[0], env)
        for expr, env, body, is_car in self._rels["car_cdr_cont2"]:
            for evaled in self._evals_of(body, env):
                self.add("ingress", evaled)
                cc = self._cons_of(evaled)
                if cc:
                    self.add("eval", expr, env, cc[0] if is_car else cc[1])

    # -- atom op (evaluation.rs:802-822) ----------------------------------------

    def rule_atom(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if not (c and c[0].is_atom_op()):
                continue
            self.add("ingress", c[1])
            self.add("atom_cont1", expr, env, c[1])
        for expr, env, tail in self._rels["atom_cont1"]:
            c = self._cons_of(tail)
            if c and c[1].is_nil():
                self.add("eval_input", c[0], env)
                for evaled in self._evals_of(c[0], env):
                    self.add("eval", expr, env,
                             Ptr.lurk_bool(not evaled.is_cons()))

    # -- quote op (evaluation.rs:824-837) -----------------------------------------

    def rule_quote(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if c and c[0].is_quote():
                self.add("ingress", c[1])
                self.add("quote_cont1", expr, env, c[1])
        for expr, env, tail in self._rels["quote_cont1"]:
            c = self._cons_of(tail)
            if c and c[1].is_nil():
                self.add("eval", expr, env, c[0])

    # -- if (evaluation.rs:839-886) --------------------------------------------------

    def rule_if(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if not (c and c[0].is_if()):
                continue
            rest = c[1]
            self.add("ingress", rest)
            cr = self._cons_of(rest)
            if not cr:
                continue
            cond, branches = cr
            self.add("eval_input", cond, env)
            self.add("ingress", branches)
            cb = self._cons_of(branches)
            if not cb:
                continue
            a, more = cb
            for econd in self._evals_of(cond, env):
                if not econd.is_nil():
                    self.add("eval_input", a, env)
                    for res in self._evals_of(a, env):
                        self.add("eval", expr, env, res)
                else:
                    self.add("ingress", more)
                    cm = self._cons_of(more)
                    if cm and cm[1].is_nil():
                        self.add("eval_input", cm[0], env)
                        for res in self._evals_of(cm[0], env):
                            self.add("eval", expr, env, res)

    # -- function application (evaluation.rs:888-933) -------------------------------

    def rule_fun_call_head(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if not c:
                continue
            head, rest = c
            f = self._fun_of(head)
            if f:
                self.add("ingress", f[0])
                self.add("ingress", rest)
                self.add("fun_call", expr, env, f[0], f[1], f[2], rest)
            if not head.is_fun() and not head.is_built_in():
                self.add("eval_input", head, env)
                self.add("maybe_fun_call", expr, env, head, rest)

    def rule_maybe_fun_call(self):
        for expr, env, maybe_fun, rest in self._rels["maybe_fun_call"]:
            for evaled in self._evals_of(maybe_fun, env):
                f = self._fun_of(evaled)
                if f:
                    self.add("ingress", f[0])
                    self.add("ingress", rest)
                    self.add("fun_call", expr, env, f[0], f[1], f[2], rest)

    def rule_fun_call_step(self):
        for expr, env, args, body, closed_env, rest in self._rels["fun_call"]:
            self.add("ingress", args)
            self.add("ingress", rest)
            if args.is_nil() and rest.is_nil():
                self.add("eval_input", body, closed_env)
                for result in self._evals_of(body, closed_env):
                    self.add("eval", expr, env, result)
                continue
            ca = self._cons_of(args)
            cr = self._cons_of(rest)
            if not (ca and cr):
                continue
            arg, more_args = ca
            unevaled, more_vals = cr
            self.add("eval_input", unevaled, env)
            for evaled in self._evals_of(unevaled, env):
                self.add("cons", arg, evaled)
                binding = self._cons_of_pair(arg, evaled)
                if binding is None:
                    continue
                self.add("cons", binding, closed_env)
                new_env = self._cons_of_pair(binding, closed_env)
                if new_env is None:
                    continue
                self.add("fun_call", expr, env, more_args, body,
                         new_env, more_vals)

    # -- let / letrec (evaluation.rs:935-1056) ------------------------------------------

    def rule_bind_parse(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if not c:
                continue
            head, tail = c
            if head.is_binding():
                self.add("ingress", tail)
                self.add("bind_parse", expr, env, tail)
            elif head.is_recursive_binding():
                self.add("ingress", tail)
                self.add("rec_bind_parse", expr, env, tail)

    def rule_bind_base(self):
        for rel, is_rec in (("bind_parse", False), ("rec_bind_parse", True)):
            for expr, env, tail in self._rels[rel]:
                c = self._cons_of(tail)
                if not c:
                    continue
                bindings, rest = c
                self.add("ingress", bindings)
                self.add("ingress", rest)
                cr = self._cons_of(rest)
                if cr and cr[1].is_nil():
                    self.add("bind", expr, env, cr[0], env, bindings, is_rec)

    def rule_bind_body(self):
        for expr, env, body, ext_env, bindings, _is_rec in self._rels["bind"]:
            if bindings.is_nil():
                self.add("eval_input", body, ext_env)
                for result in self._evals_of(body, ext_env):
                    self.add("eval", expr, env, result)

    def rule_bind_step(self):
        for expr, env, body, ext_env, bindings, is_rec in self._rels["bind"]:
            cb = self._cons_of(bindings)
            if not cb:
                continue
            binding, more_bindings = cb
            self.add("ingress", binding)
            self.add("ingress", more_bindings)
            c2 = self._cons_of(binding)
            if not c2:
                continue
            var, binding_tail = c2
            self.add("ingress", binding_tail)
            self.add("bind_cont1", expr, env, body, ext_env, binding,
                     more_bindings, var, binding_tail, is_rec)

    def rule_bind_cont2(self):
        for row in self._rels["bind_cont1"]:
            (expr, env, body, ext_env, binding, more_bindings, var,
             binding_tail, is_rec) = row
            c = self._cons_of(binding_tail)
            if not (c and c[1].is_nil()):
                continue
            inner = c[0]
            if is_rec:
                self.add("thunk", inner, ext_env)
                self.add("bind_cont2", expr, env, body, ext_env, var,
                         inner, more_bindings, True)
            else:
                self.add("eval_input", inner, ext_env)
                self.add("bind_cont2", expr, env, body, ext_env, var,
                         inner, more_bindings, False)

    def rule_bind_cont3(self):
        thunk_by_pair = self.by("thunk_rel", 0, 1)
        for row in self._rels["bind_cont2"]:
            expr, env, body, ext_env, var, inner, more_bindings, is_rec = row
            if is_rec:
                rows = thunk_by_pair.get((inner, ext_env), [])
                vals = [r[2] for r in rows]
            else:
                vals = self._evals_of(inner, ext_env)
            for val in vals:
                self.add("cons", var, val)
                self.add("bind_cont3", expr, env, body, ext_env, var, val,
                         more_bindings, is_rec)

    def rule_bind_extend(self):
        # the "real rule" (evaluation.rs:1036-1055): extend the env with
        # the new binding and recurse on the remaining bindings
        for row in self._rels["bind_cont3"]:
            expr, env, body, ext_env, var, val, more_bindings, is_rec = row
            env_binding = self._cons_of_pair(var, val)
            if env_binding is None:
                continue
            self.add("cons", env_binding, ext_env)
            new_env = self._cons_of_pair(env_binding, ext_env)
            if new_env is None:
                continue
            self.add("bind", expr, env, body, new_env, more_bindings, is_rec)

    # -- lambda (evaluation.rs:1080-1105) ---------------------------------------------------

    def rule_lambda(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if c and c[0].is_lambda():
                self.add("ingress", c[1])
                self.add("lambda_cont1", expr, env, c[1])
        for expr, env, tail in self._rels["lambda_cont1"]:
            c = self._cons_of(tail)
            if not c:
                continue
            args, rest = c
            self.add("ingress", rest)
            cr = self._cons_of(rest)
            if cr and cr[1].is_nil():
                self.add("fun", args, cr[0], env)
                self.add("lambda_cont2", expr, env, args, cr[0])
        fun_by_key = self.by("fun_rel", 0, 1, 2)
        for expr, env, args, body in self._rels["lambda_cont2"]:
            for row in fun_by_key.get((args, body, env), []):
                self.add("eval", expr, env, row[3])

    # -- fold ops (evaluation.rs:1107-1175) ---------------------------------------------------

    def rule_fold_start(self):
        for expr, env in self._rels["eval_input"]:
            c = self._cons_of(expr)
            if not c:
                continue
            head, tail = c
            if head.is_left_foldable():
                self.add("ingress", tail)
                self.add("fold", expr, env, head, head.neutral_element(),
                         tail)
            elif head.is_right_foldable():
                self.add("ingress", tail)
                self.add("fold_right", expr, env, head, tail)
            elif head.is_relational():
                self.add("ingress", tail)
                self.add("bool_fold0", expr, env, head, tail)

    def rule_fold_step(self):
        for expr, env, op, acc, tail in self._rels["fold"]:
            if tail.is_nil():
                self.add("eval", expr, env, Ptr.num(acc))
                continue
            c = self._cons_of(tail)
            if not c:
                continue
            car, cdr = c
            self.add("eval_input", car, env)
            self.add("ingress", car)
            for ecar in self._evals_of(car, env):
                if ecar.is_num():
                    self.add("ingress", cdr)
                    self.add("fold", expr, env, op,
                             op.apply_op(acc, ecar.addr), cdr)

    def rule_fold_right_step(self):
        for expr, env, op, tail in self._rels["fold_right"]:
            if tail.is_nil():
                self.add("eval", expr, env, Ptr.num(op.neutral_element()))
                continue
            c = self._cons_of(tail)
            if not c:
                continue
            car, cdr = c
            self.add("eval_input", car, env)
            self.add("ingress", car)
            for ecar in self._evals_of(car, env):
                if ecar.is_num():
                    self.add("ingress", cdr)
                    self.add("fold", expr, env, op, ecar.addr, cdr)

    def rule_bool_fold(self):
        for expr, env, op, tail in self._rels["bool_fold0"]:
            if tail.is_nil():
                self.add("eval", expr, env, Ptr.t())
                continue
            c = self._cons_of(tail)
            if not c:
                continue
            car, cdr = c
            self.add("eval_input", car, env)
            self.add("ingress", car)
            self.add("ingress", cdr)
            for ecar in self._evals_of(car, env):
                self.add("ingress", tail)
                self.add("bool_fold", expr, env, op, ecar.addr, cdr)
        for expr, env, op, acc, tail in self._rels["bool_fold"]:
            if tail.is_nil():
                self.add("eval", expr, env, Ptr.t())
                continue
            c = self._cons_of(tail)
            if not c:
                continue
            car, cdr = c
            self.add("eval_input", car, env)
            self.add("ingress", car)
            self.add("ingress", cdr)
            for ecar in self._evals_of(car, env):
                if cdr.is_nil():
                    self.add("eval", expr, env,
                             op.apply_relop(acc, ecar.addr))
                elif cdr.is_cons():
                    if op.apply_relop(acc, ecar.addr) == Ptr.t():
                        self.add("ingress", cdr)
                        self.add("bool_fold", expr, env, op, ecar.addr, cdr)
                    else:
                        # short-circuit false: return nil. The reference's
                        # rule set only continues on true and derives NO
                        # eval fact for e.g. (= 1n 2n 3n)
                        # (evaluation.rs:1166-1174, acknowledged TODO);
                        # here the relational evaluator agrees with the
                        # production evaluator instead.
                        self.add("eval", expr, env, Ptr.nil())

    # -- output (evaluation.rs:1177) -----------------------------------------------------------

    def rule_output(self):
        for input_expr, env in self._rels["input_ptr"]:
            for output in self._evals_of(input_expr, env):
                self.add("output_ptr", output)

    # ========================================================================
    # Public driver API
    # ========================================================================

    def set_toplevel_input(self, expr: WidePtr, env: Optional[WidePtr] = None):
        if env is None:
            nil = self.zstore.nil
            env = WidePtr.from_zptr(nil)
        self.add("toplevel_input", expr, env)

    @property
    def output_exprs(self) -> List[WidePtr]:
        return [row[0] for row in self._rels["output_expr"]]


class EvaluationProgram(_LurkEvalRules):
    """First-pass program: allocating memory lattices
    (evaluation.rs:205-423)."""

    def __init__(self, zstore):
        super().__init__(zstore)
        self.lattice("cons_digest_mem")   # value -> min addr
        self.lattice("cons_mem")          # (car, cdr) -> min addr
        self.lattice("fun_digest_mem")
        self.lattice("fun_mem")           # (args, body, env) -> addr
        self.lattice("thunk_digest_mem")
        self.lattice("thunk_mem")         # (body, env) -> addr
        self.lattice("sym_digest_mem", initial_symbol_relation(zstore))
        self.lattice("builtin_digest_mem", initial_builtin_relation(zstore))

    # -- allocation rules (evaluation.rs:266-423) -----------------------

    def rule_mem_alloc(self):
        spec = {int(Tag.Cons): ("cons_digest_mem", 0),
                int(Tag.Fun): ("fun_digest_mem", 0),
                int(Tag.Fix): ("thunk_digest_mem", 0),
                int(Tag.Sym): ("sym_digest_mem", initial_symbol_addr()),
                int(Tag.Builtin): ("builtin_digest_mem",
                                   initial_builtin_addr())}
        for tag, value in self._rels["alloc"]:
            if tag == Tag.Num:
                self.add("ptr_value", Ptr(Tag.Num, value[0]), value)
                continue
            entry = spec.get(tag)
            if entry is None:
                continue
            rel, init = entry
            existing = self._rels[rel].get(value)
            if existing is not None:
                continue
            addr = self.memo((rel, value),
                             lambda t=tag, i=init:
                             self.allocator.alloc_addr(t, i))
            self.add(rel, value, addr)

    def rule_mem_construct(self):
        for rel, mem, tag in (("cons", "cons_mem", Tag.Cons),
                              ("thunk", "thunk_mem", Tag.Fix),
                              ("fun", "fun_mem", Tag.Fun)):
            for row in self._rels[rel]:
                if self._rels[mem].get(*row) is not None:
                    continue
                addr = self.memo((mem, row),
                                 lambda t=int(tag):
                                 self.allocator.alloc_addr(t, 0))
                self.add(mem, *row, addr)

    def rule_mem_register(self):
        # digest lattices -> ptr_value; content lattices -> *_rel
        for rel, tag in (("cons_digest_mem", Tag.Cons),
                         ("fun_digest_mem", Tag.Fun),
                         ("thunk_digest_mem", Tag.Fix),
                         ("sym_digest_mem", Tag.Sym),
                         ("builtin_digest_mem", Tag.Builtin)):
            for row in self._rels[rel]:
                value, addr = row[0], row[-1]
                self.add("ptr_value", Ptr(int(tag), addr), value)
        for row in self._rels["cons_mem"]:
            car, cdr, addr = row
            self.add("cons_rel", car, cdr, Ptr(Tag.Cons, addr))
        for row in self._rels["fun_mem"]:
            args, body, env, addr = row
            self.add("fun_rel", args, body, env, Ptr(Tag.Fun, addr))
        for row in self._rels["thunk_mem"]:
            body, env, addr = row
            self.add("thunk_rel", body, env, Ptr(Tag.Fix, addr))

    def rule_mem_cross_link(self):
        """Link content- and digest-allocated views of the same object
        through hash4_rel/hash5_rel (evaluation.rs:289-300 etc.); the
        lattice min then merges the two addresses."""
        pv = self.by("ptr_value", 0)
        pv_by_value = self.by("ptr_value", 1)
        h4_by_digest = self.by("hash4_rel", 4)
        h5_by_digest = self.by("hash5_rel", 5)

        def val(p):
            rows = pv.get((p,), [])
            return rows[0][1] if rows else None

        h4 = self.by("hash4_rel", 0, 1, 2, 3)
        for row in self._rels["cons_mem"]:
            car, cdr, addr = row
            cv, dv = val(car), val(cdr)
            if cv is None or dv is None:
                continue
            for *_, digest in h4.get(
                    (car.wide_tag(), cv, cdr.wide_tag(), dv), []):
                self.add("cons_digest_mem", digest, addr)
        for digest, addr in self._rels["cons_digest_mem"]:
            for a, b, c, d, _ in h4_by_digest.get((digest,), []):
                for car, _ in pv_by_value.get((b,), []):
                    if car.wide_tag() != a:
                        continue
                    for cdr, _ in pv_by_value.get((d,), []):
                        if cdr.wide_tag() != c:
                            continue
                        self.add("cons_mem", car, cdr, addr)
        for row in self._rels["thunk_mem"]:
            body, env, addr = row
            bv, ev = val(body), val(env)
            if bv is None or ev is None:
                continue
            for *_, digest in h4.get(
                    (body.wide_tag(), bv, env.wide_tag(), ev), []):
                self.add("thunk_digest_mem", digest, addr)
        for digest, addr in self._rels["thunk_digest_mem"]:
            for a, b, c, d, _ in h4_by_digest.get((digest,), []):
                for body, _ in pv_by_value.get((b,), []):
                    if body.wide_tag() != a:
                        continue
                    for env, _ in pv_by_value.get((d,), []):
                        if env.wide_tag() != c:
                            continue
                        self.add("thunk_mem", body, env, addr)
        h5 = self.by("hash5_rel", 0, 1, 2, 3, 4)
        for row in self._rels["fun_mem"]:
            args, body, env, addr = row
            av, bv, ev = val(args), val(body), val(env)
            if av is None or bv is None or ev is None:
                continue
            for *_, digest in h5.get(
                    (args.wide_tag(), av, body.wide_tag(), bv, ev), []):
                self.add("fun_digest_mem", digest, addr)
        for digest, addr in self._rels["fun_digest_mem"]:
            for a, b, c, d, e, _ in h5_by_digest.get((digest,), []):
                for args, _ in pv_by_value.get((b,), []):
                    if args.wide_tag() != a:
                        continue
                    for body, _ in pv_by_value.get((d,), []):
                        if body.wide_tag() != c:
                            continue
                        for env, _ in pv_by_value.get((e,), []):
                            if env.tag != Tag.Cons:
                                continue
                            self.add("fun_mem", args, body, env, addr)

    # -- memory export (mod.rs:293-330) ----------------------------------

    def export_memory(self) -> VirtualMemory:
        vm = VirtualMemory()
        for ptr, value in self._rels["ptr_value"]:
            vm.ptr_value[VPtr(*ptr)] = value
        for car, cdr, cons in self._rels["cons_rel"]:
            vm.cons_mem[VPtr(*cons)] = (VPtr(*car), VPtr(*cdr))
        for args, body, env, fun in self._rels["fun_rel"]:
            vm.fun_mem[VPtr(*fun)] = (VPtr(*args), VPtr(*body), VPtr(*env))
        for body, env, thunk in self._rels["thunk_rel"]:
            vm.thunk_mem[VPtr(*thunk)] = (VPtr(*body), VPtr(*env))
        return vm


class DistilledEvaluationProgram(_LurkEvalRules):
    """Second-pass program: runs the same evaluation rules against an
    imported, distilled memory; nothing allocates
    (distilled_evaluation.rs:23-1012)."""

    def __init__(self, zstore, memory: Memory):
        super().__init__(zstore)
        self.relation("cons_digest_mem",
                      [tuple(r) for r in memory.cons_digest_mem])
        self.relation("cons_mem", [tuple(r) for r in memory.cons_mem])
        self.relation("fun_digest_mem",
                      [tuple(r) for r in memory.fun_digest_mem])
        self.relation("fun_mem", [tuple(r) for r in memory.fun_mem])
        self.relation("thunk_digest_mem",
                      [tuple(r) for r in memory.thunk_digest_mem])
        self.relation("thunk_mem", [tuple(r) for r in memory.thunk_mem])
        self.relation("sym_digest_mem",
                      [tuple(r) for r in memory.sym_digest_mem])
        self.relation("builtin_digest_mem",
                      [tuple(r) for r in memory.builtin_digest_mem])

    def rule_mem_lookup(self):
        # Register ptr_value only for alloc'd digests present in the
        # imported memory (distilled_evaluation.rs:98-231).
        for rel, tag in (("cons_digest_mem", Tag.Cons),
                         ("fun_digest_mem", Tag.Fun),
                         ("thunk_digest_mem", Tag.Fix)):
            idx = self.by(rel, 0)
            for atag, value in self._rels["alloc"]:
                if atag != tag:
                    continue
                for _, addr in idx.get((value,), []):
                    self.add("ptr_value", Ptr(int(tag), addr), value)
        for rel, tag in (("sym_digest_mem", Tag.Sym),
                         ("builtin_digest_mem", Tag.Builtin)):
            for value, addr in self._rels[rel]:
                self.add("ptr_value", Ptr(int(tag), addr), value)
        for atag, value in self._rels["alloc"]:
            if atag == Tag.Num:
                self.add("ptr_value", Ptr(Tag.Num, value[0]), value)

    def rule_mem_construct(self):
        cons_by_pair = self.by("cons_mem", 0, 1)
        for car, cdr in self._rels["cons"]:
            for *_, addr in cons_by_pair.get((car, cdr), []):
                self.add("cons_rel", car, cdr, Ptr(Tag.Cons, addr))
        fun_by_key = self.by("fun_mem", 0, 1, 2)
        for args, body, env in self._rels["fun"]:
            for *_, addr in fun_by_key.get((args, body, env), []):
                self.add("fun_rel", args, body, env, Ptr(Tag.Fun, addr))
        thunk_by_pair = self.by("thunk_mem", 0, 1)
        for body, env in self._rels["thunk"]:
            for *_, addr in thunk_by_pair.get((body, env), []):
                self.add("thunk_rel", body, env, Ptr(Tag.Fix, addr))

    # NOTE: no wholesale mem -> *_rel registration here. The reference's
    # distilled program derives cons_rel/fun_rel/thunk_rel only on demand
    # (distilled_evaluation.rs:103-104: cons_rel <-- cons(car, cdr),
    # cons_mem(car, cdr, addr)) - that is rule_mem_construct above plus
    # the digest direction in rule_mem_cross_link. Registering every
    # imported row unconditionally would mask distillation bugs the
    # second-pass consistency check exists to catch.

    def rule_mem_cross_link(self):
        # hash4_rel/hash5_rel <-> ptr_value links (distilled_evaluation.rs
        # cons/fun/thunk "other way around" rules)
        pv = self.by("ptr_value", 0)
        pv_by_value = self.by("ptr_value", 1)
        h4_by_digest = self.by("hash4_rel", 4)
        h5_by_digest = self.by("hash5_rel", 5)
        h4 = self.by("hash4_rel", 0, 1, 2, 3)
        h5 = self.by("hash5_rel", 0, 1, 2, 3, 4)

        def val(p):
            rows = pv.get((p,), [])
            return rows[0][1] if rows else None

        for car, cdr, cons in self._rels["cons_rel"]:
            cv, dv = val(car), val(cdr)
            if cv is None or dv is None:
                continue
            for *_, digest in h4.get(
                    (car.wide_tag(), cv, cdr.wide_tag(), dv), []):
                self.add("ptr_value", cons, digest)
        for ptr, digest in self._rels["ptr_value"]:
            if ptr.tag == Tag.Cons:
                for a, b, c, d, _ in h4_by_digest.get((digest,), []):
                    for car, _ in pv_by_value.get((b,), []):
                        if car.wide_tag() != a:
                            continue
                        for cdr, _ in pv_by_value.get((d,), []):
                            if cdr.wide_tag() != c:
                                continue
                            self.add("cons_rel", car, cdr, ptr)
            elif ptr.tag == Tag.Fix:
                for a, b, c, d, _ in h4_by_digest.get((digest,), []):
                    for body, _ in pv_by_value.get((b,), []):
                        if body.wide_tag() != a:
                            continue
                        for env, _ in pv_by_value.get((d,), []):
                            if env.wide_tag() != c:
                                continue
                            self.add("thunk_rel", body, env, ptr)
            elif ptr.tag == Tag.Fun:
                for a, b, c, d, e, _ in h5_by_digest.get((digest,), []):
                    for args, _ in pv_by_value.get((b,), []):
                        if args.wide_tag() != a:
                            continue
                        for body, _ in pv_by_value.get((d,), []):
                            if body.wide_tag() != c:
                                continue
                            for env, _ in pv_by_value.get((e,), []):
                                if env.tag != Tag.Cons:
                                    continue
                                self.add("fun_rel", args, body, env, ptr)
        for args, body, env, fun in self._rels["fun_rel"]:
            av, bv, ev = val(args), val(body), val(env)
            if av is None or bv is None or ev is None:
                continue
            for *_, digest in h5.get(
                    (args.wide_tag(), av, body.wide_tag(), bv, ev), []):
                self.add("ptr_value", fun, digest)
        for body, env, thunk in self._rels["thunk_rel"]:
            bv, ev = val(body), val(env)
            if bv is None or ev is None:
                continue
            for *_, digest in h4.get(
                    (body.wide_tag(), bv, env.wide_tag(), ev), []):
                self.add("ptr_value", thunk, digest)
