"""The map_double pedagogy program.

Reference: /root/reference/src/loam/allocation.rs:196-378
(AllocationProgram): ingress a cons tree of Nums, double every Num,
cons up the doubled tree, egress its digest. Exercises the full
allocate/ingress/egress machinery without the Lurk evaluator.

Like the reference - where every `ascent!` program is standalone and
AllocationProgram restates the alloc/ingress/egress rules that
evaluation.rs also carries - this program deliberately duplicates the
flush/cons/cross-link rules from evaluation.py rather than sharing a
mixin: the point of the pedagogy program is that its full rule set is
readable in one place, and its rules are pinned to allocation.rs line
anchors rather than to the evaluator's.
"""

from __future__ import annotations

from ..core.tag import Tag
from ..field.babybear import P
from .allocation import Allocator
from .engine import Program
from .types import Ptr, WidePtr, widen, tag_wide_relation


class AllocationProgram(Program):
    def __init__(self, zstore):
        super().__init__()
        self.zstore = zstore
        self.allocator = Allocator()
        self.allocator.import_zstore(zstore)
        self.relation("tag", tag_wide_relation())
        self.relation("ptr_value")
        self.relation("input_expr")
        self.relation("output_expr")
        self.relation("input_ptr")
        self.relation("output_ptr")
        self.relation("cons")
        self.relation("hash4")
        self.relation("unhash4")
        self.relation("hash4_rel")
        self.relation("egress")
        self.relation("ingress")
        self.relation("alloc")
        self.relation("cons_rel")
        self.lattice("cons_digest_mem")
        self.lattice("cons_mem")
        self.relation("map_double_input")
        self.relation("map_double")
        self.relation("map_double_cont")

    def flush(self):
        todo = [row for row in self._rels["hash4"]
                if not self.by("hash4_rel", 0, 1, 2, 3).get(row)]
        if todo:
            for row, d in zip(todo, self.allocator.hash_rows_batch(todo)):
                self.add("hash4_rel", *row, d)

    def _cons_of(self, ptr):
        rows = self.by("cons_rel", 2).get((ptr,))
        return (rows[0][0], rows[0][1]) if rows else None

    def _cons_of_pair(self, car, cdr):
        rows = self.by("cons_rel", 0, 1).get((car, cdr))
        return rows[0][2] if rows else None

    # -- memory rules (allocation.rs:236-283) -------------------------------

    def rule_alloc_mem(self):
        for tag, value in self._rels["alloc"]:
            if tag == Tag.Num:
                self.add("ptr_value", Ptr(Tag.Num, value[0]), value)
            elif tag == Tag.Cons:
                if self._rels["cons_digest_mem"].get(value) is None:
                    addr = self.memo(
                        ("cons_digest_mem", value),
                        lambda: self.allocator.alloc_addr(int(Tag.Cons), 0))
                    self.add("cons_digest_mem", value, addr)

    def rule_cons_mem(self):
        for car, cdr in self._rels["cons"]:
            if self._rels["cons_mem"].get(car, cdr) is None:
                addr = self.memo(
                    ("cons_mem", car, cdr),
                    lambda: self.allocator.alloc_addr(int(Tag.Cons), 0))
                self.add("cons_mem", car, cdr, addr)

    def rule_register(self):
        for value, addr in self._rels["cons_digest_mem"]:
            self.add("ptr_value", Ptr(Tag.Cons, addr), value)
        for car, cdr, addr in self._rels["cons_mem"]:
            self.add("cons_rel", car, cdr, Ptr(Tag.Cons, addr))

    def rule_cross_link(self):
        pv = self.by("ptr_value", 0)
        pv_by_value = self.by("ptr_value", 1)
        h4 = self.by("hash4_rel", 0, 1, 2, 3)
        h4_by_digest = self.by("hash4_rel", 4)

        def val(p):
            rows = pv.get((p,), [])
            return rows[0][1] if rows else None

        for car, cdr, addr in self._rels["cons_mem"]:
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

    # -- ingress (allocation.rs:289-311) -------------------------------------

    def rule_ingress(self):
        tag_by_wide = self.by("tag", 1)
        pv_by_value = self.by("ptr_value", 1)
        pv = self.by("ptr_value", 0)
        for (wp,) in self._rels["input_expr"]:
            for t, _ in tag_by_wide.get((wp.tag,), []):
                self.add("alloc", t, wp.value)
            for ptr, _ in pv_by_value.get((wp.value,), []):
                if ptr.tag == wp.ptr_tag():
                    self.add("ingress", ptr)
                    self.add("input_ptr", ptr)
        for (ptr,) in self._rels["ingress"]:
            if ptr.is_cons():
                for _, digest in pv.get((ptr,), []):
                    self.add("unhash4", digest)
        for (digest,) in self._rels["unhash4"]:
            if digest in self.allocator.preimage_cache:
                a, b, c, d = self.allocator.unhash4(digest)
                self.add("hash4_rel", a, b, c, d, digest)
        h4_by_digest = self.by("hash4_rel", 4)
        for (digest,) in self._rels["unhash4"]:
            for a, b, c, d, _ in h4_by_digest.get((digest,), []):
                for ct, _ in tag_by_wide.get((a,), []):
                    for dt, _ in tag_by_wide.get((c,), []):
                        self.add("alloc", ct, b)
                        self.add("alloc", dt, d)

    # -- map_double (allocation.rs:331-355) -----------------------------------

    def rule_map_double(self):
        for (ptr,) in self._rels["input_ptr"]:
            self.add("map_double_input", ptr)
        md = self.by("map_double", 0)
        for (ptr,) in self._rels["map_double_input"]:
            self.add("ingress", ptr)
            if ptr.is_num():
                self.add("map_double", ptr, Ptr(Tag.Num, (2 * ptr.addr) % P))
                continue
            c = self._cons_of(ptr)
            if not c:
                continue
            self.add("map_double_input", c[0])
            self.add("map_double_input", c[1])
            dcar = md.get((c[0],))
            dcdr = md.get((c[1],))
            if dcar and dcdr:
                self.add("cons", dcar[0][1], dcdr[0][1])
                self.add("map_double_cont", ptr, dcar[0][1], dcdr[0][1])
        for ptr, dcar, dcdr in self._rels["map_double_cont"]:
            made = self._cons_of_pair(dcar, dcdr)
            if made is not None:
                self.add("map_double", ptr, made)
        md = self.by("map_double", 0)
        for (ptr,) in self._rels["input_ptr"]:
            for row in md.get((ptr,), []):
                self.add("output_ptr", row[1])

    # -- egress (allocation.rs:313-329) -----------------------------------------

    def rule_egress(self):
        pv = self.by("ptr_value", 0)

        def val(p):
            rows = pv.get((p,), [])
            return rows[0][1] if rows else None

        for (ptr,) in self._rels["output_ptr"]:
            self.add("egress", ptr)
        for (ptr,) in self._rels["egress"]:
            if ptr.is_num():
                self.add("ptr_value", ptr, widen(ptr.addr))
                continue
            c = self._cons_of(ptr)
            if c:
                self.add("egress", c[0])
                self.add("egress", c[1])
                cv, dv = val(c[0]), val(c[1])
                if cv is not None and dv is not None:
                    self.add("hash4", c[0].wide_tag(), cv,
                             c[1].wide_tag(), dv)
        for (ptr,) in self._rels["output_ptr"]:
            for _, value in pv.get((ptr,), []):
                self.add("output_expr", WidePtr(ptr.wide_tag(), value))

    # -- driver API ---------------------------------------------------------------

    def set_input(self, wp: WidePtr):
        self.add("input_expr", wp)

    @property
    def output_exprs(self):
        return [row[0] for row in self._rels["output_expr"]]
