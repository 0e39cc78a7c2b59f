"""Loam memory: virtual memory export, distillation, physical Store.

Reference: /root/reference/src/loam/memory.rs. A first-pass Loam run
allocates *virtual* pointers (VPtr) freely - structurally equal objects
may get many addresses. Distillation interns the virtual memory into a
`Store` that deduplicates structurally (hash-consing on children), then
reconstructs a compact `Memory` whose physical pointers (PPtr) are dense
per-tag addresses. The second-pass (distilled) program re-runs evaluation
against that memory and must reproduce the same output - the
deduplication consistency check.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..core.state import BUILTIN_SYMBOLS
from ..core.symbol import builtin_sym, lurk_sym
from ..core.tag import Tag
from .allocation import Allocator
from .types import Ptr, Wide, tag_wide_relation


class VPtr(Ptr):
    """Virtual pointer (memory.rs:44-77)."""

    @staticmethod
    def num(addr: int) -> "VPtr":
        return VPtr(Tag.Num, addr)

    @staticmethod
    def cons(addr: int) -> "VPtr":
        return VPtr(Tag.Cons, addr)

    @staticmethod
    def fun(addr: int) -> "VPtr":
        return VPtr(Tag.Fun, addr)


class PPtr(Ptr):
    """Physical (distilled) pointer (memory.rs:79-119)."""

    @staticmethod
    def num(addr: int) -> "PPtr":
        return PPtr(Tag.Num, addr)

    @staticmethod
    def cons(addr: int) -> "PPtr":
        return PPtr(Tag.Cons, addr)


@dataclass
class Memory:
    """Distilled relation rows, importable by the second-pass program
    (memory.rs:20-42)."""
    cons_digest_mem: List[Tuple[Wide, int]] = field(default_factory=list)
    cons_mem: List[Tuple[Ptr, Ptr, int]] = field(default_factory=list)
    fun_digest_mem: List[Tuple[Wide, int]] = field(default_factory=list)
    fun_mem: List[Tuple[Ptr, Ptr, Ptr, int]] = field(default_factory=list)
    thunk_digest_mem: List[Tuple[Wide, int]] = field(default_factory=list)
    thunk_mem: List[Tuple[Ptr, Ptr, int]] = field(default_factory=list)
    sym_digest_mem: List[Tuple[Wide, int]] = field(default_factory=list)
    builtin_digest_mem: List[Tuple[Wide, int]] = field(default_factory=list)

    def report_sizes(self, summary: "DistillationSummary"):
        summary.set_distilled_size(Tag.Cons, len(self.cons_mem))
        summary.set_distilled_size(Tag.Fun, len(self.fun_mem))
        summary.set_distilled_size(Tag.Fix, len(self.thunk_mem))


@dataclass
class VirtualMemory:
    """First-pass export (memory.rs:136-183)."""
    ptr_value: Dict[VPtr, Wide] = field(default_factory=dict)
    cons_mem: Dict[VPtr, Tuple[VPtr, VPtr]] = field(default_factory=dict)
    fun_mem: Dict[VPtr, Tuple[VPtr, VPtr, VPtr]] = field(default_factory=dict)
    thunk_mem: Dict[VPtr, Tuple[VPtr, VPtr]] = field(default_factory=dict)

    def report_sizes(self, summary: "DistillationSummary"):
        summary.set_original_size(Tag.Cons, len(self.cons_mem))
        summary.set_original_size(Tag.Fun, len(self.fun_mem))
        summary.set_original_size(Tag.Fix, len(self.thunk_mem))

    def distill(self, options: Optional["DistillationOptions"] = None,
                store: Optional["Store"] = None) -> Memory:
        store = store if store is not None else Store()
        store.intern_virtual_memory(self)
        distilled = store.reconstruct_memory()
        if options is not None and options.summary_threshold is not None:
            summary = DistillationSummary(options.summary_threshold)
            self.report_sizes(summary)
            distilled.report_sizes(summary)
            summary.report()
        return distilled


@dataclass
class DistillationOptions:
    summary_threshold: Optional[float] = None

    def with_summary(self, threshold: float) -> "DistillationOptions":
        self.summary_threshold = threshold
        return self


class DistillationSummary:
    """Reduction report (memory.rs:203-263)."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.original: Dict[Tag, int] = {}
        self.distilled: Dict[Tag, int] = {}

    def set_original_size(self, tag: Tag, size: int):
        self.original[tag] = size

    def set_distilled_size(self, tag: Tag, size: int):
        self.distilled[tag] = size

    def lines(self) -> List[str]:
        out = ["Distillation summary:"]
        for tag, orig in self.original.items():
            dist = self.distilled.get(tag, 0)
            ratio = dist / orig if orig else 1.0
            flag = "  [!ABOVE THRESHOLD]" if ratio > self.threshold else ""
            out.append(f"  {tag.name}: {orig} -> {dist} "
                       f"({ratio:.0%} kept){flag}")
        return out

    def report(self):
        print("\n".join(self.lines()))


class Store:
    """Physical store: hash-consed DAG + digest maps (memory.rs:265-533)."""

    def __init__(self):
        self.allocator = Allocator()
        self.dag: Dict[PPtr, Tuple[tuple, Optional[Wide]]] = {}
        self.inv_dag: Dict[Tuple[int, tuple], PPtr] = {}
        self.pptr_digest: Dict[PPtr, Wide] = {}
        self.digest_pptr: Dict[Wide, PPtr] = {}
        self.vptr_pptr: Dict[VPtr, PPtr] = {}

    # -- interning --------------------------------------------------------

    def _intern_tuple(self, tag: Tag, children: tuple) -> PPtr:
        key = (int(tag), children)
        ptr = self.inv_dag.get(key)
        if ptr is not None:
            return ptr
        addr = self.allocator.alloc_addr(int(tag), 0)
        ptr = PPtr(int(tag), addr)
        self.dag[ptr] = (children, None)
        self.inv_dag[key] = ptr
        return ptr

    def intern_tuple2(self, tag: Tag, p1: PPtr, p2: PPtr) -> PPtr:
        return self._intern_tuple(tag, (p1, p2))

    def intern_tuple3(self, tag: Tag, p1: PPtr, p2: PPtr, p3: PPtr) -> PPtr:
        return self._intern_tuple(tag, (p1, p2, p3))

    def intern_ptr(self, vptr: VPtr, memory: VirtualMemory) -> PPtr:
        known = self.vptr_pptr.get(vptr)
        if known is not None:
            return known
        tag = Tag(vptr.tag)

        def _row(table):
            # a compound reachable from an interned parent but never
            # unhashed has no memory row; fail like the reference's
            # .expect("dangling virtual pointer") (memory.rs:323-348)
            # instead of a bare KeyError
            row = table.get(vptr)
            if row is None:
                raise ValueError(f"dangling virtual pointer: {vptr}")
            return row

        if tag == Tag.Cons:
            vcar, vcdr = _row(memory.cons_mem)
            ptr = self.intern_tuple2(Tag.Cons, self.intern_ptr(vcar, memory),
                                     self.intern_ptr(vcdr, memory))
        elif tag == Tag.Fun:
            va, vb, ve = _row(memory.fun_mem)
            ptr = self.intern_tuple3(Tag.Fun, self.intern_ptr(va, memory),
                                     self.intern_ptr(vb, memory),
                                     self.intern_ptr(ve, memory))
        elif tag == Tag.Fix:
            vb, ve = _row(memory.thunk_mem)
            ptr = self.intern_tuple2(Tag.Fix, self.intern_ptr(vb, memory),
                                     self.intern_ptr(ve, memory))
        elif tag in (Tag.Sym, Tag.Num, Tag.Err, Tag.Builtin):
            ptr = PPtr(vptr.tag, vptr.addr)
        else:
            raise NotImplementedError(f"unimplemented: {vptr}")
        self.vptr_pptr[vptr] = ptr
        return ptr

    def intern_digest(self, vptr: VPtr, digest: Wide):
        """Attach a known digest to the physical image of vptr
        (memory.rs:365-383); dangling vptrs become opaque."""
        ptr = self.vptr_pptr.get(vptr)
        if ptr is None:
            ptr = PPtr(vptr.tag, vptr.addr)
            self.vptr_pptr[vptr] = ptr
        if ptr in self.dag:
            children, _ = self.dag[ptr]
            self.dag[ptr] = (children, digest)
            self.digest_pptr[digest] = ptr
        else:
            other = self.pptr_digest.get(ptr)
            if other is not None:
                assert digest == other, "conflicting digests for one ptr"
            else:
                self.pptr_digest[ptr] = digest
                self.digest_pptr[digest] = ptr
        return ptr

    def intern_virtual_memory(self, memory: VirtualMemory):
        for cons in memory.cons_mem:
            self.intern_ptr(cons, memory)
        for fun in memory.fun_mem:
            self.intern_ptr(fun, memory)
        for thunk in memory.thunk_mem:
            self.intern_ptr(thunk, memory)
        for vptr, digest in memory.ptr_value.items():
            if Tag(vptr.tag) in (Tag.Cons, Tag.Fun, Tag.Fix) \
                    and vptr not in self.vptr_pptr:
                continue  # dangling digest-only compound: drop
            self.intern_digest(vptr, digest)

    # -- reconstruction (memory.rs:401-453) --------------------------------

    def reconstruct_memory(self) -> Memory:
        memory = Memory()
        for ptr in sorted(self.dag):
            children, maybe_digest = self.dag[ptr]
            tag = Tag(ptr.tag)
            if tag == Tag.Cons:
                car, cdr = children
                memory.cons_mem.append((Ptr(*car), Ptr(*cdr), ptr.addr))
                if maybe_digest is not None:
                    memory.cons_digest_mem.append((maybe_digest, ptr.addr))
            elif tag == Tag.Fun:
                a, b, e = children
                memory.fun_mem.append(
                    (Ptr(*a), Ptr(*b), Ptr(*e), ptr.addr))
                if maybe_digest is not None:
                    memory.fun_digest_mem.append((maybe_digest, ptr.addr))
            elif tag == Tag.Fix:
                b, e = children
                memory.thunk_mem.append((Ptr(*b), Ptr(*e), ptr.addr))
                if maybe_digest is not None:
                    memory.thunk_digest_mem.append((maybe_digest, ptr.addr))
            else:
                raise AssertionError(f"floating pointer: {ptr}")
        for ptr, digest in self.pptr_digest.items():
            tag = Tag(ptr.tag)
            if tag == Tag.Sym:
                memory.sym_digest_mem.append((digest, ptr.addr))
            elif tag == Tag.Builtin:
                memory.builtin_digest_mem.append((digest, ptr.addr))
            elif tag == Tag.Num:
                pass
            else:
                raise NotImplementedError(f"unimplemented: {ptr}")
        return memory

    # -- fetching (memory.rs:455-533) ---------------------------------------

    def fetch_tuple2(self, ptr: PPtr):
        children, _ = self.dag[ptr]
        assert len(children) == 2, f"Tuple2 data not found on DAG: {ptr}"
        return children

    def fetch_tuple3(self, ptr: PPtr):
        children, _ = self.dag[ptr]
        assert len(children) == 3, f"Tuple3 data not found on DAG: {ptr}"
        return children

    def fetch_list(self, ptr: PPtr):
        assert ptr.tag == Tag.Cons or ptr == Ptr.nil()
        elts = []
        while ptr.tag == Tag.Cons:
            car, cdr = self.fetch_tuple2(ptr)
            elts.append(car)
            ptr = cdr
        return (elts, None) if ptr == Ptr.nil() else (elts, ptr)

    def zptr_ptr(self, zptr) -> Optional[Ptr]:
        digest = tuple(int(x) for x in zptr.digest)
        pptr = self.digest_pptr.get(digest)
        return Ptr(pptr.tag, pptr.addr) if pptr is not None else None

    def fmt(self, zstore, ptr: PPtr) -> str:
        from ..core.zstore import ZPtr
        tag = Tag(ptr.tag)
        if tag == Tag.Num:
            return f"{ptr.addr}n"
        if tag in (Tag.Builtin, Tag.BigNum, Tag.Sym, Tag.Key, Tag.Coroutine):
            digest = self.pptr_digest.get(ptr)
            if digest is None:
                return f"<Opaque {ptr}>"
            return zstore.fmt(ZPtr(tag, digest))
        if tag == Tag.Cons:
            elts, last = self.fetch_list(ptr)
            body = " ".join(self.fmt(zstore, e) for e in elts)
            if last is not None:
                return f"({body} . {self.fmt(zstore, last)})"
            return f"({body})"
        if tag == Tag.Fun:
            args, fbody, _ = self.fetch_tuple3(ptr)
            if args == Ptr.nil():
                return f"<Fun () {self.fmt(zstore, fbody)}>"
            return f"<Fun {self.fmt(zstore, args)} {self.fmt(zstore, fbody)}>"
        if tag == Tag.Fix:
            body = self.fetch_tuple2(ptr)[0]
            return f"<Thunk {self.fmt(zstore, body)}>"
        if tag == Tag.Err:
            return f"<Err {ptr.addr}>"
        raise NotImplementedError(tag)


# -- initial relations (memory.rs:535-595) ----------------------------------

def initial_builtin_relation(zstore) -> List[Tuple[Wide, int]]:
    rows = []
    for i, name in enumerate(BUILTIN_SYMBOLS):
        zptr = zstore.intern_symbol(builtin_sym(name))
        rows.append((tuple(int(x) for x in zptr.digest), i))
    return rows


def initial_builtin_addr() -> int:
    return len(BUILTIN_SYMBOLS)


def initial_symbol_relation(zstore) -> List[Tuple[Wide, int]]:
    nil = zstore.intern_symbol(lurk_sym("nil"))
    t = zstore.intern_symbol(lurk_sym("t"))
    return [(tuple(int(x) for x in nil.digest), 0),
            (tuple(int(x) for x in t.digest), 1)]


def initial_symbol_addr() -> int:
    return 2


def initial_tag_relation():
    return tag_wide_relation()


def generate_lisp_program(n: int, op: str) -> str:
    """Equality-stress program builder (memory.rs:598-654): two cons-chains
    over shared structure, compared with `op`."""
    x = [f"x{i}" for i in range(n)]
    y = [f"y{i}" for i in range(n)]
    a = [f"a{i}" for i in range(n)]
    b = [f"b{i}" for i in range(n)]

    out = ["((lambda (", " ".join(x), ")\n"]
    out.append("    (let (")
    for i in range(n):
        out.append(f"({y[i]} (cons {2 * i + 1}n {2 * i + 2}n))\n          ")
    out.append("\n          (a0 x0)\n          ")
    for i in range(n - 1):
        curr = y[i + 1] if i % 2 == 0 else x[i + 1]
        out.append(f"({a[i + 1]} (cons {a[i]} {curr}))\n          ")
    out.append("\n          (b0 y0)\n          ")
    for i in range(n - 1):
        curr = y[i + 1] if i % 2 == 1 else x[i + 1]
        out.append(f"({b[i + 1]} (cons {b[i]} {curr}))\n          ")
    out.append(")\n")
    out.append(f"\n        ({op} {a[n - 1]} {b[n - 1]})\n    ))\n    ")
    for i in range(n):
        out.append(f"'({2 * i + 1}n . {2 * i + 2}n) ")
    out.append(")")
    return "".join(out)
