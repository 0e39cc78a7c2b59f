"""A small Datalog fixpoint engine for Loam programs.

The reference implements Loam on the `ascent` Rust engine plus a `loam!`
proc-macro layer (reference: /root/reference/src/loam/mod.rs:18-22,
loam-macros/src/lib.rs:12-15). This rebuild keeps the same model -
monotone relations derived to fixpoint by joins - expressed as plain
Python: a relation is an insertion-ordered tuple set, a lattice relation
is a key->value map with a merge function (the reference uses
`Dual<LEWrap>` = min over addresses), and a rule is a method that scans
relations and inserts derived facts. `run()` iterates all rules until no
relation changes; facts are never retracted (standard Datalog/ascent
semantics - lattice columns *replace*, everything else accumulates).

Differences from ascent, by design:
  * Side-effectful rule bodies (the reference allocates addresses inside
    rules via `_self.alloc_addr(...)`) are expressed through `memo()`,
    which pins the side effect's result to the triggering binding so
    naive re-evaluation cannot double-allocate. ascent gets the same
    effect from semi-naive evaluation firing each rule body once.
  * Hash side effects are *batched per round*: rules enqueue preimages
    into pending relations and the program's `flush()` hook materializes
    all of them with one vectorized Poseidon2 batch (the TPU-native
    analog of the reference calling its hasher once per tuple).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List


class Relation:
    """Insertion-ordered set of tuples."""

    __slots__ = ("name", "rows", "version")

    def __init__(self, name: str, init: Iterable[tuple] = ()):
        self.name = name
        self.rows: Dict[tuple, None] = dict.fromkeys(init)
        self.version = len(self.rows)

    def add(self, row: tuple) -> bool:
        if row in self.rows:
            return False
        self.rows[row] = None
        self.version += 1
        return True

    def __iter__(self):
        # snapshot so rules may insert while iterating
        return iter(list(self.rows))

    def __len__(self):
        return len(self.rows)

    def __contains__(self, row):
        return row in self.rows


class LatticeRelation:
    """Relation whose last column is a lattice value merged per key.

    The reference's `lattice foo(K..., Dual<LEWrap>)` keeps the MINIMUM
    address per key (Dual flips the join order); `merge` defaults to min.
    """

    __slots__ = ("name", "vals", "merge", "version")

    def __init__(self, name: str, init: Iterable[tuple] = (), merge=min):
        self.name = name
        self.merge = merge
        self.version = 0
        self.vals: Dict[tuple, object] = {}
        for row in init:
            self.add(row)

    def add(self, row: tuple) -> bool:
        key, val = row[:-1], row[-1]
        old = self.vals.get(key)
        if old is None:
            self.vals[key] = val
            self.version += 1
            return True
        new = self.merge(old, val)
        if new != old:
            self.vals[key] = new
            self.version += 1
            return True
        return False

    def __iter__(self):
        return iter([k + (v,) for k, v in list(self.vals.items())])

    def __len__(self):
        return len(self.vals)

    def get(self, *key):
        return self.vals.get(key)


class Program:
    """Base class: subclasses declare relations in `__init__` and rules as
    `rule_*` methods (run in definition order)."""

    def __init__(self):
        self._rels: Dict[str, object] = {}
        self._version = 0
        self._memo: Dict[tuple, object] = {}
        self._index_cache: Dict[tuple, dict] = {}

    # -- declaration ------------------------------------------------------

    def relation(self, name: str, init: Iterable[tuple] = ()) -> Relation:
        r = Relation(name, init)
        self._rels[name] = r
        if len(r):
            self._version += 1
        return r

    def lattice(self, name: str, init: Iterable[tuple] = (),
                merge=min) -> LatticeRelation:
        r = LatticeRelation(name, init, merge)
        self._rels[name] = r
        if len(r):
            self._version += 1
        return r

    # -- derivation -------------------------------------------------------

    def add(self, name: str, *row) -> bool:
        changed = self._rels[name].add(tuple(row))
        if changed:
            self._version += 1
        return changed

    def memo(self, key: tuple, fn: Callable[[], object]):
        """Run `fn` once per distinct `key`; reuse its result after.

        Mirrors ascent firing a side-effectful rule body exactly once per
        new binding (allocation rules depend on this)."""
        if key in self._memo:
            return self._memo[key]
        val = fn()
        self._memo[key] = val
        return val

    def by(self, name: str, *cols: int) -> Dict[tuple, List[tuple]]:
        """Hash index of a relation on the given column positions, cached
        until that relation's version changes."""
        rel = self._rels[name]
        ck = (name, cols)
        cached = self._index_cache.get(ck)
        if cached is not None and cached[0] == rel.version:
            return cached[1]
        idx: Dict[tuple, List[tuple]] = {}
        for row in rel:
            idx.setdefault(tuple(row[c] for c in cols), []).append(row)
        self._index_cache[ck] = (rel.version, idx)
        return idx

    # -- fixpoint ---------------------------------------------------------

    def rules(self) -> List[Callable[[], None]]:
        names = [n for n in dir(type(self)) if n.startswith("rule_")]
        # definition order: sort by the function's position in the class
        members = {n: getattr(type(self), n) for n in names}
        names.sort(key=lambda n: members[n].__code__.co_firstlineno)
        return [getattr(self, n) for n in names]

    def flush(self):
        """Per-round hook for batched side effects (hashing). Override."""

    def run(self, max_rounds: int = 100_000):
        rules = self.rules()
        for _ in range(max_rounds):
            before = self._version
            for rule in rules:
                rule()
            self.flush()
            if self._version == before:
                return self
        raise RuntimeError(f"{type(self).__name__}: no fixpoint after "
                           f"{max_rounds} rounds")

    def relation_sizes_summary(self) -> str:
        return "\n".join(f"{n}: {len(r)}" for n, r in self._rels.items())
