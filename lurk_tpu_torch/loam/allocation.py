"""Loam Allocator: virtual-address counters + hash/preimage caches.

Reference: /root/reference/src/loam/allocation.rs:26-199. The allocator
hands out consecutive virtual addresses per tag, imports a ZStore's
hash caches so `unhash4/5` can open digests seen during interning, and
computes fresh hash4/hash5 digests on the egress path.

TPU-native twist: programs batch their egress hashing per fixpoint round
(engine.Program.flush); `hash_rows_batch` pushes all pending preimages
through the native batched Poseidon2 kernel at once instead of hashing
tuple-by-tuple like the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..core.zstore import DIGEST_SIZE
from .types import Wide


def _chunk8(flat: tuple) -> Tuple[Wide, ...]:
    return tuple(tuple(flat[i:i + 8]) for i in range(0, len(flat), 8))


class Allocator:
    def __init__(self):
        self.allocation_map: Dict[int, int] = {}
        self.digest_cache: Dict[Tuple[Wide, ...], Wide] = {}
        self.preimage_cache: Dict[Wide, Tuple[Wide, ...]] = {}

    def init(self):
        self.__init__()

    def reset_allocation(self):
        self.allocation_map = {}

    # -- address allocation (allocation.rs:110-117) -----------------------

    def alloc_addr(self, tag: int, initial_addr: int) -> int:
        if tag in self.allocation_map:
            self.allocation_map[tag] += 1
        else:
            self.allocation_map[tag] = initial_addr
        return self.allocation_map[tag]

    # -- hash-cache import (allocation.rs:57-108) --------------------------

    def import_hashes(self, hashes: Dict[tuple, tuple]):
        for preimage, digest in hashes.items():
            wides = _chunk8(tuple(int(x) for x in preimage))
            d = tuple(int(x) for x in digest)
            self.digest_cache[wides] = d
            self.preimage_cache[d] = wides

    def import_zstore(self, zstore):
        self.import_hashes(zstore.hashes3)
        self.import_hashes(zstore.hashes4)
        self.import_hashes(zstore.hashes5)

    # -- hashing (allocation.rs:119-199) -----------------------------------

    def _hash(self, wides: Tuple[Wide, ...]) -> Wide:
        digest = self.digest_cache.get(wides)
        if digest is not None:
            return digest
        digest = self.hash_rows_batch([wides])[0]
        return digest

    def hash4(self, a: Wide, b: Wide, c: Wide, d: Wide) -> Wide:
        return self._hash((a, b, c, d))

    def hash5(self, a: Wide, b: Wide, c: Wide, d: Wide, e: Wide) -> Wide:
        return self._hash((a, b, c, d, e))

    def unhash4(self, digest: Wide):
        return list(self.preimage_cache[digest][:4])

    def unhash5(self, digest: Wide):
        return list(self.preimage_cache[digest][:5])

    def hash_rows_batch(self, rows: List[Tuple[Wide, ...]]) -> List[Wide]:
        """Hash many preimages (each a tuple of Wides, all the same arity)
        in one batched Poseidon2 permutation; results enter both caches."""
        from ..lair.native import poseidon_batch

        if not rows:
            return []
        todo = [r for r in dict.fromkeys(rows) if r not in self.digest_cache]
        if todo:
            width = len(todo[0]) * 8
            mat = np.zeros((len(todo), width), np.uint32)
            for i, wides in enumerate(todo):
                mat[i] = [x for w in wides for x in w]
            out = poseidon_batch(width, mat)[:, :DIGEST_SIZE]
            for wides, drow in zip(todo, out):
                d = tuple(int(x) for x in drow)
                self.digest_cache[wides] = d
                self.preimage_cache[d] = wides
        return [self.digest_cache[r] for r in rows]


