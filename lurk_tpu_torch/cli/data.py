"""Persistable Lurk data: ZDag slices, commitment data, proof objects, paths.

Reference: src/core/cli/{zdag,comm_data,proofs,paths,config}.rs. The wire
format is the data-only codec in utils/codec.py wrapped with a magic/version
header (the reference uses bincode for the same reason: proofs and
commitments arrive from untrusted parties and must never execute code on
load — ADVICE.md round-1 findings)."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Tuple

from ..core.zstore import ZPtr, ZStore, ATOM, TUPLE11, TUPLE110
from ..utils import codec
from .. import __version__

MAGIC = b"LURKTPU2"

codec.register(ZPtr)


def dump_data(obj, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(codec.encode(obj))


def load_data(path):
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise codec.CodecError(f"bad file magic in {path}")
        return codec.decode(f.read())


# ---------------------------------------------------------------------------
# paths (reference: src/core/cli/paths.rs:19-41, config.rs)
# ---------------------------------------------------------------------------

def lurk_dir() -> Path:
    base = os.environ.get("LURK_DIR")
    if base:
        return Path(base)
    return Path.home() / ".lurk-tpu"


def proofs_dir() -> Path:
    return lurk_dir() / "proofs"


def commits_dir() -> Path:
    return lurk_dir() / "commits"


def microchains_dir() -> Path:
    return lurk_dir() / "microchains"


def repl_history_path() -> Path:
    return lurk_dir() / "repl-history"


def random_field_digest() -> tuple:
    """8 uniform BabyBear elements from OS entropy (reference:
    src/core/cli/rdg.rs rand_digest). Rejection-sampled: a plain 32-bit
    draw mod p would make small residues ~1.5x likelier, biasing hiding-
    commitment secrets."""
    import secrets as _secrets
    from ..field.babybear import P
    limit = (1 << 32) - ((1 << 32) % P)   # largest multiple of p
    out = []
    while len(out) < 8:
        v = int.from_bytes(_secrets.token_bytes(4), "little")
        if v < limit:
            out.append(v % P)
    return tuple(out)


# ---------------------------------------------------------------------------
# ZDag (reference: src/core/cli/zdag.rs)
# ---------------------------------------------------------------------------

@codec.register
@dataclass
class ZDag:
    entries: Dict[ZPtr, tuple] = field(default_factory=dict)

    def populate_with(self, zptr: ZPtr, zstore: ZStore, cache=None):
        # iterative post-order walk: long list/string spines exceed
        # Python's recursion limit around ~1000 cells
        if cache is None:
            cache = set()
        stack = [(zptr, False)]
        while stack:
            node, expanded = stack.pop()
            if node in cache:
                continue
            entry = zstore.dag.get(node)
            assert entry is not None, "Data missing from ZStore's DAG"
            if expanded or entry[0] == ATOM:
                cache.add(node)
                self.entries[node] = entry
                continue
            stack.append((node, True))
            for child in entry[1:]:
                if child not in cache:
                    stack.append((child, False))

    def populate_with_many(self, zptrs, zstore: ZStore):
        cache = set()
        for z in zptrs:
            self.populate_with(z, zstore, cache)

    def populate_zstore(self, zstore: ZStore):
        """Move this DAG slice into a target ZStore."""
        for zptr, entry in self.entries.items():
            zstore.dag[zptr] = entry

    def is_flawed(self, zstore: ZStore) -> bool:
        """Check hash consistency of every compound node (used by the
        microchain server to reject malformed DAGs). Entries arrive from
        untrusted decoders, so ANY malformed shape counts as flawed
        rather than raising out of the check."""
        from ..core.zstore import flatten_tuple11, flatten_tuple110
        try:
            for zptr, entry in self.entries.items():
                if not isinstance(zptr, ZPtr) or not isinstance(entry, tuple):
                    return True
                if entry[0] == TUPLE11:
                    if len(entry) != 3:
                        return True
                    digest = zstore.hash4(flatten_tuple11(entry[1], entry[2]))
                elif entry[0] == TUPLE110:
                    if len(entry) != 4:
                        return True
                    digest = zstore.hash5(
                        flatten_tuple110(entry[1], entry[2], entry[3]))
                else:
                    continue
                if digest != zptr.digest:
                    return True
        except Exception:
            return True
        return False


@codec.register
@dataclass
class LurkData:
    """A ZPtr plus the DAG needed to interpret it (reference:
    src/core/cli/lurk_data.rs)."""
    zptr: ZPtr
    zdag: ZDag

    @staticmethod
    def new(zptr: ZPtr, zstore: ZStore) -> "LurkData":
        zdag = ZDag()
        zdag.populate_with(zptr, zstore)
        return LurkData(zptr, zdag)

    def interned(self, zstore: ZStore) -> ZPtr:
        self.zdag.populate_zstore(zstore)
        return self.zptr

    def is_flawed(self, zstore: ZStore) -> bool:
        return self.zdag.is_flawed(zstore)


# ---------------------------------------------------------------------------
# CommData (reference: src/core/cli/comm_data.rs)
# ---------------------------------------------------------------------------

@codec.register
@dataclass
class CommData:
    secret: Tuple[int, ...]
    payload: ZPtr
    zdag: ZDag

    @staticmethod
    def hash(secret, payload: ZPtr, zstore: ZStore):
        preimg = tuple(secret) + payload.flatten()
        return zstore.hash3(preimg)

    @staticmethod
    def new(secret, payload: ZPtr, zstore: ZStore) -> "CommData":
        zdag = ZDag()
        zdag.populate_with(payload, zstore)
        return CommData(tuple(secret), payload, zdag)

    def commit(self, zstore: ZStore) -> ZPtr:
        digest = CommData.hash(self.secret, self.payload, zstore)
        return ZPtr.comm(digest)

    def populate_zstore(self, zstore: ZStore):
        self.zdag.populate_zstore(zstore)


# ---------------------------------------------------------------------------
# Proof objects (reference: src/core/cli/proofs.rs)
# ---------------------------------------------------------------------------

def get_verifier_version() -> str:
    return __version__


@codec.register
@dataclass
class CryptoProof:
    machine_proof: object            # stark.machine.MachineProof
    verifier_version: str
    depth: int

    @staticmethod
    def from_machine_proof(proof) -> "CryptoProof":
        pv = proof.public_values
        depth_bytes = pv[-4:]
        assert all(0 <= b < 256 for b in depth_bytes)
        depth = sum(b << (8 * i) for i, b in enumerate(depth_bytes))
        return CryptoProof(proof, get_verifier_version(), depth)

    def into_machine_proof(self, expr: ZPtr, env: ZPtr, result: ZPtr):
        """Rebuild the public values from the claim (reference:
        proofs.rs:44-77) so the verifier checks the *intended* statement."""
        pv = list(expr.flatten()) + list(env.digest) + list(result.flatten())
        pv += [(self.depth >> (8 * i)) & 0xFF for i in range(4)]
        self.machine_proof.public_values = pv
        return self.machine_proof

    def has_same_verifier_version(self) -> bool:
        return self.verifier_version == get_verifier_version()


@codec.register
@dataclass
class CachedProof:
    crypto_proof: CryptoProof
    zdag: ZDag
    expr: ZPtr
    env: ZPtr
    result: ZPtr

    @staticmethod
    def new(crypto_proof: CryptoProof, public_values, zstore: ZStore
            ) -> "CachedProof":
        expr = ZPtr.from_flat_data(public_values[:16])
        env = ZPtr(12, tuple(public_values[16:24]))  # Tag.Env
        result = ZPtr.from_flat_data(public_values[24:40])
        zdag = ZDag()
        zdag.populate_with_many([expr, env, result], zstore)
        return CachedProof(crypto_proof, zdag, expr, env, result)

    def into_machine_proof(self):
        return self.crypto_proof.into_machine_proof(self.expr, self.env,
                                                    self.result)


@codec.register
@dataclass
class ProtocolProof:
    crypto_proof: CryptoProof
    args: LurkData

    @staticmethod
    def new(crypto_proof: CryptoProof, args: ZPtr, zstore: ZStore):
        return ProtocolProof(crypto_proof, LurkData.new(args, zstore))
