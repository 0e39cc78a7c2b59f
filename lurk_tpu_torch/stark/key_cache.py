"""Disk cache for StarkMachine setup keys (VERDICT round-2 item #7).

The reference re-runs sphinx setup once per process
(/root/reference/src/core/cli/repl.rs:164-207); here a fresh process's
setup costs 20-50s on the TPU backend (kernel compiles + first dispatch
inside pcs.commit of the 2^16-row bytes table). The committed prep round
is deterministic, so it is persisted once and reloaded in <1s.

Cache key = sha256(format version, FriConfig params, per-chip name +
preprocessed matrix bytes). Any toplevel/gadget change alters some prep
matrix or chip name and lands on a new key; stale entries are garbage,
never wrong. Files live under <LURK_DIR>/keys/ and use the data-only
codec (no pickle).
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np

from ..utils import codec
from . import merkle, pcs
from .machine import ProvingKey, StarkMachine, VerifyingKey

_FORMAT_VERSION = 1


def machine_setup_key(machine: StarkMachine) -> str:
    """Content hash of everything setup's output depends on."""
    from ..lair.chips import chip_preprocessed
    h = hashlib.sha256()
    h.update(f"v{_FORMAT_VERSION};{pcs.LOG_BLOWUP};"
             f"{machine.config.log_blowup},{machine.config.num_queries},"
             f"{machine.config.pow_bits};"
             f"{machine.num_public_values}".encode())
    for chip in machine.chips:
        p = chip_preprocessed(chip)
        if p is None:
            continue
        arr = np.ascontiguousarray(np.asarray(p, np.uint64))
        h.update(chip.name.encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _keys_dir() -> str:
    from ..cli.data import lurk_dir
    return os.path.join(str(lurk_dir()), "keys")


def _serialize(pk: ProvingKey, vk: VerifyingKey) -> bytes:
    trees = []
    if pk.prep_round is not None:
        for log_h, tree in pk.prep_round.trees:
            trees.append({
                "log_h": log_h,
                "n_mats": len(tree.matrices),
                "sorted_idx": list(tree.sorted_idx),
                "levels": [np.asarray(l, np.uint32) for l in tree.levels],
                "root": tuple(tree.root),
            })
    payload = {
        "version": _FORMAT_VERSION,
        "has_prep": pk.prep_round is not None,
        "mats": [np.asarray(m, np.uint64)
                 for m in (pk.prep_round.matrices if pk.prep_round else [])],
        "ldes": [np.asarray(m, np.uint64)
                 for m in (pk.prep_round.ldes if pk.prep_round else [])],
        "trees": trees,
        "prep_chip_names": list(pk.prep_chip_names),
        "vk_roots": [tuple(r) for r in vk.prep_roots],
        "vk_widths": list(vk.prep_widths),
        "vk_log_heights": list(vk.prep_log_heights),
    }
    return codec.encode(payload)


def _deserialize(buf: bytes) -> Optional[Tuple[ProvingKey, VerifyingKey]]:
    d = codec.decode(buf)
    if not isinstance(d, dict) or d.get("version") != _FORMAT_VERSION:
        return None
    names = list(d["prep_chip_names"])
    vk = VerifyingKey([tuple(r) for r in d["vk_roots"]], list(names),
                      list(d["vk_widths"]), list(d["vk_log_heights"]))
    if not d["has_prep"]:
        return ProvingKey(None, names), vk
    mats = [np.asarray(m, np.uint64) for m in d["mats"]]
    ldes = [np.asarray(m, np.uint64) for m in d["ldes"]]
    # rebuild the per-group trees around the shared lde buffers (commit
    # groups matrices by height: a tree's matrices are the group's ldes,
    # in original order)
    trees = []
    lde_iter = 0
    for t in d["trees"]:
        n = int(t["n_mats"])
        t_mats = ldes[lde_iter:lde_iter + n]
        lde_iter += n
        tree = merkle.MerkleTree(
            t_mats, [int(i) for i in t["sorted_idx"]],
            [np.asarray(l, np.uint32) for l in t["levels"]],
            tuple(int(x) for x in t["root"]))
        trees.append((int(t["log_h"]), tree))
    rnd = pcs.CommittedRound(mats, ldes, trees)
    return ProvingKey(rnd, names), vk


def setup_cached(machine: StarkMachine,
                 cache_dir: Optional[str] = None
                 ) -> Tuple[ProvingKey, VerifyingKey]:
    """machine.setup() with a disk cache; falls back to a fresh setup on
    any cache problem (corrupt file, version change, io errors).

    Disable with LURK_TPU_KEY_CACHE=0."""
    if os.environ.get("LURK_TPU_KEY_CACHE", "1") == "0":
        return machine.setup()
    key = machine_setup_key(machine)
    d = cache_dir or _keys_dir()
    path = os.path.join(d, key + ".bin")
    try:
        with open(path, "rb") as f:
            loaded = _deserialize(f.read())
        if loaded is not None:
            pk, vk = loaded
            # cheap internal consistency check: vk roots must equal the
            # deserialized trees' roots
            if pk.prep_round is None or \
                    list(pk.prep_round.roots) == list(vk.prep_roots):
                return pk, vk
    except (OSError, codec.CodecError, ValueError, KeyError, TypeError):
        pass
    pk, vk = machine.setup()
    try:
        os.makedirs(d, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(_serialize(pk, vk))
        os.replace(tmp, path)
    except OSError:
        pass
    return pk, vk
