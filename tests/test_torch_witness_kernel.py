"""The device witness kernel's argument packing (lair/witness_kernel.py),
on the CPU.

A CUDA kernel cannot run here, so what the wrapper hands csrc/witness.cu
is read back by a numpy interpreter of it: one pass over the packed
WitnessArgs, through its pointers and counts, doing what each block and
thread does: a tile's rows through the sorted order, their stream offsets
less the range's first, the args, outputs, provide pair, hints and require
pairs placed in their registers, the nonce, selector and depth bytes, the
requires' inverses, the depth less-than witnesses, the op stream, the
rows written back, and the padding blocks. Its trace must equal
generate_trace_device(..., "cpu"), the eager row groups that are the
kernel's plain version, cell for cell:

- for every VM chip of golden.LURK_PROGRAM on the direct and the compiled
  toplevel, in one shard and in every shard at max_shard_size 64;
- for every path of four VM chips of the direct toplevel (RANDOM_CHIPS)
  on random streams in the middle of a longer query map, with 0, 1 and p - 1 among
  the values, require counts of p - 1 (an inverse of 0), INVZ of 0, depths
  at and past 2^31 (equal to their dependency's, or differing in one
  byte) and a path of one row.

Every VM chip of both machines fits the kernel's block; a register file
that fits no block and rows of a path without a plan raise ValueError
naming the chip; the structure's fields, the path header and the
constants are held to the source's. Tolerances are exact.
"""

import dataclasses
import functools
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.lair import device_trace as dt
from lurk_tpu_torch.lair import witness_kernel as wk
from lurk_tpu_torch.lair.chips import chip_included
from lurk_tpu_torch.lair.columnar import ColumnarQueryMap
from lurk_tpu_torch.lair.execute import Shard, ShardingConfig
from lurk_tpu_torch.lair.func_chip import DEPTH_W
from lurk_tpu_torch.lair.trace import FuncChip
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark import quotient_kernel as qk
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

P = bb.P
U = np.uint64
SOURCE = (Path(wk.__file__).resolve().parents[1] / "csrc" /
          "witness.cu").read_text()


@functools.lru_cache(maxsize=None)
def _machine(compiled: bool):
    machine, q, shown = golden.lurk_machine(golden.LURK_PROGRAM,
                                            FriConfig(1, 8, 2), compiled)
    assert shown == golden.LURK_RESULT
    return machine, q


def _vm_chips(machine):
    return [c for c in machine.chips
            if isinstance(c, FuncChip) and dt._plans_for(c) is not None]


# ---------------------------------------------------------------------------
# a numpy interpreter of csrc/witness.cu over the packed structure
# ---------------------------------------------------------------------------

def _mem(ptr):
    """(the uint32 words of the storage behind ptr, ptr's word index)."""
    t = ptr.tensor
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy().view(np.uint32), t.storage_offset() + ptr.offset


def _read(ptr, idx):
    mem, base = _mem(ptr)
    return mem[base + np.asarray(idx, np.int64)].astype(U)


def _inv(x):
    """x^(p - 2) mod p, elementwise: 0 for 0."""
    r, b, e = np.ones_like(x), x % U(P), P - 2
    while e:
        if e & 1:
            r = r * b % U(P)
        b = b * b % U(P)
        e >>= 1
    return r


def _byte(v, b):
    return (v >> U(8 * b)) & U(0xFF)


def interpret(a, seen=None):
    """What the kernel's blocks write into a["trace"] (a CPU tensor).
    `seen` counts INVZ ops and require inverses that meet a 0."""
    seen = {"invz_of_0": 0, "req_inv_of_0": 0} if seen is None else seen
    T, ld, n_reg = a["tile"], a["ld"], a["n_reg"]
    assert 1 <= T <= 128 and ld % 2 == 1 and ld >= T
    assert wk.smem_bytes(n_reg, T) <= qk.SMEM_BYTES
    n, width, start = a["n"], a["width"], a["start"]
    trace, tbase = _mem(a["trace"])

    def store(rows, block):
        idx = tbase + rows[:, None] * width + np.arange(width)[None, :]
        trace[idx] = block.astype(np.uint32)

    n_fields = len(wk.PATH_FIELDS)
    tiles = _read(a["tiles"], np.arange(4 * a["n_tiles"])).astype(np.int64)
    base = {k: _read(a[f"{k}_offs"], 0).astype(np.int64)
            for k in ("req", "dreq", "hint")}
    for path, first, rows, _ in tiles.reshape(-1, 4):
        assert 1 <= rows <= T
        h = dict(zip(wk.PATH_FIELDS, _read(
            a["paths"], n_fields * path + np.arange(n_fields))
            .astype(np.int64).tolist()))

        def words(field, k):                 # int32 words of a section
            return _read(a["prog"], h[field] + np.arange(k)).astype(
                np.uint32).view(np.int32).astype(np.int64)

        r = _read(a["order"], first + np.arange(rows)).astype(np.int64)
        offs = {k: _read(a[f"{k}_offs"], r).astype(np.int64) - base[k]
                for k in base}
        X = np.zeros((n_reg, rows), U)
        for col, ptr, k in ((h["in"], a["args"], a["n_in"]),
                            (h["out"], a["outs"], a["n_out"])):
            if k:
                X[col:col + k] = _read(ptr, r[:, None] * k + np.arange(k)).T
        X[h["prov_nonce"]] = _read(a["provide"], 2 * r)
        X[h["prov_count"]] = _read(a["provide"], 2 * r + 1)
        for k, col in enumerate(words("hint", h["n_hint"])):
            if col >= 0:
                X[col] = _read(a["hint"], offs["hint"] + k)
        reqs = words("req", 4 * h["n_req"]).reshape(-1, 4)
        for c_nonce, c_count, _, w in reqs:
            stream = "dreq" if w & 1 else "req"
            pair = offs[stream] + 2 * (w >> 1)
            X[c_nonce] = _read(a[stream], pair)
            X[c_count] = _read(a[stream], pair + 1)
        X[0] = (start + r) % P
        X[h["sel"]] = 1
        own = _read(a["depth"], r)
        for b, col in enumerate(words("depth", h["n_depth"])):
            X[col] = _byte(own, b)
        for _, c_count, c_inv, _ in reqs:
            plus = (X[c_count] + U(1)) % U(P)
            seen["req_inv_of_0"] += int((plus == 0).sum())
            X[c_inv] = _inv(plus)
        for w in words("dlt", wk.DLT_WORDS * h["n_dlt"]).reshape(
                -1, wk.DLT_WORDS):
            dep = _read(a["hint"], offs["hint"] + w[0])
            ms = np.full(rows, DEPTH_W - 1)
            found = np.zeros(rows, bool)
            for b in reversed(range(DEPTH_W)):
                hit = (_byte(dep, b) != _byte(own, b)) & ~found
                ms[hit] = b
                found |= hit
            for b in range(DEPTH_W):
                X[w[1 + b]] = _byte(dep, b)
                X[w[1 + DEPTH_W + b]] = ms == b
            X[w[1 + 2 * DEPTH_W]] = (dep >> (8 * ms).astype(U)) & U(0xFF)
            X[w[2 + 2 * DEPTH_W]] = (own >> (8 * ms).astype(U)) & U(0xFF)
        for op, dst, x, y in words("ops", 4 * h["n_ops"]).reshape(-1, 4):
            if op == dt.ADD:
                v = (X[x] + X[y]) % U(P)
            elif op == dt.SUB:
                v = (X[x] + U(P) - X[y]) % U(P)
            elif op == dt.MUL:
                v = X[x] * X[y] % U(P)
            elif op == dt.INVZ:
                seen["invz_of_0"] += int((X[x] == 0).sum())
                v = _inv(X[x])
            elif op == dt.EQZ:
                v = (X[x] == 0).astype(U)
            elif op == dt.CONST:
                v = np.full(rows, x, U)
            else:
                assert op == dt.NOP
                v = np.zeros(rows, U)
            X[dst] = v
        store(r, X[:width].T)
    assert a["pad_tiles"] == -(-(a["height"] - n) // T)
    for p in range(a["pad_tiles"]):
        rows = np.arange(n + p * T, min(n + (p + 1) * T, a["height"]))
        block = np.zeros((len(rows), width), U)
        block[:, 0] = (start + rows) & 0xFFFFFFFF
        store(rows, block)
    return seen


def _interpreted(chip, shard):
    a = wk.witness_args(chip, shard, "cpu")
    a["trace"].tensor.fill_(-7)          # every cell must be written
    seen = interpret(a)
    return a["trace"].tensor, seen


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_structures_match_the_source():
    """The ctypes structure lists WitnessArgs's fields in order, each an
    8-byte integer or a pointer as in the source; the path header is the
    source's PathWord; the constants are the wrapper's and the VM's."""
    body = re.search(r"struct WitnessArgs \{(.*?)\};", SOURCE, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    assert tuple(n for _, n in decl) == wk.WITNESS_FIELDS
    for ctype, n in decl:
        assert (ctype == "long long") == (n in wk.INT_FIELDS), (n, ctype)
        assert ctype.endswith("*") == (n not in wk.INT_FIELDS), (n, ctype)
    enum = re.search(r"enum PathWord \{(.*?)\};", SOURCE, re.S).group(1)
    names = [w.strip() for w in enum.split(",")]
    assert names[-1] == "PATH_WORDS"
    assert tuple(w[3:].lower() for w in names[:-1]) == wk.PATH_FIELDS
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", SOURCE))
    assert {k: int(v) for k, v in consts.items()} == {
        "MAX_THREADS": qk.MAX_TILE, "SMEM_MAX": qk.SMEM_BYTES,
        "DEPTH_W": DEPTH_W, "META": wk.META, "NOP": dt.NOP, "ADD": dt.ADD,
        "SUB": dt.SUB, "MUL": dt.MUL, "INVZ": dt.INVZ, "EQZ": dt.EQZ,
        "CONST": dt.CONST}
    assert f"dlt + {wk.DLT_WORDS} * k" in SOURCE


@pytest.mark.parametrize("compiled", [False, True])
@pytest.mark.parametrize("shard_size", [None, 64])
def test_packing_matches_plain_on_the_lurk_golden(compiled, shard_size):
    machine, q = _machine(compiled)
    shards = Shard(q, 0, None if shard_size is None
                   else ShardingConfig(shard_size)).shard()
    assert (len(shards) == 1) == (shard_size is None)
    names = set()
    for shard in shards:
        for chip in _vm_chips(machine):
            if not chip_included(chip, shard):
                continue
            got, _ = _interpreted(chip, shard)
            want = dt.generate_trace_device(chip, shard, "cpu")
            bad = np.argwhere((got != want).numpy())
            assert not len(bad), (chip.name, shard.index, bad[:3])
            names.add(chip.func.name)
    assert {"eval", "apply", "env_lookup"} <= names


class _Shard:
    """One func's queries and its chip's range, as Shard gives them."""

    def __init__(self, index, fq, rng):
        self.queries = SimpleNamespace(func_queries={index: fq})
        self._rng = rng

    def get_func_range(self, func_index):
        return self._rng


def _random_shard(chip, rng, extra_path=None):
    """Random streams for every path of `chip` (one of them a single row),
    rows 5 .. the chip's range of a longer query map: field values with 0,
    1 and p - 1, require counts of p - 1, depths and their dependencies'
    32-bit values at and past 2^31, some equal, some one byte apart."""
    plans = dt._plans_for(chip)
    idents = sorted(plans)
    counts = rng.integers(1, 9, len(idents))
    counts[rng.integers(len(idents))] = 1
    path = rng.permutation(np.repeat(idents, counts))
    if extra_path is not None:
        path[-1] = extra_path
    path = np.concatenate([rng.choice(idents, 5), path,
                           rng.choice(idents, 3)]).astype(np.uint32)
    n = len(path)
    special = np.array([0, 1, P - 1, 1 << 30], U)

    def field(*shape):
        v = rng.integers(0, P, shape, dtype=U)
        pick = rng.random(shape) < 0.3
        v[pick] = rng.choice(special, int(pick.sum()))
        return v.astype(np.uint32)

    def word(*shape):
        v = rng.integers(0, 1 << 32, shape, dtype=U)
        pick = rng.random(shape) < 0.3
        v[pick] = rng.choice(np.array([0, 1 << 31, (1 << 32) - 1,
                                       (1 << 31) + 0x01020304], U),
                             int(pick.sum()))
        return v.astype(np.uint32)

    def stream(per_row):
        lens = np.array([per_row(plans.get(int(p))) for p in path])
        offs = np.concatenate([[0], np.cumsum(lens)]).astype(np.uint32)
        return offs, int(offs[-1])

    req_offs, n_req = stream(lambda p: 2 * p.n_req if p else 0)
    dreq_offs, n_dreq = stream(lambda p: 2 * p.n_dreq if p else 0)
    hint_offs, n_hint = stream(lambda p: p.n_hint if p else 0)
    req_flat, dreq_flat = field(n_req), field(n_dreq)
    req_flat[1::2][rng.random(n_req // 2) < 0.3] = P - 1
    dreq_flat[1::2][rng.random(n_dreq // 2) < 0.3] = P - 1
    depth = word(n)
    hint_flat = field(n_hint)
    for i, p in enumerate(path):
        plan = plans.get(int(p))
        for k in (plan.dlt_hint_idx if plan else ()):
            dep = int(word())
            kind = rng.integers(3)
            if kind == 1:
                dep = int(depth[i])
            elif kind == 2:
                dep = int(depth[i]) ^ (1 << (8 * int(rng.integers(4))))
            hint_flat[hint_offs[i] + k] = dep
    func = chip.func
    fq = ColumnarQueryMap(
        func.input_size, func.output_size, field(n, func.input_size),
        field(n, func.output_size), field(n, 2), req_offs, req_flat, depth,
        dreq_offs, dreq_flat, path, hint_offs, hint_flat)
    return _Shard(func.index, fq, range(5, n - 3))


# the chips with the most paths, the most INVZ ops and depth witnesses,
# the widest register file, and a func that is not partial (the plain
# version costs a few milliseconds a path)
RANDOM_CHIPS = ("eval_builtin_expr", "eval_binop_num", "preallocate_symbols",
                "ingress")


def test_packing_matches_plain_on_random_streams():
    machine, _ = _machine(False)
    rng = np.random.default_rng(15)
    seen = {"invz_of_0": 0, "req_inv_of_0": 0}
    past_2_31 = rebased = 0
    chips = [c for c in _vm_chips(machine) if c.func.name in RANDOM_CHIPS]
    assert len(chips) == len(RANDOM_CHIPS)
    for chip in chips:
        shard = _random_shard(chip, rng)
        a = wk.witness_args(chip, shard, "cpu")
        assert a["start"] == 5
        rebased += int(_read(a["req_offs"], 0)) > 0
        a["trace"].tensor.fill_(-7)
        interpret(a, seen)
        want = dt.generate_trace_device(chip, shard, "cpu")
        got = a["trace"].tensor
        bad = np.argwhere((got != want).numpy())
        assert not len(bad), (chip.name, bad[:3])
        fq = shard.queries.func_queries[chip.func.index]
        past_2_31 += int((fq.depth[5:-3] >= 1 << 31).sum())
    assert seen["invz_of_0"] and seen["req_inv_of_0"] and past_2_31 \
        and rebased


def test_every_lurk_chip_fits_a_block(monkeypatch):
    """No VM chip of either Lurk machine has a register file too big for
    the kernel's block; one that is raises ValueError naming the chip."""
    for compiled in (False, True):
        machine, _ = _machine(compiled)
        for chip in _vm_chips(machine):
            table = wk.program_table(chip)
            tile = qk.tile_rows(lambda t: wk.smem_bytes(table.n_reg, t),
                                1 << 18)
            assert tile >= 32, (chip.name, table.n_reg, tile)
    machine, q = _machine(False)
    chip = next(c for c in _vm_chips(machine) if c.func.name == "eval")
    shard = Shard(q, 0, None).shard()[0]
    real = wk.program_table(chip)
    huge = dataclasses.replace(real, n_reg=qk.SMEM_BYTES // 4)
    monkeypatch.setattr(wk, "program_table", lambda c: huge)
    with pytest.raises(ValueError, match=re.escape(chip.name)):
        wk.witness_args(chip, shard, "cpu")


def test_rejects_what_the_kernel_does_not_take():
    machine, q = _machine(False)
    chip = next(c for c in _vm_chips(machine) if c.func.name == "eval")
    unknown = max(dt._plans_for(chip)) + 1
    shard = _random_shard(chip, np.random.default_rng(1), unknown)
    with pytest.raises(ValueError, match=re.escape(chip.name)):
        wk.witness_args(chip, shard, "cpu")
    before = wk.witness_trace.launches
    with pytest.raises(ValueError, match="CUDA"):
        wk.witness_trace(chip, Shard(q, 0, None).shard()[0], "cpu")
    assert wk.witness_trace.launches == before
