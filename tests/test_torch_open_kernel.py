"""The PCS-opening and FRI-fold kernels (stark/open_kernel.py) on the CPU.

A CUDA kernel cannot run here, so what the wrappers hand the kernels is
read back by a numpy interpreter of csrc/open.cu: one pass over the
packed structure, through its pointers, row strides, counts, words and
tables, doing what each block and thread does. open_eval: the block ->
tile map and the column-tile records of a shard's groups, each block's
ITEM_ROWS rows staged (zero past the rows and columns), Z's powers from
the group's table of z^(2^j), each warp's byte-plane products summed in
s32 (held below 2^31; the worst case, an all-(p - 1) column of 2^15 + 3
rows at z = (p - 1, ...), among them), reduced mod p and scaled by
2^(8(a+b)), the 64-bit accumulators and the last block's reduction; one
warp's K-block lane by lane (the swizzled stage, the byte transposes run
with the source's own selectors, the MMA's fragments as the PTX ISA
defines them). open_reduce: the block -> height map and the height,
chunk and segment records of a shard's groups, each block's table of
alpha^e and each chunk's weights made from one alpha^o a segment, the
chunk staged, the byte-plane products of one a + b summed in s32 (held
below 2^31, past FLUSH_CHUNKS chunks among them) and reduced, the points
shared by a height's groups, the block's batched inverse of x - z (0 for
a zero), each height's codeword written once; one warp's stage lane by
lane (the swizzle, the weight planes, the fragments with K = columns).
fri_fold: 1/(2x) from the table of g^-(2^j) and steps, the next layer's
pair matrix. On slices of wider matrices (odd row strides) holding 0, 1,
p - 1 and values past 2^30, each interpretation equals the plain version
(the eager code that the CPU runs).

The plain versions and the interpreted packing equal lurk_tpu's jitted
programs on JAX's CPU backend: _ext_powers_fn + _eval_coeffs_fn,
_inv_xz_fn + _reduce_fn and _fold_fn, on the same numpy inputs, converted
here to the Montgomery form lurk_tpu takes; device_open_rounds on CPU
tensors gives lurk_tpu's host open_rounds proof. The header's constants
and the structures' field order are held to the wrapper's. Tolerances are
exact.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lurk_tpu.stark import device_prover as jdp
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.field import ext as ext_t
from lurk_tpu_torch.field.ntt import GENERATOR
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import open_kernel as ok
from lurk_tpu_torch.stark.fri import layer_shift

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

P = bb.P
U = np.uint64
CSRC = Path(ok.__file__).resolve().parents[1] / "csrc"
SOURCE = (CSRC / "open.cu").read_text()
SPECIAL = (0, 1, P - 1, 1 << 30, P - 2)
R1 = bb.R_MOD_P                       # 2^32 mod p: Montgomery 1
RINV = pow(R1, P - 2, P)              # what a Montgomery reduction scales by
CPU = torch.device("cpu")


def _const(name):
    return int(re.search(r"constexpr (?:int|uint32_t) %s = (\d+)u?;" % name,
                         SOURCE).group(1))


def _field(rng, rows, width):
    """(rows, width) canonical values with the special ones sprinkled in."""
    a = rng.integers(0, P, (rows, width)).astype(np.int64)
    idx = rng.integers(0, a.size, min(a.size, 4 * len(SPECIAL)))
    a.reshape(-1)[idx] = np.resize(np.asarray(SPECIAL), len(idx))
    return a


def _slice(rng, rows, width):
    """A (rows, width) column slice of a (rows, odd) int32 matrix."""
    total = width + 3 + (width % 2 == 0)
    whole = torch.from_numpy(_field(rng, rows, total).astype(np.int32))
    return whole[:, 1:1 + width]


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


# ---------------------------------------------------------------------------
# a numpy interpreter of csrc/open.cu over the packed structures
# ---------------------------------------------------------------------------

def _mem(ptr):
    """(the whole storage behind ptr, ptr's element index)."""
    t = ptr.tensor
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy(), t.storage_offset() + ptr.offset


def _read(ptr, idx):
    mem, base = _mem(ptr)
    v = mem[base + np.asarray(idx, np.int64)]
    return (v.view(np.uint32) if v.dtype == np.int32 else v).astype(U)


def _mul(a, b):
    return (np.asarray(a, U) * np.asarray(b, U)) % U(P)


def _emul(a, b):
    c = [None] * 7
    for i in range(4):
        for j in range(4):
            v = _mul(a[..., i], b[..., j])
            c[i + j] = v if c[i + j] is None else (c[i + j] + v) % U(P)
    return np.stack([(c[0] + _mul(c[4], 11)) % U(P),
                     (c[1] + _mul(c[5], 11)) % U(P),
                     (c[2] + _mul(c[6], 11)) % U(P), c[3]], axis=-1)


def _emm(a, b):
    """A Montgomery extension product: a * b * 2^-32."""
    return _mul(_emul(a, b), RINV)


def _mpow(x, e):
    """x^e for Montgomery x (elementwise over e), Montgomery."""
    acc = np.full(np.shape(e), R1, U)
    e = np.asarray(e, np.int64).copy()
    x = np.broadcast_to(np.asarray(x, U), acc.shape).copy()
    while e.any():
        acc = np.where(e & 1, _mul(_mul(acc, x), RINV), acc)
        x = _mul(_mul(x, x), RINV)
        e >>= 1
    return acc


def _inv(x):
    acc = np.ones_like(x)
    base, e = x.copy(), P - 2
    while e:
        if e & 1:
            acc = _mul(acc, base)
        base = _mul(base, base)
        e >>= 1
    return acc


def _einv(a):
    c = int(ext_t._FROB_C)
    fr = [np.array([pow(c, (i * k) % 4, P) for i in range(4)], U)
          for k in range(4)]
    b = _emul(_mul(a, fr[1]), _emul(_mul(a, fr[2]), _mul(a, fr[3])))
    return _mul(b, _inv(_emul(a, b)[..., 0])[..., None])


def _words(a, name, n):
    return np.asarray(a[name][:4 * n], U).reshape(n, 4)


def _records(a):
    """open_eval's EvalTile records, read back from the packed buffer."""
    mem, base = _mem(a["tiles"])
    words = len(ok.TILE_FIELDS)
    recs = mem[base:base + 2 * words * a["n_tiles"]].view(np.int64)
    return [dict(zip(ok.TILE_FIELDS, map(int, r)))
            for r in recs.reshape(-1, words)]


def _bytes(v):
    """(..., 4): the four bytes of each 32-bit value, low byte first."""
    return (np.asarray(v, U)[..., None] >> (U(8) * np.arange(4, dtype=U))) \
        & U(255)


def _shift_m(s):
    """SHIFT_M[s]: 2^(8s) in Montgomery form."""
    return pow(2, 8 * s + 32, P)


def interpret_eval(a):
    """What every block of open_eval_kernel does for its work item (the
    block -> tile map, the tile's record, ITEM_ROWS rows of its columns):
    the staged coefficients (zero past the item's rows and the group's
    columns), Z's powers from the group's table of z^(2^j) (each thread's
    first row by the bits of its exponent, then steps by z), each warp's
    16 columns and 32 rows of every stage as byte-plane products summed in
    s32 (held below 2^31), reduced mod p, scaled by 2^(8(a+b)) and added
    into the 64-bit accumulators; the last block of a tile reduces them,
    writes its outputs and zeroes them and the counter."""
    recs = _records(a)
    bt_mem, bt_base = _mem(a["block_tile"])
    block_tile = bt_mem[bt_base:bt_base + a["blocks"]]
    z_mem, z_base = _mem(a["zpow"])
    zpow = z_mem[z_base:z_base + len(a["groups"]) * ok.MAX_POINTS
                 * ok.LOG_POWERS * 4].astype(U).reshape(
        -1, ok.MAX_POINTS, ok.LOG_POWERS, 4)
    rows_out = int(a["out"].tensor.shape[0])
    acc_mem, acc_base = _mem(a["acc"])
    acc = acc_mem[acc_base:acc_base + 4 * rows_out].view(U)
    c_mem, c_base = _mem(a["counter"])
    counter = c_mem[c_base:c_base + a["n_tiles"]]
    assert not acc.any() and not counter.any()
    out_mem, out_base = _mem(a["out"])
    assert a["blocks"] == sum(r["items"] for r in recs)
    half = ok.EVAL_THREADS // ok.MAX_POINTS
    shift = np.array([[_shift_m(x + y) for y in range(4)] for x in range(4)],
                     U)
    for b in range(a["blocks"]):
        tile = int(block_tile[b])
        T = recs[tile]
        ptr = a["groups"][T["group"]]
        assert ptr.address() == T["coeffs"]
        ld, h, w, n, c0, m = (T[k] for k in ("ld", "h", "w", "n_points",
                                             "c0", "m_tiles"))
        item = b - T["first_block"]
        assert 0 <= item < T["items"] and m in (1, 2, 4, 8)
        ct = 16 * m
        stage_rows = ok.STAGE_WORDS // ct
        r0 = item * ok.ITEM_ROWS
        rows, cols = min(ok.ITEM_ROWS, h - r0), min(ct, w - c0)
        stages = -(-rows // stage_rows)
        A = np.zeros((stages * stage_rows, ct), U)
        A[:rows, :cols] = _read(ptr, (r0 + np.arange(rows))[:, None] * ld
                                + c0 + np.arange(cols))
        Z = np.zeros((ok.ITEM_ROWS, ok.MAX_POINTS, 4), U)
        i0 = 8 * np.arange(half)
        i0 = i0[i0 < rows]
        for k in range(n):
            p = np.zeros((len(i0), 4), U)
            p[:, 0] = 1                                   # canonical
            e = r0 + i0
            for j in range(ok.LOG_POWERS):
                p = np.where(((e >> j) & 1)[:, None] == 1,
                             _emm(p, zpow[T["group"], k, j]), p)
            for r in range(8):
                Z[i0 + r, k] = p
                p = _emm(p, zpow[T["group"], k, 0])
        Ab, Zb = _bytes(A), _bytes(Z[:len(A)]).astype(np.int64)
        for warp in range(ok.EVAL_THREADS // 32):
            mt, kr = warp % m, 32 * (warp // m)
            if kr >= rows:
                continue
            rsel = np.concatenate([s * stage_rows + kr + np.arange(32)
                                   for s in range(stages)
                                   if s * stage_rows + kr < rows])
            part = np.einsum("rca,rklb->cklab",
                             Ab[rsel, 16 * mt:16 * mt + 16]
                             .astype(np.int64), Zb[rsel])
            assert part.max() < 1 << 31                   # s32, exact
            canon = _mul(((part % P).astype(U) * shift % U(P))
                         .sum(axis=(-2, -1)) % U(P), RINV)  # (16, 2, 4)
            for cc in range(16):
                col = c0 + 16 * mt + cc
                if col >= w:
                    continue
                for k in range(n):
                    i = (T["out_row"] + k * w + col) * 4
                    acc[i:i + 4] += canon[cc, k]
        counter[tile] += 1
        if counter[tile] == T["items"]:
            for k in range(n):
                i = (T["out_row"] + k * w + c0) * 4
                out_mem[out_base + i:out_base + i + 4 * cols] = \
                    (acc[i:i + 4 * cols] % U(P)).astype(np.int32)
                acc[i:i + 4 * cols] = 0
            counter[tile] = 0
    return a["out"].tensor


def _recs(ptr, n, fields, arrays):
    """n records of 8-byte words (fields in order, arrays at their
    lengths) read back from a packed buffer."""
    words = sum(arrays.get(f, 1) for f in fields)
    mem, base = _mem(ptr)
    raw = mem[base:base + 2 * words * n].view(np.int64).reshape(n, words)
    out = []
    for r in raw:
        rec, i = {}, 0
        for f in fields:
            k = arrays.get(f, 1)
            rec[f] = r[i:i + k].astype(U) if f in arrays else int(r[i])
            i += k
        out.append(rec)
    return out


def _tensor_at(tensors, address):
    """The tensor among `tensors` whose data starts at `address`."""
    hit = [t for t in tensors if t.data_ptr() == address]
    assert hit, address
    return hit[0]


def reduce_tables(a):
    """open_reduce's ReduceHeight, ReduceChunk and ReduceSeg records."""
    heights = _recs(a["heights"], a["n_heights"], ok.HEIGHT_FIELDS,
                    ok.RECORD_ARRAYS)
    chunks = _recs(a["chunks"], a["n_chunks"], ok.CHUNK_FIELDS, {})
    n_segs = max((c["first_seg"] + c["segs"] for c in chunks), default=0)
    segs = _recs(a["segs"], n_segs, ok.SEG_FIELDS, ok.RECORD_ARRAYS)
    return heights, chunks, segs


def _alpha_table(apow, n):
    """alpha^e (canonical) for e < n, from alpha^(2^j) (Montgomery) by the
    bits of e, as a weight ticket tables them."""
    e = np.arange(n)
    p = np.zeros((n, 4), U)
    p[:, 0] = 1
    for j in range(ok.LOG_SEG):
        p = np.where(((e >> j) & 1)[:, None] == 1, _emm(p, apow[j]), p)
    return p


def _chunk_weights(C, segs, ptab):
    """(MAX_SLOTS, REDUCE_COLS, 4) canonical weights of a chunk's columns:
    sum over its segments of the slot holding column c of a * alpha^(c -
    c0); zero past the group's columns and for slots no segment has."""
    W = np.zeros((ok.MAX_SLOTS, ok.REDUCE_COLS, 4), U)
    c = C["c0"] + np.arange(ok.REDUCE_COLS)
    for S in segs[C["first_seg"]:C["first_seg"] + C["segs"]]:
        e = c - S["c0"]
        hit = (e >= 0) & (e < S["w"])
        if hit.any():
            W[S["slot"], hit] = (W[S["slot"], hit] +
                                 _emm(S["a"], ptab[e[hit]])) % U(P)
    return W


def _wb_index():
    """(MAX_SLOTS, 8, 4, 4): the word of a chunk's weight planes that
    holds (slot j, column word kw, limb l, byte plane b), wb_word's."""
    j, kw, l, b = np.meshgrid(np.arange(ok.MAX_SLOTS), np.arange(8),
                              np.arange(4), np.arange(4), indexing="ij")
    return _wb_word(j >> 1, b, 4 * (j & 1) + l, kw)


def make_planes(W):
    """A chunk's (MAX_SLOTS, REDUCE_COLS, 4) weights as its WB_WORDS weight
    planes: byte b of limb l of columns 4 kw .. 4 kw + 3 in one word (low
    byte first), at wb_word(j / 2, b, 4 (j % 2) + l, kw)."""
    Wb = _bytes(W)                                    # (j, col, l, b)
    words = sum(Wb[:, r::4] << U(8 * r) for r in range(4))  # (j, kw, l, b)
    planes = np.zeros(ok.WB_WORDS, U)
    planes[_wb_index()] = words
    return planes


def read_planes(planes, nn):
    """The (REDUCE_COLS, nn, 4) bytes B[k, n, b] a row item's MMAs read
    from a chunk's weight planes: K row 4 kw + r, column n of n-tile n /
    8, byte r of the word at wb_word."""
    out = np.zeros((ok.REDUCE_COLS, nn, 4), np.int64)
    for n in range(nn):
        for b in range(4):
            for kw in range(8):
                word = int(planes[_wb_word(n // 8, b, n % 8, kw)])
                for r in range(4):
                    out[4 * kw + r, n, b] = (word >> (8 * r)) & 255
    return out


def _batch_inverse(d, zero):
    """open_reduce's batched inverse of an item's (REDUCE_ROWS,
    MAX_SLOTS, 4) Montgomery denominators (a zero already replaced by
    one): each thread's running product, the exclusive prefix and suffix
    products over its warp's lanes, each warp's factor (the inverse of
    the item's product, taken once, times the other warps' products),
    then each slot's inverse from the back; the inverse of a zero is 0."""
    one = np.array([R1, 0, 0, 0], U)
    pre = np.empty_like(d)
    run = np.broadcast_to(one, (d.shape[0], 4)).copy()
    for j in range(ok.MAX_SLOTS):
        pre[:, j] = run
        run = _emm(run, d[:, j])
    lanes = run.reshape(-1, 32, 4)
    before, after = np.empty_like(lanes), np.empty_like(lanes)
    acc = np.broadcast_to(one, (len(lanes), 4)).copy()
    for lane in range(32):
        before[:, lane] = acc
        acc = _emm(acc, lanes[:, lane])
    tot, acc = acc, np.broadcast_to(one, (len(lanes), 4)).copy()
    for lane in range(31, -1, -1):
        after[:, lane] = acc
        acc = _emm(acc, lanes[:, lane])
    total = one
    for w in range(len(tot)):
        total = _emm(total, tot[w])
    inv = _mul(_einv(_mul(total, RINV)), R1)          # Montgomery, once
    fac = []
    for w in range(len(tot)):
        others = one
        for v in range(len(tot)):
            if v != w:
                others = _emm(others, tot[v])
        fac.append(_emm(inv, others))
    inv = _emm(_emm(np.repeat(np.stack(fac), 32, axis=0),
                    before.reshape(-1, 4)), after.reshape(-1, 4))
    out = np.empty_like(d)
    for j in range(ok.MAX_SLOTS - 1, -1, -1):
        out[:, j] = _emm(inv, pre[:, j])
        inv = _emm(inv, d[:, j])
    out[zero] = 0
    return out


def interpret_reduce(a):
    """What every block of open_reduce_kernel does for its ticket. The
    first wblocks tickets: a table of alpha^e, then the weight planes of
    WEIGHT_CHUNKS chunks each (a * alpha^(c - c0) summed over the
    chunk's segments per slot, byte-transposed) into the buffer. Every
    later ticket, a row item (REDUCE_ROWS rows of the last height whose
    first item is at most its own): each chunk of the height staged (zero
    past the height's rows and the group's columns) beside its weight
    planes read back from the buffer (the n-tiles its segments use), each
    warp's 16 rows by the chunk's 32 columns as byte-plane products, the
    planes of one a + b summed in
    s32 (held below 2^31) and every FLUSH_CHUNKS chunks reduced mod p,
    scaled by 2^(8(a+b)) and added into canonical numerators; x =
    GENERATOR * g^row from the table of generators, the block's x - z
    inverted as one batch (0 for 0), the numerators less y_alpha times
    the inverses, summed over the slots, plus the addend, written once.
    The counters are zero before and after. Returns the codewords by
    log H."""
    heights, chunks, segs = reduce_tables(a)
    gens = np.asarray(a["gens"], U)
    apow = np.asarray(a["apow"], U).reshape(ok.LOG_SEG, 4)
    outs = list(a["outs"].values())
    shift = np.array([_shift_m(s) for s in range(7)], U)
    one = np.array([R1, 0, 0, 0], U)
    ctr_mem, ctr_base = _mem(a["ctr"])
    assert not ctr_mem[ctr_base:ctr_base + 3].any()
    assert a["blocks"] == sum(-(-(1 << h["log_h"]) // ok.REDUCE_ROWS)
                              for h in heights)
    assert [h["first_block"] for h in heights] == list(np.cumsum(
        [0] + [-(-(1 << h["log_h"]) // ok.REDUCE_ROWS)
               for h in heights])[:-1])
    assert a["n_chunks"] == sum(h["chunks"] for h in heights)
    assert a["wblocks"] == -(-a["n_chunks"] // ok.WEIGHT_CHUNKS)
    assert 1 <= a["seg_w"] <= ok.MAX_SEG_W
    assert max(s["w"] for s in segs) <= a["seg_w"] if segs else True
    w_mem, w_base = _mem(a["wts"])
    ptab = _alpha_table(apow, a["seg_w"])
    for ticket in range(a["wblocks"]):
        for q in range(ticket * ok.WEIGHT_CHUNKS,
                       min((ticket + 1) * ok.WEIGHT_CHUNKS, len(chunks))):
            w_mem[w_base + q * ok.WB_WORDS:
                  w_base + (q + 1) * ok.WB_WORDS] = make_planes(
                _chunk_weights(chunks[q], segs, ptab)).astype(np.uint32) \
                .view(np.int32)
    for item in range(a["blocks"]):
        hi = max(i for i, h in enumerate(heights)
                 if h["first_block"] <= item)
        H = heights[hi]
        big, ns = 1 << H["log_h"], H["n_slots"]
        assert 1 <= ns <= ok.MAX_SLOTS
        r0 = (item - H["first_block"]) * ok.REDUCE_ROWS
        rows = min(ok.REDUCE_ROWS, big - r0)
        nn = 8 * ((ns + 1) // 2)                  # the n-tiles' columns
        acc = np.zeros((7, ok.REDUCE_ROWS, nn), np.int64)
        part = np.zeros((ok.REDUCE_ROWS, nn), U)

        def flush():
            assert acc.max() < 1 << 31                # s32, exact
            s = (acc % P).astype(U) * shift[:, None, None] % U(P)
            part[:] = (part + _mul(s.sum(axis=0) % U(P), RINV)) % U(P)
            acc[:] = 0

        for s in range(H["chunks"]):
            q = H["first_chunk"] + s
            C = chunks[q]
            ptr = next(p for p in a["lde"] if p.address() == C["lde"])
            assert C["vec"] == ok._copy_words(ptr, C["ld"])
            cols = min(ok.REDUCE_COLS, C["w"] - C["c0"])
            A = np.zeros((ok.REDUCE_ROWS, ok.REDUCE_COLS), U)
            A[:rows, :cols] = _read(
                ptr, (r0 + np.arange(rows))[:, None] * C["ld"] + C["c0"]
                + np.arange(cols))
            # the n-tiles the chunk's segments use (the rest are zero)
            assert 1 <= C["tiles"] <= (ns + 1) // 2
            nc = 8 * C["tiles"]
            planes = w_mem[w_base + q * ok.WB_WORDS:
                           w_base + (q + 1) * ok.WB_WORDS].view(np.uint32)
            assert not _planes_cache(planes, 16)[:, nc:].any()
            Bb = _planes_cache(planes, nc)
            Ab = _bytes(A).astype(np.int64)
            for x in range(4):
                for y in range(4):
                    acc[x + y, :, :nc] += Ab[..., x] @ Bb[..., y]
            if (s + 1) % ok.FLUSH_CHUNKS == 0:
                flush()
        flush()
        num = np.zeros((ok.REDUCE_ROWS, ok.MAX_SLOTS, 4), U)
        num.reshape(ok.REDUCE_ROWS, -1)[:, :nn] = part
        # x of the block's first row, then each row's low bits
        x0 = np.asarray(a["x0"], U)
        for j in range(H["log_h"]):
            if (r0 >> j) & 1:
                x0 = _mul(_mul(x0, gens[H["log_h"] - j]), RINV)
        t = np.arange(ok.REDUCE_ROWS)
        live = t < rows
        xm = np.full(ok.REDUCE_ROWS, x0, U)
        for j in range(H["log_h"]):
            xm = np.where(live & ((t >> j) & 1 == 1),
                          _mul(_mul(xm, gens[H["log_h"] - j]), RINV), xm)
        z = H["z"].reshape(ok.MAX_SLOTS, 4)
        d = np.broadcast_to(one, (ok.REDUCE_ROWS, ok.MAX_SLOTS, 4)).copy()
        for j in range(ns):
            dj = (np.stack([xm] + [np.zeros_like(xm)] * 3, -1) + U(P)
                  - z[j]) % U(P)
            d[live, j] = dj[live]
        zero = (d == 0).all(axis=-1)
        d[zero] = one
        inv = _batch_inverse(d, zero)[:rows]
        ya = H["ya"].reshape(ok.MAX_SLOTS, 4)
        total = np.zeros((rows, 4), U)
        for j in range(ns):
            total = (total + _emm((num[:rows, j] + U(P) - ya[j]) % U(P),
                                  inv[:, j])) % U(P)
        if H["add"]:
            add = _tensor_at(outs, H["add"]).numpy()
            total = (total + add[r0:r0 + rows].astype(U)) % U(P)
        out = _tensor_at(outs, H["out"]).numpy()
        out[r0:r0 + rows] = total.astype(np.int32)
    return a["outs"]


def _planes_cache(planes, nn, _cache={}):
    """read_planes, remembered by the planes' bytes (every row item of a
    height reads the same planes)."""
    key = (planes.tobytes(), nn)
    if key not in _cache:
        if len(_cache) > 4096:
            _cache.clear()
        _cache[key] = read_planes(planes, nn)
    return _cache[key]


def interpret_fold(a):
    """What every thread of fri_fold_kernel does for its FOLD_RUN outputs
    i0 + r * FOLD_THREADS: f(x) and f(-x) from pair row i, 1/(2x) from
    the table of g^-(2^j) over the bits of i0 and r steps of
    g^-FOLD_THREADS, output i at row i mod n/4, block i div n/4."""
    half = 1 << (a["log_n"] - 1)
    quarter = half // 2
    i = np.arange(half)
    per = ok.FOLD_THREADS * ok.FOLD_RUN
    i0 = i // per * per + i % ok.FOLD_THREADS
    run = i % per // ok.FOLD_THREADS
    table = np.asarray(a["g_inv"], U)
    inv2x = np.full(half, a["inv_shift2"], U)
    for j in range(ok.LOG_POWERS):
        inv2x = np.where((i0 >> j) & 1 == 1, _mul(_mul(inv2x, table[j]),
                                                  RINV), inv2x)
    step = table[ok.FOLD_THREADS.bit_length() - 1]
    for r in range(1, ok.FOLD_RUN):
        inv2x = np.where(run >= r, _mul(_mul(inv2x, step), RINV), inv2x)
    quad = i[:, None] * 8 + np.arange(4)
    fx = _read(a["pair"], quad)
    fm = _read(a["pair"], quad + 4)
    two_inv_m = _const("TWO_INV_M")
    s = _mul(_mul((fx + fm) % U(P), two_inv_m), RINV)
    d = _mul(_mul((fx + U(P) - fm) % U(P), inv2x[:, None]), RINV)
    beta = _words(a, "beta", 1)[0]
    o = (s + _emm(d, beta)) % U(P)
    if a["add"] is not None:
        o = (o + _read(a["add"], i[:, None] * 4 + np.arange(4))) % U(P)
    out_mem, out_base = _mem(a["out"])
    dst = (i % quarter * 8 + i // quarter * 4)[:, None] + np.arange(4)
    out_mem[out_base + dst] = o.astype(np.int32)
    return a["out"].tensor


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_header_constants_are_the_wrappers():
    assert (_const("MAX_POINTS"), _const("LOG_POWERS"),
            _const("EVAL_THREADS"), _const("ITEM_ROWS"),
            _const("STAGE_WORDS"), _const("FOLD_THREADS"),
            _const("FOLD_RUN"), _const("TILE_WORDS")) == \
        (ok.MAX_POINTS, ok.LOG_POWERS, ok.EVAL_THREADS, ok.ITEM_ROWS,
         ok.STAGE_WORDS, ok.FOLD_THREADS, ok.FOLD_RUN, len(ok.TILE_FIELDS))
    assert (_const("REDUCE_THREADS"), _const("REDUCE_ROWS"),
            _const("REDUCE_COLS"), _const("MAX_SLOTS"), _const("MAX_SEG_W"),
            _const("LOG_SEG"), _const("FLUSH_CHUNKS")) == \
        (ok.REDUCE_THREADS, ok.REDUCE_ROWS, ok.REDUCE_COLS, ok.MAX_SLOTS,
         ok.MAX_SEG_W, ok.LOG_SEG, ok.FLUSH_CHUNKS)
    for name, fields in (("HEIGHT_WORDS", ok.HEIGHT_FIELDS),
                         ("CHUNK_WORDS", ok.CHUNK_FIELDS),
                         ("SEG_WORDS", ok.SEG_FIELDS)):
        assert _const(name) == sum(ok.RECORD_ARRAYS.get(f, 1)
                                   for f in fields), name
    assert _const("TWO_INV_M") == (P + 1) // 2 * R1 % P
    assert 1 << _const("LOG_FOLD_THREADS") == ok.FOLD_THREADS
    shift = re.search(r"SHIFT_M\[7\] = \{(.*?)\};", SOURCE, re.S).group(1)
    assert [int(v.strip().rstrip("u")) for v in shift.split(",")] == \
        [_shift_m(s) for s in range(7)]
    # a warp's rows of a stage: STAGE_WORDS / (16 m) = 32 (8 / m)
    assert ok.STAGE_WORDS == 32 * ok.MMA_COLS * ok.EVAL_THREADS // 32
    # a warp sums at most ITEM_ROWS rows into s32: 255^2 * rows < 2^31
    assert 255 ** 2 * ok.ITEM_ROWS < 255 ** 2 * (1 << 15) < 1 << 31
    # open_reduce: 16 rows a warp; the 4 plane pairs of one a + b over
    # FLUSH_CHUNKS chunks of REDUCE_COLS columns stay below 2^31
    assert ok.REDUCE_ROWS == 16 * ok.REDUCE_THREADS // 32
    assert 4 * 255 ** 2 * ok.REDUCE_COLS * ok.FLUSH_CHUNKS < 1 << 31
    assert 1 << ok.LOG_SEG == ok.MAX_SEG_W


# each structure's pointer fields (every other field an 8-byte integer)
_POINTERS = {"EvalArgs": {"tiles", "block_tile", "zpow", "acc", "counter",
                          "out"},
             "ReduceArgs": {"heights", "chunks", "segs", "wts", "ctr"},
             "FoldArgs": {"pair", "add", "out"},
             "EvalTile": {"coeffs"}, "ReduceHeight": {"out", "add"},
             "ReduceChunk": {"lde"}, "ReduceSeg": set()}


@pytest.mark.parametrize("name,fields", [
    ("EvalArgs", ok.EVAL_FIELDS), ("ReduceArgs", ok.REDUCE_FIELDS),
    ("FoldArgs", ok.FOLD_FIELDS), ("EvalTile", ok.TILE_FIELDS),
    ("ReduceHeight", ok.HEIGHT_FIELDS), ("ReduceChunk", ok.CHUNK_FIELDS),
    ("ReduceSeg", ok.SEG_FIELDS)])
def test_structures_match_the_source(name, fields):
    """The wrapper lists the C structures' fields in order, each an 8-byte
    integer (or an array of them) or a pointer as in the source (the
    argument structures' integers are INT_FIELDS); the records' arrays
    have RECORD_ARRAYS' lengths, the structures' _ARRAYS'."""
    body = re.search(r"struct %s \{(.*?)\};" % name, SOURCE, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+)(\[[^\]]+\])?;", body, re.M)
    assert tuple(n for _, n, _ in decl) == fields
    pointers = _POINTERS[name]
    if name.endswith("Args"):
        assert pointers == set(fields) - ok.INT_FIELDS
    arrays = ok._ARRAYS if name.endswith("Args") else ok.RECORD_ARRAYS
    for ctype, n, arr in decl:
        assert (ctype == "long long") == (n not in pointers), (n, ctype)
        assert ctype.endswith("*") == (n in pointers), (n, ctype)
        if arr:
            assert eval(arr[1:-1], {k: getattr(ok, k) for k in (
                "MAX_POINTS", "LOG_POWERS", "MAX_SLOTS", "LOG_SEG")}) == \
                arrays[n]


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte j of the result is byte (sel >> 4j) & 7 of
    the 8 bytes y:x (x's low byte first)."""
    src = [(x >> (8 * i)) & 255 for i in range(4)] + \
        [(y >> (8 * i)) & 255 for i in range(4)]
    return sum(src[(sel >> (4 * j)) & 7] << (8 * j) for j in range(4))


def _transpose4(v):
    """transpose4 of csrc/open.cu, run with its own selectors."""
    body = re.search(r"void transpose4\(.*?\{(.*?)\n\}", SOURCE,
                     re.S).group(1)
    env = dict(zip(("v0", "v1", "v2", "v3"), v))
    o = [None] * 4
    for lhs, x, y, sel in re.findall(
            r"(\w+(?:\[\d\])?) = __byte_perm\((\w+), (\w+), (0x[0-9a-f]+)\)",
            body):
        val = _byte_perm(env[x], env[y], int(sel, 16))
        if lhs.startswith("o["):
            o[int(lhs[2])] = val
        else:
            env[lhs] = val
    return o


def _a_word(row, col, ct):
    """a_word of csrc/open.cu."""
    return (row * ct + col) ^ (((row >> 2) & 3) << 3)


def test_staging_swizzle_and_byte_transpose():
    """A stage's swizzle puts every (row, column) of a tile of ct columns
    in its own word of the stage, keeps each 16-byte chunk whole, and a
    warp's fragment loads (8 columns x 4 row groups) hit 32 banks; Z's
    column stride does the same for the B loads; transpose4's selectors
    take byte a of four words into word a."""
    assert re.search(r"return \(row \* ct \+ col\) \^ \(\(\(row >> 2\) & 3\) "
                     r"<< 3\);", SOURCE)
    lanes = np.arange(32)
    g, tig = lanes >> 2, lanes & 3
    for m in (1, 2, 4, 8):
        ct = 16 * m
        rows = ok.STAGE_WORDS // ct
        words = [_a_word(r, c, ct) for r in range(rows) for c in range(ct)]
        assert sorted(words) == list(range(ok.STAGE_WORDS))
        for r in range(rows):
            for c in range(0, ct, 4):
                w0 = _a_word(r, c, ct)
                assert w0 % 4 == 0 and [_a_word(r, c + j, ct)
                                        for j in range(4)] == \
                    list(range(w0, w0 + 4))
        for kr in range(0, rows, 32):
            for mt in range(m):
                for rg in range(4):
                    for j in range(4):
                        banks = {_a_word(kr + 4 * t + 16 * (rg >> 1) + j,
                                         16 * mt + gg + 8 * (rg & 1), ct) % 32
                                 for gg, t in zip(g, tig)}
                        assert len(banks) == 32, (m, kr, mt, rg, j)
    z_ld = eval(re.search(r"constexpr int Z_LD = (.*?);", SOURCE).group(1)
                .replace("/", "//"), {"ITEM_ROWS": ok.ITEM_ROWS})
    assert len({(gg * z_ld + t) % 32 for gg, t in zip(g, tig)}) == 32
    rng = np.random.default_rng(3)
    v = [int(x) for x in rng.integers(0, 1 << 32, 4)]
    assert _transpose4(v) == [sum(((v[r] >> (8 * a)) & 255) << (8 * r)
                                  for r in range(4)) for a in range(4)]


def _mma_m16n8k32(a_regs, b_regs):
    """mma.sync.m16n8k32.row.col.s32.u8.u8.s32 over a warp's fragments
    (PTX ISA: lane = 4 groupID + threadID_in_group; A's register i holds
    row groupID + 8 (i % 2), columns 4 threadID_in_group + 16 (i // 2) +
    byte; B's register i rows 4 threadID_in_group + 16 i + byte, column
    groupID; D's element i row groupID + 8 (i // 2), column 2
    threadID_in_group + i % 2): the (32, 4) D registers of A B."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for i in range(4):
            for byte in range(4):
                A[g + 8 * (i % 2), 4 * t + 16 * (i // 2) + byte] = \
                    (a_regs[lane][i] >> (8 * byte)) & 255
        for i in range(2):
            for byte in range(4):
                B[4 * t + 16 * i + byte, g] = \
                    (b_regs[lane][i] >> (8 * byte)) & 255
    D = A @ B
    return [[D[(lane >> 2) + 8 * (i // 2), 2 * (lane & 3) + i % 2]
             for i in range(4)] for lane in range(32)]


def test_mma_fragments_give_the_byte_products():
    """One warp's K-block as open_eval_kernel runs it, lane by lane: its A
    fragments from the swizzled stage (four rows of a column, transposed
    by transpose4), its B fragments from Z's byte planes, the MMAs as the
    PTX ISA defines them, and the epilogue's (column, point, limb) of each
    D register: every (a, b) sum equals the byte-plane product."""
    rng = np.random.default_rng(4)
    m, mt, warp_k = 2, 1, 1                      # a warp of a 32-column tile
    ct, rows = 16 * m, ok.STAGE_WORDS // (16 * m)
    kr = 32 * warp_k
    tile = rng.integers(0, P, (rows, ct)).astype(np.int64)
    stage = np.zeros(ok.STAGE_WORDS, np.int64)
    for r in range(rows):
        for c in range(ct):
            stage[_a_word(r, c, ct)] = tile[r, c]
    z = rng.integers(0, P, (rows, ok.MAX_POINTS, 4)).astype(np.int64)
    zbytes = {}                          # (column b*8 + k*4 + l, word)
    for k in range(ok.MAX_POINTS):
        for l in range(4):
            for q in range(rows // 4):
                o = _transpose4([int(z[4 * q + r, k, l]) for r in range(4)])
                for b in range(4):
                    zbytes[(b * 8 + k * 4 + l, q)] = o[b]
    af = [[[0] * 4 for _ in range(4)] for _ in range(32)]
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for rg in range(4):
            row = kr + 4 * t + 16 * (rg >> 1)
            col = 16 * mt + g + 8 * (rg & 1)
            o = _transpose4([int(stage[_a_word(row + j, col, ct)])
                             for j in range(4)])
            for b in range(4):
                af[lane][b][rg] = o[b]
    for b in range(4):
        bregs = [[zbytes[(b * 8 + (lane >> 2), kr // 4 + (lane & 3) + 4 * i)]
                  for i in range(2)] for lane in range(32)]
        for x in range(4):
            d = _mma_m16n8k32([af[lane][x] for lane in range(32)], bregs)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for r in range(4):
                    col = 16 * mt + g + 8 * (r >> 1)
                    k, l = t >> 1, 2 * (t & 1) + (r & 1)
                    want = sum(((tile[kr + i, col] >> (8 * x)) & 255) *
                               ((z[kr + i, k, l] >> (8 * b)) & 255)
                               for i in range(32))
                    assert d[lane][r] == want, (b, x, lane, r)


def test_column_tiles_cover_each_group():
    for w in (1, 7, 16, 17, 33, 64, 65, 128, 130, 300, 520, 660):
        tiles = ok.column_tiles(w)
        spans = [(c0, c0 + 16 * m) for c0, m in tiles]
        assert spans[0][0] == 0 and spans[-1][1] >= w
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(m in (1, 2, 4, 8) for _, m in tiles)
        # the last tile takes the fewest MMA tiles that cover its columns
        c0, m = tiles[-1]
        assert m == 1 or 16 * m // 2 < w - c0


def _groups(rng, shapes, points=None, special=False):
    """(coeffs, zs) groups: column slices of wider odd-stride matrices;
    shapes (h, w, n points); the points' list may repeat a point."""
    out = []
    for gi, (h, w, n) in enumerate(shapes):
        coeffs = _slice(rng, h, w)
        zs = points[gi] if points else \
            [_ext(rng) for _ in range(n - 1)] + [(P - 1, 0, 1, 0)]
        out.append((coeffs, zs))
    return out


EVAL_CASES = {
    "one row, one point": [(1, 1, 1)],
    "mixed groups": [(1, 7, 1), (2, 300, 2), (16, 1, 2), (64, 7, 2),
                     (1 << 12, 300, 2), (8, 17, 1), (1 << 11, 65, 2)],
    "items and tiles": [(3 * ok.ITEM_ROWS + 5, 130, 2), (1 << 10, 33, 1)],
}


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_packing_matches_plain(case):
    """open_eval's packing of a shard's groups, interpreted, equals the
    plain version group by group: heights 1 to 2^12 (and past a work
    item), widths 1 to 300 (every column-tile size), 1 and 2 points."""
    rng = np.random.default_rng(len(case))
    groups = _groups(rng, EVAL_CASES[case])
    got = interpret_eval(ok.eval_args(groups))
    want = ok.eval_groups_plain(groups)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _jax_eval(coeffs, z, zp_mont=None):
    """lurk_tpu's _eval_coeffs_fn at one point, on the powers of its
    _ext_powers_fn, or on `zp_mont` where given."""
    h, w = (int(v) for v in coeffs.shape)
    if zp_mont is None:
        zp_mont = jdp.device_ext_powers_mont(z, h)
    return np.asarray(jdp._eval_coeffs_fn(h, w)(
        _jnp(coeffs.contiguous().numpy().astype(np.int64)), zp_mont))


def test_grouped_eval_matches_lurk_tpu():
    """The grouped packing, interpreted, on groups of 1 to 2^12 rows with
    widths 1, 7 and 300, odd strides, one and two points and a repeated
    point (zeta twice, as a 1-row matrix's list has it), group by group
    equal to lurk_tpu's jitted programs (three shapes: JAX compiles each
    anew). Past 16 rows lurk_tpu's _eval_coeffs_fn runs on
    device_ext_powers' powers (_ext_powers_fn compiles for half a minute
    at 2^12 rows; the two agree at 16 rows in
    test_eval_plain_matches_lurk_tpu)."""
    rng = np.random.default_rng(21)
    zeta = _ext(rng)
    shapes = [(1, 1, 2), (16, 300, 2), (16, 300, 1), (1 << 12, 7, 2)]
    points = [[zeta, zeta], [zeta, _ext(rng)], [zeta], [_ext(rng), zeta]]
    groups = _groups(rng, shapes, points)
    got = interpret_eval(ok.eval_args(groups)).numpy()
    off = 0
    for coeffs, zs in groups:
        h, w = (int(v) for v in coeffs.shape)
        for z in zs:
            zp = None if h <= 16 else _jnp(_mul(
                dp.device_ext_powers(z, h, CPU).numpy(), R1))
            np.testing.assert_array_equal(got[off:off + w],
                                          _jax_eval(coeffs, z, zp))
            off += w
    assert off == len(got)


def test_eval_worst_case_column_is_exact():
    """An all-(p - 1) column of 2^15 + 3 rows (a slice of odd stride) at
    z = (p - 1, p - 1, p - 1, p - 1) and a second point: interpreted (every
    s32 sum held below 2^31), equal to the plain version, and at both
    points equal to lurk_tpu's jitted _eval_coeffs_fn at the shape that
    test_grouped_eval_matches_lurk_tpu compiles, (2^12, 7): the column,
    zero past its rows, cut into chunks of 2^12 rows laid side by side,
    each chunk's value scaled by (z^(2^12))^c (a new shape would compile
    anew, and lurk_tpu's _ext_powers_fn takes a minute at this height)."""
    h, rows, w = (1 << 15) + 3, 1 << 12, 7
    coeffs = torch.full((h, 3), P - 1, dtype=torch.int32)[:, 1:2]
    zs = [(P - 1,) * 4, (P - 1, 0, 0, P - 1)]
    got = interpret_eval(ok.eval_args([(coeffs, zs)]))
    assert torch.equal(got, ok.eval_groups_plain([(coeffs, zs)]))
    blocks = -(-h // (rows * w))
    padded = np.zeros(blocks * rows * w, np.uint32)
    padded[:h] = P - 1
    for k, z in enumerate(zs):
        zp = _jnp(_mul(dp.device_ext_powers(z, rows, CPU).numpy(), R1))
        step = ext_t.epow_s(z, rows)
        want, scale = (0, 0, 0, 0), (1, 0, 0, 0)
        for b in range(blocks):
            chunk = padded[b * rows * w:(b + 1) * rows * w]
            ys = np.asarray(jdp._eval_coeffs_fn(rows, w)(
                _jnp(chunk.reshape(w, rows).T), zp))
            for y in ys:
                want = ext_t.eadd_s(want, ext_t.emul_s(
                    scale, tuple(int(v) for v in y)))
                scale = ext_t.emul_s(scale, step)
        assert tuple(int(v) for v in got[k]) == want


@pytest.mark.parametrize("log_big,w,n_points,add", [
    (1, 1, 1, False), (4, 7, 2, True), (7, 40, 2, False), (8, 3, 1, True)])
def test_reduce_packing_matches_plain(log_big, w, n_points, add):
    """open_reduce's packing of one group with dense weights (a segment a
    column), interpreted, equals the plain version; the last point is a
    row's x of the domain (x - z = 0 there)."""
    rng = np.random.default_rng(100 + log_big)
    lde = _slice(rng, 1 << log_big, w)
    x5 = GENERATOR * pow(bb.two_adic_generator_s(log_big), 5 % (1 << log_big),
                         P) % P
    zs = [_ext(rng) for _ in range(n_points - 1)] + [(x5, 0, 0, 0)]
    weights = np.stack([_field(rng, w, 4) for _ in zs])
    y_alpha = _field(rng, n_points, 4)
    ro = torch.from_numpy(_field(rng, 1 << log_big, 4).astype(np.int32)) \
        if add else None
    want = ok.reduce_plain(ro, lde, zs, weights, y_alpha)
    a = ok.reduce_args(None if ro is None else ro.clone(), lde, zs, weights,
                       y_alpha)
    got = interpret_reduce(a)[log_big]
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _alpha_segments(widths, points, o, alpha):
    """A group's weight segments as device_open_rounds makes them: a
    matrix of each width side by side, a segment (k, first column, width,
    alpha^o) for each of its points (indices into the group's points),
    o counting every (matrix, point)'s columns from `o`. Returns the
    segments and the next offset."""
    segs, c0 = [], 0
    for w, pts in zip(widths, points):
        for k in pts:
            segs.append((k, c0, w, ext_t.epow_s(alpha, o)))
            o += w
        c0 += w
    return segs, o


def _reduce_groups(rng, spec, alpha, zeta):
    """(lde, zs, segments, y_alpha) groups from (log H, matrix widths,
    each matrix's point indices, point kinds, layout) specs: the points
    zeta, zeta * g_(H/2), zeta^2 or a row's x of the domain; an LDE
    contiguous (as dcommit makes it) or a column slice of an odd-stride
    matrix; y_alpha random."""
    groups, o = [], 0
    for log_h, widths, points, kinds, layout in spec:
        w = sum(widths)
        lde = _slice(rng, 1 << log_h, w) if layout == "slice" else \
            torch.from_numpy(_field(rng, 1 << log_h, w).astype(np.int32))
        g = bb.two_adic_generator_s(max(log_h - 1, 0))
        x3 = GENERATOR * pow(bb.two_adic_generator_s(log_h), 3 % (1 << log_h),
                             P) % P
        pool = {"zeta": zeta, "zg": ext_t.emul_s(zeta, (g, 0, 0, 0)),
                "zeta2": ext_t.emul_s(zeta, zeta), "x": (x3, 0, 0, 0)}
        zs = [pool[k] for k in kinds]
        segs, o = _alpha_segments(widths, points, o, alpha)
        groups.append((lde, zs, segs, _field(rng, len(zs), 4)))
    return groups


REDUCE_CASES = {
    # three rounds' groups at 2^10 (zeta, zeta * g, zeta^2 share slots),
    # 2^7 and a 1-row matrix's 2 rows whose list repeats zeta; widths
    # past MAX_SEG_W and REDUCE_COLS; 16-, 8- and 4-byte copies
    "rounds": [
        (10, [300, 20], [[0, 1], [0, 1]], ["zeta", "zg"], "contiguous"),
        (10, [18], [[0, 1]], ["zeta", "zg"], "contiguous"),
        (10, [8, 8], [[0], [0]], ["zeta2"], "slice"),
        (7, [13, 6], [[0, 1], [1]], ["zeta", "zg"], "slice"),
        (7, [8], [[0]], ["zeta2"], "contiguous"),
        (1, [3, 2], [[0, 0], [0]], ["zeta"], "contiguous"),
        (1, [4], [[0]], ["zeta2"], "contiguous")],
    # four distinct points at one height, one of them a row's x (x - z
    # = 0), past a block's REDUCE_ROWS rows
    "four slots": [
        (8, [40], [[0, 1]], ["zeta", "x"], "slice"),
        (8, [33], [[0, 1]], ["zeta2", "zg"], "contiguous")],
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
@pytest.mark.parametrize("into", [False, True])
def test_reduce_groups_packing_matches_plain(case, into):
    """open_reduce_groups' packing of several rounds' groups, interpreted,
    equals the plain version height by height: points shared across
    rounds in one slot, repeated points, segments cut at MAX_SEG_W,
    weights made from one alpha^o a segment; written anew, or added into
    given codewords."""
    rng = np.random.default_rng(300 + len(case) + into)
    alpha, zeta = _ext(rng), _ext(rng)
    groups = _reduce_groups(rng, REDUCE_CASES[case], alpha, zeta)
    logs = sorted({_log2(g[0]) for g in groups})
    ro = {lh: torch.from_numpy(_field(rng, 1 << lh, 4).astype(np.int32))
          for lh in logs} if into else None
    want = ok.reduce_groups_plain(groups, alpha, ro)
    a = ok.reduce_groups_args(
        groups, alpha, {k: v.clone() for k, v in ro.items()} if into
        else None)
    heights, chunks, _ = reduce_tables(a)
    assert [h["log_h"] for h in heights] == \
        list(dict.fromkeys(_log2(g[0]) for g in groups))
    assert {c["vec"] for c in chunks} == ({1} if case == "four slots"
                                          else {4, 2, 1})
    assert {c["tiles"] for c in chunks} == {1, 2}
    got = interpret_reduce(a)
    assert sorted(got) == logs
    for lh in logs:
        assert got[lh].dtype == torch.int32
        assert torch.equal(got[lh], want[lh]), lh


def _log2(t):
    return int(t.shape[0]).bit_length() - 1


def test_reduce_weights_are_alpha_powers():
    """The weights the kernel makes from one alpha^o a segment (each
    block's table of alpha^e, the chunks' segments summed per slot), and
    the plain version's, equal host_pcs.ext_powers_from(alpha, o, w) per
    (matrix, point), summed where a matrix repeats a point."""
    from lurk_tpu_torch.stark import pcs as host_pcs
    rng = np.random.default_rng(41)
    alpha, zeta = _ext(rng), _ext(rng)
    widths, points = [5, 600, 40], [[0, 1], [1], [0, 0]]
    (group,) = _reduce_groups(rng, [(3, widths, points, ["zeta", "zg"],
                                     "contiguous")], alpha, zeta)
    w = sum(widths)
    want = np.zeros((2, w, 4), U)
    o = c0 = 0
    for wd, pts in zip(widths, points):
        for k in pts:
            want[k, c0:c0 + wd] = (want[k, c0:c0 + wd] +
                                   host_pcs.ext_powers_from(alpha, o, wd)) \
                % U(P)
            o += wd
        c0 += wd
    a = ok.reduce_groups_args([group], alpha)
    heights, chunks, segs = reduce_tables(a)
    assert max(s["w"] for s in segs) == a["seg_w"] == ok.MAX_SEG_W
    ptab = _alpha_table(np.asarray(a["apow"], U).reshape(ok.LOG_SEG, 4),
                        a["seg_w"])
    made = [_chunk_weights(C, segs, ptab) for C in chunks]
    np.testing.assert_array_equal(
        np.concatenate([m[:2] for m in made], axis=1)[:, :w], want)
    assert not any(m[2:].any() for m in made)
    for m in made:                   # the planes give back the bytes
        got = read_planes(make_planes(m), 16)
        np.testing.assert_array_equal(
            got, _bytes(m.transpose(1, 0, 2).reshape(ok.REDUCE_COLS, 16)))
    np.testing.assert_array_equal(
        ok.segment_weights(group[2], 2, w, alpha, CPU).numpy(), want)


def test_reduce_wide_group_flushes_exactly():
    """An all-(p - 1) group wider than one s32 sum's FLUSH_CHUNKS chunks
    (2 rows of a slice of odd stride, 4-byte copies), one segment of all
    its columns: interpreted (each s32 sum held below 2^31 at every
    flush), equal to the plain version; row 1's x is the second point."""
    rng = np.random.default_rng(43)
    w = ok.FLUSH_CHUNKS * ok.REDUCE_COLS + 3
    lde = torch.full((2, w + 2), P - 1, dtype=torch.int32)[:, 1:1 + w]
    alpha = (P - 1,) * 4
    x1 = GENERATOR * (P - 1) % P                   # GENERATOR * g_2
    zs = [(P - 1, 0, 0, P - 1), (x1, 0, 0, 0)]
    groups = [(lde, zs, [(0, 0, w, alpha), (1, 0, w, (P - 1, 0, 0, 0))],
               _field(rng, 2, 4))]
    got = interpret_reduce(ok.reduce_groups_args(groups, alpha))[1]
    assert torch.equal(got, ok.reduce_groups_plain(groups, alpha)[1])


def test_reduce_batch_inverse_with_zero_denominators():
    """The block's batched inverse of x - z (prefix and suffix products
    over each warp's lanes, one inverse of the block's product) gives
    each denominator's inverse, 0 for 0, however the zeros fall: one in
    a row, a whole row, a whole warp."""
    rng = np.random.default_rng(44)
    d = _mul(_field(rng, ok.REDUCE_ROWS * ok.MAX_SLOTS, 4).astype(U),
             R1).reshape(ok.REDUCE_ROWS, ok.MAX_SLOTS, 4)
    d[3, 1] = 0
    d[40] = 0
    d[32:64, 2] = 0
    zero = (d == 0).all(axis=-1)
    d_one = d.copy()
    d_one[zero] = np.array([R1, 0, 0, 0], U)
    got = _batch_inverse(d_one, zero)
    want = _mul(_einv(_mul(d, RINV)), R1)
    np.testing.assert_array_equal(got, want)
    assert not got[zero].any()


def _r_word(row, q):
    """r_word of csrc/open.cu."""
    return row * ok.REDUCE_COLS + ((q ^ ((row & 1) << 2)) << 2)


def _wb_word(nt, b, n, kw):
    """wb_word of csrc/open.cu."""
    return ((nt * 4 + b) * 8 + n) * 8 + 2 * (kw & 3) + (kw >> 2)


def test_reduce_fragments_give_the_byte_products():
    """One warp's stage of open_reduce_kernel, lane by lane: its A
    fragments as 16-byte loads of four columns of a row from the swizzled
    stage (transpose4 run with the source's selectors), its B fragments
    as 8-byte loads of the weight planes made by four lanes a limb, the
    MMAs as the PTX ISA defines them (K = the stage's columns), and the
    epilogue's (row, slot, limb) of each D register: every (a, b) sum
    equals the byte-plane product. The stage's swizzle keeps each row's
    16-byte chunks whole and puts a quarter warp's loads on 32 banks; the
    B loads and the weight writes hit distinct banks."""
    assert re.search(r"return row \* REDUCE_COLS \+ \(\(q \^ \(\(row & 1\) << "
                     r"2\)\) << 2\);", SOURCE)
    assert re.search(r"return \(\(nt \* 4 \+ b\) \* 8 \+ n\) \* 8 \+ 2 \* "
                     r"\(kw & 3\) \+ \(kw >> 2\);", SOURCE)
    rng = np.random.default_rng(45)
    rows, cols = ok.REDUCE_ROWS, ok.REDUCE_COLS
    lanes = np.arange(32)
    g, tig = lanes >> 2, lanes & 3
    assert sorted(_r_word(r, q) + j for r in range(rows) for q in range(8)
                  for j in range(4)) == list(range(rows * cols))
    for i in range(4):                     # a quarter warp's 16-byte loads
        for quarter in range(4):
            sel = lanes[8 * quarter:8 * quarter + 8]
            chunks = {(_r_word(g[x] + 8 * (i & 1), tig[x] + 4 * (i >> 1))
                       // 4) % 8 for x in sel}
            assert len(chunks) == 8, (i, quarter)
    for half in range(2):                  # a half warp's 8-byte B loads
        sel = lanes[16 * half:16 * half + 16]
        assert len({_wb_word(0, 0, g[x], tig[x]) // 2 % 16 for x in sel}) \
            == 16
    assert len({_wb_word(0, 0, 4 * (0 & 1) + (x & 3), x >> 2) % 32
                for x in lanes}) == 32     # the weight writes
    tile = rng.integers(0, P, (rows, cols)).astype(np.int64)
    stage = np.zeros(rows * cols, np.int64)
    for r in range(rows):
        for c in range(cols):
            stage[_r_word(r, c // 4) + c % 4] = tile[r, c]
    W = rng.integers(0, P, (ok.MAX_SLOTS, cols, 4)).astype(np.int64)
    wb = np.zeros(2 * 4 * 8 * 8, np.int64)
    for j in range(ok.MAX_SLOTS):          # slot j's warp, lane 4 kw + l
        for lane in range(32):
            kw, l = lane >> 2, lane & 3
            o = _transpose4([int(W[j, 4 * kw + r, l]) for r in range(4)])
            for b in range(4):
                wb[_wb_word(j >> 1, b, 4 * (j & 1) + l, kw)] = o[b]
    np.testing.assert_array_equal(wb, make_planes(W.astype(U)))
    warp = 3
    af = [[[0] * 4 for _ in range(4)] for _ in range(32)]
    for lane in range(32):
        for i in range(4):
            w0 = _r_word(16 * warp + g[lane] + 8 * (i & 1),
                         tig[lane] + 4 * (i >> 1))
            o = _transpose4([int(v) for v in stage[w0:w0 + 4]])
            for x in range(4):
                af[lane][x][i] = o[x]
    for nt in range(2):
        for b in range(4):
            bregs = [[int(wb[_wb_word(nt, b, g[lane], tig[lane]) + i])
                      for i in range(2)] for lane in range(32)]
            for x in range(4):
                d = _mma_m16n8k32([af[lane][x] for lane in range(32)],
                                  bregs)
                for lane in range(32):
                    for r in range(4):
                        row = 16 * warp + g[lane] + 8 * (r >> 1)
                        j = 2 * nt + (tig[lane] >> 1)
                        l = 2 * (tig[lane] & 1) + (r & 1)
                        want = sum(((tile[row, c] >> (8 * x)) & 255) *
                                   ((W[j, c, l] >> (8 * b)) & 255)
                                   for c in range(cols))
                        assert d[lane][r] == want, (nt, b, x, lane, r)


@pytest.mark.parametrize("log_n,add", [(2, False), (5, True), (11, False),
                                       (12, True)])
def test_fold_packing_matches_plain(log_n, add):
    """fri_fold's packing, interpreted, equals the plain version: the next
    layer's pair matrix, from layers of 4 rows to past a block's
    FOLD_THREADS * FOLD_RUN outputs."""
    rng = np.random.default_rng(200 + log_n)
    pair = dp.pairs(torch.from_numpy(_field(rng, 1 << log_n, 4)
                                     .astype(np.int32)))
    extra = torch.from_numpy(_field(rng, 1 << (log_n - 1), 4)
                             .astype(np.int32)) if add else None
    shift = layer_shift(log_n + 2, 2)
    beta = _ext(rng)
    got = interpret_fold(ok.fold_args(pair, beta, shift, extra))
    want = ok.fold_plain(pair, beta, shift, extra)
    assert got.dtype == torch.int32 and tuple(got.shape) == \
        (1 << (log_n - 2), 8) and torch.equal(got, want)


def test_packing_rejects_layouts_the_kernels_do_not_take():
    rng = np.random.default_rng(5)
    coeffs = _slice(rng, 8, 4)
    z = [_ext(rng)]
    for bad in (coeffs.T.contiguous().T, coeffs.to(torch.int64)):
        with pytest.raises(ValueError):
            ok.eval_args([(coeffs, z), (bad, z)])
    with pytest.raises(ValueError):
        ok.eval_args([(coeffs, z * (ok.MAX_POINTS + 1))])
    with pytest.raises(ValueError):
        ok.eval_args([])
    lde = _slice(rng, 12, 4)                      # not a power of two rows
    with pytest.raises(ValueError):
        ok.reduce_args(None, lde, z, np.zeros((1, 4, 4)), np.zeros((1, 4)))
    lde = _slice(rng, 8, 4)
    with pytest.raises(ValueError):               # weights of another width
        ok.reduce_args(None, lde, z, np.zeros((1, 5, 4)), np.zeros((1, 4)))
    with pytest.raises(ValueError):               # a codeword of int64
        ok.reduce_args(torch.zeros((8, 4), dtype=torch.int64), lde, z,
                       np.zeros((1, 4, 4)), np.zeros((1, 4)))
    ya = np.zeros((1, 4))
    five = [[(k, 0, 0, 0)] for k in range(ok.MAX_SLOTS + 1)]
    with pytest.raises(ValueError):               # 5 points at one height
        ok.reduce_groups_args([(lde, p, [], ya) for p in five], z[0])
    for seg in ((0, 2, 3, z[0]), (1, 0, 1, z[0]), (0, -1, 2, z[0])):
        with pytest.raises(ValueError):           # outside the group
            ok.reduce_groups_args([(lde, z, [seg], ya)], z[0])
    with pytest.raises(ValueError):               # y_alpha of 2 points
        ok.reduce_groups_args([(lde, z, [], np.zeros((2, 4)))], z[0])
    with pytest.raises(ValueError):
        ok.reduce_groups_args([], z[0])
    pair = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):               # an add of the wrong height
        ok.fold_args(pair, z[0], GENERATOR,
                     torch.zeros((4, 4), dtype=torch.int32))
    for bad in (pair[::2], pair[:, :4], pair[:1]):
        with pytest.raises(ValueError):           # strided, unpaired, 2 rows
            ok.fold_args(bad, z[0], GENERATOR)


# ---------------------------------------------------------------------------
# the plain versions against lurk_tpu's jitted programs
# ---------------------------------------------------------------------------

def _jnp(a):
    return jnp.asarray(np.asarray(a, np.uint32))


def _canon(mont):
    return _mul(np.asarray(mont, U), RINV)


def test_eval_plain_matches_lurk_tpu():
    """eval_plain (device_ext_powers + _eval_coeffs per point) equals
    lurk_tpu's _ext_powers_fn + _eval_coeffs_fn at each point."""
    rng = np.random.default_rng(11)
    h, w = 1 << 4, 5
    coeffs = _field(rng, h, w)
    zs = [_ext(rng), (P - 1, 0, 1, 0)]
    got = ok.open_eval(torch.from_numpy(coeffs.astype(np.int32)), zs)
    for k, z in enumerate(zs):
        zp_mont = jdp.device_ext_powers_mont(z, h)
        np.testing.assert_array_equal(
            dp.device_ext_powers(z, h, CPU).numpy(), _canon(zp_mont))
        want = np.asarray(jdp._eval_coeffs_fn(h, w)(_jnp(coeffs), zp_mont))
        np.testing.assert_array_equal(got[k].numpy(), want)


def test_reduce_plain_matches_lurk_tpu():
    """reduce_plain (_inv_xz + _reduce_chunked + bb.fadd per point), and
    open_reduce's packings interpreted (one group with dense weights; the
    group with weights made from alpha^o segments, a matrix repeating a
    point), equal lurk_tpu's _inv_xz_fn + _reduce_fn added into the
    codeword, at the one shape this test compiles."""
    from lurk_tpu_torch.stark import pcs as host_pcs
    rng = np.random.default_rng(12)
    log_big, w = 4, 5
    big = 1 << log_big
    lde = _field(rng, big, w)
    lde_t = torch.from_numpy(lde.astype(np.int32))
    zs = [_ext(rng), _ext(rng)]
    y_alpha = _field(rng, 2, 4)
    ro = _field(rng, big, 4)
    xs = jdp._xs_dev(log_big)
    inv_xz = [jdp._inv_xz_fn(big)(xs, jdp.ext_scalar_dev(z)) for z in zs]

    def lurk(weights):
        want = ro.astype(U)
        for k, z in enumerate(zs):
            contrib = jdp._reduce_fn(big, w)(
                _jnp(lde), _jnp(_mul(weights[k], R1)), _jnp(y_alpha[k]),
                inv_xz[k])
            want = (want + np.asarray(contrib, U)) % U(P)
        return want

    for k, z in enumerate(zs):
        np.testing.assert_array_equal(
            dp._inv_xz(dp._xs_dev(log_big, CPU),
                       dp.ext_scalar_dev(z, CPU)).numpy(),
            np.asarray(inv_xz[k]))
    weights = np.stack([_field(rng, w, 4) for _ in zs])
    want = lurk(weights)
    got = ok.open_reduce(torch.from_numpy(ro.astype(np.int32)), lde_t, zs,
                         weights, y_alpha)
    np.testing.assert_array_equal(got.numpy(), want)
    a = ok.reduce_args(torch.from_numpy(ro.astype(np.int32)), lde_t, zs,
                       weights, y_alpha)
    np.testing.assert_array_equal(interpret_reduce(a)[log_big].numpy(),
                                  want)
    # matrices of widths 2 and 3; the first opens at both points, the
    # second at point 1 twice (alpha offsets 0, 2, 4, 7)
    alpha = _ext(rng)
    segs = [(0, 0, 2, ext_t.epow_s(alpha, 0)),
            (1, 0, 2, ext_t.epow_s(alpha, 2)),
            (1, 2, 3, ext_t.epow_s(alpha, 4)),
            (1, 2, 3, ext_t.epow_s(alpha, 7))]
    weights = np.zeros((2, w, 4), U)
    for k, c0, wd, o in ((0, 0, 2, 0), (1, 0, 2, 2), (1, 2, 3, 4),
                         (1, 2, 3, 7)):
        weights[k, c0:c0 + wd] = (weights[k, c0:c0 + wd] +
                                  host_pcs.ext_powers_from(alpha, o, wd)) \
            % U(P)
    a = ok.reduce_groups_args([(lde_t, zs, segs, y_alpha)], alpha,
                              {log_big: torch.from_numpy(
                                  ro.astype(np.int32))})
    np.testing.assert_array_equal(interpret_reduce(a)[log_big].numpy(),
                                  lurk(weights.astype(np.int64)))


def test_fold_plain_matches_lurk_tpu():
    """fold_plain (_fold + bb.fadd, then pairs) equals lurk_tpu's _fold_fn
    with the next height's codeword added, as the next layer's pair
    matrix."""
    rng = np.random.default_rng(13)
    log_n = 4
    cw = _field(rng, 1 << log_n, 4)
    extra = _field(rng, 1 << (log_n - 1), 4)
    beta = _ext(rng)
    shift = layer_shift(log_n + 3, 3)
    got = ok.fri_fold(dp.pairs(torch.from_numpy(cw.astype(np.int32))), beta,
                      shift, torch.from_numpy(extra.astype(np.int32)))
    folded = jdp._fold_fn(log_n)(_jnp(cw), _jnp(_mul(beta, R1)),
                                 jdp._inv_2x_dev(log_n, shift))
    want = (np.asarray(folded, U) + extra.astype(U)) % U(P)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(
        [want[:1 << (log_n - 2)], want[1 << (log_n - 2):]], axis=1))


@pytest.mark.parametrize("tail", [0, 5])
def test_device_fri_layers_pass_pairs_between_folds(tail, monkeypatch):
    """device_fri_prove with its layers on the device (CPU tensors: the
    plain fri_fold), each fold's pair matrix committed and folded as it
    stands, un-paired at the switch to the host tail (tail 5) or for the
    final polynomial (tail 0): the same FRI proof and transcript as the
    host's prove of the same codeword."""
    from lurk_tpu_torch.field.ntt import coset_eval
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.utils import codec
    rng = np.random.default_rng(31 + tail)
    log_n = 9
    coeffs = torch.from_numpy(_field(rng, 1 << (log_n - 1), 4))
    cw = coset_eval(coeffs, 1)                    # degree < n/2: folds to 1
    config = FriConfig(1, 4, 1)
    monkeypatch.setenv("LURK_TPU_FRI_HOST_TAIL_LOG", str(tail))
    want_ch, got_ch = Challenger(), Challenger()
    want, _ = dp.device_fri_prove({log_n: bb.to_numpy(cw).astype(U)},
                                  config, want_ch)
    before = ok.fri_fold.launches
    got, _ = dp.device_fri_prove({log_n: cw}, config, got_ch)
    assert codec.encode(got) == codec.encode(want)
    assert got_ch.sample_ext() == want_ch.sample_ext()
    assert ok.fri_fold.launches == before       # no card: plain version


def test_device_open_rounds_match_lurk_tpus_host_open():
    """device_open_rounds on CPU tensors (open_eval_groups' and
    open_reduce_groups' plain versions, y_alpha in one vectorised pass)
    gives lurk_tpu's host pcs.open_rounds proof, byte for byte, on two
    rounds: 1-row matrices whose point list repeats zeta, 16- and 64-row
    ones at zeta and zeta * g, and a quotient-like round at zeta^2 (three
    distinct points at a height)."""
    from lurk_tpu.stark import pcs as jpcs
    from lurk_tpu.stark.challenger import Challenger as JChallenger
    from lurk_tpu.stark.fri import FriConfig as JFriConfig
    from lurk_tpu.utils import codec as jcodec
    from lurk_tpu_torch.stark.challenger import Challenger
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.utils import codec
    rng = np.random.default_rng(46)
    shapes = [[(1, 3), (1, 2), (16, 5), (64, 4), (16, 9)], [(16, 8), (64, 8)]]
    mats = [[rng.integers(0, P, s).astype(U) for s in r] for r in shapes]
    zeta = _ext(rng)

    def at(h):
        g = bb.two_adic_generator_s(h.bit_length() - 1) if h > 1 else 1
        return [zeta, ext_t.emul_s(zeta, (g, 0, 0, 0))]

    points = [[at(m.shape[0]) for m in mats[0]],
              [[ext_t.emul_s(zeta, zeta)] for _ in mats[1]]]
    assert points[0][0] == [zeta, zeta]
    jch, ch = JChallenger(), Challenger()
    jrounds = [jpcs.commit(r) for r in mats]
    rounds = [dp.dcommit([m.copy() for m in r], CPU) for r in mats]
    for jr, r in zip(jrounds, rounds):
        assert jr.roots == r.roots
        for root in r.roots:
            jch.observe_many(root)
            ch.observe_many(root)
    want = jpcs.open_rounds(jrounds, points, JFriConfig(1, 4, 1), jch)
    got = dp.device_open_rounds(rounds, points, FriConfig(1, 4, 1), ch)
    assert codec.encode(got) == jcodec.encode(want)
    assert ch.sample_ext() == jch.sample_ext()
