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
defines them). open_reduce: rows on the coset GENERATOR * <g_H>, the
Montgomery weights and inverses, the add into the reduced codeword.
fri_fold: 1/(2x) from the table of g^-(2^j) and steps, the next layer's
pair matrix. On slices of wider matrices (odd row strides) holding 0, 1,
p - 1 and values past 2^30, each interpretation equals the plain version
(the eager code that the CPU runs).

The plain versions and the interpreted packing equal lurk_tpu's jitted
programs on JAX's CPU backend: _ext_powers_fn + _eval_coeffs_fn,
_inv_xz_fn + _reduce_fn and _fold_fn, on the same numpy inputs, converted
here to the Montgomery form lurk_tpu takes. The header's constants and the
structures' field order are held to the wrapper's. Tolerances are exact.
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


REDUCE_ROWS = _const("REDUCE_ROWS")


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


def interpret_reduce(a):
    """What every thread of open_reduce_kernel does for its LDE row x =
    GENERATOR * g^row: its points' weighted row sums, less y_alpha, times
    1/(x - z) (0 for 0), added into (or written to) the codeword."""
    big, ld, w, n = 1 << a["log_big"], a["ld"], a["w"], a["n_points"]
    rows = np.arange(big)
    assert -(-big // REDUCE_ROWS) * REDUCE_ROWS >= big
    lde = _read(a["lde"], rows[:, None] * ld + np.arange(w))   # (H, w)
    wts = _read(a["weights"], np.arange(n * w * 4)).reshape(n, w, 4)
    zm, ya = _words(a, "z", n), _words(a, "ya", n)
    xm = _mul(_mul(a["x0"], _mpow(a["g"], rows)), RINV)
    total = np.zeros((big, 4), U)
    for k in range(n):
        f = np.zeros((big, 4), U)
        for c in range(w):
            f = (f + _mul(lde[:, c:c + 1], wts[k, c])) % U(P)
        f = _mul(f, RINV)                                 # canonical
        d = (np.stack([xm, *(np.zeros(big, U),) * 3], -1) + U(P)
             - zm[k]) % U(P)                              # Montgomery
        inv = _mul(_einv(_mul(d, RINV)), R1)              # Montgomery
        num = (f + U(P) - ya[k]) % U(P)
        total = (total + _mul(_emul(num, inv), RINV)) % U(P)
    out_mem, out_base = _mem(a["out"])
    idx = out_base + rows[:, None] * 4 + np.arange(4)
    if a["accumulate"]:
        total = (total + out_mem[idx].astype(U)) % U(P)
    out_mem[idx] = total.astype(np.int32)
    return a["out"].tensor


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
    assert _const("TWO_INV_M") == (P + 1) // 2 * R1 % P
    assert 1 << _const("LOG_FOLD_THREADS") == ok.FOLD_THREADS
    shift = re.search(r"SHIFT_M\[7\] = \{(.*?)\};", SOURCE, re.S).group(1)
    assert [int(v.strip().rstrip("u")) for v in shift.split(",")] == \
        [_shift_m(s) for s in range(7)]
    # a warp's rows of a stage: STAGE_WORDS / (16 m) = 32 (8 / m)
    assert ok.STAGE_WORDS == 32 * ok.MMA_COLS * ok.EVAL_THREADS // 32
    # a warp sums at most ITEM_ROWS rows into s32: 255^2 * rows < 2^31
    assert 255 ** 2 * ok.ITEM_ROWS < 255 ** 2 * (1 << 15) < 1 << 31


@pytest.mark.parametrize("name,fields", [("EvalArgs", ok.EVAL_FIELDS),
                                         ("ReduceArgs", ok.REDUCE_FIELDS),
                                         ("FoldArgs", ok.FOLD_FIELDS),
                                         ("EvalTile", ok.TILE_FIELDS)])
def test_structures_match_the_source(name, fields):
    """The wrapper lists the C structures' fields in order, each an 8-byte
    integer (or an array of them) or a pointer as in the source; an
    EvalTile is its slice's address and 8-byte integers."""
    body = re.search(r"struct %s \{(.*?)\};" % name, SOURCE, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+)(\[[^\]]+\])?;", body, re.M)
    assert tuple(n for _, n, _ in decl) == fields
    ints = ok.INT_FIELDS if name != "EvalTile" else set(fields[1:])
    for ctype, n, arr in decl:
        assert (ctype == "long long") == (n in ints), (n, ctype)
        assert ctype.endswith("*") == (n not in ints), (n, ctype)
        if arr:
            assert eval(arr[1:-1], {"MAX_POINTS": ok.MAX_POINTS,
                                    "LOG_POWERS": ok.LOG_POWERS}) == \
                ok._ARRAYS[n]


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
    """open_reduce's packing, interpreted, equals the plain version; the
    last point is a row's x of the domain (x - z = 0 there)."""
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
    got = interpret_reduce(a)
    assert got.dtype == torch.int32 and torch.equal(got, want)


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
    """reduce_plain (_inv_xz + _reduce_chunked + bb.fadd per point) equals
    lurk_tpu's _inv_xz_fn + _reduce_fn added into the codeword."""
    rng = np.random.default_rng(12)
    log_big, w = 4, 5
    big = 1 << log_big
    lde = _field(rng, big, w)
    zs = [_ext(rng), _ext(rng)]
    weights = np.stack([_field(rng, w, 4) for _ in zs])
    y_alpha = _field(rng, 2, 4)
    ro = _field(rng, big, 4)
    got = ok.open_reduce(torch.from_numpy(ro.astype(np.int32)),
                         torch.from_numpy(lde.astype(np.int32)), zs, weights,
                         y_alpha)
    want = ro.astype(U)
    xs = jdp._xs_dev(log_big)
    for k, z in enumerate(zs):
        inv_xz = jdp._inv_xz_fn(big)(xs, jdp.ext_scalar_dev(z))
        np.testing.assert_array_equal(
            dp._inv_xz(dp._xs_dev(log_big, CPU),
                       dp.ext_scalar_dev(z, CPU)).numpy(),
            np.asarray(inv_xz))
        contrib = jdp._reduce_fn(big, w)(
            _jnp(lde), _jnp(_mul(weights[k], R1)), _jnp(y_alpha[k]), inv_xz)
        want = (want + np.asarray(contrib, U)) % U(P)
    np.testing.assert_array_equal(got.numpy(), want)


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
