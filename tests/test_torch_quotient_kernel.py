"""The constraint-quotient and LogUp perm-trace kernels' argument packing
(stark/quotient_kernel.py), on the CPU.

A CUDA kernel cannot run here, so what the wrappers hand the kernels is
read back by a numpy interpreter of csrc/quotient.cu: one pass over the
packed structure, through its pointers, row strides, widths and counts,
doing what each thread does. For every chip of golden.LURK_PROGRAM's
direct machine with an affine plan, on random LDE slices of a wider
matrix (an odd row stride) holding 0, 1, p - 1 and values past 2^30:

- kernel A's packing, interpreted over every LDE row of a 256-row LDE (the
  last rows' next rows wrap to the first), equals the plain version
  (_vm_eval + _pq_eval);
- kernel B's packing, interpreted over a 128-row trace, equals the batch
  contributions of device_perm_trace_plan's plain version.

On three chips (LURK_TPU_CHIPS) the plain versions equal lurk_tpu's jitted
programs on JAX's CPU backend: _vm_fn + _pq_fn (canonical outputs;
lurk_tpu is Montgomery inside), and _generic_perm_fn's perm matrix and
cumulative sum. tests/test_torch_quotient_lurk_tpu.py and
tests/test_torch_perm_lurk_tpu.py hold the other plan chips (PLAN_CHIPS)
to them, in files of their own so that the suite's workers share the
compiles.

The header's field constants and the structures' field order are held to
the wrapper's. Tolerances are exact.
"""

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lurk_tpu.logup import affine as j_affine
from lurk_tpu.stark import device_prover as jdp
from lurk_tpu_torch.field import babybear as bb
from lurk_tpu_torch.field import ext as ext_t
from lurk_tpu_torch.stark import device_prover as dp
from lurk_tpu_torch.stark import golden
from lurk_tpu_torch.stark import quotient_kernel as qk
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

P = bb.P
U = np.uint64
CSRC = Path(qk.__file__).resolve().parents[1] / "csrc"
LOG_H = 7
SPECIAL = (0, 1, P - 1, 1 << 30, P - 2)


@functools.lru_cache(maxsize=None)
def _machine():
    machine, q, _ = golden.lurk_machine(golden.LURK_PROGRAM,
                                        FriConfig(1, 8, 2))
    return machine, len(q.expect_public_values())


def _plan_chips():
    machine, n_pv = _machine()
    out = []
    for chip in machine.chips:
        builder = machine.builder_for(chip)
        plan = dp.plan_for(builder)
        if plan is not None:
            out.append((chip.name, builder, plan))
    return out, n_pv


def _field(rng, rows, width):
    """(rows, width) canonical values with the special ones sprinkled in."""
    a = rng.integers(0, P, (rows, width)).astype(np.int64)
    if a.size:
        idx = rng.integers(0, a.size, min(a.size, 4 * len(SPECIAL)))
        a.reshape(-1)[idx] = np.resize(np.asarray(SPECIAL), len(idx))
    return a


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, 4))


def _slices(rng, rows, widths):
    """Column slices of one (rows, sum + 3) int32 matrix, an odd width."""
    total = sum(widths) + 3
    if total % 2 == 0:
        total += 1
    whole = torch.from_numpy(_field(rng, rows, total).astype(np.int32))
    out, off = [], 1
    for w in widths:
        out.append(None if w == 0 else whole[:, off:off + w])
        off += w
    return out


# ---------------------------------------------------------------------------
# a numpy interpreter of csrc/quotient.cu over the packed structures
# ---------------------------------------------------------------------------

def _mem(ptr):
    """(the whole int32/int64 storage behind ptr, ptr's element index)."""
    t = ptr.tensor
    flat = torch.empty(0, dtype=t.dtype).set_(t.untyped_storage())
    return flat.numpy(), t.storage_offset() + ptr.offset


def _read(ptr, idx):
    mem, base = _mem(ptr)
    return mem[base + np.asarray(idx, np.int64)].astype(U)


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
    norm = _emul(a, b)[..., 0]
    return _mul(b, _inv(norm)[..., None])


def _ext_at(ptr, k):
    return _read(ptr, 4 * k + np.arange(4))


def _affine(x, rows, k, n, a):
    """Interaction k's fingerprint (rows, 4) and multiplicity (rows,)."""
    d = np.broadcast_to(_ext_at(a["dconst"], k), (len(rows), 4)).copy()
    for t in range(a["n_t"]):
        col = x(int(_read(a["ti"], t * n + k)), rows)
        d = (d + _mul(_ext_at(a["tw"], t * n + k), col[:, None])) % U(P)
    m = np.full(len(rows), _read(a["mconst"], k), U)
    for t in range(a["n_m"]):
        col = x(int(_read(a["mi"], t * n + k)), rows)
        m = (m + _mul(_read(a["mw"], t * n + k), col)) % U(P)
    return d, m


def _columns(a, extras):
    def x(c, rows):
        if c < a["main_w"]:
            return _read(a["main"], rows * a["main_ld"] + c)
        c -= a["main_w"]
        if c < a["prep_w"]:
            return _read(a["prep"], rows * a["prep_ld"] + c)
        return extras(c - a["prep_w"], rows)
    return x


def interpret_quotient(a):
    """What every thread of every launch of quotient_kernel writes: the
    (big, 4) output read back from the packed `out` pointer."""
    big = 1 << a["log_big"]
    R, ld = a["n_regs"], a["scratch_ld"]
    wx = a["main_w"] + a["prep_w"] + 4
    sels = (a["first"], a["last"], a["trans"])
    x = _columns(a, lambda c, rows: _read(sels[c], rows) if c < 3
                 else np.ones(len(rows), U))
    smem, sbase = _mem(a["scratch"])
    omem, obase = _mem(a["out"])
    ops = _read(a["ops"], np.arange(4 * a["n_ops"])).astype(np.int64) \
        .reshape(-1, 4)
    for row0 in range(0, big, ld):
        t = np.arange(min(ld, big - row0))
        row = row0 + t
        nrow = (row + a["stride"]) & (big - 1)

        def operand(i):
            if i < R:
                return smem[sbase + i * ld + t].astype(U)
            i -= R
            if i < wx:
                return x(i, row)
            i -= wx
            if i < wx:
                return x(i, nrow)
            return np.full(len(t), _read(a["consts"], i - wx), U)

        for code, dst, ia, ib in ops:
            va, vb = operand(ia), operand(ib)
            v = (va + vb) % U(P) if code == 0 else \
                (va + U(P) - vb) % U(P) if code == 1 else _mul(va, vb)
            smem[sbase + dst * ld + t] = v.astype(smem.dtype)
        acc = np.zeros((len(t), 4), U)
        for c in range(a["n_cons"]):
            reg = smem[sbase + c * ld + t].astype(U)
            acc = (acc + _mul(_ext_at(a["wbase"], c), reg[:, None])) % U(P)
        n, nb = 2 * a["nb"], a["nb"]
        perm = lambda r, j: _read(a["perm"], r[:, None] * a["perm_ld"]
                                  + j + np.arange(4))
        tphi = np.zeros((len(t), 4), U)
        tphi_n = np.zeros((len(t), 4), U)
        for b in range(nb):
            phi = perm(row, 4 * b)
            tphi = (tphi + phi) % U(P)
            tphi_n = (tphi_n + perm(nrow, 4 * b)) % U(P)
            d0, m0 = _affine(x, row, 2 * b, n, a)
            d1, m1 = _affine(x, row, 2 * b + 1, n, a)
            lhs = _emul(_emul(phi, d0), d1)
            rhs = (_mul(d1, m0[:, None]) + _mul(d0, m1[:, None])) % U(P)
            acc = (acc + _emul(np.broadcast_to(_ext_at(a["wb"], b), lhs.shape),
                               (lhs + U(P) - rhs) % U(P))) % U(P)
        s, s_n = perm(row, 4 * nb), perm(nrow, 4 * nb)
        cum = _ext_at(a["cum"], 0)
        terms = ((s + U(P) - tphi) % U(P), sels[0]),  \
            ((s_n + 2 * U(P) - s - tphi_n) % U(P), sels[2]), \
            ((s + U(P) - cum) % U(P), sels[1])
        for j, (v, sel) in enumerate(terms):
            v = _mul(v, _read(sel, row)[:, None])
            w = np.broadcast_to(_ext_at(a["wsel"], j), v.shape)
            acc = (acc + _emul(w, v)) % U(P)
        omem[obase + 4 * row[:, None] + np.arange(4)] = acc.astype(np.int32)
    return a["out"].tensor.numpy().astype(U)


def interpret_perm(a):
    """What perm_phi_kernel writes: every row's phi_b into `out`."""
    h, nb = a["h"], a["nb"]
    extras = lambda c, rows: ((rows == 0) if c == 0 else
                              (rows == h - 1) if c == 1 else
                              (rows < h - 1)).astype(U)
    x = _columns(a, extras)
    rows = np.arange(h)
    omem, obase = _mem(a["out"])
    for b in range(nb):
        phi = np.zeros((h, 4), U)
        for k in (2 * b, 2 * b + 1):
            d, m = _affine(x, rows, k, 2 * nb, a)
            phi = (phi + _mul(_einv(d), m[:, None])) % U(P)
        omem[obase + rows[:, None] * a["out_ld"] + 4 * b + np.arange(4)] = \
            phi.astype(np.int32)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def test_header_constants_are_the_fields():
    src = (CSRC / "babybear.cuh").read_text()
    consts = {k: int(v, 0) for k, v in re.findall(
        r"constexpr uint32_t (\w+) = (0x[0-9a-f]+|\d+)u;", src)}
    c = ext_t._FROB_C
    assert consts == {"P": P, "MU": bb.P_INV_NEG, "R2": bb.R2_MOD_P % P,
                      "W": ext_t.W, "FROB1": c, "FROB2": c * c % P,
                      "FROB3": pow(c, 3, P)}
    assert c * c % P == P - 1


@pytest.mark.parametrize("name,fields", [("QuotientArgs", qk.QUOTIENT_FIELDS),
                                         ("PermArgs", qk.PERM_FIELDS)])
def test_structures_match_the_source(name, fields):
    """The ctypes structures list the C structures' fields in order, each
    an 8-byte integer or a pointer as in the source."""
    src = (CSRC / "quotient.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    decl = re.findall(r"^\s*([\w ]+?\*?)\s*(\w+);", body, re.M)
    assert tuple(n for _, n in decl) == fields
    for ctype, n in decl:
        assert (ctype == "long long") == (n in qk._INT_FIELDS), (n, ctype)
        assert ctype.endswith("*") == (n not in qk._INT_FIELDS), (n, ctype)


def _jax_quotient(qi, plan, pv, r, gamma, alpha, cum):
    """lurk_tpu's _vm_fn + _pq_fn over all `big` rows in one window."""
    prog = qi.prog
    big = int(qi.main.shape[0])
    stride = qi.stride
    nb = qi.nb
    Bp = plan.n_inter_padded // 2
    Wp = max(prog.width_padded, plan.width_padded)
    win = np.arange(big + stride) % big
    sels = {k: v.numpy() for k, v in qi.sels.items()}
    cols = [qi.main.numpy()] + ([qi.prep.numpy()] if qi.prep is not None
                                else []) + \
        [np.stack([sels["first"], sels["last"], sels["transition"],
                   np.ones(big, np.int64)], axis=1)]
    X = np.concatenate([c.astype(np.int64) for c in cols], axis=1)[win]
    X = np.pad(X, ((0, 0), (0, Wp - X.shape[1]))).astype(np.uint32)
    wbase = np.zeros((prog.regs_padded, 4), np.uint32)
    wbase[:len(qi.wbase)] = qi.wbase
    vm = jdp._vm_fn(big, prog.regs_padded, Wp, prog.consts_padded,
                    prog.ops_padded)
    folded = vm(jnp.asarray(X), jnp.asarray(prog.padded_ops(Wp)),
                jnp.asarray(prog.consts_mont(pv)),
                jnp.asarray(bb.np_to_mont(wbase)))
    arrs = j_affine.assemble(plan, pv, r, gamma, pad_d_one=True)
    perm = qi.perm.numpy().astype(np.int64)[win]
    phi = np.zeros((big + stride, 4 * Bp), np.uint32)
    phi[:, :4 * nb] = perm[:, :4 * nb]
    wb = np.zeros((Bp, 4), np.uint32)
    wb[:nb] = qi.wb
    pq = jdp._pq_fn(big, Wp, plan.n_inter_padded, plan.max_terms,
                    plan.max_mult_terms, Bp)
    folded_pq = pq(jnp.asarray(X), jnp.asarray(phi),
                   jnp.asarray(perm[:, 4 * nb:4 * nb + 4].astype(np.uint32)),
                   *(jnp.asarray(arrs[k]) for k in qk._PLAN_KEYS),
                   jdp.ext_scalar_dev(cum), jnp.asarray(bb.np_to_mont(wb)),
                   jnp.asarray(bb.np_to_mont(qi.wsel.astype(np.uint32))),
                   *(jnp.asarray(sels[k].astype(np.uint32))
                     for k in ("first", "transition", "last")))
    return (np.asarray(folded, U) + np.asarray(folded_pq, U)) % U(P)


def _chip(name):
    chips, n_pv = _plan_chips()
    return next(c for c in chips if c[0] == name)[1:], n_pv


def _quotient_case(builder, n_pv, rng):
    pv = [int(v) for v in rng.integers(0, P, n_pv)]
    r, gamma, alpha, cum = (_ext(rng) for _ in range(4))
    nb = (len(builder.interactions) + 1) // 2
    main, prep, perm = _slices(rng, 2 << LOG_H, [builder.main_width,
                                                 builder.preprocessed_width,
                                                 4 * (nb + 1)])
    qi = dp.quotient_inputs(builder, main, prep, perm, pv, r, gamma, alpha,
                            cum, LOG_H)
    return qi, (pv, r, gamma, alpha, cum)


def _perm_case(builder, n_pv, rng):
    pv = [int(v) for v in rng.integers(0, P, n_pv)]
    r, gamma = _ext(rng), _ext(rng)
    main, prep = _slices(rng, 1 << LOG_H, [builder.main_width,
                                           builder.preprocessed_width])
    return main, prep, pv, r, gamma


def test_quotient_packing_matches_plain():
    chips, n_pv = _plan_chips()
    rng = np.random.default_rng(11)
    for name, builder, _ in chips:
        qi, _ = _quotient_case(builder, n_pv, rng)
        got = interpret_quotient(qk.quotient_args(qi))
        assert np.array_equal(got, qk.quotient_plain(qi).numpy().astype(U)), \
            name


@pytest.mark.parametrize("name", ("Func[eval]", "Bytes", "Mem[2-wide]"))
def test_quotient_packing_on_a_two_row_lde(name):
    """A one-row trace: the LDE has 2 rows, fewer than a row and its next
    row's stride past it, so every next row wraps."""
    (builder, _), n_pv = _chip(name)
    rng = np.random.default_rng(16)
    pv = [int(v) for v in rng.integers(0, P, n_pv)]
    nb = (len(builder.interactions) + 1) // 2
    main, prep, perm = _slices(rng, 2, [builder.main_width,
                                        builder.preprocessed_width,
                                        4 * (nb + 1)])
    qi = dp.quotient_inputs(builder, main, prep, perm, pv, *(
        _ext(rng) for _ in range(4)), 0)
    got = interpret_quotient(qk.quotient_args(qi))
    assert np.array_equal(got, qk.quotient_plain(qi).numpy().astype(U))


def test_perm_packing_matches_plain():
    chips, n_pv = _plan_chips()
    rng = np.random.default_rng(12)
    n = 0
    for name, builder, plan in chips:
        if not builder.interactions:
            continue
        n += 1
        nb = plan.n_batches
        main, prep, pv, r, gamma = _perm_case(builder, n_pv, rng)
        perm, _ = dp.device_perm_trace_plan(plan, main, prep, pv, r, gamma)
        a = dp._plan_arrays(plan, pv, r, gamma, pad_d_one=False,
                            n_keep=2 * nb)
        out = torch.full_like(perm, -1)
        interpret_perm(qk.perm_args(out, main, prep, a))
        assert torch.equal(out[:, :4 * nb], perm[:, :4 * nb]), name
        assert bool((out[:, 4 * nb:] == -1).all()), name
    assert n == len(chips)


# lurk_tpu's jitted programs compile for each shape bucket, seconds apiece
# on the CPU, so this file runs them on three chips: the largest VM
# program, the one chip with preprocessed columns and a two-interaction
# memory chip. The other plan chips run in two files of their own.
LURK_TPU_CHIPS = ("Func[eval_builtin_expr]", "Bytes", "Mem[2-wide]")

# Every chip of LURK_PROGRAM's direct machine with an affine plan, in the
# machine's order.
PLAN_CHIPS = (
    "Entrypoint[0]", "Func[lurk_main]", "Func[preallocate_symbols]",
    "Func[eval]", "Func[eval_builtin_expr]", "Func[eval_bind_builtin]",
    "Func[eval_env_builtin]", "Func[eval_apply_builtin]",
    "Func[eval_coroutine_expr]", "Func[eval_opening_unop]",
    "Func[eval_hide]", "Func[eval_unop]", "Func[eval_binop_num]",
    "Func[eval_binop_misc]", "Func[eval_begin]", "Func[eval_list]",
    "Func[coerce_if_sym]", "Func[open_comm]", "Func[equal]",
    "Func[equal_inner]", "Func[car_cdr]", "Func[eval_let]",
    "Func[eval_letrec]", "Func[extend_env_with_mutuals]",
    "Func[eval_letrec_bindings]", "Func[apply]", "Func[env_lookup]",
    "Func[ingress]", "Func[egress]", "Func[hash3]", "Func[hash4]",
    "Func[hash5]", "Func[u64_add]", "Func[u64_sub]", "Func[u64_mul]",
    "Func[u64_divrem]", "Func[u64_lessthan]", "Func[u64_iszero]",
    "Func[digest_equal]", "Func[big_num_lessthan]", "Mem[2-wide]",
    "Mem[3-wide]", "Mem[4-wide]", "Mem[5-wide]", "Mem[6-wide]",
    "Mem[8-wide]", "Bytes")
OTHER_PLAN_CHIPS = tuple(c for c in PLAN_CHIPS if c not in LURK_TPU_CHIPS)


def test_plan_chips_are_the_machines():
    """PLAN_CHIPS names every plan chip, each with interactions, so that
    the lurk_tpu comparisons cover them all."""
    chips, _ = _plan_chips()
    assert tuple(name for name, _, _ in chips) == PLAN_CHIPS
    assert all(builder.interactions for _, builder, _ in chips)


@pytest.mark.parametrize("name", LURK_TPU_CHIPS)
def test_quotient_plain_matches_lurk_tpu(name):
    (builder, plan), n_pv = _chip(name)
    qi, (pv, r, gamma, alpha, cum) = _quotient_case(
        builder, n_pv, np.random.default_rng(14))
    want = _jax_quotient(qi, plan, pv, r, gamma, alpha, cum)
    assert np.array_equal(qk.quotient_plain(qi).numpy().astype(U), want)


@pytest.mark.parametrize("name", LURK_TPU_CHIPS)
def test_perm_plain_matches_lurk_tpu(name):
    """device_perm_trace_plan's perm matrix and cumulative sum against
    lurk_tpu's _generic_perm_fn over the same rows."""
    (builder, plan), n_pv = _chip(name)
    main, prep, pv, r, gamma = _perm_case(builder, n_pv,
                                          np.random.default_rng(15))
    perm, cum = dp.device_perm_trace_plan(plan, main, prep, pv, r, gamma)
    h, nb = 1 << LOG_H, plan.n_batches
    cols = [main.numpy()] + ([prep.numpy()] if prep is not None else [])
    X = np.concatenate([c.astype(np.int64) for c in cols]
                       + [np.asarray(jdp._x_extras(h, plan.width_padded
                                                   - plan.x_width))],
                       axis=1).astype(np.uint32)
    arrs = j_affine.assemble(plan, pv, r, gamma)
    fn = jdp._generic_perm_fn(h, plan.width_padded, plan.n_inter_padded,
                              plan.max_terms, plan.max_mult_terms)
    phis, s, total = fn(jnp.asarray(X),
                        *(jnp.asarray(arrs[k]) for k in qk._PLAN_KEYS))
    want = np.concatenate([np.asarray(phis, U)[:, :4 * nb],
                           np.asarray(s, U)], axis=1)
    assert np.array_equal(perm.numpy().astype(U), want)
    assert np.array_equal(cum.numpy().astype(U), np.asarray(total, U))


def test_packing_rejects_layouts_the_kernels_do_not_take():
    chips, n_pv = _plan_chips()
    name, builder, plan = next(c for c in chips
                               if c[1].interactions and
                               c[1].preprocessed_width == 0)
    rng = np.random.default_rng(13)
    big = 2 << LOG_H
    nb = plan.n_batches
    main, perm = _slices(rng, big, [builder.main_width, 4 * (nb + 1)])
    args = ([0] * n_pv, (1, 2, 3, 4), (5, 6, 7, 8), (9, 1, 2, 3),
            (4, 5, 6, 7), LOG_H)
    qk.quotient_args(dp.quotient_inputs(builder, main, None, perm, *args))
    for bad in (main.T.contiguous().T, main.to(torch.int64), main[:-1]):
        with pytest.raises(ValueError):
            qk.quotient_args(dp.quotient_inputs(builder, bad, None, perm,
                                                *args))
    a = dp._plan_arrays(plan, [0] * n_pv, (1, 2, 3, 4), (5, 6, 7, 8),
                        pad_d_one=False, n_keep=2 * nb)
    h_main = main[:big // 2]
    out = torch.empty((big // 2, 4 * (nb + 1)), dtype=torch.int32)
    qk.perm_args(out, h_main, None, a)
    for bad_out in (out.T.contiguous().T, out[:, :-1]):
        with pytest.raises(ValueError):
            qk.perm_args(bad_out, h_main, None, a)


def test_launch_rows_bound_the_register_file():
    assert qk.launch_rows(624, 1 << 19) == 1 << 16
    assert qk.launch_rows(624, 1 << 10) == 1 << 10
    assert qk.launch_rows(9954, 1 << 20) == 1 << 12
    for regs in (1, 8, 128, 846, 100000):
        rows = qk.launch_rows(regs, 1 << 22)
        assert rows >= 256 and rows & (rows - 1) == 0
        assert 4 * regs * rows <= qk.SCRATCH_BYTES or rows == 256
