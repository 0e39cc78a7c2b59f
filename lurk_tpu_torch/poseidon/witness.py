"""Poseidon2 wide-chip witness generation + AIR (one row per permutation).

Witness layout (reference: src/poseidon/wide/columns.rs:17-32):
  external_rounds_state[R_F][W] | external_rounds_sbox[R_F][W] |
  internal_rounds_state_init[W] | internal_rounds_state0[R_P-1] |
  internal_rounds_sbox[R_P]
num_cols = 17*W + 2*R_P - 1.

populate_batch is vectorized numpy (trace replay); eval symbolically expands
the permutation keeping constraint degree <= 3 (only the cube is witnessed;
x^7 = x * (x^3)^2), exactly mirroring src/poseidon/wide/{trace,air}.rs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..field.babybear import P
from ..air.symbolic import Const, Expr
from .constants import get_config
from .ref import M4

U = np.uint64
_P = U(P)


def num_cols(width: int) -> int:
    cfg = get_config(width)
    return 2 * cfg.r_f * width + width + (cfg.r_p - 1) + cfg.r_p


# --- vectorized numpy permutation pieces -----------------------------------

def _ext_layer_np(state: List[np.ndarray]) -> List[np.ndarray]:
    w = len(state)
    out = [None] * w
    for c in range(0, w, 4):
        blk = state[c:c + 4]
        for r in range(4):
            acc = (M4[r][0] * blk[0]) % _P
            for j in range(1, 4):
                acc = (acc + M4[r][j] * blk[j]) % _P
            out[c + r] = acc
    sums = []
    for k in range(4):
        acc = out[k]
        for c in range(4 + k, w, 4):
            acc = (acc + out[c]) % _P
        sums.append(acc)
    return [(out[i] + sums[i % 4]) % _P for i in range(w)]


def _int_layer_np(state, diag):
    s = state[0]
    for x in state[1:]:
        s = (s + x) % _P
    return [(x * U(d) + s) % _P for x, d in zip(state, diag)]


def populate_batch(width: int, inputs: np.ndarray):
    """inputs (n, width) canonical -> (witness (n, 8+num_cols), result (n, width)).

    The witness prefix is the 8-felt output (reference: src/core/poseidon.rs
    witness = OUTPUT_SIZE + Poseidon2Cols); result is the full final state
    (pushed into the replay map, mirroring the reference's populate_witness).
    """
    cfg = get_config(width)
    n = inputs.shape[0]
    state = [inputs[:, i].astype(U) % _P for i in range(width)]
    cols = []

    ext_states = []
    ext_sboxes = []
    state = _ext_layer_np(state)
    for r in range(cfg.r_f // 2):
        state, st, sb = _ext_round_np(state, cfg, r)
        ext_states.append(st)
        ext_sboxes.append(sb)
    init_state = list(state)
    state0 = []
    int_sbox = []
    for r in range(cfg.r_p):
        if r > 0:
            state0.append(state[0])
        x0 = (state[0] + U(cfg.part_rc_list[r])) % _P
        sb3 = (x0 * x0 % _P) * x0 % _P
        int_sbox.append(sb3)
        state[0] = (x0 * (sb3 * sb3 % _P)) % _P
        state = _int_layer_np(state, cfg.diag_list)
    for r in range(cfg.r_f // 2, cfg.r_f):
        state, st, sb = _ext_round_np(state, cfg, r)
        ext_states.append(st)
        ext_sboxes.append(sb)

    result = np.stack(state, axis=1)
    witness = np.concatenate(
        [result[:, :8]]
        + [np.stack(st, axis=1) for st in ext_states]
        + [np.stack(sb, axis=1) for sb in ext_sboxes]
        + [np.stack(init_state, axis=1)]
        + ([np.stack(state0, axis=1)] if state0 else [np.zeros((n, 0), U)])
        + [np.stack(int_sbox, axis=1)], axis=1)
    assert witness.shape[1] == 8 + num_cols(width)
    return witness, result


def _ext_round_np(state, cfg, r):
    st_record = list(state)
    rc = cfg.full_rc_list[r]
    state = [(x + U(c)) % _P for x, c in zip(state, rc)]
    sb_record = []
    out = []
    for x in state:
        sb3 = (x * x % _P) * x % _P
        sb_record.append(sb3)
        out.append((x * (sb3 * sb3 % _P)) % _P)
    return _ext_layer_np(out), st_record, sb_record


# --- symbolic AIR -----------------------------------------------------------

def _ext_layer_sym(state: List[Expr]) -> List[Expr]:
    w = len(state)
    out = [None] * w
    for c in range(0, w, 4):
        blk = state[c:c + 4]
        for r in range(4):
            acc = blk[0] * M4[r][0]
            for j in range(1, 4):
                acc = acc + blk[j] * M4[r][j]
            out[c + r] = acc
    sums = []
    for k in range(4):
        acc = out[k]
        for c in range(4 + k, w, 4):
            acc = acc + out[c]
        sums.append(acc)
    return [out[i] + sums[i % 4] for i in range(w)]


def _int_layer_sym(state: List[Expr], diag) -> List[Expr]:
    s = state[0]
    for x in state[1:]:
        s = s + x
    return [x * int(d) + s for x, d in zip(state, diag)]


def eval_sym(builder, width: int, inputs: List[Expr], witness,
             is_real) -> List[Expr]:
    """Constrain witness cols against the permutation of `inputs`; returns
    the 8 output exprs. witness = [output(8) | Poseidon2Cols]."""
    cfg = get_config(width)
    output = list(witness[:8])
    w_iter = list(witness[8:])
    i = 0
    ext_state = [[w_iter[r * width + k] for k in range(width)]
                 for r in range(cfg.r_f)]
    i = cfg.r_f * width
    ext_sbox = [[w_iter[i + r * width + k] for k in range(width)]
                for r in range(cfg.r_f)]
    i += cfg.r_f * width
    init_state = w_iter[i:i + width]
    i += width
    state0 = w_iter[i:i + cfg.r_p - 1]
    i += cfg.r_p - 1
    int_sbox = w_iter[i:i + cfg.r_p]
    i += cfg.r_p
    assert i == num_cols(width)

    state = [is_real * x for x in inputs]
    state = _ext_layer_sym(state)

    def ext_round(state, r):
        for k in range(width):
            builder.assert_eq(state[k], ext_state[r][k])
        state = [ext_state[r][k] + is_real * cfg.full_rc_list[r][k]
                 for k in range(width)]
        out = []
        for k, x in enumerate(state):
            builder.assert_eq(x * x * x, ext_sbox[r][k])
            out.append(x * (ext_sbox[r][k] * ext_sbox[r][k]))
        return _ext_layer_sym(out)

    for r in range(cfg.r_f // 2):
        state = ext_round(state, r)
    for r in range(cfg.r_p):
        if r == 0:
            for k in range(width):
                builder.assert_eq(state[k], init_state[k])
            state = list(init_state)
        else:
            builder.assert_eq(state[0], state0[r - 1])
            state[0] = state0[r - 1]
        x0 = state[0] + is_real * cfg.part_rc_list[r]
        builder.assert_eq(x0 * x0 * x0, int_sbox[r])
        state[0] = x0 * (int_sbox[r] * int_sbox[r])
        state = _int_layer_sym(state, cfg.diag_list)
    for r in range(cfg.r_f // 2, cfg.r_f):
        state = ext_round(state, r)

    # only the truncated 8-felt output is constrained (the reference zips
    # `state` against the 8-entry output slice, src/poseidon/wide/air.rs:47-49)
    for k in range(8):
        builder.assert_eq(state[k], is_real * output[k])
    return output


from functools import lru_cache


@lru_cache(maxsize=None)
def _perm_tables(width: int):
    cfg = get_config(width)
    return (np.asarray(cfg.full_rc_list, U), np.asarray(cfg.part_rc_list, U),
            np.asarray(cfg.diag_list, U))


def _pow7_np(x: np.ndarray) -> np.ndarray:
    x2 = x * x % _P
    x3 = x2 * x % _P
    return (x3 * x3 % _P) * x % _P


def _ext_layer_arr(st: np.ndarray) -> np.ndarray:
    """External layer on a (n, w) uint64 array, inputs canonical; all adds
    with one final reduction (max magnitude ~ w/4 * 7p + 7p < 2^38).
    Vectorized across the w/4 M4 blocks via a (n, w/4, 4) view."""
    n, w = st.shape
    x = st.reshape(n, w // 4, 4)
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    t01 = x0 + x1
    t23 = x2 + x3
    t0123 = t01 + t23
    t01123 = t0123 + x1
    t01233 = t0123 + x3
    out = np.empty_like(x)
    out[..., 0] = t01123 + t01
    out[..., 1] = t01123 + (x2 << 1)
    out[..., 2] = t01233 + t23
    out[..., 3] = t01233 + (x0 << 1)
    out += out.sum(axis=1, keepdims=True)
    out %= _P
    return out.reshape(n, w)


def permute_batch_host(width: int, states: np.ndarray) -> np.ndarray:
    """Host-side batched permutation: threaded C++ when cpp/liblair.so is
    built, vectorized numpy otherwise. Bit-identical either way."""
    from ..lair import native
    if native.native_available():
        try:
            return native.poseidon_batch(width, states).astype(U)
        except Exception:
            pass  # stale library without the batch entry point
    return permute_batch_np(width, states)


def permute_batch_np(width: int, states: np.ndarray) -> np.ndarray:
    """Vectorized numpy Poseidon2 permutation (no XLA compile cost; used for
    small batches where device dispatch would dominate). Whole-array column
    ops; the external layer is adds-only with deferred reduction.
    (A Montgomery variant was measured slower here: numpy's uint64 `%` by a
    constant beats the extra multiply/mask/shift passes.)"""
    cfg = get_config(width)
    full_rc, part_rc, diag = _perm_tables(width)
    st = states.astype(U) % _P
    st = _ext_layer_arr(st)
    for r in range(cfg.r_f // 2):
        st = _ext_layer_arr(_pow7_np((st + full_rc[r][None, :]) % _P))
    for r in range(cfg.r_p):
        x0 = _pow7_np((st[:, 0] + part_rc[r]) % _P)
        st[:, 0] = x0
        s = st.sum(axis=1) % _P  # w * (p-1) < 2^36: no uint64 overflow
        st = (st * diag[None, :] + s[:, None]) % _P
    for r in range(cfg.r_f // 2, cfg.r_f):
        st = _ext_layer_arr(_pow7_np((st + full_rc[r][None, :]) % _P))
    return st


# --- device (torch) witness population --------------------------------------
# Vectorized over the full (m, width) state in canonical int64, reducing
# after every product; modular adds and products are exact, so the values
# are the numpy path's, in the same column layout (pinned against lurk_tpu
# in tests/test_torch_device_trace.py).


def _dev_ext_layer_v(st):
    """External (MDS) layer on (m, w) int64: the M4-blockwise product plus
    per-position block sums (every intermediate is below 2^36)."""
    import torch
    m, w = st.shape
    blk = st.reshape(m, w // 4, 4)
    out = torch.stack([sum(M4[r][j] * blk[:, :, j] for j in range(4)) % P
                       for r in range(4)], dim=2)      # (m, w//4, 4)
    sums = out.sum(dim=1, keepdim=True)
    return ((out + sums) % P).reshape(m, w)


def _dev_pow7_v(x):
    sb3 = x * x % P * x % P
    return sb3, x * (sb3 * sb3 % P) % P


def populate_batch_device(width: int, inputs):
    """torch mirror of populate_batch: (m, width) canonical tensor ->
    (witness (m, 8+num_cols), result (m, width)), int32 on the inputs'
    device. Exact mod-p int64 arithmetic, identical column layout. This
    lets the Poseidon wide chips (the widest traces in the Lurk machine)
    populate on the device instead of being uploaded."""
    import torch
    cfg = get_config(width)
    dev = inputs.device
    full_rc = torch.as_tensor(np.asarray(cfg.full_rc_list, np.int64),
                              device=dev)
    diag = torch.as_tensor(np.asarray(cfg.diag_list, np.int64), device=dev)
    state = _dev_ext_layer_v(inputs.to(torch.int64) % P)

    ext_states = []
    ext_sboxes = []

    def ext_round(state, r):
        ext_states.append(state)
        sb3, x7 = _dev_pow7_v((state + full_rc[r][None, :]) % P)
        ext_sboxes.append(sb3)
        return _dev_ext_layer_v(x7)

    for r in range(cfg.r_f // 2):
        state = ext_round(state, r)
    init_state = state
    state0 = []
    int_sbox = []
    for r in range(cfg.r_p):
        if r > 0:
            state0.append(state[:, 0])
        sb3, x7 = _dev_pow7_v((state[:, 0] + int(cfg.part_rc_list[r])) % P)
        int_sbox.append(sb3)
        state = torch.cat([x7[:, None], state[:, 1:]], dim=1)
        s = state.sum(dim=1) % P            # w * (p-1) < 2^37
        state = (state * diag[None, :] % P + s[:, None]) % P
    for r in range(cfg.r_f // 2, cfg.r_f):
        state = ext_round(state, r)

    result = state
    parts = [result[:, :8]] + ext_states + ext_sboxes + [init_state]
    if state0:
        parts.append(torch.stack(state0, dim=1))
    parts.append(torch.stack(int_sbox, dim=1))
    witness = torch.cat(parts, dim=1)
    assert witness.shape[1] == 8 + num_cols(width)
    return witness.to(torch.int32), result.to(torch.int32)
