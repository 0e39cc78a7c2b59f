"""Narrow Poseidon2 chip: one row per round (rounds+1 rows per permutation).

Counterpart of the wide chip for contexts where row count beats row width
(reference: src/poseidon/columns.rs:16-24, trace.rs:14-47, air.rs:22-166).
Column layout per row:

    input[W] | is_init | rounds[R] | add_rc[W] | sbox_deg_3[W] |
    sbox_deg_7[W] | output[W]

Row 0 of each permutation is the initial layer (add_rc = input, output =
external_linear_layer(input)); row 1+r applies round r (external rounds add
the full constant vector and sbox every element; internal rounds add a single
constant and sbox only element 0). The AIR chains output -> next.input for
every non-final round row, wrap-around style, with zero padding rows gated
out by the round flags.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..air.symbolic import Expr, SymbolicBuilder
from ..field.babybear import P
from .constants import get_config
from .witness import (U, _P, _ext_layer_arr, _int_layer_np)

__all__ = ["num_cols", "rounds", "generate_trace", "build_air"]


def rounds(width: int) -> int:
    cfg = get_config(width)
    return cfg.r_f + cfg.r_p


def num_cols(width: int) -> int:
    return 5 * width + 1 + rounds(width)


def _round_constants(cfg):
    """Per-round constant rows: full vectors for external rounds, a single
    element for internal rounds (reference: config.rs round_constants_iter)."""
    out = []
    half = cfg.r_f // 2
    for r in range(half):
        out.append(list(cfg.full_rc_list[r]))
    for r in range(cfg.r_p):
        out.append([cfg.part_rc_list[r]])
    for r in range(half, cfg.r_f):
        out.append(list(cfg.full_rc_list[r]))
    return out


def generate_trace(width: int, inputs: np.ndarray) -> np.ndarray:
    """inputs (n, width) canonical uint -> ((n*(R+1)) padded pow2, num_cols).

    Vectorized across permutations: all n permutations advance one round per
    step, writing row-block slices."""
    cfg = get_config(width)
    n = inputs.shape[0]
    r_tot = rounds(width)
    rows_per = r_tot + 1
    n_rows = n * rows_per
    padded = 1 << max(0, (n_rows - 1).bit_length())
    cols = num_cols(width)
    trace = np.zeros((max(padded, 1), cols), U)

    c_input = 0
    c_init = width
    c_rounds = width + 1
    c_addrc = c_rounds + r_tot
    c_sb3 = c_addrc + width
    c_sb7 = c_sb3 + width
    c_out = c_sb7 + width

    state = inputs.astype(U) % _P
    consts = _round_constants(cfg)
    half = cfg.r_f // 2

    # initial layer rows (row 0 of each permutation block)
    rows = slice(0, n_rows, rows_per)
    trace[rows, c_input:c_input + width] = state
    trace[rows, c_init] = 1
    trace[rows, c_addrc:c_addrc + width] = state
    sb3 = (state * state % _P) * state % _P
    trace[rows, c_sb3:c_sb3 + width] = sb3
    trace[rows, c_sb7:c_sb7 + width] = (sb3 * sb3 % _P) * state % _P
    state = _ext_layer_arr(state)
    trace[rows, c_out:c_out + width] = state

    for r in range(r_tot):
        rows = slice(1 + r, n_rows, rows_per)
        trace[rows, c_input:c_input + width] = state
        trace[rows, c_rounds + r] = 1
        add_rc = state.copy()
        rc = consts[r]
        add_rc[:, :len(rc)] = (add_rc[:, :len(rc)]
                               + np.asarray(rc, U)[None, :]) % _P
        trace[rows, c_addrc:c_addrc + width] = add_rc
        sb3 = (add_rc * add_rc % _P) * add_rc % _P
        sb7 = (sb3 * sb3 % _P) * add_rc % _P
        trace[rows, c_sb3:c_sb3 + width] = sb3
        trace[rows, c_sb7:c_sb7 + width] = sb7
        external = r < half or r >= half + cfg.r_p
        lin_in = sb7.copy() if external else add_rc.copy()
        if not external:
            lin_in[:, 0] = sb7[:, 0]
        if external:
            state = _ext_layer_arr(lin_in)
        else:
            cols_list = [lin_in[:, i] for i in range(width)]
            state = np.stack(_int_layer_np(cols_list, cfg.diag_list), axis=1)
        trace[rows, c_out:c_out + width] = state
    return trace


def _ext_layer_sym(state: List[Expr]) -> List[Expr]:
    from .witness import _ext_layer_sym as f
    return f(state)


def _int_layer_sym(state: List[Expr], diag) -> List[Expr]:
    from .witness import _int_layer_sym as f
    return f(state, diag)


def build_air(width: int) -> SymbolicBuilder:
    """Harvest the narrow chip's constraints (reference: air.rs:22-166)."""
    cfg = get_config(width)
    r_tot = rounds(width)
    b = SymbolicBuilder(num_cols(width))
    local = b.local_row()
    nxt = b.next_row()

    c_input = 0
    c_init = width
    c_rounds = width + 1
    c_addrc = c_rounds + r_tot
    c_sb3 = c_addrc + width
    c_sb7 = c_sb3 + width
    c_out = c_sb7 + width

    half = cfg.r_f // 2
    is_init = local[c_init]
    flags = local[c_rounds:c_rounds + r_tot]
    is_ext_first = sum(flags[:half], 0)
    is_internal = sum(flags[half:half + cfg.r_p], 0)
    is_ext_second = sum(flags[half + cfg.r_p:], 0)
    is_external = is_ext_first + is_ext_second
    is_linear = is_init + is_external
    is_real = is_init + is_internal + is_external

    b.assert_bool(is_init)
    for f in flags:
        b.assert_bool(f)
    b.assert_bool(is_real)

    consts = _round_constants(cfg)
    add_rc = [local[c_input + i] for i in range(width)]
    add_rc = list(add_rc)
    for r, rc in enumerate(consts):
        for i, c in enumerate(rc):
            add_rc[i] = add_rc[i] + flags[r] * int(c)
    for i in range(width):
        with b.when(is_real):
            b.assert_eq(add_rc[i], local[c_addrc + i])

    for i in range(width):
        x = local[c_addrc + i]
        sb3 = local[c_sb3 + i]
        sb7 = local[c_sb7 + i]
        b.assert_eq(x * x * x, sb3)
        b.assert_eq(sb3 * sb3 * x, sb7)

    sbox_result = []
    for i in range(width):
        if i == 0:
            sbox_result.append(is_init * local[c_addrc + i]
                               + (is_internal + is_external) * local[c_sb7 + i])
        else:
            sbox_result.append((is_init + is_internal) * local[c_addrc + i]
                               + is_external * local[c_sb7 + i])

    ext_out = _ext_layer_sym(sbox_result)
    for i in range(width):
        with b.when(is_linear):
            b.assert_eq(ext_out[i], local[c_out + i])

    int_out = _int_layer_sym(sbox_result, cfg.diag_list)
    for i in range(width):
        with b.when(is_internal):
            b.assert_eq(int_out[i], local[c_out + i])

    is_not_last = is_real - flags[-1]
    for i in range(width):
        with b.when(is_not_last):
            b.assert_eq(local[c_out + i], nxt[c_input + i])
    return b
