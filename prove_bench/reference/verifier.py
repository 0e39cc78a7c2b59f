"""A plain verifier of lurk_tpu_torch's machine proofs: the Fiat-Shamir
transcript, every Merkle opening, the reduced openings, FRI and its proof
of work, each chip's constraints and LogUp interactions at zeta against
its quotient (the AIR as data, prove_bench/configs/air_<toplevel>.json.gz,
written from lurk_tpu by prove_bench/tools/export_air.py), the LogUp
balance and the public values. Plain PyTorch (int64) on any device and
Python ints; it imports nothing of the program. It follows the protocol of
lurk_tpu's host verifier (lurk_tpu/stark/machine.py `_verify`,
`_shard_transcript` and `_batched_zeta_checks`, logup/constraints.py
`eval_perm_at_point_batch`, pcs.py `verify_rounds`, fri.py `verify`,
challenger.py), written anew for the benchmark.

`verify(proof, key, fri)` returns a list of the faults found (empty when
the proof holds); `proof` is read through its attributes only.
"""

from __future__ import annotations

import gzip
import json
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from . import field as F
from . import poseidon2

LOG_BLOWUP = 1


@dataclass
class Key:
    """What the verifier knows of the statement besides the proof: the
    preprocessed round's roots, chips, widths and trace heights, and the
    number of public values."""
    prep_roots: list
    prep_chip_names: List[str]
    prep_widths: List[int]
    prep_log_heights: List[int]
    num_public_values: int
    air: dict                       # chip name -> load_air()'s entry


def load_air(path) -> tuple:
    """(the chips of an exported AIR by name, the number of public
    values)."""
    with gzip.open(path, "rt") as f:
        data = json.load(f)
    return {c["name"]: c for c in data["chips"]}, data["num_public_values"]


@dataclass
class Fri:
    log_blowup: int
    num_queries: int
    pow_bits: int


class Challenger:
    """The duplex sponge of the transcript: width 16, rate 8; an observed
    value goes into the input buffer and a full buffer overwrites the rate
    and permutes; a sample permutes first if there is pending input or no
    output left, then takes the first word left of the rate."""

    def __init__(self):
        self.state = [0] * 16
        self.inp: List[int] = []
        self.out: List[int] = []

    def _duplex(self):
        self.state[:len(self.inp)] = self.inp
        self.inp = []
        self.state = poseidon2.permute_ints(self.state)
        self.out = self.state[:8]

    def observe(self, value: int):
        self.out = []
        self.inp.append(int(value) % F.P)
        if len(self.inp) == 8:
            self._duplex()

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def sample(self) -> int:
        if self.inp or not self.out:
            self._duplex()
        return self.out.pop(0)

    def sample_ext(self) -> tuple:
        return tuple(self.sample() for _ in range(4))

    def sample_bits(self, bits: int) -> int:
        return self.sample() & ((1 << bits) - 1)

    def copy(self) -> "Challenger":
        c = Challenger()
        c.state, c.inp, c.out = list(self.state), list(self.inp), \
            list(self.out)
        return c


class Reject(Exception):
    pass


def _need(cond, what: str):
    if not cond:
        raise Reject(what)


def _ints(values) -> List[int]:
    return [int(v) for v in values]


def _canonical(t: torch.Tensor, what: str) -> torch.Tensor:
    _need(bool(((t >= 0) & (t < F.P)).all()), f"{what}: value out of range")
    return t


class Merkle:
    """Every Merkle opening of a proof, checked in one batched pass: the
    leaves of all jobs hashed chunk by chunk (jobs sorted by their number of
    chunks, so the rows still absorbing are a prefix) and the paths walked
    level by level the same way."""

    def __init__(self, device):
        self.device = device
        self.jobs = []              # (chunks, depth, root, rows, idx, path, what)

    def add(self, root, rows: torch.Tensor, idx: torch.Tensor, paths,
            depth: int, what: str):
        paths = torch.as_tensor(np.asarray(
            [np.asarray(p, dtype=np.int64).reshape(-1, 8) for p in paths]),
            device=self.device).reshape(len(paths), -1, 8)
        _need(paths.shape[1] == depth, f"{what}: path length")
        _canonical(paths, what)
        self.jobs.append((max(-(-rows.shape[1] // 8), 1), depth,
                          _ints(root), rows, idx, paths, what))

    def check(self):
        jobs = sorted(self.jobs, key=lambda j: -j[0])
        nq = [j[3].shape[0] for j in jobs]
        width = 8 * jobs[0][0]
        rows = torch.cat([torch.nn.functional.pad(j[3], (0, width -
                                                         j[3].shape[1]))
                          for j in jobs])
        active = [sum(n for n, j in zip(nq, jobs) if j[0] > c)
                  for c in range(jobs[0][0])]
        state = rows.new_zeros(rows.shape[0], 16)
        for c, r in enumerate(active):
            state = torch.cat([torch.cat([rows[:r, 8 * c:8 * c + 8],
                                          state[:r, 8:]], dim=1),
                               state[r:]])
            state = torch.cat([poseidon2.permute(state[:r]), state[r:]])
        digests = state[:, :8]
        order = sorted(range(len(jobs)), key=lambda i: -jobs[i][1])
        starts = np.cumsum([0] + nq)
        pick = torch.cat([torch.arange(starts[i], starts[i] + nq[i],
                                       device=self.device) for i in order])
        node = digests[pick]
        idx = torch.cat([jobs[i][4] for i in order])
        depth = jobs[order[0]][1]
        paths = torch.cat([torch.nn.functional.pad(
            jobs[i][5], (0, 0, 0, depth - jobs[i][1])) for i in order])
        for d in range(depth):
            r = sum(nq[i] for i in order if jobs[i][1] > d)
            sib = paths[:r, d]
            right = ((idx[:r] >> d) & 1 == 1).unsqueeze(1)
            up = poseidon2.compress(torch.where(right, sib, node[:r]),
                                    torch.where(right, node[:r], sib))
            node = torch.cat([up, node[r:]])
        at = 0
        for i in order:
            got = node[at:at + nq[i]]
            at += nq[i]
            want = torch.tensor(jobs[i][2], dtype=torch.int64,
                                device=self.device)
            _need(bool((got == want).all()), f"{jobs[i][6]}: Merkle path "
                  "does not reach the root")


def _groups(log_heights: Sequence[int]):
    """[(log_h, [matrix indices])], tallest first, each in matrix order."""
    g: dict = {}
    for i, lh in enumerate(log_heights):
        g.setdefault(lh, []).append(i)
    return sorted(g.items(), key=lambda kv: -kv[0])


def _verify_rounds(roots, widths, lhs, points, pcs_proof, fri: Fri,
                   ch: Challenger, merkle: Merkle, device):
    """The PCS opening of one shard's rounds at their points, then FRI."""
    opened = pcs_proof.opened
    _need(len(opened) == len(points), "rounds opened")
    flat: List[int] = []
    ys = []                         # (r, m, point index) -> (w, 4) tensor
    for r, (rv, pts_r, ws) in enumerate(zip(opened, points, widths)):
        _need(len(rv) == len(pts_r) == len(ws), "matrices opened")
        for m, (mv, pts, w) in enumerate(zip(rv, pts_r, ws)):
            _need(len(mv) == len(pts), "points opened")
            for vals in mv:
                _need(len(vals) == w and all(len(v) == 4 for v in vals),
                      "opened width")
                for v in vals:
                    flat.extend(_ints(v))
                ys.append(F.ext([_ints(v) for v in vals], device))
    _need(all(0 <= v < F.P for v in flat), "opened value out of range")
    ch.observe_many(flat)
    alpha = ch.sample_ext()

    lde = [[lh + LOG_BLOWUP for lh in rnd] for rnd in lhs]
    max_log = max(lh for rnd in lde for lh in rnd)
    total_w = sum(w * len(points[r][m]) for r in range(len(widths))
                  for m, w in enumerate(widths[r]))
    apows = F.powers(alpha, total_w, device)

    # the (matrix, point) terms at each LDE height: weights and y_alpha
    terms: dict = {}                # log_n -> list of (r, m, z, weights, ya)
    off = blk = 0
    for r in range(len(widths)):
        for m, w in enumerate(widths[r]):
            for z in points[r][m]:
                wts = apows[off:off + w]
                ya = F.emul(ys[blk], wts).sum(0) % F.P
                terms.setdefault(lde[r][m], []).append((r, m, z, wts, ya))
                off += w
                blk += 1

    fp = pcs_proof.fri_proof
    nq = fri.num_queries
    _need(len(pcs_proof.query_openings) == nq, "query count")
    _need(len(fp.queries) == nq and len(fp.query_indices) == nq,
          "FRI query count")
    num_layers = max_log - fri.log_blowup
    _need(len(fp.layer_roots) == num_layers, "FRI layer count")
    betas = []
    for root in fp.layer_roots:
        ch.observe_many(_ints(root))
        betas.append(ch.sample_ext())
    ch.observe_many(_ints(fp.final_value))
    ch.observe(int(fp.pow_witness))
    _need(ch.sample_bits(fri.pow_bits) == 0, "proof of work")
    q = [ch.sample_bits(max_log) for _ in range(nq)]
    _need(q == _ints(fp.query_indices), "query indices")
    q = torch.tensor(q, dtype=torch.int64, device=device)

    # Merkle openings of every committed round at every query
    rows_at: dict = {}              # (r, m) -> (nq, w) opened rows
    for r, rnd_roots in enumerate(roots):
        groups = _groups(lde[r])
        _need(len(rnd_roots) == len(groups), "roots of a round")
        for g, ((log_h, mids), root) in enumerate(zip(groups, rnd_roots)):
            ents = [qo[r][g] for qo in pcs_proof.query_openings]
            _need(all(int(e[0]) == log_h for e in ents), "opening height")
            parts = []
            for k, m in enumerate(mids):
                t = torch.as_tensor(np.asarray(
                    [e[1].rows[k] for e in ents], dtype=np.int64),
                    device=device)
                _need(t.shape == (nq, widths[r][m]), "opened row width")
                rows_at[(r, m)] = _canonical(t, "opened row")
                parts.append(t)
            merkle.add(root, torch.cat(parts, dim=1), q % (1 << log_h),
                       [e[1].path for e in ents], log_h,
                       f"round {r} height {log_h}")

    # the reduced opening at each height, all inverses in one batch
    reduced = {}
    xz, keys = [], []
    for log_n, ts in terms.items():
        x = F.bpow(F.two_adic_generator(log_n), q % (1 << log_n),
                   F.GENERATOR)
        for k, (r, m, z, wts, ya) in enumerate(ts):
            xe = torch.zeros(nq, 4, dtype=torch.int64, device=device)
            xe[:, 0] = x
            xz.append(F.esub(xe, F.ext([list(z)], device)))
            keys.append((log_n, k))
    inv = F.einv(torch.cat(xz)).split(nq) if xz else []
    for (log_n, k), inv_xz in zip(keys, inv):
        r, m, z, wts, ya = terms[log_n][k]
        rows = rows_at[(r, m)]                      # (nq, w)
        fx = (rows.unsqueeze(-1) * wts % F.P).sum(1) % F.P
        term = F.emul(F.esub(fx, ya), inv_xz)
        reduced[log_n] = term if log_n not in reduced else \
            F.eadd(reduced[log_n], term)

    # FRI: fold the queries down the layers
    _need(max_log in reduced, "no codeword at the largest height")
    v = reduced[max_log]
    idx, log_n = q, max_log
    two_inv = F.inv(2)
    for layer, root in enumerate(fp.layer_roots):
        half = 1 << (log_n - 1)
        j = idx % half
        steps = [qq.steps[layer] for qq in fp.queries]
        _need(all(len(s.pair_row) == 8 for s in steps), "FRI pair row")
        pair = _canonical(F.ext([_ints(s.pair_row) for s in steps], device),
                          "FRI pair row")
        merkle.add(root, pair, j, [s.path for s in steps], log_n - 1,
                   f"FRI layer {layer}")
        f_x, f_mx = pair[:, :4], pair[:, 4:]
        mine = torch.where((idx < half).unsqueeze(1), f_x, f_mx)
        _need(bool((mine == v).all()), f"FRI layer {layer}: the folded "
              "value disagrees with the opened one")
        shift = pow(F.GENERATOR, 1 << layer, F.P)
        x = F.bpow(F.two_adic_generator(log_n), j, shift)
        inv_2x = _base_inv(x * 2 % F.P)
        s = F.eadd(f_x, f_mx) * two_inv % F.P
        d = F.escale(F.esub(f_x, f_mx), inv_2x)
        beta = F.ext([list(betas[layer])], device)
        v = F.eadd(s, F.emul(beta, d))
        idx, log_n = j, log_n - 1
        if log_n in reduced:
            v = F.eadd(v, reduced[log_n])
    final = F.ext([_ints(fp.final_value)], device)
    _need(bool((v == final).all()), "FRI final value")


def _base_inv(x: torch.Tensor) -> torch.Tensor:
    out = torch.ones_like(x)
    b, e = x % F.P, F.P - 2
    while e:
        if e & 1:
            out = out * b % F.P
        b = b * b % F.P
        e >>= 1
    return out


def verify(proof, key: Key, fri: Fri, device="cpu") -> List[str]:
    """The faults found in `proof` (an empty list: it holds)."""
    try:
        _verify(proof, key, fri, torch.device(device))
    except Reject as e:
        return [str(e)]
    except (AttributeError, IndexError, KeyError, OverflowError, TypeError,
            ValueError) as e:
        return [f"malformed proof: {type(e).__name__}: {e}"]
    return []


def _selectors(log_h: int, zeta) -> tuple:
    """The first-row, last-row and transition selectors at zeta and the
    vanishing polynomial zeta^h - 1 of a trace of 2^log_h rows."""
    h = 1 << log_h
    zh = F.esub_s(F.epow_s(zeta, h), (1, 0, 0, 0))
    g_inv = pow(F.two_adic_generator(log_h), h - 1, F.P) if log_h else 1
    return {"first": F.emul_s(zh, F.einv_s(F.esub_s(zeta, (1, 0, 0, 0)))),
            "last": F.emul_s(zh, F.einv_s(F.esub_s(zeta, (g_inv, 0, 0, 0)))),
            "transition": F.esub_s(zeta, (g_inv, 0, 0, 0))}, zh


_X = [F.epow_s((0, 1, 0, 0), k) for k in range(4)]


def _recombine(cols) -> tuple:
    """An extension column from the values of its 4 base columns."""
    acc = (0, 0, 0, 0)
    for c, x in zip(cols, _X):
        acc = F.eadd_s(acc, F.emul_s(c, x))
    return acc


def _identity(air: dict, opened: dict, pv, sels, zh, zeta, r, gamma, alpha,
              cum) -> bool:
    """One chip's constraints and LogUp interactions at zeta, folded by
    alpha (Horner, in the AIR's order, the LogUp checks after the
    constraints), against its quotient times the vanishing polynomial."""
    vals = []
    for item in air["nodes"]:
        op = item[0]
        if op == "c":
            v = (item[1], 0, 0, 0)
        elif op == "col":
            v = opened[(item[1], item[2])][item[3]]
        elif op == "pub":
            v = (pv[item[1]] % F.P, 0, 0, 0)
        elif op == "sel":
            v = sels[item[1]]
        elif op == "+":
            v = F.eadd_s(vals[item[1]], vals[item[2]])
        elif op == "-":
            v = F.esub_s(vals[item[1]], vals[item[2]])
        elif op == "*":
            v = F.emul_s(vals[item[1]], vals[item[2]])
        else:
            raise Reject(f"unknown AIR node {op!r}")
        vals.append(v)
    checks = [vals[c] for c in air["constraints"]]

    inters = air["interactions"]
    batches = [inters[i:i + 2] for i in range(0, len(inters), 2)]
    nb = len(batches)
    perm_l, perm_n = opened[("perm", 0)], opened[("perm", 1)]
    phi = [_recombine(perm_l[4 * b:4 * b + 4]) for b in range(nb)]
    phi_n = [_recombine(perm_n[4 * b:4 * b + 4]) for b in range(nb)]
    s_val = _recombine(perm_l[4 * nb:4 * nb + 4])
    s_next = _recombine(perm_n[4 * nb:4 * nb + 4])
    gpows = [(1, 0, 0, 0)]
    for _ in range(max((len(i[1]) for i in inters), default=0)):
        gpows.append(F.emul_s(gpows[-1], gamma))
    for b, batch in enumerate(batches):
        ds, ms = [], []
        for kind, values, mult in batch:
            d = tuple(r)
            for j, v in enumerate(values):
                d = F.eadd_s(d, F.emul_s(gpows[j + 1], vals[v]))
            ds.append(d)
            m = vals[mult]
            ms.append(F.esub_s((0, 0, 0, 0), m) if kind == "receive" else m)
        lhs = phi[b]
        for d in ds:
            lhs = F.emul_s(lhs, d)
        rhs = (0, 0, 0, 0)
        for i, m in enumerate(ms):
            term = m
            for j, d in enumerate(ds):
                if j != i:
                    term = F.emul_s(term, d)
            rhs = F.eadd_s(rhs, term)
        checks.append(F.esub_s(lhs, rhs))
    total, total_n = (0, 0, 0, 0), (0, 0, 0, 0)
    for b in range(nb):
        total, total_n = F.eadd_s(total, phi[b]), F.eadd_s(total_n, phi_n[b])
    checks.append(F.emul_s(sels["first"], F.esub_s(s_val, total)))
    checks.append(F.emul_s(sels["transition"], F.esub_s(
        F.esub_s(s_next, s_val), total_n)))
    checks.append(F.emul_s(sels["last"], F.esub_s(s_val, cum)))

    folded = (0, 0, 0, 0)
    for c in checks:
        folded = F.eadd_s(F.emul_s(folded, alpha), c)
    q = opened[("quotient", 0)]
    quotient = F.eadd_s(_recombine(q[:4]), F.emul_s(zeta, _recombine(q[4:])))
    return folded == F.emul_s(quotient, zh)


def _verify(proof, key: Key, fri: Fri, device):
    pv = _ints(proof.public_values)
    _need(len(pv) == key.num_public_values, "public value count")
    _need(all(0 <= v < F.P for v in pv), "public value out of range")
    sps = proof.shard_proofs
    _need(len(sps) > 0, "no shard")
    ch = Challenger()
    for root in key.prep_roots:
        ch.observe_many(_ints(root))
    ch.observe_many(pv)
    entry = {n for n in key.air if n.startswith("Entrypoint")}
    first_only = {n for n, c in key.air.items() if c["shard0_only"]}
    for pos, sp in enumerate(sps):
        _need(int(sp.index) == pos, "shard order")
        names = [cp.name for cp in sp.chip_proofs]
        _need(len(set(names)) == len(names), "a chip twice in a shard")
        _need(set(names) <= set(key.air), "a chip the AIR does not have")
        if pos == 0:
            _need(not entry or set(names) & entry, "no entrypoint chip")
        else:
            _need(not set(names) & first_only, "a first-shard chip later")
        for root in sp.main_roots:
            ch.observe_many(_ints(root))

    total = (0, 0, 0, 0)
    merkle = Merkle(device)
    for sp in sps:
        sch = ch.copy()
        r = sch.sample_ext()
        gamma = sch.sample_ext()
        for root in sp.perm_roots:
            sch.observe_many(_ints(root))
        for cp in sp.chip_proofs:
            sch.observe_many(_ints(cp.cumulative_sum))
            total = F.eadd_s(total, _ints(cp.cumulative_sum))
        alpha = sch.sample_ext()
        for root in sp.quotient_roots:
            sch.observe_many(_ints(root))
        zeta = sch.sample_ext()
        zeta2 = F.emul_s(zeta, zeta)

        chips = list(sp.chip_proofs)
        airs = [key.air[cp.name] for cp in chips]
        lh = [int(cp.log_height) for cp in chips]

        def pts(log_h):
            g = F.two_adic_generator(log_h) if log_h else 1
            return [zeta, F.emul_s(zeta, (g, 0, 0, 0))]

        widths, lhs, points, roots = [], [], [], []
        if key.prep_roots:
            by_name = {cp.name: int(cp.log_height) for cp in chips}
            widths.append(list(key.prep_widths))
            lhs.append(list(key.prep_log_heights))
            points.append([pts(by_name[n]) if n in by_name else [zeta]
                           for n in key.prep_chip_names])
            roots.append(list(key.prep_roots))
        r0 = len(widths)
        widths += [[a["main_width"] for a in airs],
                   [4 * ((len(a["interactions"]) + 1) // 2 + 1)
                    for a in airs], [8] * len(chips)]
        lhs += [list(lh)] * 3
        points += [[pts(h) for h in lh], [pts(h) for h in lh],
                   [[zeta2] for _ in chips]]
        roots += [list(sp.main_roots), list(sp.perm_roots),
                  list(sp.quotient_roots)]
        _verify_rounds(roots, widths, lhs, points, sp.pcs_proof, fri, sch,
                       merkle, device)

        opened = sp.pcs_proof.opened
        for i, (cp, air) in enumerate(zip(chips, airs)):
            vals = {("main", 0): opened[r0][i][0],
                    ("main", 1): opened[r0][i][1],
                    ("perm", 0): opened[r0 + 1][i][0],
                    ("perm", 1): opened[r0 + 1][i][1],
                    ("quotient", 0): opened[r0 + 2][i][0]}
            if air["prep_width"]:
                _need(cp.name in key.prep_chip_names, "preprocessed chip")
                k = key.prep_chip_names.index(cp.name)
                vals[("preprocessed", 0)] = opened[0][k][0]
                vals[("preprocessed", 1)] = opened[0][k][1]
            vals = {k: [tuple(_ints(v)) for v in col]
                    for k, col in vals.items()}
            sels, zh = _selectors(int(cp.log_height), zeta)
            _need(_identity(air, vals, pv, sels, zh, zeta, r, gamma, alpha,
                            tuple(_ints(cp.cumulative_sum))),
                  f"shard {sp.index} chip {cp.name}: the constraints at "
                  "zeta do not match the quotient")
    _need(total == (0, 0, 0, 0), "the LogUp cumulative sums do not balance")
    merkle.check()
