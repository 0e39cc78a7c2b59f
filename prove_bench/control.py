"""The control and the planted faults of prove_bench's correctness check:
runs of a cell with the timed path broken underneath, each of which has to
come out not correct. The benchmark's own runs never run them.

    python3 -m prove_bench.control --workload <cell> --seeds 11 12 13 \
        [--cases fewer_queries weaker_pow] [--seconds 1]

Cases (`planted(case, ...)` patches StarkMachine.prove for the run):
- fewer_queries: the control. The program proves at its own FriConfig
  with half the queries: the guarantee the configuration states (100
  queries) broken, the step that would tempt a faster FRI.
- weaker_pow: the program proves with half the proof-of-work bits.
- other_statement: each prove returns a proof of another input's statement
  (what a wrongly keyed cache of proofs would return).
- stale_proof: each prove does its work and returns the first proof the
  process made, of whatever statement it is asked for (a cache of proofs
  keyed on nothing).
- half_left_out: each proof loses its back half of shards (of chips, in a
  one-shard proof).
- answer_altered: one opened value of each proof's last shard is changed
  where the prover produced it.

Prints one JSON line per run (case, seed, correct, the checks) and exits 1
if any run came out correct. On the card it needs one; a CPU test drives
the same cases at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import sys
from types import SimpleNamespace

CASES = ("fewer_queries", "weaker_pow", "other_statement", "stale_proof",
         "half_left_out", "answer_altered")


def _half_left_out(proof):
    sps = proof.shard_proofs
    if len(sps) > 1:
        del sps[len(sps) // 2 + len(sps) % 2:]
        return
    sp = sps[0]
    keep = len(sp.chip_proofs) // 2
    del sp.chip_proofs[keep:]
    for rnd in sp.pcs_proof.opened[-3:]:
        del rnd[keep:]


def _altered(proof):
    vals = proof.shard_proofs[-1].pcs_proof.opened[-3][0][0]
    v = list(vals[0])
    v[0] = (int(v[0]) + 1) % 2013265921
    vals[0] = tuple(v)


@contextlib.contextmanager
def planted(case: str, config: dict, workload: dict, seed: int):
    """Break StarkMachine.prove (and, for other_statement, capture the
    evaluation's toplevel) for the duration of a run."""
    from lurk_tpu_torch.core import eval_api
    from lurk_tpu_torch.stark.fri import FriConfig
    from lurk_tpu_torch.stark.machine import StarkMachine
    from . import inputs
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}")
    orig_prove, orig_eval = StarkMachine.prove, eval_api.evaluate
    seen: dict = {}

    def evaluate(toplevel, zstore, code, *a, **k):
        seen.setdefault("tz", (toplevel, zstore))
        return orig_eval(toplevel, zstore, code, *a, **k)

    def prove(self, pk, queries, challenger, shard_config=None, device=None):
        c = self.config
        if case in ("fewer_queries", "weaker_pow"):
            self.config = FriConfig(
                c.log_blowup,
                c.num_queries // 2 if case == "fewer_queries"
                else c.num_queries, c.pow_bits // 2 if case == "weaker_pow"
                else c.pow_bits)
            try:
                return orig_prove(self, pk, queries, challenger,
                                  shard_config, device)
            finally:
                self.config = c
        if case == "other_statement":
            if "queries" not in seen:
                other = seed + 1
                while inputs.draw(config, workload, other) == \
                        inputs.draw(config, workload, seed):
                    other += 1
                toplevel, zstore = seen["tz"]
                seen["queries"] = orig_eval(
                    toplevel, zstore, inputs.program(
                        config, inputs.draw(config, workload, other)))[1]
            queries = seen["queries"]
        proof = orig_prove(self, pk, queries, challenger, shard_config,
                           device)
        if case == "stale_proof":
            return seen.setdefault("proof", proof)
        proof = copy.deepcopy(proof)
        if case == "half_left_out":
            _half_left_out(proof)
        elif case == "answer_altered":
            _altered(proof)
        return proof

    StarkMachine.prove, eval_api.evaluate = prove, evaluate
    try:
        yield
    finally:
        StarkMachine.prove, eval_api.evaluate = orig_prove, orig_eval


def run_case(case: str, cell: str, seed: int, seconds: float, **run_kw):
    from . import run as bench
    workload, config, _ = bench.load_cell(cell, run_kw.get("bench",
                                                           bench.BENCH))
    args = SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                           trace=0)
    with planted(case, config, workload, seed):
        return bench.run(args, **run_kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m prove_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--cases", nargs="+", default=["fewer_queries"],
                    choices=CASES)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    from . import run as bench
    try:
        workload, _, _ = bench.load_cell(args.workload)
        bench.require_cards(int(workload.get("chips", 1)))
        bench._caches()
    except bench.BenchError as e:
        print(f"prove_bench.control: {e}", file=sys.stderr)
        return 2
    passed = 0
    for case in args.cases:
        for seed in args.seeds:
            out = run_case(case, args.workload, seed, args.seconds)
            passed += bool(out["correct"])
            print(json.dumps({"case": case, "seed": seed,
                              "correct": out["correct"],
                              "checks": out["checks"]}), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
