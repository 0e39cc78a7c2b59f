"""open_fri_s: host-clock seconds a prove spends from the points' set-up
to the query openings (the "open+fri" [prove-timing] stamp of each shard,
summed over the shards), the mean over the traced proves."""

from prove_bench.trace import phases


def read(trace):
    total = phases("".join(line + "\n" for _, line in trace.stamps)) \
        .get("open+fri")
    return total / trace.proofs if total is not None else None
