"""hasher_witness_s: host-clock seconds a prove spends in its
`witness.hasher` spans (the hash3/4/5 chips' device witness,
lair/device_trace.py: their streams' uploads and the Poseidon2 rounds on
the card, as dispatched), uploads included, the mean over the traced
proves; None where no prove records one."""

from prove_bench.spans import mean_over_proves


def _inclusive_s(stats: dict) -> float:
    return sum(r["end_ns"] - r["start_ns"] for r in stats["spans"]
               if r["name"] == "witness.hasher") / 1e9


def read(trace):
    if not any(r["name"] == "witness.hasher" for s in trace.stats
               for r in s.get("spans", ())):
        return None
    return mean_over_proves(trace, _inclusive_s)
