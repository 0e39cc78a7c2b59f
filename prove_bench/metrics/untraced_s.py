"""untraced_s: host-clock seconds of a prove that no span below the root
`prove` holds (the root's exclusive seconds), the mean over the traced
proves."""

from prove_bench.spans import mean_over_proves


def read(trace):
    return mean_over_proves(trace, lambda s: sum(
        r["exclusive_s"] for r in s["spans"] if r["parent"] is None))
