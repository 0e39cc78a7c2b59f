"""h2d_gib: GiB a prove copies from the host to the card (the program's
`h2d_bytes` counter: its copy helpers and the kernels' argument uploads),
the mean over the traced proves."""

from prove_bench.spans import mean_over_proves


def read(trace):
    return mean_over_proves(
        trace, lambda s: s["counters"].get("h2d_bytes", 0) / 2 ** 30)
