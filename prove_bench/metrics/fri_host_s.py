"""fri_host_s: host-clock seconds a prove spends in FRI's host tail (the
`fri.tail` spans: the download, the layers under the host-tail threshold,
the final polynomial) and its proof of work (the `fri.pow` spans), the mean
over the traced proves."""

from prove_bench.spans import mean_exclusive_s


def read(trace):
    return mean_exclusive_s(trace, "fri.tail", "fri.pow")
