"""gc_pause_s: host-clock seconds a prove spends in the Python collector's
pauses (the `gc` spans), the mean over the traced proves."""

from prove_bench.spans import mean_exclusive_s


def read(trace):
    return mean_exclusive_s(trace, "gc")
