"""witness_device_host_s: host-clock seconds a prove spends in its
`witness.device` spans outside their uploads: the host side of the device
witness (lair/device_trace.py's grouping, gathers and dispatch), the mean
over the traced proves."""

from prove_bench.spans import mean_exclusive_s


def read(trace):
    return mean_exclusive_s(trace, "witness.device")
