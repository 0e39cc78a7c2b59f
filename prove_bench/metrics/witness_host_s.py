"""witness_host_s: host-clock seconds a prove spends making the witnesses
of the chips that take the host path (`last_device_prove`'s
host_witness_s: generated on the host and uploaded), the mean over the
traced proves."""


def read(trace):
    vals = [s["host_witness_s"] for s in trace.stats if "host_witness_s" in s]
    return sum(vals) / len(vals) if vals else None
