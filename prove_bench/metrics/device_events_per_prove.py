"""device_events_per_prove: device events (kernels, copies and sets) a
prove puts on the card, from the profiler's events."""


def read(trace):
    return len(trace.events) / trace.proofs if trace.events else None
