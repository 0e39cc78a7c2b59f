"""The arithmetic of the readers of the program's recorded spans: each
traced prove's `last_device_prove` carries, where the program records
them (lurk_tpu_torch/stark/spans.py, switched on by LURK_TPU_PROVE_TIMING,
which a traced run sets), "spans" (dicts with name, shard, parent,
start_ns, end_ns, exclusive_s: the seconds of the span that no child span
holds) and "counters". A program that records none gives every reader
nothing to read: None."""


def mean_over_proves(trace, value):
    """The mean of value(stats) over the traced proves that carry spans;
    None when none does."""
    stats = [s for s in trace.stats if "spans" in s]
    if not stats:
        return None
    return sum(value(s) for s in stats) / len(stats)


def exclusive_s(stats: dict, *names: str) -> float:
    """The exclusive seconds of a prove's spans of these names."""
    return sum(r["exclusive_s"] for r in stats["spans"]
               if r["name"] in names)


def mean_exclusive_s(trace, *names: str):
    return mean_over_proves(trace, lambda s: exclusive_s(s, *names))
