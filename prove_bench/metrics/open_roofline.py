"""open_roofline: the least time of the proves' opened values and reduced
codewords (prove_bench/work.py's open_least_s over each shard's opened
groups) over the device time of csrc/open.cu's open_eval_kernel and
open_reduce_kernel, in percent."""

from prove_bench.work import open_least_s


def read(trace):
    measured = trace.kernel_s("open_eval_kernel") + \
        trace.kernel_s("open_reduce_kernel")
    if measured <= 0:
        return None
    least = sum(open_least_s(m) for shards in trace.shapes for m in shards)
    return 100.0 * least / measured
