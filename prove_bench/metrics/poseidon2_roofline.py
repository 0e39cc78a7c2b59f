"""poseidon2_roofline: the least time of the proves' Poseidon2 work on the
card (prove_bench/work.py's poseidon2_least_s over each shard's commits)
over the device time of the Poseidon2 kernel (csrc/poseidon2.cu's
perm_kernel), in percent."""

from prove_bench.work import poseidon2_least_s


def read(trace):
    measured = trace.kernel_s("perm_kernel")
    if measured <= 0:
        return None
    least = sum(poseidon2_least_s(m) for shards in trace.shapes
                for m in shards)
    return 100.0 * least / measured
