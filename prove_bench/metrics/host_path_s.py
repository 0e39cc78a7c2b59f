"""host_path_s: host-clock seconds a prove spends on the perm traces and
quotients of the chips under the host-path threshold (the `perm.host` and
`quotient.host` spans: numpy perm trace, host LDE, host quotient), the mean
over the traced proves."""

from prove_bench.spans import mean_exclusive_s


def read(trace):
    return mean_exclusive_s(trace, "perm.host", "quotient.host")
