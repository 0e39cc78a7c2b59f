"""witness_upload_s: host-clock seconds a prove spends in its
`witness.upload` spans (each host array's conversion and copy to the card
in the witness phase: the host chips' traces, the device witness's
streams), exclusive of collector pauses, the mean over the traced
proves."""

from prove_bench.spans import mean_exclusive_s


def read(trace):
    return mean_exclusive_s(trace, "witness.upload")
