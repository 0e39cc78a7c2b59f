"""kernel_ms.ntt: device milliseconds a prove spends in the NTT kernel
(csrc/ntt.cu's lurk_ntt_pass: the commits' LDE and the quotient
epilogue's transforms), from the profiler's events; nothing where no
transform takes the kernel (a tree without it)."""


def read(trace):
    s = trace.kernel_s("lurk_ntt_")
    return 1e3 * s / trace.proofs if s > 0 else None
