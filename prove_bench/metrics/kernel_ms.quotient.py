"""kernel_ms.quotient: device milliseconds a prove spends in the
constraint-quotient and LogUp perm kernels (csrc/quotient.cu's
quotient_kernel and perm_phi_kernel), from the profiler's events; nothing
where no chip takes the kernels' path."""


def read(trace):
    s = trace.kernel_s("quotient_kernel") + trace.kernel_s("perm_phi_kernel")
    return 1e3 * s / trace.proofs if s > 0 else None
