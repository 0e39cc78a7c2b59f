"""eval_s: seconds of the set-up's evaluations of the program, both
statements' (core/eval_api.py's evaluate: the native interpreter and the
ZStore), by the benchmark's host clock."""


def read(trace):
    return trace.eval_s
