"""prove_bench: the benchmark of lurk_tpu_torch (see README.md)."""
