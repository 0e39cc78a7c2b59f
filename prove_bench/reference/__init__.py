"""The plain reference that judges the proofs prove_bench times."""
