"""lurk_tpu_torch: lurk_tpu ported to PyTorch and CUDA (NVIDIA Hopper).

Mirrors lurk_tpu's layout, module and function names, and is held
bit-exact against it: the same field elements, Poseidon2 digests, Merkle
roots and encoded proof bytes. It imports torch and numpy, never jax.

  field/    BabyBear + degree-4 extension arithmetic on int32 tensors
            (int64 compute); NTT/LDE on torch tensors or on the host.
  poseidon/ Poseidon2 configs and constants, the plain PyTorch permutation
            and the hand-written CUDA kernel (csrc/poseidon2.cu).
  lair/     The Lair IR, interpreter, trace generation and chips (copies
            of lurk_tpu's framework-free modules).
  air/      Symbolic constraint harvesting and the trace debugger.
  logup/    LogUp permutation traces, constraints and affine plans.
  stark/    Merkle commitments, challenger, FRI PCS, the STARK machine and
            the device prover on torch tensors.
  core/     The Lurk language: parser, ZStore, evaluator, the Lurk machine.
  gadgets/  Unsigned-integer Lair gadgets.
  cli/      The REPL, meta commands, proof persistence, microchain server.
  ocaml/    The OCaml frontend of !(load-ocaml).
  utils/    The wire codec.

`python -m lurk_tpu_torch repl|load|microchain` runs the CLI; its proofs
run on the CUDA card (LURK_TPU_PROVE=host asks for the host prover).
"""

__version__ = "0.1.0"
