"""Small proofs with known digests: the on-card checks that the device
prover is byte-exact.

`fib_proof(device)` proves demo `fib` at n = 1000 with FriConfig(1, 8, 2)
on the device prover (torch tensors on `device`). The sha256 of its encoded
bytes must equal GOLDEN_FIB1000_SHA256, which is also the sha256 of
lurk_tpu's host proof of the same statement (tests/test_torch_prover.py).

`lurk_proof(device, shard_size)` proves the Lurk program LURK_PROGRAM on
the full Lurk machine (47 chips) at FriConfig(1, 8, 2): in one shard its
sha256 is GOLDEN_LURK_SHA256, and at ShardingConfig(max_shard_size=128)
(two shards) GOLDEN_LURK_2SHARD_SHA256; both are the sha256 of lurk_tpu's
host proofs (tests/test_torch_lurk_prover.py).

Every entry point proves on `device`; with no device it is CUDA, and it
raises when there is no card.
"""

from __future__ import annotations

import hashlib

GOLDEN_N = 1000
GOLDEN_FIB1000_SHA256 = \
    "bc7b68ea7d77b7935b712e72dc384b9dbfaba776b0c2136c0a1571a5870e9054"

# touches eval, builtins, apply, binops, env lookup, begin, car/cdr, u64,
# strings and conses; evaluates to (12 . 92)
LURK_PROGRAM = """
(letrec ((fib (lambda (n) (if (<= n 1) n
                  (+ (fib (- n 1)) (fib (- (- n 1) 1))))))
         (rev (lambda (l acc) (if l (rev (cdr l) (cons (car l) acc)) acc))))
  (begin
    (fib 14)
    (rev '(1 2 3 "abc" :kw) nil)
    (cons (* 3 4) (- 100 (/ 64 8)))))
"""
LURK_RESULT = "(12 . 92)"
LURK_2SHARD_SIZE = 128
GOLDEN_LURK_SHA256 = \
    "24d1bde136f210074cce61bdfa731b3929eb1e89f1b2994f141bc58befbdaef7"
GOLDEN_LURK_2SHARD_SHA256 = \
    "7fed5027e36c2bac554bb3a3ee699a99da5af36cce1c6ce083ab63fedfead2e5"


def fib_machine(n: int, config):
    """(machine, queries) for demo `fib` at n, as bench.py builds them."""
    from ..lair.chips import build_lair_chip_vector
    from ..lair.demo import demo_toplevel
    from ..lair.execute import QueryRecord
    from ..lair.native import NativeToplevel
    from ..lair.trace import FuncChip
    from .machine import StarkMachine
    tl = demo_toplevel()
    q = QueryRecord(tl)
    NativeToplevel(tl).execute(tl.func_index["fib"], [n], q)
    chips = build_lair_chip_vector(FuncChip.from_name("fib", tl))
    return StarkMachine(chips, len(q.expect_public_values()), config), q


def _proved(machine, pk, vk, queries, device, shard_config=None):
    from ..utils import codec
    from .challenger import Challenger
    from .device_prover import device_prove
    proof = device_prove(machine, pk, queries, Challenger(), shard_config,
                         device=device)
    return machine, vk, proof, hashlib.sha256(codec.encode(proof)).hexdigest()


def fib_proof(device=None):
    """(machine, vk, proof, sha256 hex) of the golden statement proved on
    the device prover."""
    from .fri import FriConfig
    machine, q = fib_machine(GOLDEN_N, FriConfig(1, 8, 2))
    pk, vk = machine.setup()
    return _proved(machine, pk, vk, q, device)


def lurk_machine(code: str, config):
    """(machine, queries, printed result) of a Lurk program evaluated by
    the native interpreter, on the full Lurk machine at `config`."""
    from ..core.eval_api import evaluate
    from ..core.eval_direct import build_lurk_toplevel
    from ..core.stark_machine import new_machine
    toplevel, zstore, _ = build_lurk_toplevel()
    result, queries = evaluate(toplevel, zstore, code)
    return new_machine(toplevel, config), queries, zstore.fmt(result)


def lurk_proof(device=None, shard_size=None, machine_queries=None):
    """(machine, vk, proof, sha256 hex) of LURK_PROGRAM proved on the
    device prover, in one shard or at ShardingConfig(shard_size). Pass
    `machine_queries` (from lurk_machine) to reuse an evaluated machine."""
    from ..lair.execute import ShardingConfig
    from .fri import FriConfig
    if machine_queries is None:
        machine_queries = lurk_machine(LURK_PROGRAM, FriConfig(1, 8, 2))[:2]
    machine, q = machine_queries
    pk, vk = machine.setup()
    cfg = None if shard_size is None else ShardingConfig(shard_size)
    return _proved(machine, pk, vk, q, device, cfg)
