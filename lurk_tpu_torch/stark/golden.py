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

The REPL goldens: DEMO_PROOF_SHA256 holds the sha256 of the proof files
that the REPL writes for the demo corpus (one REPL at the CLI's default
config, `!(clear)` before each of DEMO_FILES in order), and
CLI_PROOF_SHA256 that of `python -m lurk_tpu_torch load <file> --prove` on
CLI_PROGRAM, a program past 2^22 padded cells. Both are lurk_tpu's host
proofs, computed by scripts/repl_goldens.py; chip_smoke.py holds the card
to them.

The compiled goldens (COMPILED_*) are the same statements evaluated by the
compiled pipeline (core/eval_compiled.py) and proved on its 43-chip
machine: lurk_tpu's host proofs, computed by scripts/compiled_goldens.py
(lurk_machine(..., compiled=True) builds the machine).

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


DEMO_FILES = ("simple", "functional-commitment",
              "chained-functional-commitment", "bank", "mastermind",
              "mini-mastermind", "protocol", "microbank")
# demo file -> {proof key: sha256 of the proof file}; microbank.lurk draws
# !(rand), so its proof differs from run to run and has no golden
DEMO_PROOF_SHA256 = {
    "simple": {
        "573853d53bcac3486aeb6542699a48ea02430dea45fe85002746158a29618520":
            "e6775a0504572d0e08cd818fa3a9fb5eebb4abd5794758f27f57cd8836b1cc58",
    },
    "functional-commitment": {
        "32aea5b833eca7b01668fabf057fa5433045310d667da67c0b0cb0fc5050fa65":
            "38a885ffdf72e4c3e8904bf69a7acad7fbd2366eb941083c5cc6ec7baecb1508",
    },
    "chained-functional-commitment": {
        "4c3477a234d783611c216e7954f2dcde3dfff2965e6c2a514da70cfc3ab8c9f9":
            "cd0f47e9f00a5d2276a2a9cb7545aec270a3ba88b025632d4d10885f83b94956",
    },
    "bank": {
        "044237c940d2a8ce52980e8d1852476335ba9e343e6765e34253b38f6bdfc9dc":
            "0d8a6e29a6ecef9c284b6ae259616fb656cdc8f2facca3c0c6aa0eb6924a4291",
        "559e48f96e6836a46c68258d157bfece1d69f3713e76bfb5535458e71d70f3ed":
            "f4950ecd48282e9bc2cddeea0fc81b399716bc74f9ff560332f3a3f01e52cc28",
    },
    "mastermind": {
        "3724c52e13c3dd0b5a55182c64d573374bde186f269b88b15fab5594673fb0a0":
            "3cab06877779cf4875e0e1c9a6017faaaac09b6f529d2728cdf86abf172e95cd",
    },
    "mini-mastermind": {
        "0bf967f20dc6c5cd040f75e55bd297923d79cd6d5e140a9f720a4b5e55872722":
            "6084ad78a383ddf8651ed1795b4b95733ecb99a657ed9816393de757992bfe1c",
    },
}
# Lurk fib(1000): 4,648,968 padded main cells in one shard (python -m
# lurk_tpu_torch.plan_stats --n 1000 --shard-size 4194304), past the 2^22
# cells under which lurk_tpu's machine.prove picks its host prover
CLI_PROGRAM = ("(letrec ((fib (lambda (n) (if (<= n 1) n "
               "(+ (fib (- n 1)) (fib (- (- n 1) 1))))))) (fib 1000))\n")
CLI_PROOF_KEY = \
    "5269dde90450741d6d3da95e0dc9cf0b679f47722125f51462b5aadf5ffa3a2e"
CLI_PROOF_SHA256 = \
    "b35006b09d90a4db4de6eec6c12ba84215171138b705490145a8183a81597f05"

# The compiled pipeline (core/eval_compiled.py, 43 chips): lurk_tpu's host
# proofs of LURK_PROGRAM at FriConfig(1, 8, 2) in one shard (1,008,421
# padded main cells) and in two at ShardingConfig(LURK_2SHARD_SIZE), and
# of CLI_PROGRAM at PRODUCTION_CONFIG in one shard (3,163,088 cells),
# from scripts/compiled_goldens.py
COMPILED_LURK_SHA256 = \
    "475a379f4ba17b0a808e6a9122117f788dff4b1b165392252b7c5699c672e2ba"
COMPILED_LURK_2SHARD_SHA256 = \
    "e362ea16d5d40e6f238098d11528c84967b613e0132c27d40428968b4d87fda7"
COMPILED_CLI_SHA256 = \
    "594a128e1b45d62cdc356e4fc9c5a393c654f8a2070a0b2c9bb392eb83922727"


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


def _ackermann_func():
    """Ackermann(m, n) as one Lair function (lurk_tpu's tests build it the
    same way, tests/test_lair_air.py)."""
    from ..lair.dsl import FuncBuilder
    b = FuncBuilder("ackermann", ["m", "n"], 1)
    m, n = b.input("m"), b.input("n")
    one = b.const(1)

    def m0(bb):
        bb.ret(bb.add(n, one))

    def m_default(bb):
        m_minus_one = bb.sub(m, one)

        def n0(b2):
            b2.ret(b2.call("ackermann", m_minus_one, one)[0])

        def n_default(b2):
            inner = b2.call("ackermann", m, b2.sub(n, one))[0]
            b2.ret(b2.call("ackermann", m_minus_one, inner)[0])

        bb.match(n, [(0, n0)], default=n_default)

    b.match(m, [(0, m0)], default=m_default)
    return b.build()


def ackermann_machine(m: int, n: int, config):
    """(machine, queries) for Ackermann(m, n): one func chip whose shards
    stitch many lookups (a multi-shard proof at a small max_shard_size)."""
    from ..lair.chips import build_lair_chip_vector
    from ..lair.execute import QueryRecord, execute_by_name
    from ..lair.toplevel import Toplevel
    from ..lair.trace import FuncChip
    from .machine import StarkMachine
    tl = Toplevel([_ackermann_func()])
    q = QueryRecord(tl)
    execute_by_name(tl, "ackermann", [m, n], q)
    chips = build_lair_chip_vector(FuncChip.from_name("ackermann", tl))
    return StarkMachine(chips, len(q.expect_public_values()), config), q


def _proved(machine, pk, vk, queries, device, shard_config=None):
    from ..utils import codec
    from .challenger import Challenger
    proof = machine.prove(pk, queries, Challenger(), shard_config,
                          device=True if device is None else device)
    return machine, vk, proof, hashlib.sha256(codec.encode(proof)).hexdigest()


def fib_proof(device=None):
    """(machine, vk, proof, sha256 hex) of the golden statement proved on
    the device prover."""
    from .fri import FriConfig
    machine, q = fib_machine(GOLDEN_N, FriConfig(1, 8, 2))
    pk, vk = machine.setup()
    return _proved(machine, pk, vk, q, device)


def lurk_machine(code: str, config, compiled: bool = False):
    """(machine, queries, printed result) of a Lurk program evaluated by
    the native interpreter, on the full Lurk machine at `config`: the
    direct pipeline's (47 chips) or, with compiled=True, the compiled
    pipeline's (43 chips)."""
    from ..core import eval_compiled, eval_direct
    from ..core.eval_api import evaluate
    from ..core.stark_machine import new_machine
    pipeline = eval_compiled if compiled else eval_direct
    toplevel, zstore, _ = pipeline.build_lurk_toplevel()
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
