"""CLI: REPL, meta commands, proof persistence, microchain server.

Entry points (reference: src/core/cli/mod.rs:29-152):
  python -m lurk_tpu_torch repl [--preload FILE]
  python -m lurk_tpu_torch load FILE [--prove] [--demo]
  python -m lurk_tpu_torch microchain ADDR

Every !(prove) runs on the CUDA card and fails without one; set
LURK_TPU_PROVE=host to prove on the CPU with the host prover.
"""

from __future__ import annotations

import argparse


def run(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m lurk_tpu_torch",
        description="Lurk CLI on PyTorch, proving on a CUDA card")
    sub = parser.add_subparsers(dest="command")

    p_repl = sub.add_parser("repl", help="Run the REPL")
    p_repl.add_argument("--preload", help="Lurk file to preload", default=None)
    p_repl.add_argument("--test-config", action="store_true",
                        help="use the fast (insecure) FRI test config")

    p_load = sub.add_parser("load", help="Load a Lurk file")
    p_load.add_argument("file")
    p_load.add_argument("--prove", action="store_true",
                        help="prove the file's last reduction")
    p_load.add_argument("--demo", action="store_true",
                        help="step through the file form by form")
    p_load.add_argument("--test-config", action="store_true",
                        help="use the fast (insecure) FRI test config")

    p_micro = sub.add_parser("microchain", help="Run the microchain server")
    p_micro.add_argument("addr", help="host:port to listen on")

    args = parser.parse_args(argv)

    from ..stark.fri import FriConfig
    test_config = FriConfig(log_blowup=1, num_queries=8, pow_bits=2)

    if args.command == "repl" or args.command is None:
        from .repl import Repl
        cfg = test_config if getattr(args, "test_config", False) else None
        repl = Repl(config=cfg)
        repl.start_background_warmup()
        if getattr(args, "preload", None):
            repl.load_file(args.preload)
        repl.run()
    elif args.command == "load":
        from .repl import Repl
        cfg = test_config if args.test_config else None
        repl = Repl(config=cfg)
        if args.prove:
            # overlap the kernel build with parsing + evaluation
            repl.start_background_warmup()
        repl.load_file(args.file, demo=args.demo)
        if args.prove:
            repl.prove_last_reduction()
    elif args.command == "microchain":
        from .repl import Repl
        from .microchain import serve
        repl = Repl()
        repl.start_background_warmup()
        serve(repl, args.addr)
    else:
        parser.print_help()
        return 1
    return 0
