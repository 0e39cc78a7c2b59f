#!/usr/bin/env python3
"""Compute the REPL goldens of lurk_tpu_torch/stark/golden.py with
lurk_tpu's REPL and CLI on the CPU (host prover).

    JAX_PLATFORMS=cpu python scripts/repl_goldens.py

- The demo corpus: one REPL at the CLI's default config (PRODUCTION_CONFIG,
  FriConfig(1, 100, 16)), `!(clear)` before each of golden.DEMO_FILES in
  order, then the sha256 of every proof file each file writes, by proof
  key. Run twice, in two temporary LURK_DIRs: a file whose proofs differ
  between the runs (microbank.lurk draws `!(rand)`) gets no golden.
- The CLI: `python -m lurk_tpu load <file> --prove` on golden.CLI_PROGRAM,
  and the sha256 of the proof file it writes.

Prints DEMO_PROOF_SHA256, CLI_PROOF_KEY and CLI_PROOF_SHA256 as Python.
Takes about three minutes on 8 cores.
"""

import hashlib
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lurk_tpu_torch.stark import golden  # noqa: E402  (imports no torch)


def _sha(path: Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


def corpus_digests() -> dict:
    """{demo file: {proof key: sha256}} from one lurk_tpu REPL."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    from lurk_tpu.cli.repl import Repl
    out = {}
    with tempfile.TemporaryDirectory() as lurk_dir:
        os.environ["LURK_DIR"] = lurk_dir
        proofs = Path(lurk_dir) / "proofs"
        repl = Repl()
        for name in golden.DEMO_FILES:
            before = set(proofs.glob("*"))
            repl.process("!(clear)")
            repl.load_file(ROOT / "demo" / f"{name}.lurk")
            out[name] = {p.name: _sha(p)
                         for p in sorted(set(proofs.glob("*")) - before)}
    return out


def cli_digest() -> tuple:
    with tempfile.TemporaryDirectory() as lurk_dir:
        src = Path(lurk_dir) / "program.lurk"
        src.write_text(golden.CLI_PROGRAM)
        env = dict(os.environ, LURK_DIR=lurk_dir, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT))
        res = subprocess.run([sys.executable, "-m", "lurk_tpu", "load",
                              str(src), "--prove"], cwd=ROOT, env=env,
                             capture_output=True, text=True, check=True)
        key = re.search(r'Proof key: "([0-9a-f]+)"', res.stdout).group(1)
        return key, _sha(Path(lurk_dir) / "proofs" / key)


def main() -> int:
    runs = [corpus_digests(), corpus_digests()]
    demo = {name: digests for name, digests in runs[0].items()
            if digests and digests == runs[1][name]}
    print("DEMO_PROOF_SHA256 = {")
    for name, digests in demo.items():
        print(f"    {name!r}: {{")
        for key, sha in digests.items():
            print(f"        {key!r}:\n            {sha!r},")
        print("    },")
    print("}")
    key, sha = cli_digest()
    print(f"CLI_PROOF_KEY = {key!r}")
    print(f"CLI_PROOF_SHA256 = {sha!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
