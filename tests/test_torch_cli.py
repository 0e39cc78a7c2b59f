"""The Lurk REPL, its meta commands, the microchain server and the CLI of
lurk_tpu_torch against lurk_tpu's, at FriConfig(1, 2, 1).

- The same REPL lines print the same results in both packages, and
  `!(prove)` writes byte-identical proof files (the port's device prover on
  the CPU, lurk_tpu's host prover); each package verifies and inspects the
  other's file.
- A port microchain server takes a port client's chain: start, one proved
  transition, microchain-verify; the server's stored chain files decode
  with lurk_tpu's codec.
- Without CUDA, nothing proves unless the CPU is asked for: the REPL's
  `!(prove)`, `cli.run(["load", f, "--prove"])` and `python -m
  lurk_tpu_torch load f --prove` fail and write no proof.

One REPL per package serves the first two tests: a port proof on the CPU
costs tens of seconds.
"""

import functools
import os
import socketserver
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from lurk_tpu.cli import data as jdata
from lurk_tpu.cli.repl import Repl as JRepl
from lurk_tpu.stark.fri import FriConfig as JFriConfig
from lurk_tpu_torch import cli
from lurk_tpu_torch.cli import microchain as mc
from lurk_tpu_torch.cli.repl import Repl
from lurk_tpu_torch.stark.fri import FriConfig

# The suite runs in parallel worker processes; torch's default of one
# OpenMP thread per core oversubscribes the cores and stalls every worker.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LINES = ["!(def x (+ 1 2))", "(* x x)", "!(prove (* 6 7))"]
ACC = ("(letrec ((acc (lambda (total) (lambda (amount)"
       " (let ((total (+ total amount))) (cons total (commit (acc total))))))))"
       " (cons 0 (commit (acc 0))))")


@functools.lru_cache(maxsize=None)
def _repls():
    """(lurk_tpu's REPL, the port's REPL proving on the CPU)."""
    return (JRepl(config=JFriConfig(1, 2, 1)),
            Repl(config=FriConfig(1, 2, 1), device="cpu"))


def test_repl_proof_matches_lurk_tpu(tmp_path, monkeypatch, capsys):
    # tiny chips take the host path inside device_prove, as on the card
    monkeypatch.setenv("LURK_TPU_DEVICE_CHIP_MIN_ROWS", str(1 << 12))
    jrepl, repl = _repls()
    dirs = {"port": tmp_path / "port", "lurk_tpu": tmp_path / "lurk_tpu"}
    printed = {}
    for name, r in (("port", repl), ("lurk_tpu", jrepl)):
        monkeypatch.setenv("LURK_DIR", str(dirs[name]))
        capsys.readouterr()
        for line in LINES:
            key_z = r.process(line)
        printed[name] = capsys.readouterr().out
        key = r.zstore.fetch_string(key_z)
    assert "[2 iterations] => 9" in printed["port"]
    assert printed["port"] == printed["lurk_tpu"]
    proof = (dirs["port"] / "proofs" / key).read_bytes()
    assert proof == (dirs["lurk_tpu"] / "proofs" / key).read_bytes()

    inspected = {}
    for name, r, other in (("port", repl, "lurk_tpu"),
                           ("lurk_tpu", jrepl, "port")):
        monkeypatch.setenv("LURK_DIR", str(dirs[other]))
        assert r.process(f'!(verify "{key}")') == r.zstore.t
        capsys.readouterr()
        r.process(f'!(inspect "{key}")')
        inspected[name] = capsys.readouterr().out
    assert "Expr: (* 6 7)" in inspected["port"]
    assert inspected["port"] == inspected["lurk_tpu"]


def test_microchain_round_trip(tmp_path, monkeypatch):
    """Server and client share the port's REPL, as in test_microchain.py.
    The transition proves with the host prover (device=False) to keep the
    test cheap; the device prover's bytes are held by the test above."""
    monkeypatch.setenv("LURK_DIR", str(tmp_path))
    _, repl = _repls()
    monkeypatch.setattr(repl, "device", False)
    server_state = mc.MicrochainServer(repl)

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while (req := mc._recv(self.request)) is not None:
                mc._send(self.request, server_state.handle(req))

    srv = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        addr = f"127.0.0.1:{srv.server_address[1]}"
        repl.process(f"!(def s0 {ACC})")
        repl.process(f'!(def id !(microchain-start "{addr}" s0))')
        repl.process(f'!(defq s1 !(microchain-transition "{addr}" id s0 7))')
        assert repl.fmt(repl.process("(car s1)")) == "7"
        assert repl.process(f'!(microchain-verify "{addr}" id)') == \
            repl.zstore.t
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()

    (chain,) = (tmp_path / "microchains").iterdir()
    genesis = jdata.load_data(chain / "genesis")
    state = jdata.load_data(chain / "state")
    proofs = jdata.load_data(chain / "proofs")
    assert type(genesis).__name__ == type(state).__name__ == "ChainState"
    assert type(state).__module__ == "lurk_tpu.cli.microchain"
    assert [type(p).__name__ for p in proofs] == ["OpaqueChainProof"]


def test_cli_proves_only_on_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI would prove on it")
    monkeypatch.setenv("LURK_DIR", str(tmp_path))
    monkeypatch.delenv("LURK_TPU_PROVE", raising=False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Repl().process("!(prove (+ 1 2))")
    src = tmp_path / "sum.lurk"
    src.write_text("(+ 1 2)\n")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        cli.run(["load", str(src), "--prove"])
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "lurk_tpu_torch", "load",
                          str(src), "--prove"], capture_output=True,
                         text=True, cwd=ROOT, env=env, timeout=300)
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr
    assert "Proof key" not in out.stdout
    assert not list(tmp_path.glob("proofs/*"))
