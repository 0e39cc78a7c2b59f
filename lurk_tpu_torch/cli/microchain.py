"""Microchain server + client (reference: src/core/cli/microchain.rs).

A TCP service maintaining verifiable state-transition chains. Each chain id
is a hiding commitment to the genesis state (random secret). A transition
submits a ChainProof: a STARK proving that `(apply <callable> <args>)` in the
empty env reduces to `(next_result . next_callable)`; the server verifies the
proof (and the verifier version), persists an OpaqueChainProof, and advances
the state.

Wire format: 4-byte big-endian length + data-only codec payload (see
utils/codec.py). Never unpickle untrusted bytes: the reference uses bincode
for the same reason (ADVICE.md round-1 high finding).
"""

from __future__ import annotations

import socket
import socketserver
import struct
from dataclasses import dataclass
from pathlib import Path

from ..core.tag import Tag
from ..utils import codec
from ..core.zstore import ZPtr, DIGEST_SIZE
from ..stark.challenger import Challenger
from .data import CommData, LurkData, ZDag, dump_data, load_data, microchains_dir


@codec.register
@dataclass
class ChainState:
    chain_result: LurkData
    callable_data: LurkData

    def into_zptr(self, zstore) -> ZPtr:
        result = self.chain_result.interned(zstore)
        callable_ = self.callable_data.interned(zstore)
        return zstore.intern_cons(result, callable_)


@codec.register
@dataclass
class ChainProof:
    crypto_proof: object
    call_args: LurkData
    next_chain_result: LurkData
    next_callable: LurkData


@codec.register
@dataclass
class OpaqueChainProof:
    crypto_proof: object
    call_args: ZPtr
    next_chain_result: ZPtr
    next_callable: ZPtr


def _send(sock, obj):
    payload = codec.encode(obj)
    sock.sendall(struct.pack(">I", len(payload)) + payload)


MAX_MESSAGE_BYTES = 1 << 30


def _recv(sock):
    header = _read_exact(sock, 4)
    if header is None:
        return None
    (length,) = struct.unpack(">I", header)
    if length > MAX_MESSAGE_BYTES:
        return None
    payload = _read_exact(sock, length)
    if payload is None:
        return None
    try:
        return codec.decode(payload)
    except codec.CodecError:
        return None


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


class MicrochainServer:
    """In-process server state; wrap with `serve` for TCP."""

    def __init__(self, repl):
        # reuse the Repl's toplevel/zstore/machine for verification
        self.repl = repl
        self.dir = microchains_dir()
        # the first Transition request should not pay the verifier's
        # per-process prep (AIR builds + constraint-VM linearization)
        repl.machine().prepare_verifier(background=True)

    # -- persistence -------------------------------------------------------

    def _chain_dir(self, id_hex: str) -> Path:
        return self.dir / id_hex

    def _load(self, id_hex: str, name: str):
        p = self._chain_dir(id_hex) / name
        return load_data(p) if p.exists() else None

    def _dump(self, id_hex: str, name: str, obj):
        dump_data(obj, self._chain_dir(id_hex) / name)

    # -- request handling --------------------------------------------------

    def handle(self, req: dict) -> dict:
        if not isinstance(req, dict):
            return {"kind": "error", "error": "malformed request"}
        kind = req.get("kind")
        try:
            if kind == "start":
                return self._start(req["state"])
            if kind == "get_genesis":
                return self._get(req["id"], "genesis", "NoDataForId")
            if kind == "get_state":
                return self._get(req["id"], "state", "NoDataForId")
            if kind == "get_proofs":
                proofs = self._load(_hex(req["id"]), "proofs") or []
                return {"kind": "proofs", "proofs": proofs}
            if kind == "transition":
                return self._transition(req["id"], req["proof"])
            return {"kind": "error", "error": f"unknown request {kind}"}
        except Exception as e:  # noqa: BLE001 - protocol errors reported
            return {"kind": "error", "error": str(e)}

    def _start(self, state: ChainState) -> dict:
        zstore = self.repl.zstore
        state_zptr = state.into_zptr(zstore)
        if state_zptr.tag != Tag.Cons:
            return {"kind": "error", "error": "genesis state must be a pair"}
        from .data import random_field_digest
        secret = random_field_digest()
        id_digest = CommData.hash(secret, state_zptr, zstore)
        id_hex = _hex(id_digest)
        if (self._chain_dir(id_hex) / "genesis").exists():
            return {"kind": "error", "error": "chain already exists"}
        self._dump(id_hex, "genesis", state)
        self._dump(id_hex, "state", state)
        self._dump(id_hex, "proofs", [])
        return {"kind": "id_secret", "id": id_digest, "secret": secret}

    def _get(self, id_digest, name, err):
        obj = self._load(_hex(id_digest), name)
        if obj is None:
            return {"kind": "error", "error": err}
        return {"kind": "state", "state": obj}

    def _transition(self, id_digest, proof: ChainProof) -> dict:
        repl = self.repl
        zstore = repl.zstore
        id_hex = _hex(id_digest)
        state = self._load(id_hex, "state")
        if state is None:
            return {"kind": "error", "error": "NoDataForId"}
        # flaw checks
        for ld in (proof.call_args, proof.next_chain_result,
                   proof.next_callable):
            if ld.is_flawed(zstore):
                return {"kind": "error", "error": "flawed ZDag data"}
        callable_zptr = state.callable_data.interned(zstore)
        call_args = proof.call_args.interned(zstore)
        next_result = proof.next_chain_result.interned(zstore)
        next_callable = proof.next_callable.interned(zstore)
        # the proven claim: (apply <callable> <args>) in the empty env
        expr = zstore.intern_cons(callable_zptr, call_args)
        env = zstore.intern_empty_env()
        result = zstore.intern_cons(next_result, next_callable)
        crypto_proof = proof.crypto_proof
        if not crypto_proof.has_same_verifier_version():
            return {"kind": "error", "error": "verifier version mismatch"}
        machine = repl.machine()
        _, vk = repl.machine_keys()
        mp = crypto_proof.into_machine_proof(expr, env, result)
        if not machine.verify(vk, mp, Challenger()):
            return {"kind": "error", "error": "ProofVerificationFailed"}
        # accept: persist opaque proof + new state
        proofs = self._load(id_hex, "proofs") or []
        proofs.append(OpaqueChainProof(crypto_proof, call_args, next_result,
                                       next_callable))
        self._dump(id_hex, "proofs", proofs)
        new_state = ChainState(LurkData.new(next_result, zstore),
                               LurkData.new(next_callable, zstore))
        self._dump(id_hex, "state", new_state)
        return {"kind": "proof_accepted"}


def _hex(digest) -> str:
    return "".join(f"{int(x):08x}" for x in digest)


def serve(repl, addr: str):
    """Run the TCP server until interrupted."""
    host, port = addr.rsplit(":", 1)
    server_state = MicrochainServer(repl)

    class Handler(socketserver.BaseRequestHandler):
        def handle(self):
            while True:
                req = _recv(self.request)
                if req is None:
                    return
                _send(self.request, server_state.handle(req))

    class Server(socketserver.ThreadingTCPServer):
        # per-connection handler threads block in _recv until the client
        # hangs up; non-daemon threads (the socketserver default) would
        # pin process shutdown on every client that keeps its connection
        # open (reference server handles one request per accept and never
        # outlives a connection - microchain.rs:121-140)
        daemon_threads = True
        allow_reuse_address = True

    with Server((host, int(port)), Handler) as srv:
        print(f"Microchain server listening on {addr}")
        srv.serve_forever()


# ---------------------------------------------------------------------------
# client side (used by the microchain-* meta commands)
# ---------------------------------------------------------------------------

def _request(addr: str, req: dict) -> dict:
    host, port = addr.rsplit(":", 1)
    with socket.create_connection((host, int(port))) as sock:
        _send(sock, req)
        resp = _recv(sock)
    if resp is None:
        raise RuntimeError("connection closed by server")
    if resp.get("kind") == "error":
        raise RuntimeError(f"server error: {resp['error']}")
    return resp


def client_start(repl, addr: str, state_zptr: ZPtr):
    zstore = repl.zstore
    assert state_zptr.tag == Tag.Cons, "state must be a pair"
    result, callable_ = zstore.fetch_tuple11(state_zptr)
    state = ChainState(LurkData.new(result, zstore),
                       LurkData.new(callable_, zstore))
    resp = _request(addr, {"kind": "start", "state": state})
    return tuple(resp["id"])


def client_get_genesis(repl, addr: str, id_digest):
    resp = _request(addr, {"kind": "get_genesis", "id": tuple(id_digest)})
    return resp["state"].into_zptr(repl.zstore)


def client_get_state(repl, addr: str, id_digest):
    resp = _request(addr, {"kind": "get_state", "id": tuple(id_digest)})
    return resp["state"].into_zptr(repl.zstore)


def client_transition(repl, addr: str, id_digest, state_and_args: ZPtr):
    """Prove one chain transition locally and submit it."""
    from .meta import _transition_call, MetaError

    zstore = repl.zstore
    state_expr, call_args_exprs = zstore.fetch_tuple11(state_and_args)
    cons, call_args = _transition_call(repl, state_expr, call_args_exprs)
    if cons.tag != Tag.Cons:
        raise MetaError("transition result must be a pair")
    repl.memoize_dag(cons)
    next_result, next_callable = zstore.fetch_tuple11(cons)
    proof_key = repl.prove_last_reduction()
    from .data import proofs_dir
    cached = load_data(proofs_dir() / proof_key)
    proof = ChainProof(
        crypto_proof=cached.crypto_proof,
        call_args=LurkData.new(call_args, zstore),
        next_chain_result=LurkData.new(next_result, zstore),
        next_callable=LurkData.new(next_callable, zstore),
    )
    _request(addr, {"kind": "transition", "id": tuple(id_digest),
                    "proof": proof})
    return cons


def client_verify(repl, addr: str, id_digest):
    """Fetch and locally re-verify a chain's full transition history."""
    zstore = repl.zstore
    genesis = _request(addr, {"kind": "get_genesis",
                              "id": tuple(id_digest)})["state"]
    proofs = _request(addr, {"kind": "get_proofs",
                             "id": tuple(id_digest)})["proofs"]
    state_zptr = genesis.into_zptr(zstore)
    _result, callable_zptr = zstore.fetch_tuple11(state_zptr)
    machine = repl.machine()
    _, vk = repl.machine_keys()
    env = zstore.intern_empty_env()
    for i, op in enumerate(proofs):
        expr = zstore.intern_cons(callable_zptr, op.call_args)
        result = zstore.intern_cons(op.next_chain_result, op.next_callable)
        mp = op.crypto_proof.into_machine_proof(expr, env, result)
        if not machine.verify(vk, mp, Challenger()):
            raise RuntimeError(f"transition {i} failed verification")
        callable_zptr = op.next_callable
    print(f"✓ {len(proofs)} transition proofs verified")
