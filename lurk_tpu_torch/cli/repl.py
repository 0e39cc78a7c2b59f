"""The Lurk REPL (reference: src/core/cli/repl.rs).

Holds {zstore, queries, toplevel, env, state, lang_symbols}; reduction runs
`lurk_main` through the Lair interpreter and prints `[N iterations] => result`
where N is the number of memoized `eval` queries. `prove_last_reduction`
produces a STARK proof, caches it under the hash3-derived key, and verifies
before reuse.

The REPL holds the device its proofs run on: None is the CUDA card (and
raises without one, unless LURK_TPU_PROVE=host asks for the host prover);
"cpu" runs the device prover on the CPU, as the tests do.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

from ..core.eval_direct import build_lurk_toplevel
from ..core.parser import parse, SynMeta
from ..core.state import State
from ..core.stark_machine import new_machine, PRODUCTION_CONFIG
from ..core.zstore import ZPtr
from ..lair.execute import QueryRecord, execute_by_name, EvalBail, LoopDetected
from ..stark.challenger import Challenger
from ..stark.fri import FriConfig
from . import data as cli_data
from .data import (CachedProof, CryptoProof, dump_data, load_data,
                   proofs_dir)


class ReplError(Exception):
    pass


class Repl:
    def __init__(self, lang=None, config: Optional[FriConfig] = None,
                 device=None):
        self.toplevel, self.zstore, self.lang_symbols = build_lurk_toplevel(lang)
        self.queries = QueryRecord(self.toplevel)
        self.env = self.zstore.intern_empty_env()
        self.state = State.init_lurk_state()
        self.config = config or PRODUCTION_CONFIG
        self.device = device
        # tri-state: None = auto (native C++ interpreter when built),
        # False = force python (set by !(debug) to collect call entries)
        self.use_native = None
        self._machine = None
        self._machine_lock = __import__("threading").Lock()
        self._machine_keys = None
        from .meta import build_meta_cmds
        self.meta_cmds = build_meta_cmds()

    # -- infrastructure ----------------------------------------------------

    def fmt(self, zptr: ZPtr) -> str:
        return self.zstore.fmt_with_state(self.state, zptr)

    def machine(self):
        with self._machine_lock:
            if self._machine is None:
                self._machine = new_machine(self.toplevel, self.config)
            return self._machine

    def start_background_warmup(self):
        """Prepare this config's verifier on a daemon thread and, on a
        CUDA card, build the kernels' libraries (Poseidon2, the quotient
        and the open kernels), so that neither a first !(verify) nor a
        first !(prove) waits for them. The reference's !(prove) starts
        proving immediately
        (src/core/cli/repl.rs:164-207). A failure here changes no path:
        the prove that needs what failed raises it again."""
        import os as _os
        if _os.environ.get("LURK_TPU_WARMUP", "1") == "0":
            return
        import threading

        def _run():
            try:
                self.machine().prepare_verifier()
                import torch
                if torch.cuda.is_available():
                    from ..poseidon import cuda_kernel
                    from ..stark import open_kernel, quotient_kernel
                    cuda_kernel.build()
                    quotient_kernel.build()
                    open_kernel.build()
            except Exception:
                pass  # warmup is best-effort, never user-visible

        threading.Thread(target=_run, daemon=True,
                         name="lurk-warm-init").start()

    def machine_keys(self):
        if self._machine_keys is None:
            # disk-cached setup: a fresh process's first !(prove) skips the
            # 20-50s pcs.commit of the preprocessed round (the reference
            # re-runs setup per process - repl.rs:164-207 - so this beats
            # it rather than matching it)
            from ..stark.key_cache import setup_cached
            self._machine_keys = setup_cached(self.machine())
        return self._machine_keys

    def bind(self, sym: ZPtr, val: ZPtr):
        self.env = self.zstore.intern_env(sym, val, self.env)

    def memoize_dag(self, zptr: ZPtr):
        hash4_idx = self.toplevel.func_index["hash4"]
        hash5_idx = self.toplevel.func_index["hash5"]
        self.zstore.memoize_dag(zptr.tag, zptr.digest,
                                self.queries.inv_func_queries[hash4_idx],
                                self.queries.inv_func_queries[hash5_idx])

    def memoize_env_dag(self):
        self.memoize_dag(self.env)

    def prepare_queries(self):
        self.queries.clean()
        self.queries.inject_inv_queries("hash3", self.zstore.hashes3_diff.items())
        self.queries.inject_inv_queries("hash4", self.zstore.hashes4_diff.items())
        self.queries.inject_inv_queries("hash5", self.zstore.hashes5_diff.items())
        self.zstore.hashes3_diff.clear()
        self.zstore.hashes4_diff.clear()
        self.zstore.hashes5_diff.clear()

    # -- reduction ---------------------------------------------------------

    def reduce_with_env(self, expr: ZPtr, env: ZPtr) -> ZPtr:
        from ..core.eval_api import execute_main
        self.prepare_queries()
        args = ((expr.tag,) + (0,) * 7 + tuple(expr.digest)
                + tuple(env.digest))
        dbg = self.toplevel.func_index["eval"]
        out = execute_main(self.toplevel, "lurk_main", list(args),
                           self.queries, use_native=self.use_native,
                           dbg_func_idx=dbg)
        return ZPtr(int(out[0]), tuple(int(x) for x in out[8:16]))

    def reduce_aux_with_env(self, expr: ZPtr, env: ZPtr):
        result = self.reduce_with_env(expr, env)
        self.memoize_dag(result)
        return result, self.num_iterations()

    def reduce_aux(self, expr: ZPtr):
        return self.reduce_aux_with_env(expr, self.env)

    def manual_egression(self, tag: int, ptr: int) -> ZPtr:
        """Egress a VM-internal (tag, ptr) pair into a ZPtr using a scratch
        copy of the query record (reference: src/core/cli/repl.rs:432-458)."""
        return self.manual_egression_many([(tag, ptr)])[0]

    def manual_egression_many(self, pairs) -> list:
        """Egress many (tag, ptr) pairs against ONE scratch query-record
        copy (the deepcopy dominates; per-value copies made assert-emitted
        O(values x record size))."""
        import copy
        queries_tmp = copy.deepcopy(self.queries)
        # a native reduction leaves columnar query maps; the python
        # interpreter continues from them only in IndexMap form
        queries_tmp.func_queries = [
            m.to_index_map() if hasattr(m, "to_index_map") else m
            for m in queries_tmp.func_queries]
        hash4_idx = self.toplevel.func_index["hash4"]
        hash5_idx = self.toplevel.func_index["hash5"]
        out_zptrs = []
        for tag, ptr in pairs:
            out = execute_by_name(self.toplevel, "egress", [int(tag),
                                                            int(ptr)],
                                  queries_tmp)
            zptr = ZPtr(int(out[0]), tuple(int(x) for x in out[1:9]))
            self.zstore.memoize_dag(zptr.tag, zptr.digest,
                                    queries_tmp.inv_func_queries[hash4_idx],
                                    queries_tmp.inv_func_queries[hash5_idx])
            out_zptrs.append(zptr)
        return out_zptrs

    def num_iterations(self) -> int:
        return len(self.queries.func_queries[self.toplevel.func_index["eval"]])

    def handle_non_meta_with_env(self, expr: ZPtr, env: ZPtr) -> ZPtr:
        result = self.reduce_with_env(expr, env)
        self.memoize_dag(result)
        n = self.num_iterations()
        suffix = "" if n == 1 else "s"
        print(f"[{n} iteration{suffix}] => {self.fmt(result)}")
        return result

    def handle_non_meta(self, expr: ZPtr) -> ZPtr:
        return self.handle_non_meta_with_env(expr, self.env)

    # -- proving -----------------------------------------------------------

    def proof_key(self) -> str:
        pv = self.queries.expect_public_values()
        digest = self.zstore.hash3(tuple(pv[:24]))
        return "".join(f"{x:08x}" for x in digest)

    def prove_last_reduction(self) -> str:
        pv = self.queries.public_values
        if pv is None:
            raise ReplError("No reduction to prove")
        proof_key = self.proof_key()
        proof_path = proofs_dir() / proof_key
        machine = self.machine()
        pk, vk = self.machine_keys()
        must_prove = True
        if proof_path.exists():
            try:
                cached = load_data(proof_path)
                mp = cached.into_machine_proof()
                if machine.verify(vk, mp, Challenger()):
                    must_prove = False
            except Exception:
                pass  # overwrite corrupted proofs
        if must_prove:
            proof = machine.prove(pk, self.queries, Challenger(),
                                  device=self.device)
            assert machine.verify(vk, proof, Challenger()), \
                "internal verification failed"
            crypto_proof = CryptoProof.from_machine_proof(proof)
            cached = CachedProof.new(crypto_proof, pv, self.zstore)
            dump_data(cached, proof_path)
        print(f'Proof key: "{proof_key}"')
        return proof_key

    # -- input processing --------------------------------------------------

    def process(self, code: str, path: Path = Path(".")) -> Optional[ZPtr]:
        """Process every form in `code` in order; returns the last form's
        result (trailing forms used to be silently dropped)."""
        result = None
        while code.strip():
            syn, code = parse(code, self.state)
            if syn is None:
                break
            result = self._process_syntax(syn, path)
        return result

    def intern_syntax(self, syn, path: Path) -> ZPtr:
        """Reference-parity syntax interning: meta forms nested inside an
        expression RUN their command and splice the returned value, e.g.
        `!(defq s1 !(transition s0 :foo))` (reference repl.rs:524-534)."""
        from ..core.parser import SynList, SynImproper, SynQuote
        if isinstance(syn, SynMeta):
            name = syn.sym.name()
            cmd = self.meta_cmds.get(name)
            if cmd is None:
                raise ReplError(f"Unknown meta command: {name}")
            args = self.zstore.intern_list(
                [self.intern_syntax(a, path) for a in syn.args])
            result = cmd.run(self, args, path)
            if result is None:
                raise ReplError(
                    f"Meta command {name} returned no value in expression "
                    "position")
            return result
        if isinstance(syn, SynList):
            return self.zstore.intern_list(
                [self.intern_syntax(x, path) for x in syn.items])
        if isinstance(syn, SynImproper):
            return self.zstore.intern_list(
                [self.intern_syntax(x, path) for x in syn.items],
                self.intern_syntax(syn.tail, path))
        if isinstance(syn, SynQuote):
            return self.zstore.intern_list(
                [self.zstore.quote, self.intern_syntax(syn.inner, path)])
        return self.zstore.intern_syntax(syn)

    def _process_syntax(self, syn, path: Path):
        if isinstance(syn, SynMeta):
            name = syn.sym.name()
            cmd = self.meta_cmds.get(name)
            if cmd is None:
                raise ReplError(f"Unknown meta command: {name}")
            args = self.zstore.intern_list(
                [self.intern_syntax(a, path) for a in syn.args])
            return cmd.run(self, args, path)
        expr = self.intern_syntax(syn, path)
        return self.handle_non_meta(expr)

    def load_file(self, path, demo: bool = False):
        path = Path(path)
        code = path.read_text()
        print(f"Loading {path}")
        state = self.state
        while True:
            syn, rest = parse(code, state)
            if syn is None:
                break
            if demo:
                # step-through mode (reference cli/mod.rs demo): show the
                # form about to run, wait for Enter
                src = code[:len(code) - len(rest)].strip()
                print(f"> {src}")
                try:
                    input()
                except EOFError:
                    pass
            code = rest
            self._process_syntax(syn, path.parent)

    def _init_line_editor(self):
        """Wire GNU readline: arrow keys / line editing, persistent history
        at repl_history_path(), and vi editing mode when $EDITOR looks
        vi-like (reference: src/core/cli/repl.rs:642-650 - rustyline with
        vi mode + ~/.lurk/repl-history). Returns a save callback (no-op
        when readline is unavailable, e.g. non-tty embedders)."""
        try:
            import readline
        except ImportError:
            return lambda: None
        import os
        editor = os.environ.get("EDITOR", "")
        if any(v in editor for v in ("vi", "vim", "nvim")):
            readline.parse_and_bind("set editing-mode vi")
        hist = cli_data.repl_history_path()
        try:
            hist.parent.mkdir(parents=True, exist_ok=True)
            if hist.exists():
                readline.read_history_file(str(hist))
        except OSError:
            pass
        readline.set_history_length(10000)

        def save():
            try:
                readline.write_history_file(str(hist))
            except OSError:
                pass

        return save

    def run(self):
        """Interactive loop."""
        print("Lurk TPU REPL - :q or Ctrl-D to exit")
        save_history = self._init_line_editor()
        buffer = ""
        while True:
            try:
                prompt = "> " if not buffer else "  "
                line = input(prompt)
            except EOFError:
                print()
                break
            if line.strip() in (":q", ":quit"):
                break
            if line.strip() and not buffer:
                save_history()  # survive crashes/kills, like rustyline
            buffer += line + "\n"
            if not _balanced(buffer):
                continue
            try:
                while buffer.strip():
                    syn, buffer = parse(buffer, self.state)
                    if syn is None:
                        break
                    result = self._process_syntax(syn, Path("."))
                    if result is not None and not isinstance(result, ZPtr):
                        pass
            except Exception as e:  # noqa: BLE001 - the REPL must survive
                # any user-triggered error (MetaError, ParseErr, missing
                # files, server errors, RecursionError, ...): report and
                # return to the prompt, like the reference's rustyline loop
                print(f"Error: {e}")
            buffer = ""
        save_history()


def _balanced(code: str) -> bool:
    """Paren/string balance for multi-line REPL continuation. Comments
    run to end of line (the parser ignores them, so parens/quotes inside
    must not count), and escape handling skips the escaped character so a
    string ending in a literal backslash ("a\\\\") still closes."""
    depth = 0
    in_str = False
    i = 0
    n = len(code)
    while i < n:
        c = code[i]
        if in_str:
            if c == "\\":
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == ";":
            while i < n and code[i] != "\n":
                i += 1
        elif c == "(":
            depth += 1
        elif c == ")":
            depth -= 1
        i += 1
    return depth <= 0 and not in_str
