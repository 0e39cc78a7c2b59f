"""Write a Lurk toplevel's AIR and verifying key as data for prove_bench's
plain verifier, as a package that builds the toplevel makes them.

    python3 -m prove_bench.tools.export_air <pipeline> <package>

writes prove_bench/configs/air_<pipeline>.json.gz and
prove_bench/configs/vk_<pipeline>.json. The AIR holds, for each chip of
the machine, in order, its name, whether it lives in the first shard only,
its main and preprocessed widths, its constraints and its LogUp
interactions as nodes of one expression DAG (["c", v], ["col", matrix,
rot, idx], ["pub", idx], ["sel", kind], ["+" | "-" | "*", a, b], children
before parents). The key holds the preprocessed round's chips, widths,
trace heights and Merkle roots. The package is named by the caller and
imported by name; the benchmark itself only reads the files.
"""

from __future__ import annotations

import gzip
import importlib
import json
import sys
from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "configs"


def chip_air(builder, ops) -> dict:
    """One chip's constraints and interactions over a DAG in postorder."""
    nodes, index = [], {}

    def node(e) -> int:
        stack = [(e, False)]
        while stack:
            x, ready = stack.pop()
            if id(x) in index:
                continue
            kind = type(x).__name__
            if kind in ("Add", "Sub", "Mul"):
                if not ready:
                    stack += [(x, True), (x.b, False), (x.a, False)]
                    continue
                item = [ops[kind], index[id(x.a)], index[id(x.b)]]
            elif kind == "Const":
                item = ["c", int(x.val)]
            elif kind == "Col":
                item = ["col", x.matrix, int(x.rot), int(x.idx)]
            elif kind == "Pub":
                item = ["pub", int(x.idx)]
            elif kind == "Sel":
                item = ["sel", x.kind]
            else:
                raise TypeError(kind)
            index[id(x)] = len(nodes)
            nodes.append(item)
        return index[id(e)]

    cons = [node(c) for c in builder.constraints]
    inters = [[i.kind, [node(v) for v in i.values], node(i.mult)]
              for i in builder.interactions]
    return {"main_width": int(builder.main_width),
            "prep_width": int(builder.preprocessed_width),
            "nodes": nodes, "constraints": cons, "interactions": inters}


def _machine(pipeline: str, package: str):
    core = importlib.import_module(f"{package}.core.eval_{pipeline}")
    machine_mod = importlib.import_module(f"{package}.core.stark_machine")
    toplevel, _, _ = core.build_lurk_toplevel()
    return machine_mod.new_machine(toplevel)


def export(pipeline: str, package: str) -> dict:
    """The AIR of `package`'s `pipeline` toplevel."""
    machine = _machine(pipeline, package)
    ops = {"Add": "+", "Sub": "-", "Mul": "*"}

    class Later:                     # a shard other than the first
        index = 1

    def first_only(c) -> bool:
        included = getattr(c, "included", None)
        return included is not None and not included(Later())

    return {"source": f"{package}.core.eval_{pipeline}.build_lurk_toplevel",
            "num_public_values": int(machine.num_public_values),
            "chips": [dict(name=c.name, shard0_only=first_only(c),
                           **chip_air(machine.builder_for(c), ops))
                      for c in machine.chips]}


def export_vk(pipeline: str, package: str) -> dict:
    """The verifying key of `package`'s `pipeline` toplevel, from its own
    setup."""
    _, vk = _machine(pipeline, package).setup()
    return {"source": f"{package}.core.eval_{pipeline}.build_lurk_toplevel, "
                      "StarkMachine.setup",
            "prep_chip_names": list(vk.prep_chip_names),
            "prep_widths": [int(w) for w in vk.prep_widths],
            "prep_log_heights": [int(h) for h in vk.prep_log_heights],
            "prep_roots": [[int(x) for x in r] for r in vk.prep_roots]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python3 -m prove_bench.tools.export_air <pipeline> "
              "<package>", file=sys.stderr)
        return 2
    pipeline, package = argv
    air = OUT / f"air_{pipeline}.json.gz"
    with open(air, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb",
                                               mtime=0) as f:
        f.write(json.dumps(export(pipeline, package),
                           separators=(",", ":")).encode())
    vk = OUT / f"vk_{pipeline}.json"
    vk.write_text(json.dumps(export_vk(pipeline, package), indent=1) + "\n")
    print(f"{air}, {vk}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
