"""The program's input for a seed: one general generator, driven by the
parameters in a workload's `draw` and the configuration's upstream
`inputs`.

A workload's draw names, for each input, how a seed varies it:

    {"kind": "int", "lo": 99000, "hi": 100000}   an integer in [lo, hi]
    {"kind": "shuffle"}                          the upstream string's
                                                 characters, shuffled

A seed that is a multiple of the workload's `upstream_every` takes the
configuration's upstream inputs unchanged for its first statement, so that
the upstream bench's own statement is proved in some runs of every cell.

A run proves STATEMENTS different statements in turn (`statements`): the
first is `draw(..., seed)`, each further one a draw from the seed and its
index that differs from those before it.
"""

from __future__ import annotations

import numpy as np

STATEMENTS = 2


def draw(config: dict, workload: dict, seed: int, index: int = 0) -> dict:
    """The inputs of the seed's statement `index` (0: the seed's own draw,
    or the upstream inputs where the seed is a multiple of
    `upstream_every`)."""
    upstream = dict(config["inputs"])
    every = workload.get("upstream_every")
    if index == 0 and every and seed % every == 0:
        return upstream
    rng = np.random.default_rng(
        [seed % (1 << 64), index] if index else seed % (1 << 64))
    out = {}
    for name, value in upstream.items():
        rule = workload["draw"].get(name)
        if rule is None:
            out[name] = value
        elif rule["kind"] == "int":
            out[name] = int(rng.integers(rule["lo"], rule["hi"] + 1))
        elif rule["kind"] == "shuffle":
            out[name] = "".join(value[i] for i in rng.permutation(len(value)))
        else:
            raise ValueError(f"unknown draw kind {rule['kind']!r}")
    return out


def statements(config: dict, workload: dict, seed: int) -> list:
    """The inputs of the run's STATEMENTS statements, all different."""
    out, index = [], 0
    while len(out) < STATEMENTS:
        inputs = draw(config, workload, seed, index)
        if inputs not in out:
            out.append(inputs)
        index += 1
    return out


def program(config: dict, inputs: dict) -> str:
    """The Lurk source of the configuration's program on `inputs`."""
    return config["program"].format(**inputs)
