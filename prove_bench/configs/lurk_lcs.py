"""Plain reference of lurk_lcs's result: the upstream program's longest
common subsequence (ties go as its `lte` on lengths sends them), as a Lurk
string (tag Str = 5): the empty string's digest is eight zeros, and each
character c before a tail t hashes (Char = 4, 0 x 7, c's UTF-8 bytes padded
to 8, Str = 5, 0 x 7, t's digest) with the width-32 Poseidon2."""

from functools import lru_cache

from prove_bench.reference.poseidon2 import hash_n

CHAR, STR = 4, 5


def lcs(a: str, b: str) -> str:
    @lru_cache(maxsize=None)
    def go(i: int, j: int) -> str:
        if i == len(a) or j == len(b):
            return ""
        if a[i] == b[j]:
            return a[i] + go(i + 1, j + 1)
        left, right = go(i, j + 1), go(i + 1, j)
        return right if len(left) <= len(right) else left

    return go(0, 0)


def digest(s: str) -> tuple:
    d = (0,) * 8
    for c in reversed(s):
        bs = tuple(c.encode("utf-8"))
        d = hash_n((CHAR,) + (0,) * 7 + bs + (0,) * (8 - len(bs))
                   + (STR,) + (0,) * 7 + d)
    return d


def result(inputs: dict):
    return STR, digest(lcs(inputs["a"], inputs["b"]))
