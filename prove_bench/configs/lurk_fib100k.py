"""Plain reference of lurk_fib100k's result: fib(n) in Lurk's default
numbers, unsigned 64-bit integers that wrap, as a Lurk value (tag U64 = 0,
digest the eight little-endian bytes)."""


def result(inputs: dict):
    a, b = 0, 1
    for _ in range(inputs["n"]):
        a, b = b, (a + b) % (1 << 64)
    return 0, tuple((a >> (8 * i)) & 0xFF for i in range(8))
