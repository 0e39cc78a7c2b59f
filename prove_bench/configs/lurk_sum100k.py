"""Plain reference of lurk_sum100k's result: the sum of the list (x
followed by the tail's numbers) in Lurk's default numbers, unsigned 64-bit
integers that wrap, as a Lurk value (tag U64 = 0, digest the eight
little-endian bytes)."""


def result(inputs: dict):
    total = (int(inputs["x"]) + sum(int(t) for t in inputs["tail"].split())
             ) % (1 << 64)
    return 0, tuple((total >> (8 * i)) & 0xFF for i in range(8))
