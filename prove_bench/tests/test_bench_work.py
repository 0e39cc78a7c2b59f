"""The shape counts of prove_bench/work.py on a small proof made on the
CPU (lurk_tpu_torch's golden demo fib(1000): one shard, 9 chips), held to
counts worked out by hand, and the rooflines' and traces' arithmetic."""

import pytest

from prove_bench import trace, work
from prove_bench.reference.verifier import Key


@pytest.fixture(scope="module")
def mats():
    from lurk_tpu_torch.stark import golden
    _, vk, proof, _ = golden.fib_proof("cpu")
    key = Key(vk.prep_roots, vk.prep_chip_names, vk.prep_widths,
              vk.prep_log_heights, len(proof.public_values), {})
    (shard,) = work.shard_matrices(proof, key)
    return shard


def test_shapes(mats):
    # Bytes (preprocessed, 2^16 rows, 6 columns), then main, perm and
    # quotient of Entrypoint (1 row), Func[fib] (2^10), six Mem chips (4
    # rows each) and Bytes (2^16)
    assert [(m.round, m.log_h, m.width) for m in mats[:2]] == \
        [("preprocessed", 16, 6), ("main", 0, 2)]
    main = [(m.log_h, m.width) for m in mats if m.round == "main"]
    assert main == [(0, 2), (10, 18), (2, 6), (2, 7), (2, 8), (2, 9),
                    (2, 10), (2, 12), (16, 13)]
    perm = [m.width for m in mats if m.round == "perm"]
    assert perm == [8, 16, 8, 8, 8, 8, 8, 8, 28]
    assert all(m.width == 8 and m.points == ("z2",) for m in mats
               if m.round == "quotient")
    assert mats[1].points == ("z", "z") and \
        mats[2].points == ("z", ("zg", 10))
    assert work.fri_layers(mats) == list(range(17, 1, -1))


def test_commit_work(mats):
    # a tree per (round, height): leaves 2^(lh + 1), each hashing
    # ceil(W / 8) chunks, and leaves - 1 compressions
    main = (2 + 1) + (2048 * 3 + 2047) + (8 * 7 + 7) + (131072 * 2 + 131071)
    perm = (2 + 1) + (2048 * 2 + 2047) + (8 * 6 + 7) + (131072 * 4 + 131071)
    quot = (2 + 1) + (2048 + 2047) + (8 * 6 + 7) + (131072 + 131071)
    fri = 2 * 65536 - 1          # the one layer above the host tail, 2^17
    assert work.commit_work(mats)["perms"] == main + perm + quot + fri
    assert work.poseidon2_perm_ops() == (8 * 64 + 13 * 20,
                                         72 + 8 * 88 + 13 * 32)


def test_open_work(mats):
    # open_eval's bytes: 4 h w coefficients read, 16 n w opened values
    # written, for every matrix
    prep = 4 * 65536 * 6 + 16 * 2 * 6
    main = (4 * 1 * 2 + 16 * 2 * 2) + (4 * 1024 * 18 + 16 * 2 * 18) + \
        (4 * 4 * 52 + 16 * 2 * 52) + (4 * 65536 * 13 + 16 * 2 * 13)
    perm = (4 * 1 * 8 + 16 * 2 * 8) + (4 * 1024 * 16 + 16 * 2 * 16) + \
        (4 * 4 * 48 + 16 * 2 * 48) + (4 * 65536 * 28 + 16 * 2 * 28)
    quot = (4 * 8 + 16 * 8) + (4 * 1024 * 8 + 16 * 8) + \
        (4 * 4 * 48 + 16 * 48) + (4 * 65536 * 8 + 16 * 8)
    ev = work.open_work(mats)["open_eval"]
    assert ev[0] == prep + main + perm + quot
    # open_reduce reads every LDE word once and writes each height's
    # codeword (16 bytes a row) once
    red = work.open_work(mats)["open_reduce"]
    lde_words = 2 * (65536 * 6 + 2 + 1024 * 18 + 4 * 52 + 65536 * 13 + 8 +
                     1024 * 16 + 4 * 48 + 65536 * 28 + 8 + 1024 * 8 +
                     4 * 48 + 65536 * 8)
    codewords = 16 * (2 ** 17 + 2 ** 11 + 2 ** 3 + 2 ** 1)
    assert red[0] == 4 * lde_words + codewords


def test_least_times_are_positive_and_bound_by_their_side(mats):
    w = work.commit_work(mats)
    muls, adds = work.poseidon2_perm_ops()
    assert work.poseidon2_least_s(mats) == pytest.approx(max(
        w["bytes"] / work.HBM_BYTES_PER_S,
        max(5 * muls, 2 * adds) * w["perms"] / 64 / (132 * 1.98e9)))
    assert work.open_least_s(mats) > 0


def test_busy_union():
    assert trace.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert trace.busy_us([]) == 0


def test_stamp_phases():
    log = ("[prove-timing] shard0 witness+upload: 1.250s [cuda 1/2/3 GiB]\n"
           "[prove-timing]   open+fri: 0.500s\n"
           "[prove-timing] shard1 witness+upload: 0.750s\n"
           "[prove-timing]   open+fri: 0.25s\nother line\n")
    assert trace.phases(log) == {"witness+upload": 2.0, "open+fri": 0.75}


def test_idle_by_phase():
    # a 10 s window: device busy 1-2 and 6-7; the host in "a" over 0-4
    # and in "b" over 4-9
    t = trace.Trace(proofs=1, wall_s=10.0, t0=100.0,
                    events=[("k", 1.0, 2.0), ("k", 6.0, 7.0)],
                    stamps=[(104.0, "[prove-timing] a: 4.000s"),
                            (109.0, "[prove-timing] shard0 b: 5.000s")],
                    stats=[], shapes=[], eval_s=0.0)
    assert t.busy_s() == 2.0
    assert t.idle_gaps() == [(0.0, 1.0), (2.0, 6.0), (7.0, 10.0)]
    got = t.idle_by_phase()
    assert got == pytest.approx({"a": 3.0, "b": 4.0, "between proves": 1.0})
