"""The plain reference against stock zlib, and its failures."""

import zlib

import numpy as np
import pytest

from portbench.corpus import load_corpus, payloads
from portbench.reference import InflateError, adler32, inflate_lane

DATA = load_corpus()[3_000_000:3_200_000]


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("strategy", [zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED, zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE])
def test_against_zlib(level, strategy):
    c = zlib.compressobj(level, zlib.DEFLATED, -15, 9, strategy)
    s = c.compress(DATA) + c.flush()
    got = inflate_lane(s)
    assert got.data == DATA and got.final and (got.end_bit + 7) // 8 == len(s)
    assert got.max_dist <= 32768 and got.max_len <= 258


def test_a_sync_flushed_lane_is_not_final_and_ends_on_its_last_byte():
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    s = c.compress(DATA) + c.flush(zlib.Z_SYNC_FLUSH)
    got = inflate_lane(s)
    assert got.data == DATA and not got.final and got.end_bit == 8 * len(s)


def test_a_match_before_the_lane_fails():
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    head = c.compress(DATA[:65536]) + c.flush(zlib.Z_SYNC_FLUSH)
    tail = c.compress(DATA[65536:131072]) + c.flush()
    with pytest.raises(InflateError):
        inflate_lane(tail)
    assert inflate_lane(head).data == DATA[:65536]


def test_corrupt_and_cut_streams_fail_or_differ():
    s = zlib.compress(DATA, 6)[2:-4]
    with pytest.raises(InflateError):
        inflate_lane(s[: len(s) // 2])
    bad = bytearray(s)
    bad[len(s) // 3] ^= 0x10
    try:
        assert inflate_lane(bytes(bad)).data != DATA
    except InflateError:
        pass


def test_adler32():
    for n in (0, 1, 5551, 5552, 5553, (1 << 20) + 3):
        x = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
        assert adler32(x) == zlib.adler32(x)


def test_payloads_are_seeded_and_cover_the_corpus_evenly():
    ring = np.random.default_rng(3).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    a = payloads(2**31 + 11, 800, 5, corpus=ring)
    assert a == payloads(2**31 + 11, 800, 5, corpus=ring)
    assert a != payloads(2**31 + 12, 800, 5, corpus=ring)
    chunks = {ring[i:i + 50] for i in range(0, 1000, 50)}
    for seed in range(2**31 + 20, 2**31 + 30):
        for p in payloads(seed, 800, 5, align=50, corpus=ring):
            assert {p[i:i + 50] for i in range(0, 800, 50)} <= chunks
    assert len(set(a)) == 5 and all(len(p) == 800 for p in a)
    counts = np.zeros(1000, int)
    for j in range(5):
        start = (ring * 2).index(a[j][:300])
        counts[(start + np.arange(800)) % 1000] += 1
    assert (counts == 4).all()
