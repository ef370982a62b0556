"""Conformance tests for the out-of-core suffix sorter: bit-identity
with the in-core pipeline on every corpus shape and k, with small batch
capacities so many bucket-aligned batches and multiple refinement
rounds actually execute (the same machinery that runs at chm13 scale,
experiments/chm13_full.py)."""

import numpy as np
import pytest

from kiss_tpu.ops import external_sort, suffix_sort
from tests import oracle


def _check(text, k, **kw):
    got = external_sort.external_k_ordered_suffix_array(text, k, **kw)
    want = suffix_sort.k_ordered_suffix_array(text, k)
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("k", [4, 16, 64, 256, -1])
def test_random_matches_incore(k):
    text = oracle.random_dna(20_000, seed=1)
    _check(text, k, batch_rows=4096)


@pytest.mark.parametrize("k", [64, 256, -1])
def test_repeat_heavy_matches_incore(k):
    # tandem repeats force ties past the 64-char seed so wide rounds and
    # (for -1) multiple coverage doublings run
    unit = oracle.random_dna(13, seed=3)
    text = np.tile(unit, 2500)[:30_000].copy()
    text[15_000:] = oracle.random_dna(15_000, seed=4)
    _check(text, k, batch_rows=4096)


def test_dispersed_repeats_and_small_buckets():
    rng = np.random.default_rng(7)
    text = oracle.random_dna(24_000, seed=7)
    seg = text[2_000:4_000].copy()
    for at in (9_000, 14_500, 20_000):
        text[at : at + seg.size] = seg
    # 2-char buckets (16 total): exercises batches spanning many buckets
    _check(text, 256, batch_rows=2048, bucket_chars=2)


def test_all_same_char():
    # one giant tie group (a single bucket -- batch_rows must cover it);
    # end-of-text rule dominates
    text = np.zeros(5_000, dtype=np.int8)
    _check(text, 64, batch_rows=8192)
    _check(text, -1, batch_rows=8192)


def test_tiny_and_empty():
    assert external_sort.external_k_ordered_suffix_array(
        np.empty(0, dtype=np.int8), 16
    ).tolist() == [0]
    text = np.array([2, 1, 3, 0, 0, 1], dtype=np.int8)
    _check(text, 4, batch_rows=4096, bucket_chars=1)
    _check(text, -1, batch_rows=4096, bucket_chars=1)


@pytest.mark.parametrize("k", [100, 150, 200])
def test_arbitrary_bounded_k(k):
    """Raw-tail rounds (k not a multiple of the 64-char seed) -- the
    reference supports every bounded k (exact-k comparator cut,
    kiss1_core.hpp:94-135; protocol sweep experiment_a.sh:10-39), so the
    out-of-core path must too."""
    unit = oracle.random_dna(11, seed=31)
    text = np.tile(unit, 3000)[:30_000].copy()
    text[18_000:] = oracle.random_dna(12_000, seed=32)
    _check(text, k, batch_rows=4096)


def test_arbitrary_k_multi_level_tail():
    # k = 680 = 512 + 2*64 + 40: the tail round references two saved
    # rank levels AND closes with raw tail words
    unit = oracle.random_dna(7, seed=33)
    text = np.tile(unit, 5000)[:32_000].copy()
    text[24_000:] = oracle.random_dna(8_000, seed=34)
    _check(text, 680, batch_rows=4096)


def test_tail_words_match_device_pack():
    import jax.numpy as jnp

    from kiss_tpu.ops import pack

    text = oracle.random_dna(500, seed=35)
    pA = np.array([0, 3, 450, 470, 492, 499, 500], dtype=np.uint32)
    for tail_chars, tail_offset in [(1, 64), (8, 64), (36, 64), (40, 640)]:
        want_full = [
            np.asarray(w)
            for w in pack.suffix_key_words(
                jnp.asarray(text), tail_chars, tail_offset, pack.DNA
            )
        ]
        got = external_sort._np_tail_words(text, pA, tail_chars, tail_offset)
        assert len(got) == len(want_full)
        for g, w in zip(got, want_full):
            np.testing.assert_array_equal(g, w[pA])


def test_saved_level_snapshot():
    # k = 576 = 512 + 64 decomposes into a non-full final round that
    # references BOTH rank levels -> exercises the copy-on-save guard
    unit = oracle.random_dna(17, seed=9)
    text = np.tile(unit, 2000)[:30_000].copy()
    text[20_000:] = oracle.random_dna(10_000, seed=10)
    _check(text, 576, batch_rows=4096)


def test_oversized_tie_group_raises():
    text = np.zeros(10_000, dtype=np.int8)  # single tie group ~10k
    with pytest.raises(ValueError, match="tie group|bucket"):
        external_sort.external_k_ordered_suffix_array(
            text, 256, batch_rows=1024
        )


def test_word0_padded_matches_generic():
    text = oracle.random_dna(1000, seed=5)
    w0p = external_sort._np_word0_padded(text, 48)
    for w in range(4):
        want = external_sort._np_seed_word(text, w, 16)
        got = w0p[16 * w : 16 * w + want.size]
        np.testing.assert_array_equal(got, want)


def test_sortedness_property_large():
    """The reference's own oracle (tests/kiss.cpp:26-28) at a size that
    spans many batches."""
    text = oracle.random_dna(120_000, seed=21)
    sa = _check(text, 32, batch_rows=16_384)
    oracle.check_k_sorted(text, sa, 32)
