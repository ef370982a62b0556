"""Packed-key construction for suffix sorting and rank structures.

Device replacement for the reference's ``PackedDNAString`` AVX2 loads
(reference: include/biovoltron/algo/sort/structs.hpp:83-185): instead of
per-suffix 256-bit vector loads feeding a comparison sort, we materialize
fixed-width integer sort keys for *all* suffixes at once with shifted
whole-array slices, so key extraction is a handful of fused elementwise passes and
ordering becomes integer comparison.

Key encoding: character c at text position p contributes the value c+1 in
a ``char_bits``-wide lane; positions past the end of text contribute 0,
which makes a suffix that runs out of text sort before any extension of
it -- the same end-of-text rule as the reference comparator
(reference: include/biovoltron/algo/sort/kiss1_core.hpp:131-134). Words
are big-endian within the uint32 so unsigned integer order equals
lexicographic character order.

Two alphabets, mirroring the reference's DNA/general split
(reference: kiss1_core.hpp:229-268 vs 270-311):
  - DNA (sigma=4): 4 bits/char, 8 chars per uint32 word.
  - general (sigma<=255): 10 bits/char, 3 chars per uint32 word.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import reduce

import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class Alphabet:
    char_bits: int
    chars_per_word: int


DNA = Alphabet(char_bits=4, chars_per_word=8)
GENERAL = Alphabet(char_bits=10, chars_per_word=3)


def shifted_text(text: jnp.ndarray, max_chars: int) -> jnp.ndarray:
    """Return text+1 as uint32, zero-padded so any window of
    ``max_chars`` characters starting at p <= n is in bounds."""
    n = text.shape[0]
    padded = jnp.zeros(n + max_chars, dtype=jnp.uint32)
    # uint8 view first so int8 inputs with values >= 128 stay positive
    vals = text.view(jnp.uint8) if text.dtype == jnp.int8 else text
    return padded.at[:n].set(vals.astype(jnp.uint32) + 1)


def key_word(
    padded: jnp.ndarray,
    n_positions: int,
    char_offset: int,
    n_chars: int,
    alphabet: Alphabet = DNA,
) -> jnp.ndarray:
    """word[p] packs characters [p+char_offset, p+char_offset+n_chars) of
    the suffix starting at p, big-endian, for p in [0, n_positions).

    ``padded`` comes from :func:`shifted_text`. ``n_chars`` less than a
    full word leaves the low lanes zero (used to cut keys at exactly k
    characters).
    """
    assert 1 <= n_chars <= alphabet.chars_per_word
    acc = jnp.zeros(n_positions, dtype=jnp.uint32)
    for j in range(n_chars):
        off = char_offset + j
        shift = alphabet.char_bits * (alphabet.chars_per_word - 1 - j)
        acc = acc | (padded[off : off + n_positions] << shift)
    return acc


def suffix_key_words(
    text: jnp.ndarray,
    n_chars: int,
    char_offset: int = 0,
    alphabet: Alphabet = DNA,
):
    """Packed key words covering ``n_chars`` characters starting at
    ``char_offset`` of every suffix 0..n (inclusive of the empty suffix at
    position n, whose words are all zero -- the sentinel sorts first, as
    in the reference where SA[0] = n).

    Returns a list of uint32 arrays of length n+1, most-significant first.
    """
    n = text.shape[0]
    cpw = alphabet.chars_per_word
    n_words = -(-n_chars // cpw)
    padded = shifted_text(text, char_offset + n_words * cpw)
    words = []
    remaining = n_chars
    for w in range(n_words):
        chars = min(remaining, cpw)
        words.append(
            key_word(padded, n + 1, char_offset + w * cpw, chars, alphabet)
        )
        remaining -= chars
    return words


def suffix_key_words_2bit(
    text: jnp.ndarray, n_chars: int, char_offset: int = 0
):
    """Raw 2-bit packed DNA key words: 16 chars per uint32, big-endian,
    past-end positions contribute 0.

    Unlike :func:`suffix_key_words` (4 bits/char, c+1 so past-end sorts
    first automatically), raw 2-bit packing cannot distinguish an 'A'
    run from running out of text; callers MUST pair these words with a
    shorter-first clamped-length key (:func:`clamped_suffix_len`) to
    reproduce the reference's end-of-text rule (reference:
    include/biovoltron/algo/sort/kiss1_core.hpp:131-134). Same grouping
    and order as the 4-bit words at half the operand width.
    """
    n = text.shape[0]
    cpw = 16
    n_words = -(-n_chars // cpw)
    padded = jnp.zeros(n + char_offset + n_words * cpw, dtype=jnp.uint32)
    vals = text.view(jnp.uint8) if text.dtype == jnp.int8 else text
    padded = padded.at[:n].set(vals.astype(jnp.uint32))
    words = []
    remaining = n_chars
    for w in range(n_words):
        chars = min(remaining, cpw)
        acc = jnp.zeros(n + 1, dtype=jnp.uint32)
        for j in range(chars):
            off = char_offset + w * cpw + j
            shift = 2 * (cpw - 1 - j)
            acc = acc | (padded[off : off + n + 1] << shift)
        words.append(acc)
        remaining -= chars
    return words


def clamped_suffix_len(n: int, cover: int) -> jnp.ndarray:
    """min(n - p, cover) for every suffix p in [0, n]: the shorter-first
    tiebreak companion to :func:`suffix_key_words_2bit`."""
    p = jnp.arange(n + 1, dtype=jnp.uint32)
    return jnp.minimum(jnp.uint32(n) - p, jnp.uint32(cover))


def fused_end_pos(n: int, cover: int) -> jnp.ndarray:
    """One word encoding BOTH the shorter-first end-of-text rule and the
    ascending-position tiebreak for a ``cover``-character key window:

        fused[p] = n - p        if n - p < cover   (a "short" suffix)
                   p + cover    otherwise.

    Within a group of suffixes whose raw 2-bit key words tie, unsigned
    order of ``fused`` is exactly (clamped length asc, position asc):
    short suffixes have pairwise-distinct lengths, so length order IS
    their order; every short value (< cover) precedes every full value
    (>= cover); and full-length suffixes order by position. This is the
    reference comparator contract (kiss1_core.hpp:94-135: ties at >= k
    chars resolved by ``i < j``; a suffix hitting end-of-text sorts
    smallest) in bit_length(n) bits -- never more than the position
    alone, so one uint32 suffices up to chm13 scale for ANY cover.

    Decode: p = n - fused if fused < cover else fused - cover; the
    clamped length (the group-identity component) is min(fused, cover).
    """
    p = jnp.arange(n + 1, dtype=jnp.uint32)
    ln = jnp.uint32(n) - p
    return jnp.where(ln < cover, ln, p + jnp.uint32(cover))


# ---------------------------------------------------------------------------
# 2-bit symbol packing (BWT storage / occ rank words)
# ---------------------------------------------------------------------------

SYMS_PER_U32 = 16


def pack_dibits_u32(values: jnp.ndarray) -> jnp.ndarray:
    """Pack 2-bit symbols into uint32 words, 16 per word, LSB-first.

    LSB-first matches the reference DibitVector byte layout (reference:
    include/biovoltron/container/xbit_vector.hpp:11-66) viewed through
    little-endian uint32, so the device representation and the ``.fmi``
    serialized bytes are the same bits.
    """
    n = values.shape[0]
    npad = -(-n // SYMS_PER_U32) * SYMS_PER_U32
    v = jnp.zeros(npad, dtype=jnp.uint32).at[:n].set(values.astype(jnp.uint32))
    v = v.reshape(-1, SYMS_PER_U32)
    shifts = jnp.arange(SYMS_PER_U32, dtype=jnp.uint32) * 2
    return reduce(jnp.bitwise_or, jnp.unstack(v << shifts[None, :], axis=1))


def popcount_u32(x: jnp.ndarray) -> jnp.ndarray:
    """Branch-free population count over uint32 lanes."""
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return (x * jnp.uint32(0x01010101)) >> 24


def count_symbol_prefix(word: jnp.ndarray, sym: jnp.ndarray, t: jnp.ndarray):
    """Occurrences of 2-bit symbol ``sym`` among the first ``t`` symbols
    of each LSB-first packed ``word`` (t in [0, 16]).

    This is the vectorized form of the reference's per-byte cnt_table scan
    (reference: include/biovoltron/algo/align/exact_match/fm_index.hpp:
    158-182): XOR against the replicated symbol, detect zero 2-bit lanes,
    mask to the first t lanes, popcount.
    """
    pattern = sym.astype(jnp.uint32) * jnp.uint32(0x55555555)
    x = word ^ pattern
    zeros = ~x & (~x >> 1) & jnp.uint32(0x55555555)
    t = t.astype(jnp.uint32)
    lane_mask = jnp.where(
        t >= SYMS_PER_U32,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << (2 * t)) - jnp.uint32(1),
    ) & jnp.uint32(0x55555555)
    return popcount_u32(zeros & lane_mask)


def np_pack_dibits_u32(values: np.ndarray) -> np.ndarray:
    """Host-side (numpy) variant of :func:`pack_dibits_u32`."""
    values = np.asarray(values, dtype=np.uint32)
    n = values.shape[0]
    npad = -(-n // SYMS_PER_U32) * SYMS_PER_U32
    v = np.zeros(npad, dtype=np.uint32)
    v[:n] = values
    v = v.reshape(-1, SYMS_PER_U32)
    shifts = (np.arange(SYMS_PER_U32, dtype=np.uint32) * 2)[None, :]
    return np.bitwise_or.reduce(v << shifts, axis=1).astype(np.uint32)


def np_pack_queries_2bit(queries: np.ndarray) -> np.ndarray:
    """Pack a batch of 2-bit symbol patterns row-wise, LSB-first, 16
    symbols per uint32: int8/uint8[Q, m] -> uint32[Q, ceil(m/16)].

    Rationale: 2-bit packing cuts the host->device pattern transfer 4x
    versus int8 symbols.
    Symbol j of query q is ``(out[q, j // 16] >> (2 * (j % 16))) & 3``
    -- the same lane layout as :func:`pack_dibits_u32`/the BWT words.
    """
    q = np.asarray(queries)
    if q.dtype != np.uint8:
        q = q.astype(np.uint8)
    Q, m = q.shape
    W = -(-m // SYMS_PER_U32)
    buf = np.zeros((Q, W * SYMS_PER_U32), np.uint32)
    buf[:, :m] = q
    buf = buf.reshape(Q, W, SYMS_PER_U32)
    shifts = (np.arange(SYMS_PER_U32, dtype=np.uint32) * 2)[None, None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=2).astype(np.uint32)
