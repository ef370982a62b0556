"""k-ordered FM-index on the accelerator.

Re-design of the reference ``FMIndex<SA_INTV, uint32_t, Sorter>``
(reference: include/biovoltron/algo/align/exact_match/fm_index.hpp:99-652)
for JAX/XLA:

  - The build is whole-array dataflow: BWT by one gather (``ref[sa-1]``),
    the two-level occ table by blocked one-hot reductions and exclusive
    scans (replacing the OpenMP per-block count + serial prefix fixup,
    reference: fm_index.hpp:277-308), the sampled-SA mark/rank structure
    by popcount scans and a static-size compaction.
  - Queries are *batched*: ``get_range`` runs the backward search for Q
    patterns at once (each LF step is ONE fused occ-table gather + a bitcount
    over one packed word -- the vectorized form of compute_occ,
    fm_index.hpp:166-182, with the occ1/occ2 levels pre-summed
    device-side), and ``locate`` resolves whole row-sets with a
    masked fixed-depth LF walk. The reference accelerates locate with a
    sequential FMTree BFS queue (fm_index.hpp:453-501); on the device
    the bounded LF walk vectorizes over every row at once, so the queue
    is unnecessary -- same outputs, data-parallel form.
  - ``save``/``load`` produce byte-identical ``.fmi`` archives
    (reference: fm_index.hpp:591-646 + serializer.hpp layout).

Data layout notes: the BWT is kept 2-bit packed LSB-first in uint32 words
(16 symbols/word). Because OCC2_INTV == 16, each occ2 block corresponds
to exactly one packed word, so a partial-block rank needs exactly one
word gather + one masked popcount.
"""

from __future__ import annotations

import dataclasses
import json
import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from kiss_tpu.ops import pack
from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu.utils import serializer, timing

OCC1_INTV = 256
OCC2_INTV = 16
B_OCC_INTV = 64

# The reference build hardcodes a 32-ordered SA (reference:
# fm_index.hpp:384-386). An index built from a k-ordered (not fully
# sorted) SA is NOT per-row-LF-consistent: inside equal-k-prefix tie
# groups, lf(bwt[i], i) lands on the row of a DIFFERENT occurrence of
# the shared context, so per-row LF walks (compute_sa,
# fm_index.hpp:210-222) return wrong positions on >=k-char repeats.
# The reference itself never walks rows on the CLI path -- its locate
# is the FMTree range-BFS (fm_index.hpp:453-501), which only ever
# applies lf to RANGE ENDPOINTS; endpoint arithmetic is pure counting
# and counting is exact on a k-ordered SA for any context of length
# <= k, so the BFS emits the right position SET even where row walks
# go wrong. This library therefore keeps two locate paths:
#   - fully-sorted SA (our default build, SORT_LEN = None): the
#     data-parallel per-row walk (locate_rows_device) -- fastest;
#   - anything else (sort_len-bounded builds, `.fmi` archives loaded
#     from disk, incl. reference-written ones): the vectorized range
#     BFS (bfs_locate_device) with the reference's exact semantics.
# Routing is the FMIndex.full_sa flag.
SORT_LEN = None


class FMArrays(NamedTuple):
    """Device-resident index (a pytree usable inside jit)."""

    bwt_words: jnp.ndarray  # uint32[ceil(N/16)], 2-bit LSB-first
    occ1: jnp.ndarray  # int32[N//256+1, 4]
    occ2: jnp.ndarray  # int32[N//16+1, 4] (uint8 content)
    cnt: jnp.ndarray  # int32[4]
    pri: jnp.ndarray  # int32 scalar: row of the sentinel
    sa_samp: jnp.ndarray  # int32[ceil(N/SA_INTV)] (or full SA if INTV==1)
    b_words: jnp.ndarray  # uint32[ceil(N/32)] sampled-row marks
    b_occ: jnp.ndarray  # int32[N//64+1]
    lookup: jnp.ndarray  # int32[4^LOOKUP_LEN + 1]
    # device-only fusions (not serialized). Backward search is a chain
    # of dependent gathers, so every table an LF step touches is packed
    # into one row (one gather per step; its cost on the H100 is not
    # measured yet):
    #   lf_tab[j] = [occ1[j//16] + occ2[j] for each symbol (4 cols),
    #                bwt word j]          -- ONE gather per LF bound
    #   b_tab[blk] = [b_occ[blk], b_words[2blk], b_words[2blk+1]]
    #                -- ONE gather per mark probe / mark rank
    lf_tab: jnp.ndarray  # uint32[N//16+1, 5]
    b_tab: jnp.ndarray  # uint32[N//64+1, 3]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _word_symbol_counts(bwt_words: jnp.ndarray, N: int, pri: jnp.ndarray):
    """counts[j, c] = #occurrences of symbol c among the valid rows of
    16-row block j, computed straight from the packed BWT words by
    XOR + masked popcount (the whole-array form of the reference's
    cnt_table byte scan, fm_index.hpp:158-164). The sentinel row packs
    as symbol 0 and is subtracted from its block -- no ``[N, 4]``
    one-hot is ever materialized (that intermediate alone would be
    ~12.5 GB at chm13 scale)."""
    W = bwt_words.shape[0]
    starts = jnp.arange(W, dtype=jnp.uint32) * OCC2_INTV
    t = jnp.minimum(jnp.uint32(N) - starts, jnp.uint32(OCC2_INTV))
    cols = [
        pack.count_symbol_prefix(bwt_words, jnp.uint32(c), t).astype(
            jnp.int32
        )
        for c in range(4)
    ]
    cnts = jnp.stack(cols, axis=1)
    return cnts.at[pri // OCC2_INTV, 0].add(-1)


def _index_dtype(N: int, force_u32: bool = False):
    """Row/position/count dtype for an index with N rows: int32 when it
    fits (friendlier to XLA int indexing), uint32 up to chm13 scale
    (n = 3.117e9 > 2**31; see ROADMAP chm13 item). ``force_u32`` lets
    tests exercise the uint32 path on small corpora."""
    return jnp.uint32 if force_u32 or N >= 2**31 else jnp.int32


@partial(jax.jit, static_argnames=("sa_intv", "force_u32"))
def build_index_device(text: jnp.ndarray, sa: jnp.ndarray, sa_intv: int,
                       force_u32: bool = False):
    """text int8[n], sa int/uint32[N=n+1] -> FMArrays (without lookup).

    Mirrors build_occ/build_bwt/build_sa (reference: fm_index.hpp:277-371)
    as pure dataflow.
    """
    n = text.shape[0]
    N = n + 1
    idt = _index_dtype(N, force_u32)
    sa = sa.astype(idt)

    # ---- BWT: bwt[i] = ref[sa[i]-1], 0 at the sentinel row
    # (reference: fm_index.hpp:310-329). Computed by the sort-gather
    # trick rather than ``text[sa - 1]``: prev over the non-sentinel
    # rows is a permutation of [0, n) (sentinel -> unique key n), so
    # after sorting (prev, row) by prev, global slot j needs exactly
    # text[j] -- an ELEMENTWISE alignment -- and one more sort by row
    # returns the symbols to BWT order (same dataflow as the sharded
    # build, kiss_tpu/parallel/fm_build.py; sort against gather is not
    # measured on the H100, ROADMAP queue 1 item 3).
    row = jnp.arange(N, dtype=jnp.uint32)
    sau = sa.astype(jnp.uint32)
    prevv = jnp.where(sau == 0, jnp.uint32(n), sau - 1)
    _, rows_s = lax.sort((prevv, row), num_keys=1, is_stable=False)
    # int32 symbols: XLA:GPU rewrites this sort into a scatter (its
    # permutation_sort_simplifier) and fails to verify the rewrite for
    # uint32 values
    textN = jnp.zeros(N, jnp.int32).at[:n].set(
        text.view(jnp.uint8).astype(jnp.int32)
        if text.dtype == jnp.int8
        else text.astype(jnp.int32)
    )
    _, bwt_u = lax.sort((rows_s, textN), num_keys=1, is_stable=False)
    bwt = bwt_u.astype(jnp.int8)
    pri = jnp.argmin(sa).astype(idt)  # row with sa == 0
    bwt_words = pack.pack_dibits_u32(bwt)

    # ---- occ tables (reference: fm_index.hpp:277-308): the sentinel row
    # contributes to no symbol count (it packs as symbol 0 and is
    # subtracted from its block inside _word_symbol_counts).
    c16 = _word_symbol_counts(bwt_words, N, pri)  # [nb2e, 4]
    nb2 = N // OCC2_INTV + 1
    nb1 = N // OCC1_INTV + 1
    blocks_per_sup = OCC1_INTV // OCC2_INTV
    npad2 = nb1 * blocks_per_sup
    c16p = jnp.zeros((npad2, 4), jnp.int32).at[: c16.shape[0]].set(c16)
    grp = c16p.reshape(nb1, blocks_per_sup, 4)
    # occ2: exclusive cumsum within each 256-superblock (content fits
    # uint8; full counts only at the occ1 level)
    occ2_full = jnp.cumsum(grp, axis=1) - grp
    occ2 = occ2_full.reshape(npad2, 4)[:nb2].astype(jnp.int32)
    # occ1: exclusive cumsum of superblock totals; counts reach N, so
    # accumulate in the index dtype
    sup_tot = grp.sum(axis=1).astype(idt)
    occ1 = (jnp.cumsum(sup_tot, axis=0) - sup_tot)[:nb1]
    totals = sup_tot.sum(axis=0)
    # cnt[c] = 1 + sum of totals of smaller symbols (the +1 is the
    # sentinel, reference: fm_index.hpp:303-307)
    cnt = (jnp.cumsum(totals) - totals + 1).astype(idt)

    # ---- sampled SA + marks (reference: fm_index.hpp:331-371)
    if sa_intv == 1:
        b_words = jnp.zeros(1, jnp.uint32)
        b_occ = jnp.zeros(1, idt)
        sa_samp = sa
    else:
        b = sa % sa_intv == 0
        # an even word count so _b_rank can always read a 64-bit block
        # as two u32 words
        nw = 2 * (-(-N // 64))
        bp = jnp.zeros(nw * 32, bool).at[:N].set(b)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        b_words = (
            (bp.reshape(nw, 32).astype(jnp.uint32) << shifts[None, :])
            .sum(axis=1)
            .astype(jnp.uint32)
        )
        c64 = _blocked_counts_bool(b, B_OCC_INTV).astype(idt)
        nb64 = N // B_OCC_INTV + 1
        c64 = c64[:nb64]
        b_occ = (jnp.cumsum(c64) - c64).astype(idt)
        n_samp = (N + sa_intv - 1) // sa_intv
        # sampled-SA compaction by one 2-operand sort: each marked row's
        # key is its global mark rank (= target slot), unmarked rows get
        # unique out-of-range keys (the dataflow form of build_sa's
        # serial scan, reference: fm_index.hpp:331-371).
        bi = b.astype(jnp.uint32)
        brank = jnp.cumsum(bi) - bi
        samp_key = jnp.where(b, brank, jnp.uint32(n_samp) + row)
        _, samp_sorted = lax.sort((samp_key, sau), num_keys=1,
                                  is_stable=False)
        sa_samp = samp_sorted[:n_samp].astype(idt)

    lookup = jnp.array([0, N], idt)  # placeholder; LOOKUP_LEN=0 form
    return FMArrays(
        bwt_words, occ1, occ2, cnt, pri, sa_samp, b_words, b_occ, lookup,
        _fuse_lf_tab(occ1, occ2, bwt_words), _fuse_b_tab(b_occ, b_words),
    )


def _fuse_lf_tab(occ1, occ2, bwt_words) -> jnp.ndarray:
    """lf_tab[j] = [absolute per-symbol counts before 16-block j
    (occ1[j // 16] + occ2[j], 4 uint32 cols), packed BWT word j]: the
    whole LF step reads ONE table row instead of an occ gather plus a
    word gather (the reference reads occ1 + occ2 + packed bytes
    separately per bound, fm_index.hpp:166-182). Device-side only; the serialized ``.fmi``
    keeps the reference's two-level layout (fm_index.hpp:106-128)
    byte-exactly."""
    nb2 = occ2.shape[0]
    reps = jnp.repeat(
        occ1.astype(jnp.uint32), OCC1_INTV // OCC2_INTV, axis=0
    )[:nb2]
    occf = reps + occ2.astype(jnp.uint32)
    words = jnp.zeros(nb2, jnp.uint32).at[: bwt_words.shape[0]].set(
        bwt_words[:nb2]
    )
    return jnp.concatenate([occf, words[:, None]], axis=1)


def _fuse_b_tab(b_occ, b_words) -> jnp.ndarray:
    """b_tab[blk] = [mark-rank prefix b_occ[blk], mark words 2blk and
    2blk+1]: mark probes and mark ranks (compute_b_occ, reference:
    fm_index.hpp:189-208) each cost ONE row gather. Device-side only."""
    nb = b_occ.shape[0]
    w = jnp.zeros(2 * nb, jnp.uint32).at[: b_words.shape[0]].set(
        b_words[: 2 * nb]
    )
    return jnp.stack(
        [b_occ.astype(jnp.uint32), w[0::2], w[1::2]], axis=1
    )


def _blocked_counts_bool(flags: jnp.ndarray, block: int) -> jnp.ndarray:
    n = flags.shape[0]
    nblk = -(-n // block)
    fp = jnp.pad(flags, (0, nblk * block - n))
    return fp.reshape(nblk, block).sum(axis=1, dtype=jnp.int32)


# ---------------------------------------------------------------------------
# query primitives (device)
# ---------------------------------------------------------------------------


def _sel4(row4: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """row4[..., c] without a second gather: a one-hot select is pure
    elementwise work, while take_along_axis would lower to another
    gather."""
    onehot = (
        c[..., None] == jnp.arange(4, dtype=c.dtype)
    ).astype(jnp.uint32)
    return (row4 * onehot).sum(axis=-1)


def _occ(idx: FMArrays, c: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    """Vectorized compute_occ (reference: fm_index.hpp:166-182) as ONE
    ``lf_tab`` row gather: the row carries the absolute counts of all 4
    symbols plus the packed BWT word. Arithmetic in the index dtype
    (int32, or uint32 at chm13 scale -- see :func:`_index_dtype`); the
    pass_pri subtraction never underflows because it implies the
    sentinel's packed symbol was counted."""
    idt = idx.cnt.dtype
    row = idx.lf_tab[i // OCC2_INTV]
    word = row[..., 4]
    partial_cnt = pack.count_symbol_prefix(word, c, i % OCC2_INTV)
    beg = i - i % OCC2_INTV
    pass_pri = (c == 0) & (beg <= idx.pri) & (idx.pri < i)
    return (
        (_sel4(row[..., :4], c) + partial_cnt).astype(idt)
        - pass_pri.astype(idt)
    )


def _lf(idx: FMArrays, c: jnp.ndarray, i: jnp.ndarray) -> jnp.ndarray:
    return idx.cnt[c] + _occ(idx, c, i)


def _bwt_at(idx: FMArrays, i: jnp.ndarray) -> jnp.ndarray:
    return (
        (idx.lf_tab[i // 16, 4] >> (2 * (i % 16).astype(jnp.uint32))) & 3
    ).astype(jnp.int32)


def _lf_own_symbol(idx: FMArrays, i: jnp.ndarray) -> jnp.ndarray:
    """lf(bwt[i], i) with ONE lf_tab row gather: the locate walk needs
    the symbol at row i, its occ count, and the partial word rank, and
    they all live in the same fused row (compute_sa does the same reads
    separately, reference: fm_index.hpp:210-222)."""
    idt = idx.cnt.dtype
    row = idx.lf_tab[i // OCC2_INTV]
    word = row[..., 4]
    off = (i % OCC2_INTV).astype(jnp.uint32)
    c = ((word >> (2 * off)) & 3).astype(jnp.int32)
    partial_cnt = pack.count_symbol_prefix(word, c, i % OCC2_INTV)
    beg = i - i % OCC2_INTV
    pass_pri = (c == 0) & (beg <= idx.pri) & (idx.pri < i)
    return idx.cnt[c] + (
        (_sel4(row[..., :4], c) + partial_cnt).astype(idt)
        - pass_pri.astype(idt)
    )


def _lf_all4(idx: FMArrays, i: jnp.ndarray) -> jnp.ndarray:
    """lf(c, i) for ALL 4 symbols from ONE lf_tab row gather, shape
    [..., 4]. The fused row already carries every symbol's absolute
    count plus the packed word, so a 4-way range expansion costs one
    gather per endpoint, not four (reference runs compute_occ once per
    (symbol, bound), fm_index.hpp:453-501 + 166-182)."""
    idt = idx.cnt.dtype
    row = idx.lf_tab[i // OCC2_INTV]
    word = row[..., 4]
    t = i % OCC2_INTV
    partial = jnp.stack(
        [
            pack.count_symbol_prefix(word, jnp.uint32(c), t)
            for c in range(4)
        ],
        axis=-1,
    )
    beg = i - t
    pass_pri = (beg <= idx.pri) & (idx.pri < i)  # applies to symbol 0 only
    occ = (row[..., :4] + partial).astype(idt)
    occ = occ.at[..., 0].add(-pass_pri.astype(idt))
    return idx.cnt[None, :].astype(idt) + occ


def _b_rank(idx: FMArrays, i: jnp.ndarray) -> jnp.ndarray:
    """Vectorized compute_b_occ (reference: fm_index.hpp:189-208) as one
    ``b_tab`` row gather (rank prefix + both mark words)."""
    blk = i // B_OCC_INTV
    off = i - blk * B_OCC_INTV  # 0..63
    row = idx.b_tab[blk]
    w0, w1 = row[..., 1], row[..., 2]
    # off may be unsigned: compute the second-word bit count without
    # ever forming a negative intermediate
    lo = jnp.minimum(off, 32).astype(jnp.uint32)
    hi = jnp.where(off > 32, off - 32, jnp.zeros((), off.dtype)).astype(
        jnp.uint32
    )
    m0 = jnp.where(lo >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << lo) - 1)
    m1 = jnp.where(hi >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << hi) - 1)
    cnt = pack.popcount_u32(w0 & m0) + pack.popcount_u32(w1 & m1)
    return (row[..., 0] + cnt).astype(idx.cnt.dtype)


def _b_at(idx: FMArrays, i: jnp.ndarray) -> jnp.ndarray:
    row = idx.b_tab[i // B_OCC_INTV]
    odd = ((i // 32) % 2) == 1
    w = jnp.where(odd, row[..., 2], row[..., 1])
    return ((w >> (i % 32).astype(jnp.uint32)) & 1) == 1


@partial(jax.jit, static_argnames=("lookup_len", "early_stop"))
def get_range_device(idx: FMArrays, queries: jnp.ndarray, lookup_len: int,
                     early_stop: bool = True):
    """Backward search for a batch of equal-length patterns.

    queries: int8[Q, m], symbols 0..3. Returns (beg, end, offs) int32[Q]
    -- offs is the number of unmatched leading characters (0 on success),
    matching compute_range's early-stop semantics
    (reference: fm_index.hpp:224-235 with stop_upper = 1).

    ``early_stop=False`` keeps LF-walking an empty range (beg == end
    move together monotonically) -- required when building the lookup
    table, where absent seeds must still store their sorted insertion
    point so the table stays nondecreasing (the reference's
    build_lookup runs the full loop for the same reason,
    fm_index.hpp:237-269).
    """
    q, m = queries.shape
    idt = idx.lookup.dtype  # int32, or uint32 at chm13 scale
    beg = jnp.zeros(q, idt)
    end = jnp.full(q, idx.lookup[-1], idt)
    steps = m
    if lookup_len and m >= lookup_len:
        # seed from the lookup table on the last lookup_len characters
        # (reference: fm_index.hpp:574-584)
        key = jnp.zeros(q, jnp.int32)
        for j in range(m - lookup_len, m):
            key = (key << 2) | queries[:, j].astype(jnp.int32)
        beg = idx.lookup[key]
        end = idx.lookup[key + 1]
        steps = m - lookup_len

    offs = jnp.full(q, steps, jnp.int32)

    def step(t, carry):
        # walk characters right-to-left (reference: compute_range,
        # fm_index.hpp:224-235); fori_loop keeps compile time flat in
        # pattern length (an unrolled loop made XLA compile superlinear)
        beg, end, offs = carry
        j = steps - 1 - t
        c = lax.dynamic_slice_in_dim(queries, j, 1, axis=1)[:, 0].astype(
            jnp.int32
        )
        nbeg = _lf(idx, c, beg)
        nend = _lf(idx, c, end)
        if early_stop:
            alive = end > beg
            beg = jnp.where(alive, nbeg, beg)
            end = jnp.where(alive, nend, end)
            offs = jnp.where(alive, j, offs)
        else:
            beg, end, offs = nbeg, nend, j * jnp.ones_like(offs)
        return beg, end, offs

    beg, end, offs = lax.fori_loop(0, steps, step, (beg, end, offs))
    return beg, end, offs


@partial(jax.jit, static_argnames=("qlen", "lookup_len", "early_stop"))
def get_range_packed_device(idx: FMArrays, qwords: jnp.ndarray, qlen: int,
                            lookup_len: int, early_stop: bool = True):
    """Backward search over 2-bit PACKED patterns.

    ``qwords``: uint32[Q, ceil(qlen/16)] from
    :func:`kiss_tpu.ops.pack.np_pack_queries_2bit` (symbol j of query q
    at bits ``2*(j%16)`` of word ``j//16``). Semantically identical to
    :func:`get_range_device`; packing cuts the host->device pattern
    transfer 4x. Unpacking one symbol per LF step is a word gather of Q
    elements plus two elementwise ops, next to the occ-table gather the
    step already does.
    """
    q = qwords.shape[0]
    idt = idx.lookup.dtype
    beg = jnp.zeros(q, idt)
    end = jnp.full(q, idx.lookup[-1], idt)
    steps = qlen

    def char_static(j: int):
        return (
            (qwords[:, j // 16] >> jnp.uint32(2 * (j % 16))) & 3
        ).astype(jnp.int32)

    if lookup_len and qlen >= lookup_len:
        # seed from the lookup table on the last lookup_len characters
        # (reference: fm_index.hpp:574-584)
        key = jnp.zeros(q, jnp.int32)
        for j in range(qlen - lookup_len, qlen):
            key = (key << 2) | char_static(j)
        beg = idx.lookup[key]
        end = idx.lookup[key + 1]
        steps = qlen - lookup_len

    offs = jnp.full(q, steps, jnp.int32)

    def step(t, carry):
        beg, end, offs = carry
        j = steps - 1 - t
        w = lax.dynamic_slice_in_dim(qwords, j // 16, 1, axis=1)[:, 0]
        c = ((w >> (2 * (j % 16)).astype(jnp.uint32)) & 3).astype(jnp.int32)
        nbeg = _lf(idx, c, beg)
        nend = _lf(idx, c, end)
        if early_stop:
            alive = end > beg
            beg = jnp.where(alive, nbeg, beg)
            end = jnp.where(alive, nend, end)
            offs = jnp.where(alive, j, offs)
        else:
            beg, end, offs = nbeg, nend, j * jnp.ones_like(offs)
        return beg, end, offs

    beg, end, offs = lax.fori_loop(0, steps, step, (beg, end, offs))
    return beg, end, offs


# chunk size for host batch queries: big enough that the per-dispatch
# cost is amortized, small enough that the host->device transfer of
# chunk i+1 overlaps the backward search of chunk i (dispatch is async)
_Q_CHUNK = 1 << 18


def _ranges_chunked(idx: FMArrays, queries: np.ndarray, lookup_len: int):
    """Pack patterns 2-bit on the host, ship them chunk-wise (transfers
    overlap compute), and return device-resident (beg, end) arrays."""
    from kiss_tpu.ops.pack import np_pack_queries_2bit

    Q, m = queries.shape
    qwords = np_pack_queries_2bit(queries)
    if Q <= _Q_CHUNK:
        parts = [jax.device_put(qwords)]
    else:
        parts = [
            jax.device_put(qwords[i : i + _Q_CHUNK])
            for i in range(0, Q, _Q_CHUNK)
        ]
    outs = [
        get_range_packed_device(idx, part, m, lookup_len) for part in parts
    ]
    if len(outs) == 1:
        beg, end, offs = outs[0]
    else:
        beg = jnp.concatenate([o[0] for o in outs])
        end = jnp.concatenate([o[1] for o in outs])
        offs = jnp.concatenate([o[2] for o in outs])
    return beg, end, offs


@partial(jax.jit, static_argnames=("qlen", "lookup_len"))
def counts_packed_device(idx: FMArrays, qwords: jnp.ndarray, qlen: int,
                         lookup_len: int) -> jnp.ndarray:
    """Per-query occurrence counts (end - beg) for 2-bit packed
    patterns, as uint32. The count-only form of the batch loop
    (reference: include/command/fmindex_query.hpp:66-99 accumulates
    ``occ += end - beg``): keeping only counts quarters the
    device->host payload."""
    beg, end, _ = get_range_packed_device(idx, qwords, qlen, lookup_len)
    return (end - beg).astype(jnp.uint32)


def _counts_chunked(idx: FMArrays, queries: np.ndarray,
                    lookup_len: int) -> np.ndarray:
    """End-to-end host counts: pack, ship chunk-wise, search, and pull
    each chunk's uint32 counts back with ``copy_to_host_async`` as soon
    as its search is dispatched -- chunk i's D2H overlaps chunk i+1's
    transfer and search (everything between the numpy conversions is
    async)."""
    from kiss_tpu.ops.pack import np_pack_queries_2bit

    Q, m = queries.shape
    qwords = np_pack_queries_2bit(queries)
    outs = []
    for i in range(0, Q, _Q_CHUNK):
        part = jax.device_put(qwords[i : i + _Q_CHUNK])
        cnts = counts_packed_device(idx, part, m, lookup_len)
        cnts.copy_to_host_async()
        outs.append(cnts)
    return np.concatenate([np.asarray(c) for c in outs])


_CHK_CHUNK = 128


def _ragged_seg_ids(starts: jnp.ndarray, capacity: int) -> jnp.ndarray:
    """slot -> segment id for a ragged expansion: the LAST segment whose
    exclusive-prefix start is <= slot (the searchsorted(side='right')-1
    contract, which maps slots past zero-length segments sharing a start
    onto their successor). Computed as one scatter-add + one cumsum, two
    passes, where a log2(capacity)-round binary search would gather
    ~22x `capacity` rows at bench scale. Starts past `capacity` are
    dropped; their slots are masked by the caller's validity test."""
    inc = jnp.zeros(capacity, jnp.int32).at[starts].add(1, mode="drop")
    return jnp.cumsum(inc) - 1


@partial(jax.jit, static_argnames=("sa_intv", "capacity"))
def batch_locate_stats_device(
    idx: FMArrays, beg: jnp.ndarray, end: jnp.ndarray, sa_intv: int,
    capacity: int,
):
    """Expand [beg, end) ranges for a query batch into rows on device,
    locate them, and reduce toward the (total occurrences, location
    checksum) pair the reference batch loop accumulates
    (reference: include/command/fmindex_query.hpp:87-94) -- without
    moving per-query arrays to the host.

    ``capacity`` (multiple of 128) must be >= sum(end - beg); row slots
    past the total are masked out. Returns (lo_sums, hi_sums): chunked
    partial sums of the low/high 16 bits of each position. int64 is
    unavailable on-device (no x64), so the exact 64-bit checksum is
    finished on the host as sum(lo) + 2^16 * sum(hi); the chunked int32
    partials cannot overflow (128 * 0xFFFF < 2^23).
    """
    lens = end - beg
    starts = jnp.cumsum(lens) - lens  # exclusive prefix
    r = jnp.arange(capacity, dtype=lens.dtype)
    q = _ragged_seg_ids(starts, capacity)
    rows = beg[q] + (r - starts[q])
    total = starts[-1] + lens[-1]
    valid = r < total
    rows = jnp.where(valid, rows, jnp.zeros((), rows.dtype))
    pos = locate_rows_device(idx, rows, sa_intv).astype(jnp.uint32)
    pos = jnp.where(valid, pos, 0)
    lo = (pos & 0xFFFF).astype(jnp.int32).reshape(-1, _CHK_CHUNK)
    hi = (pos >> 16).astype(jnp.int32).reshape(-1, _CHK_CHUNK)
    return lo.sum(axis=1), hi.sum(axis=1)


@partial(jax.jit, static_argnames=("sa_intv",))
def locate_rows_device(idx: FMArrays, rows: jnp.ndarray, sa_intv: int):
    """Text positions for a set of suffix-array rows.

    Vectorized compute_sa (reference: fm_index.hpp:210-222): masked LF
    walk of at most sa_intv-1 steps until a sampled row, then one gather
    from the sampled SA. This replaces the FMTree BFS queue
    (fm_index.hpp:453-501) with a fixed-depth data-parallel walk.
    """
    if sa_intv == 1:
        return idx.sa_samp[rows]
    idt = idx.sa_samp.dtype
    i = rows.astype(idt)
    steps = jnp.zeros_like(i)
    one = jnp.ones((), idt)
    zero = jnp.zeros((), idt)
    done = _b_at(idx, i)
    for _ in range(sa_intv - 1):
        nxt = _lf_own_symbol(idx, i)
        i = jnp.where(done, i, nxt)
        steps = steps + jnp.where(done, zero, one)
        done = _b_at(idx, i)
    return idx.sa_samp[_b_rank(idx, i)] + steps


def _bfs_emit(idx: FMArrays, beg: jnp.ndarray, end: jnp.ndarray,
              sa_intv: int, capacity: int):
    """Vectorized FMTree BFS (reference: fm_index.hpp:453-501).

    Expands every query range by all 4 symbols per depth -- lf applied
    to RANGE ENDPOINTS only, never per row -- and emits, at each depth d,
    the sa_samp span of marked rows inside each range, +d. Endpoint lf
    is pure counting, so this is exact for an index whose source SA is
    only k-ordered (k >= sa_intv - 1 + pattern length), in particular
    for `.fmi` archives written by the reference binary (its build is
    32-ordered, fm_index.hpp:384-386), where the per-row walk of
    locate_rows_device returns wrong positions on long repeats. The
    reference expands singleton ranges via bwt[beg] only
    (fm_index.hpp:486-489); uniform all-4 expansion is semantically
    identical (the other 3 subranges are empty) and keeps shapes static.

    Each occurrence at text position p is emitted exactly once, at
    depth p % sa_intv, so the total emission count equals
    sum(end - beg); ``capacity`` must be >= that. Returns
    (pos uint32[capacity], valid bool[capacity]) with positions grouped
    query-major (contiguous per query).
    """
    Q = beg.shape[0]
    bs, es = beg[:, None], end[:, None]
    seg_b, seg_l, seg_d = [], [], []
    for d in range(sa_intv):
        rb = _b_rank(idx, bs)
        re = _b_rank(idx, es)
        seg_b.append(rb)
        seg_l.append(re - rb)
        seg_d.append(jnp.full(bs.shape[1], d, jnp.uint32))
        if d + 1 < sa_intv:
            w = bs.shape[1]
            bs = _lf_all4(idx, bs).reshape(Q, 4 * w)
            es = _lf_all4(idx, es).reshape(Q, 4 * w)
    segb = jnp.concatenate(seg_b, axis=1).reshape(-1)
    segl = jnp.concatenate(seg_l, axis=1).reshape(-1)
    segd = jnp.tile(jnp.concatenate(seg_d), (Q,))
    starts = jnp.cumsum(segl) - segl  # exclusive prefix
    r = jnp.arange(capacity, dtype=segl.dtype)
    s = _ragged_seg_ids(starts, capacity)
    total = starts[-1] + segl[-1]
    valid = r < total
    samp = segb[s] + (r - starts[s])
    samp = jnp.where(valid, samp, jnp.zeros((), samp.dtype))
    pos = idx.sa_samp[samp].astype(jnp.uint32) + segd[s]
    return jnp.where(valid, pos, 0), valid


@partial(jax.jit, static_argnames=("sa_intv", "capacity"))
def bfs_locate_device(idx: FMArrays, beg: jnp.ndarray, end: jnp.ndarray,
                      sa_intv: int, capacity: int):
    return _bfs_emit(idx, beg, end, sa_intv, capacity)


@partial(jax.jit, static_argnames=("sa_intv", "capacity"))
def batch_bfs_stats_device(
    idx: FMArrays, beg: jnp.ndarray, end: jnp.ndarray, sa_intv: int,
    capacity: int,
):
    """(lo_sums, hi_sums) checksum partials like
    :func:`batch_locate_stats_device`, but via the range BFS -- the
    locate path for indexes whose SA order is not known fully sorted."""
    pos, valid = _bfs_emit(idx, beg, end, sa_intv, capacity)
    pos = jnp.where(valid, pos, 0)
    lo = (pos & 0xFFFF).astype(jnp.int32).reshape(-1, _CHK_CHUNK)
    hi = (pos >> 16).astype(jnp.int32).reshape(-1, _CHK_CHUNK)
    return lo.sum(axis=1), hi.sum(axis=1)


# ---------------------------------------------------------------------------
# archive provenance sidecar
# ---------------------------------------------------------------------------

# The `.fmi` format records no sort depth (reference: fm_index.hpp:
# 591-646), so a loaded archive cannot know whether its source SA was
# fully sorted -- and locate routing (fast per-row walk vs order-robust
# range BFS, see the SORT_LEN note) depends on exactly that. Rather than
# break byte-compatibility, builds written by THIS tool record their
# provenance in a JSON sidecar next to the archive; reference-written
# archives have no sidecar and keep the conservative BFS routing.
META_SUFFIX = ".meta"
_META_PROBE = 1 << 16  # bytes hashed per probe window (large archives)
_META_STRIDE = 1 << 24  # probe every 16 MiB across large archives
_META_FULL_HASH = 1 << 28  # archives up to 256 MiB are hashed in full


def _archive_fingerprint(fmi_path: str) -> tuple[int, int]:
    """(size, crc32 over 64 KiB windows every 16 MiB plus the tail):
    cheap content binding for the sidecar (ADVICE r4: a sidecar must
    not survive the archive being rebuilt by another writer -- e.g. the
    reference binary's 32-ordered build -- or the stale full_sa flag
    would route locate through the walk and return wrong positions).

    A same-corpus rebuild produces an archive of IDENTICAL size whose
    differences (BWT rows and sampled-SA entries inside tie regions)
    can lie anywhere in the file, so head+tail probing is not enough:
    archives up to ``_META_FULL_HASH`` are hashed in FULL (<= ~0.25 s),
    larger ones (chm13-class, multi-GB) are sampled every 16 MiB plus
    the tail, bounding the read at ~4 MB per GB."""
    import zlib

    size = os.path.getsize(fmi_path)
    crc = 0
    with open(fmi_path, "rb") as f:
        if size <= _META_FULL_HASH:
            while True:
                chunk = f.read(1 << 22)
                if not chunk:
                    break
                crc = zlib.crc32(chunk, crc)
            return size, crc
        for off in range(0, size, _META_STRIDE):
            f.seek(off)
            crc = zlib.crc32(f.read(_META_PROBE), crc)
        f.seek(size - _META_PROBE)
        crc = zlib.crc32(f.read(_META_PROBE), crc)
    return size, crc


def write_meta(fmi_path: str, *, full_sa: bool, sort_len,
               lookup_len: int) -> None:
    """Record build provenance for ``fmi_path`` in ``<path>.meta``,
    bound to the archive's content fingerprint."""
    size, crc = _archive_fingerprint(fmi_path)
    meta = {
        "format": 2,
        "writer": "kiss-tpu",
        "full_sa": bool(full_sa),
        "sort_len": sort_len,
        "lookup_len": int(lookup_len),
        "fmi_size": size,
        "fmi_crc32": crc,
    }
    with open(fmi_path + META_SUFFIX, "w") as f:
        json.dump(meta, f)
        f.write("\n")


def read_meta(fmi_path: str) -> dict | None:
    """Provenance for ``fmi_path``, or None when the sidecar is absent,
    unreadable, or no longer matches the archive's content (the archive
    was rebuilt by a writer that did not refresh the sidecar -- treat it
    as provenance-unknown, exactly like a reference-written archive)."""
    try:
        with open(fmi_path + META_SUFFIX) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(meta, dict):
        return None
    if "fmi_size" in meta:
        try:
            size, crc = _archive_fingerprint(fmi_path)
        except OSError:
            return None
        if meta.get("fmi_size") != size or meta.get("fmi_crc32") != crc:
            return None
    return meta


def _pow2_cap(n: int, base: int) -> int:
    """Power-of-two capacity bucket >= n (bounds the compiled-program
    count across repeated calls with varying sizes). Shared by every
    locate/BFS call site incl. the mesh facade
    (kiss_tpu/parallel/fm_sharded.py) so the single-device and sharded
    paths keep identical padding behavior."""
    cap = base
    while cap < n:
        cap *= 2
    return cap


def _ragged_rows(beg: np.ndarray, lens: np.ndarray):
    """Host-side ragged expansion of per-query [beg, beg+len) row
    ranges: returns (rows int64[R], starts int64[Q+1]) with
    rows[starts[q]:starts[q+1]] belonging to query q."""
    starts = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=starts[1:])
    total = int(starts[-1])
    rows = np.repeat(beg.astype(np.int64), lens) + (
        np.arange(total, dtype=np.int64) - np.repeat(starts[:-1], lens)
    )
    return rows, starts


# ---------------------------------------------------------------------------
# host-facing model
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FMIndex:
    """Host-facing FM-index with the reference's public surface:
    ``build``, ``get_range``, ``get_offsets``, ``save``, ``load``.

    Template parameters of the reference class become constructor
    arguments; the CLI instantiation is ``FMIndex(sa_intv=4,
    lookup_len=0)`` (reference: include/command/fmindex_build.hpp:27-29).
    """

    sa_intv: int = 4
    lookup_len: int = 0
    arrays: FMArrays | None = None
    n_rows: int = 0  # N = n + 1
    # force the uint32 index dtype on small corpora (testing hook; texts
    # with n + 1 >= 2**31 switch automatically, see _index_dtype)
    force_u32: bool = False
    # True when the index is known built from a FULLY sorted SA: locate
    # may use the fast per-row LF walk. False (bounded-sort_len builds,
    # archives loaded from disk): locate uses the range BFS, the
    # reference's own semantics (see the SORT_LEN note above).
    full_sa: bool = True

    @property
    def index_dtype(self):
        return _index_dtype(self.n_rows, self.force_u32)

    # -- build ------------------------------------------------------------

    def build(
        self, ref: np.ndarray, sa=None, sort_len: int | None = SORT_LEN
    ) -> "FMIndex":
        """Build from an int8 reference (values 0..3). Unless a suffix
        array is supplied, sorts the full suffix order (see SORT_LEN
        note; the reference's counterpart is fm_index.hpp:379-388)."""
        ref = np.ascontiguousarray(ref, dtype=np.int8)
        idt = _index_dtype(len(ref) + 1, self.force_u32)
        if sa is None:
            self.full_sa = (
                sort_len is None or sort_len < 0 or sort_len >= len(ref)
            )
            sa = k_ordered_suffix_array(
                ref, -1 if sort_len is None else sort_len, as_numpy=False,
                force_u32=self.force_u32,
            )
        sa = jnp.asarray(np.asarray(sa).astype(idt)) if isinstance(
            sa, np.ndarray
        ) else sa.astype(idt)
        with timing.stage("fmindex build") as out:
            arrays = build_index_device(
                jnp.asarray(ref), sa, self.sa_intv, self.force_u32
            )
            out["block_on"] = arrays
        self.arrays = arrays
        self.n_rows = len(ref) + 1
        self._build_lookup()
        return self

    def _build_lookup(self) -> None:
        """Vectorized build_lookup (reference: fm_index.hpp:237-269): the
        reference fans a backward search of every fixed-length seed out
        over std::threads; here it is one batched get_range call."""
        N = self.n_rows
        idt = self.index_dtype
        if self.lookup_len == 0:
            lookup = jnp.array([0, N], idt)
        else:
            # seeds generated on device: the 4^L x L host array would
            # otherwise dominate build time over slow host->device links
            L = self.lookup_len
            keys = jnp.arange(4**L, dtype=jnp.int32)
            shifts = 2 * jnp.arange(L - 1, -1, -1, dtype=jnp.int32)
            seeds = ((keys[:, None] >> shifts[None, :]) & 3).astype(jnp.int8)
            beg, _end, _ = get_range_device(
                self.arrays, seeds, 0, early_stop=False
            )
            lookup = jnp.concatenate(
                [beg.astype(idt), jnp.array([N], idt)]
            )
        self.arrays = self.arrays._replace(lookup=lookup)

    # -- queries ----------------------------------------------------------

    def get_range(self, query: np.ndarray):
        """Single-pattern range; returns (beg, end, offs)."""
        beg, end, offs = self.get_ranges(
            np.asarray(query, dtype=np.int8)[None, :]
        )
        return int(beg[0]), int(end[0]), int(offs[0])

    def get_ranges(self, queries: np.ndarray):
        """Batch backward search: queries int8[Q, m] -> 3 x int32[Q].

        Patterns cross to the device 2-bit packed in chunks (see
        :func:`get_range_packed_device`)."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        beg, end, offs = _ranges_chunked(
            self.arrays, queries, self.lookup_len
        )
        # start all three D2H transfers before blocking on any of them
        for x in (beg, end, offs):
            if hasattr(x, "copy_to_host_async"):
                x.copy_to_host_async()
        return np.asarray(beg), np.asarray(end), np.asarray(offs)

    def counts(self, queries: np.ndarray) -> np.ndarray:
        """Per-query occurrence counts, uint32[Q] -- the count-only
        batch loop (reference: include/command/fmindex_query.hpp:66-99
        with the locate body skipped). Only counts cross back to the
        host, chunk-overlapped (see :func:`_counts_chunked`)."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        if queries.size == 0:
            return np.empty(0, dtype=np.uint32)
        return _counts_chunked(self.arrays, queries, self.lookup_len)

    def locate_rows(self, rows: np.ndarray) -> np.ndarray:
        idt = np.dtype(self.index_dtype)
        rows = np.ascontiguousarray(rows).astype(idt)
        if rows.size == 0:
            return np.empty(0, dtype=np.uint32)
        # pad to a power-of-two bucket so repeated queries with varying
        # occurrence counts reuse a handful of compiled programs (row 0
        # is always a valid row; pads are sliced away)
        padded = np.zeros(_pow2_cap(rows.size, 64), dtype=idt)
        padded[: rows.size] = rows
        out = locate_rows_device(
            self.arrays, jnp.asarray(padded), self.sa_intv
        )
        return np.asarray(out[: rows.size]).astype(np.uint32)

    def _bfs_positions(self, beg, end) -> np.ndarray:
        """Positions for per-query ranges via the vectorized range BFS
        (grouped query-major; exact on any k-ordered source SA)."""
        idt = np.dtype(self.index_dtype)
        beg = np.atleast_1d(np.asarray(beg)).astype(idt)
        end = np.atleast_1d(np.asarray(end)).astype(idt)
        total = int((end - beg).sum())
        if total == 0:
            return np.empty(0, dtype=np.uint32)
        cap = _pow2_cap(total, 64)
        pos, _valid = bfs_locate_device(
            self.arrays, jnp.asarray(beg), jnp.asarray(end),
            self.sa_intv, cap,
        )
        return np.asarray(pos[:total]).astype(np.uint32)

    def get_offsets(self, beg: int, end: int) -> np.ndarray:
        """Positions for one row range (reference: fm_index.hpp:453-501).
        Same result set as the FMTree BFS: computed by the vectorized LF
        walk when the index is known built from a fully sorted SA, and
        by the vectorized BFS itself otherwise (loaded archives,
        bounded-sort_len builds)."""
        if self.sa_intv == 1 or self.full_sa:
            return self.locate_rows(np.arange(beg, end, dtype=np.int32))
        return self._bfs_positions(beg, end)

    def get_offsets_traditional(self, beg: int, end: int) -> np.ndarray:
        """Alias of :meth:`get_offsets` for API parity: the reference's
        "traditional" per-row LF walk (fm_index.hpp:435-447) IS the
        data-parallel formulation we use everywhere."""
        return self.get_offsets(beg, end)

    def fmtree(self, seed: np.ndarray) -> np.ndarray:
        """Locate by first searching seed[1:] then extending by the first
        character (reference: fm_index.hpp:503-551). With the vectorized
        locate the staging is unnecessary, but the entry point and result
        set match the reference method."""
        seed = np.asarray(seed, dtype=np.int8)
        beg, end, _ = self.get_range(seed)
        return self.get_offsets(beg, end)

    def batch_query(self, queries: np.ndarray):
        """Count + locate a batch of equal-length patterns.

        Returns (counts int64[Q], positions uint32[R], starts int64[Q+1])
        where positions[starts[q]:starts[q+1]] belong to query q. This is
        the batched device form of the reference batch loop
        (reference: include/command/fmindex_query.hpp:66-99).
        """
        beg, end, _ = self.get_ranges(queries)
        lens = (end - beg).astype(np.int64)
        # ragged row materialization on host (sizes only known post-range)
        rows, starts = _ragged_rows(beg, lens)
        if self.sa_intv != 1 and not self.full_sa:
            # BFS emission is grouped query-major, so the same starts
            # partition applies
            return lens, self._bfs_positions(beg, end), starts
        positions = self.locate_rows(rows)
        return lens, positions, starts

    def batch_query_stats(self, queries: np.ndarray) -> tuple[int, int]:
        """(total occurrences, location checksum) for a batch -- the two
        accumulators of the reference batch loop (reference:
        include/command/fmindex_query.hpp:87-94). Everything except two
        scalars stays on device."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        if queries.size == 0:
            return 0, 0
        beg, end, _ = _ranges_chunked(self.arrays, queries, self.lookup_len)
        total = int(jnp.sum(end - beg))
        if total == 0:
            return 0, 0
        cap = _pow2_cap(total, 128)
        kernel = (
            batch_locate_stats_device
            if self.sa_intv == 1 or self.full_sa
            else batch_bfs_stats_device
        )
        lo, hi = kernel(self.arrays, beg, end, self.sa_intv, cap)
        checksum = int(np.asarray(lo, dtype=np.int64).sum()) + (
            int(np.asarray(hi, dtype=np.int64).sum()) << 16
        )
        return total, checksum

    # -- serialization ----------------------------------------------------

    def save(self, fout) -> None:
        """Byte-compatible ``.fmi`` writer (reference: fm_index.hpp:
        591-615 + serializer.hpp layout).

        All device->host section transfers are started asynchronously up
        front, then sections stream to disk in archive order, so the
        transfers overlap each other and the disk writes."""
        a = self.arrays
        for x in (a.cnt, a.pri, a.bwt_words, a.occ1, a.occ2, a.sa_samp,
                  a.lookup, a.b_words, a.b_occ):
            if hasattr(x, "copy_to_host_async"):
                x.copy_to_host_async()
        N = self.n_rows
        cnt = np.asarray(a.cnt).astype(np.uint32)
        fout.write(cnt.tobytes())
        fout.write(np.uint32(np.asarray(a.pri)).tobytes())
        # bwt: element count = N, payload = ceil(N/4) bytes
        bwt_bytes = (
            np.asarray(a.bwt_words).astype("<u4").tobytes()[
                : serializer.dibit_bytes(N)
            ]
        )
        serializer.save_range(fout, N, bwt_bytes)
        occ1 = np.asarray(a.occ1).astype("<u4")
        serializer.save_range(fout, occ1.shape[0], occ1)
        occ2 = np.asarray(a.occ2).astype(np.uint8)
        serializer.save_range(fout, occ2.shape[0], occ2)
        sa_samp = np.asarray(a.sa_samp).astype("<u4")
        serializer.save_range(fout, sa_samp.shape[0], sa_samp)
        lookup = np.asarray(a.lookup).astype("<u4")
        serializer.save_range(fout, lookup.shape[0], lookup)
        if self.sa_intv != 1:
            b_bytes = (
                np.asarray(a.b_words).astype("<u4").tobytes()[
                    : serializer.bit_u64_bytes(N)
                ]
            )
            serializer.save_range(fout, N, b_bytes)
            b_occ = np.asarray(a.b_occ).astype("<u4")
            serializer.save_range(fout, b_occ.shape[0], b_occ)

    def load(self, fin) -> "FMIndex":
        """Byte-compatible ``.fmi`` reader (reference: fm_index.hpp:
        620-646)."""
        cnt = np.frombuffer(fin.read(16), dtype="<u4").copy()
        pri = np.frombuffer(fin.read(4), dtype="<u4")[0]
        N, bwt_raw = serializer.load_range(fin, serializer.dibit_bytes)
        pad = -len(bwt_raw) % 4
        bwt_words = np.frombuffer(bwt_raw + b"\0" * pad, dtype="<u4").copy()
        n1, occ1_raw = serializer.load_range(fin, serializer.scalar_bytes(16))
        occ1 = np.frombuffer(occ1_raw, dtype="<u4").reshape(n1, 4).copy()
        n2, occ2_raw = serializer.load_range(fin, serializer.scalar_bytes(4))
        occ2 = np.frombuffer(occ2_raw, dtype=np.uint8).reshape(n2, 4).copy()
        ns, sa_raw = serializer.load_range(fin, serializer.scalar_bytes(4))
        sa_samp = np.frombuffer(sa_raw, dtype="<u4").copy()
        nl, lut_raw = serializer.load_range(fin, serializer.scalar_bytes(4))
        lookup = np.frombuffer(lut_raw, dtype="<u4").copy()
        if self.sa_intv != 1:
            nb, b_raw = serializer.load_range(fin, serializer.bit_u64_bytes)
            assert nb == N
            padb = -len(b_raw) % 4
            b_words = np.frombuffer(b_raw + b"\0" * padb, dtype="<u4").copy()
            nbo, bo_raw = serializer.load_range(
                fin, serializer.scalar_bytes(4)
            )
            b_occ = np.frombuffer(bo_raw, dtype="<u4").copy()
        else:
            b_words = np.zeros(1, np.uint32)
            b_occ = np.zeros(1, np.uint32)
        if fin.read(1):
            raise ValueError(".fmi archive has trailing bytes")

        self.n_rows = N
        # archive provenance is unknown (the `.fmi` format records no
        # sort depth; the reference binary writes 32-ordered indexes) --
        # locate must use the order-robust BFS path
        self.full_sa = False
        self.lookup_len = max(len(lookup) - 1, 1).bit_length() // 2
        idt = np.dtype(_index_dtype(N, self.force_u32))
        occ1_d = jnp.asarray(occ1.astype(idt))
        occ2_d = jnp.asarray(occ2.astype(np.int32))
        bwt_words_d = jnp.asarray(bwt_words)
        b_words_d = jnp.asarray(b_words)
        b_occ_d = jnp.asarray(b_occ.astype(idt))
        self.arrays = FMArrays(
            bwt_words=bwt_words_d,
            occ1=occ1_d,
            occ2=occ2_d,
            cnt=jnp.asarray(cnt.astype(idt)),
            pri=jnp.asarray(pri.astype(idt)),
            sa_samp=jnp.asarray(sa_samp.astype(idt)),
            b_words=b_words_d,
            b_occ=b_occ_d,
            lookup=jnp.asarray(lookup.astype(idt)),
            lf_tab=_fuse_lf_tab(occ1_d, occ2_d, bwt_words_d),
            b_tab=_fuse_b_tab(b_occ_d, b_words_d),
        )
        return self

    def __eq__(self, other) -> bool:
        if not isinstance(other, FMIndex):
            return NotImplemented
        if self.n_rows != other.n_rows or self.sa_intv != other.sa_intv:
            return False
        return all(
            np.array_equal(np.asarray(x), np.asarray(y))
            for x, y in zip(self.arrays, other.arrays)
        )
