"""k-ordered suffix array construction on the accelerator.

The reference builds k-ordered suffix arrays with two CPU strategies:
kISS-1 "PARALLEL_SORTING" (per-bucket AVX2 comparison sorts of LMS
suffixes + induced L/S scans, reference:
include/biovoltron/algo/sort/kiss1_core.hpp) and kISS-2 "PREFIX_DOUBLING"
(super-character encoding + rank doubling with segment sorts/merges,
reference: include/biovoltron/algo/sort/kiss2_core.hpp). Both are built
from CPU idioms -- pointer-chasing induced scans, per-thread bucket
cursors, comparison sorts -- that do not map to whole-array device
programs.

This module re-expresses the same *problem* (sort every suffix by its
first k characters, ties broken by text position, sentinel/empty suffix
first -- reference semantics: kiss1_core.hpp:94-135 comparator, ties at
>= k chars resolved by ``i < j``) in a device dataflow built almost
entirely from whole-array sorts and shifted slices -- no random gathers
or scatters on the bounded-k path. The design minimizes SORT OPERANDS
and avoids gathers (how XLA:GPU prices one against the other is not
measured on the H100 yet; ROADMAP queue 1 items 2-3):

  1. Seed: pack the first 32 characters of every suffix into raw 2-bit
     words (16 chars per uint32) plus one word fusing the clamped
     suffix length (shorter-first end-of-text rule) and the text
     position, and run ONE UNSTABLE total-order ``lax.sort`` -- 3
     operands. The fused position makes the key tuple a total order, so
     stability machinery is unnecessary and the ``i < j`` tie rule
     still falls out.
  2. Rank: group heads by compare-adjacent + ``cummax`` segmented scan;
     the position-major rank array is rebuilt by sorting (sa, rank) by
     sa (a 2-operand sort in place of a random scatter).
  3. Rank-block sort: because every rank key covers the SAME block
     length L, lexicographic order of (rank_L[p], rank_L[p+L],
     rank_L[p+2L], ...) IS the order of the concatenated blocks -- and
     in position-major layout each rank_L[p+jL] operand is a pure
     shifted slice. The 8 rank keys + position are BIT-PACKED at their
     true widths (``_pack_fields``) into the fewest uint32 words -- 8
     operands instead of 9 for k=256 at genome scale -- and one
     unstable sort lands exactly on k characters: k=256 is seed(32) +
     rank rebuild + one packed 8-key sort. This generalizes kISS-2's
     prefix doubling (a chain of 2-key rank sorts) to a single wide
     sort with zero random memory traffic.
  4. Exact-k remainders smaller than a full block are closed with saved
     rank levels (greedy decomposition) and raw packed words, so ties
     beyond exactly k characters are never consulted -- matching the
     kISS-1 comparator's exact-k cut, not kISS-2's power-of-two
     overshoot.

Bounded k compiles to ONE static XLA program (shardable under GSPMD);
unbounded (-1) runs the same wide sort in a short host-driven loop with
an all-singleton early exit (coverage multiplies by 8 per round).
Positions and ranks use int32 below 2**31 and uint32 up to chm13 scale
(``_pos_dtype``); single-operand u32 lanes cover every real genome.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial, reduce

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from kiss_tpu.ops import pack
from kiss_tpu.utils import timing

SEED_WORDS = 4  # 64 chars for DNA (2-bit packed), 12 for general
MAX_RANK_KEYS = 8  # widest rank-block sort; coverage multiplies by this


def _seed_max(alphabet: pack.Alphabet) -> int:
    """Widest seed the seed sort covers in SEED_WORDS raw words. DNA uses
    the 2-bit fast path (16 chars/word; end-of-text + position fused into
    ONE extra word by :func:`pack.fused_end_pos`), so 64 chars cost 5
    sort operands -- fewer total sorted words than a 32-char seed plus a
    wider rank-block round."""
    if alphabet is pack.DNA:
        return SEED_WORDS * 16
    return SEED_WORDS * alphabet.chars_per_word


# ---------------------------------------------------------------------------
# static planning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Round:
    # each round sorts by [rank_lv at offset] keys then raw tail words
    rank_keys: tuple[tuple[int, int], ...]  # (level_chars, char_offset)
    tail_chars: int  # raw-word chars at tail_offset (< seed)
    tail_offset: int
    new_cover: int  # characters covered after this round


@dataclass(frozen=True)
class _SortPlan:
    seed_chars: int
    rounds: tuple[_Round, ...]
    unbounded: bool

    @property
    def save_levels(self) -> frozenset[int]:
        lvls = set()
        for r in self.rounds:
            lvls.update(lv for lv, _ in r.rank_keys)
        return frozenset(lvls)


def _decompose(target: int, levels: list[int], seed: int):
    """Greedy cover of ``target`` chars: full blocks of the largest
    levels first, then a raw-word tail smaller than the seed."""
    keys = []
    off = 0
    rem = target
    for lv in sorted(levels, reverse=True):
        while lv <= rem and len(keys) < 3 * MAX_RANK_KEYS:
            keys.append((lv, off))
            off += lv
            rem -= lv
    assert rem < seed, (target, levels, rem)
    return keys, rem, off


def _make_plan(
    n: int, k: int | None, alphabet: pack.Alphabet,
    seed_chars: int | None = None, max_keys: int = MAX_RANK_KEYS,
) -> _SortPlan:
    """Round plan. The default (wide) shape is the PARALLEL_SORTING
    strategy: a seed as wide as SEED_WORDS raw words, then rounds of up
    to MAX_RANK_KEYS rank keys (coverage x8/round). ``seed_chars`` /
    ``max_keys`` reshape it -- PREFIX_DOUBLING passes (16, 2): a
    16-char super-char seed (exactly kISS-2's l = 16 bases per uint32
    encoding, reference: kiss2_core.hpp:862-863) and 2-key doubling
    rounds (rank[p], rank[p + cover] -- the reference's sort_sa_blocks
    key pair, kiss2_core.hpp:102-111,251), coverage x2/round."""
    seed_max = seed_chars or _seed_max(alphabet)
    seed_max = min(seed_max, _seed_max(alphabet))
    unbounded = k is None or k < 0 or k > n
    if unbounded:
        # comparing n characters fully distinguishes all suffixes
        # (reference: k = -1 wraps to SIZE_MAX, README.md:56); rounds of
        # max_keys full blocks until the early exit fires
        rounds = []
        cover = seed_max
        while cover < n:
            rounds.append(
                _Round(
                    tuple((cover, j * cover) for j in range(max_keys)),
                    0,
                    0,
                    cover * max_keys,
                )
            )
            cover *= max_keys
        return _SortPlan(seed_max, tuple(rounds), True)

    if k <= seed_max:
        return _SortPlan(max(k, 1), (), False)

    rounds = []
    levels = [seed_max]
    cover = seed_max
    while cover < k:
        # how far can one round reach with full blocks of known levels?
        reach = cover * max_keys
        if reach >= k:
            keys, tail, off = _decompose(k, levels, seed_max)
            rounds.append(_Round(tuple(keys), tail, off, k))
            cover = k
        else:
            rounds.append(
                _Round(
                    tuple((cover, j * cover) for j in range(max_keys)),
                    0,
                    0,
                    reach,
                )
            )
            levels.append(reach)
            cover = reach
    return _SortPlan(seed_max, tuple(rounds), False)


# ---------------------------------------------------------------------------
# device helpers
# ---------------------------------------------------------------------------


def _field_layout(specs):
    """Static layout for :func:`_pack_fields`. ``specs`` is a list of
    (bits, align) pairs; returns (placements, n_words) where each
    placement is (start_bit, bits) with start measured from the MSB of
    word 0. ``align`` forces the field to not straddle a word boundary
    (required for fields extracted back out after sorting)."""
    placements = []
    pos = 0
    for bits, align in specs:
        assert 1 <= bits <= 32
        if align and pos // 32 != (pos + bits - 1) // 32:
            pos = (pos // 32 + 1) * 32
        placements.append((pos, bits))
        pos += bits
    return placements, -(-pos // 32)


def _pack_fields(fields):
    """Pack (array, bits, align) fields, most-significant first, into
    uint32 words whose lexicographic (unsigned) order equals the order
    of the field tuples.

    This is the operand-compression step that lets one unstable
    ``lax.sort`` carry e.g. eight 26-bit rank keys plus a position in 8
    words instead of 9 stable operands. Returns (words, placements).
    """
    placements, n_words = _field_layout([(b, a) for _, b, a in fields])
    n = fields[0][0].shape[0]
    acc: list = [None] * n_words
    for (arr, bits, _), (start, _) in zip(fields, placements):
        arr = arr.astype(jnp.uint32)
        if bits < 32:
            arr = arr & jnp.uint32((1 << bits) - 1)
        end = start + bits
        w0, w1 = start // 32, (end - 1) // 32
        if w0 == w1:
            piece = arr << (32 * (w0 + 1) - end)
            acc[w0] = piece if acc[w0] is None else acc[w0] | piece
        else:
            spill = end - 32 * (w0 + 1)
            hi, lo = arr >> spill, arr << (32 - spill)
            acc[w0] = hi if acc[w0] is None else acc[w0] | hi
            acc[w1] = lo if acc[w1] is None else acc[w1] | lo
    zeros = jnp.zeros(n, dtype=jnp.uint32)
    return [w if w is not None else zeros for w in acc], placements


def _extract_field(words, placement):
    start, bits = placement
    w, shift = start // 32, 32 * (start // 32 + 1) - (start + bits)
    assert start // 32 == (start + bits - 1) // 32, "field straddles"
    return (words[w] >> shift) & jnp.uint32((1 << bits) - 1)


def _mask_field(words, placement):
    """Zero one (non-straddling) field out of the packed words, for
    group-identity comparisons that must ignore the position bits."""
    start, bits = placement
    w = start // 32
    shift = 32 * (w + 1) - (start + bits)
    cleaned = words[w] & ~jnp.uint32(((1 << bits) - 1) << shift)
    return [cleaned if i == w else x for i, x in enumerate(words)]


def _neq_adjacent(sorted_keys) -> jnp.ndarray:
    neq = reduce(
        jnp.logical_or,
        [ks != jnp.roll(ks, 1) for ks in sorted_keys],
    )
    return neq.at[0].set(True)


def _rank_shift(rank: jnp.ndarray, offset: int) -> jnp.ndarray:
    """Position-major lookup rank[p+offset] with 0 past the end, as a
    pure slice+pad -- no gather. (Past-end compares smallest: the
    reference's ``get_key`` returns 0 there, kiss2_core.hpp:102-111.)"""
    if offset == 0:
        return rank
    N = rank.shape[0]
    off = min(offset, N)
    return jnp.concatenate([rank[off:], jnp.zeros(off, rank.dtype)])


def _rank_by_position(sa: jnp.ndarray, rank_sorted: jnp.ndarray,
                      sort_impl=lax.sort):
    """Invert the sorted-order rank to position-major by sorting
    (sa, rank) by sa: for a permutation this equals the scatter
    rank[sa] = rank_sorted, without issuing one."""
    _, rank = sort_impl((sa, rank_sorted), num_keys=1, is_stable=False)
    return rank


def _pos_dtype(n: int, force_u32: bool = False):
    """Dtype for text positions/ranks: int32 when they fit (faster,
    plays well with downstream int indexing), uint32 for chm13-scale
    texts whose positions exceed 2**31 - 1 (n < 2**32 always: SA entries
    and ranks are single u32 lanes by design; see ROADMAP chm13 item).
    ``force_u32`` lets tests run the uint32 path on small corpora."""
    return jnp.uint32 if force_u32 or n >= 2**31 else jnp.int32


def _ranks_of_sorted(sorted_keys, sa, sort_impl=lax.sort):
    """(position-major rank, all-singleton flag) from a sorted key set."""
    N = sa.shape[0]
    pos = jnp.arange(N, dtype=sa.dtype)
    neq = _neq_adjacent(sorted_keys)
    # a sharded sort facade brings the scan that matches its sharding
    cummax = getattr(sort_impl, "cummax", lax.cummax)
    head = cummax(jnp.where(neq, pos, jnp.zeros((), sa.dtype)))
    rank = _rank_by_position(sa, head + 1, sort_impl)
    nxt = jnp.concatenate([neq[1:], jnp.ones(1, bool)])
    done = jnp.all(neq & nxt)
    return rank, done


# ---------------------------------------------------------------------------
# jitted cores
# ---------------------------------------------------------------------------


def _seed_sort_impl(text, seed_chars: int, alphabet, with_rank: bool,
                    sort_impl=lax.sort, force_u32: bool = False):
    """Sort of all n+1 suffixes by the first ``seed_chars`` characters
    (shorter-first at end of text, then ascending position -- the full
    reference comparator contract, kiss1_core.hpp:94-135). Returns
    (sa, rank, done); rank/done are dummies when ``with_rank`` is False
    (i.e. the seed alone covers k).

    DNA fast path: raw 2-bit packed words (16 chars/operand) plus ONE
    word fusing the end-of-text rule with the position
    (:func:`pack.fused_end_pos` -- bit_length(n) bits for any seed
    width), run as one UNSTABLE total-order sort: 5 operands for the
    standard 64-char seed, at chm13 scale included.
    """
    n = text.shape[0]
    if alphabet is pack.DNA:
        words2 = pack.suffix_key_words_2bit(text, seed_chars, 0)
        fused = pack.fused_end_pos(n, seed_chars)
        fbits = max(int(n).bit_length(), 1)
        packed, places = _pack_fields(
            [(w, 32, False) for w in words2] + [(fused, fbits, True)]
        )
        ops = sort_impl(tuple(packed), num_keys=len(packed), is_stable=False)
        fused_s = _extract_field(ops, places[-1])
        cov = jnp.uint32(seed_chars)
        sa = jnp.where(
            fused_s < cov, jnp.uint32(n) - fused_s, fused_s - cov
        ).astype(_pos_dtype(n, force_u32))
        if not with_rank:
            return sa, sa, jnp.bool_(True)
        # group identity = raw key words + clamped length (decoded from
        # the fused word; its position part must NOT split groups)
        lenc = jnp.minimum(fused_s, cov)
        rank, done = _ranks_of_sorted(
            list(ops[:-1]) + [lenc], sa, sort_impl
        )
        return sa, rank, done

    pos = jnp.arange(n + 1, dtype=_pos_dtype(n, force_u32))
    words = pack.suffix_key_words(text, seed_chars, 0, alphabet)
    ops = sort_impl(tuple(words) + (pos,), num_keys=len(words), is_stable=True)
    sa = ops[-1]
    if not with_rank:
        return sa, sa, jnp.bool_(True)
    rank, done = _ranks_of_sorted(ops[:-1], sa, sort_impl)
    return sa, rank, done


_seed_sort = partial(
    jax.jit,
    static_argnames=(
        "seed_chars", "alphabet", "with_rank", "sort_impl", "force_u32"
    ),
)(_seed_sort_impl)


def _full_round_impl(text, rank, cover, n_keys: int, with_rank: bool,
                     sort_impl=lax.sort, force_u32: bool = False):
    """One wide stable sort by ``n_keys`` shifted copies of the current
    rank level at offsets 0, cover, 2*cover, ... -- covering
    n_keys*cover characters. ``cover`` is a TRACED scalar, so one
    compiled program serves every doubling round of an unbounded sort
    (shifts become clamped dynamic slices into the zero-padded rank:
    starts beyond N clamp into the zero region, which is exactly the
    past-end-is-smallest rule)."""
    n = text.shape[0]
    N = n + 1
    padded = jnp.concatenate([rank, jnp.zeros(N, rank.dtype)])
    keys = [
        lax.dynamic_slice(padded, (cover * j,), (N,)) for j in range(n_keys)
    ]
    rank_bits = max(int(N).bit_length(), 1)
    posbits = max(int(n).bit_length(), 1)
    pos = jnp.arange(N, dtype=jnp.uint32)
    packed, places = _pack_fields(
        [(k, rank_bits, False) for k in keys] + [(pos, posbits, True)]
    )
    ops = sort_impl(tuple(packed), num_keys=len(packed), is_stable=False)
    sa = _extract_field(ops, places[-1]).astype(_pos_dtype(n, force_u32))
    if not with_rank:
        return sa, sa, jnp.bool_(True)
    rank2, done = _ranks_of_sorted(
        _mask_field(list(ops), places[-1]), sa, sort_impl
    )
    return sa, rank2, done


_full_round = partial(
    jax.jit,
    static_argnames=("n_keys", "with_rank", "sort_impl", "force_u32"),
)(_full_round_impl)


@partial(jax.jit, static_argnames=("sort_impl",))
def _active_rows_of(sa, rank, sort_impl=lax.sort):
    """Row-space flags + count of suffixes in unresolved tie groups."""
    key_sorted = rank[sa]
    neq = _neq_adjacent((key_sorted,))
    nxt = jnp.concatenate([neq[1:], jnp.ones(1, bool)])
    active = ~(neq & nxt)
    return active, jnp.sum(active, dtype=jnp.uint32)


# column width for the 2-D nonzero in _compact_rows: row ids above 2**31
# cannot come out of a flat jnp.nonzero (int32 result type under no-x64),
# so active flags are reshaped to [*, 2**16] and the two small index
# halves are recombined in uint32
_NZ_COLS = 1 << 16


@partial(jax.jit, static_argnames=("capacity",))
def _compact_rows(active, capacity: int):
    """Ascending active row ids zero-filled to a static capacity (the
    dataflow form of kISS-2's compact, reference: kiss2_core.hpp:
    464-536). Fill entries alias row 0 -- the sentinel row, whose rank 1
    is the global minimum, so downstream sorts park them harmlessly at
    the front and their writes re-store the unchanged sentinel.

    Row ids are assembled from a 2-D nonzero so they stay exact past
    2**31 (chm13-scale N); the result dtype follows the caller's need
    via the uint32 recombination."""
    N = active.shape[0]
    if N < 2**31 - _NZ_COLS:
        (rows,) = jnp.nonzero(active, size=capacity, fill_value=0)
        return rows.astype(jnp.int32)
    nrows = -(-N // _NZ_COLS)
    act2 = jnp.zeros(nrows * _NZ_COLS, bool).at[:N].set(active)
    hi, lo = jnp.nonzero(
        act2.reshape(nrows, _NZ_COLS), size=capacity, fill_value=0
    )
    return hi.astype(jnp.uint32) * jnp.uint32(_NZ_COLS) + lo.astype(
        jnp.uint32
    )


@partial(jax.jit, donate_argnames=("sa", "rank"))
def _tail_refine(sa, rank, rows, cover):
    """One compacted refinement round for the deep tail of an unbounded
    sort: re-sorts only suffixes still in tie groups by MAX_RANK_KEYS
    shifted rank lookups (small gathers -- affordable at tail sizes),
    writes the new order back into their own rows, updates ranks, and
    re-compacts. Returns (sa, rank, rows_next, m_next).

    All index arithmetic is wrap-proof in the sa dtype (uint32 at chm13
    scale): the past-end test for key j is ``cover <= (n - p) // j``,
    which never forms the (possibly overflowing) product cover * j for
    the entries it rejects."""
    n = sa.shape[0] - 1
    nv = jnp.asarray(n, sa.dtype)
    p = sa[rows]
    keys = [rank[p]]  # offset 0: always in range
    for j in range(1, MAX_RANK_KEYS):
        valid = cover <= (nv - p) // jnp.asarray(j, sa.dtype)
        q = p + cover * jnp.asarray(j, sa.dtype)  # exact where valid
        keys.append(
            jnp.where(valid, rank[jnp.minimum(q, nv)], 0)
        )
    ops = lax.sort(
        tuple(keys) + (p,), num_keys=MAX_RANK_KEYS, is_stable=True
    )
    ps = ops[-1]
    trows = jnp.sort(rows)
    sa = sa.at[trows].set(ps)

    m = rows.shape[0]
    neq = _neq_adjacent(ops[:-1])
    head = lax.cummax(jnp.where(neq, trows, jnp.zeros((), trows.dtype)))
    is_fill = ps == nv
    rank = rank.at[ps].set(
        jnp.where(is_fill, jnp.ones((), rank.dtype), head.astype(rank.dtype) + 1)
    )

    nxt = jnp.concatenate([neq[1:], jnp.ones(1, bool)])
    still = ~(neq & nxt) & ~is_fill
    # keep indexes the m-sized compacted set (m < 2**31 always): int32
    (keep,) = jnp.nonzero(still, size=m, fill_value=-1)
    rows_next = jnp.where(
        keep >= 0, trows[jnp.maximum(keep, 0)], jnp.zeros((), trows.dtype)
    )
    return (
        sa, rank, rows_next.astype(rows.dtype),
        jnp.sum(still, dtype=jnp.uint32),
    )


def _rank_block_sort_impl(text, rank_arrays, level_ids, rank_key_spec,
                          tail_chars, tail_offset, alphabet,
                          with_rank: bool, sort_impl=lax.sort,
                          force_u32: bool = False):
    """One wide stable sort by shifted rank-level keys (+ optional raw
    tail words). ``rank_arrays`` is a tuple aligned with ``level_ids``;
    ``rank_key_spec`` is ((level, offset), ...)."""
    n = text.shape[0]
    ranks = dict(zip(level_ids, rank_arrays))
    rank_bits = max(int(n + 1).bit_length(), 1)
    posbits = max(int(n).bit_length(), 1)
    fields = [
        (_rank_shift(ranks[lv], off), rank_bits, False)
        for lv, off in rank_key_spec
    ]
    if tail_chars:
        fields.extend(
            (w, 32, False)
            for w in pack.suffix_key_words(
                text, tail_chars, tail_offset, alphabet
            )
        )
    pos = jnp.arange(n + 1, dtype=jnp.uint32)
    packed, places = _pack_fields(fields + [(pos, posbits, True)])
    ops = sort_impl(tuple(packed), num_keys=len(packed), is_stable=False)
    sa = _extract_field(ops, places[-1]).astype(_pos_dtype(n, force_u32))
    if not with_rank:
        return sa, sa, jnp.bool_(True)
    rank, done = _ranks_of_sorted(
        _mask_field(list(ops), places[-1]), sa, sort_impl
    )
    return sa, rank, done


_rank_block_sort = partial(
    jax.jit,
    static_argnames=("rank_key_spec", "tail_chars", "tail_offset",
                     "alphabet", "with_rank", "level_ids", "sort_impl",
                     "force_u32"),
)(_rank_block_sort_impl)


def _next_capacity(m: int, cap: int) -> int:
    c = 1024
    while c < m:
        c *= 2
    return min(c, cap)


# unbounded sorts switch from full-array wide sorts to compacted tail
# refinement after this many rounds (one round reaches 256 chars of
# coverage; beyond that the active set is a small fraction on real data)
_FULL_ROUNDS_BEFORE_TAIL = 1


def _is_full(rnd: _Round, cover: int) -> bool:
    """A round whose keys are q shifted copies of the current level and
    no tail -- servable by the shared traced-offset program."""
    return rnd.tail_chars == 0 and all(
        lv == cover and off == j * cover
        for j, (lv, off) in enumerate(rnd.rank_keys)
    )


def _run_plan(text, plan: _SortPlan, alphabet, *, jittable: bool,
              sort_impl=lax.sort, force_u32: bool = False,
              collect_flag: bool = False):
    """Shared driver for the host path (early exits via host sync) and
    the fully-jitted path (early exits via lax.cond).

    ``collect_flag`` (requires ``jittable``): run the NON-jitted core
    implementations so every ``sort_impl`` call traces at this driver's
    own trace level, accumulate the impl's overflow flag (reset/take
    INSIDE each ``lax.cond`` branch so no tracer crosses a trace
    boundary), and return ``(sa, flag)``. This is how the sample-sort
    facade surfaces its poison-on-overflow contract at the API boundary
    instead of handing callers a poisoned permutation."""
    nrounds = len(plan.rounds)
    pdt = _pos_dtype(text.shape[0], force_u32)
    if collect_flag:
        assert jittable and hasattr(sort_impl, "take_flag")
    seed_fn = _seed_sort_impl if collect_flag else _seed_sort
    full_fn = _full_round_impl if collect_flag else _full_round
    block_fn = _rank_block_sort_impl if collect_flag else _rank_block_sort
    # per-phase stopwatch logs under --verbose (reference model:
    # kiss1_core.hpp:244-267 / README.md:94-101 stage table); host path
    # only -- inside jit there is no host timer to read
    dbg = (not jittable) and timing.debug_enabled()
    if collect_flag:
        sort_impl.reset_flag()
    sa, rank, done = timing.staged(
        f"seed_sort(chars={plan.seed_chars})" if dbg else None,
        lambda: seed_fn(
            text, plan.seed_chars, alphabet, nrounds > 0, sort_impl,
            force_u32,
        ),
    )
    flag = sort_impl.take_flag() if collect_flag else None
    if nrounds == 0:
        return (sa, flag) if collect_flag else sa

    # keep only the rank levels the (static) final round will reference
    save_levels = set()
    for rnd in plan.rounds:
        if not _is_full(rnd, min(lv for lv, _ in rnd.rank_keys)):
            save_levels.update(lv for lv, _ in rnd.rank_keys)
    ranks = {plan.seed_chars: rank}
    cover = plan.seed_chars
    for i, rnd in enumerate(plan.rounds):
        is_last = i == nrounds - 1
        need_rank = (not is_last) or plan.unbounded
        if not jittable and bool(done):
            break
        if (
            plan.unbounded
            and not jittable
            and sort_impl is lax.sort
            and i >= _FULL_ROUNDS_BEFORE_TAIL
        ):
            # deep-tail refinement on the compacted active set (row ids
            # and covers in the pos dtype -- uint32-exact at chm13 scale,
            # see _compact_rows/_tail_refine)
            N = text.shape[0] + 1
            active, m_dev = _active_rows_of(sa, rank)
            m = int(m_dev)
            if m == 0:
                break
            rows = _compact_rows(active, _next_capacity(m, N)).astype(pdt)
            t = 0
            while m > 0:
                ncap = _next_capacity(m, N)
                if ncap < rows.shape[0]:
                    rows = rows[:ncap]
                # cover past n behaves identically to cover == n + 1 (all
                # shifted keys out of range), so clamp before the cast --
                # the Python int cover can exceed 2**32
                cdev = jnp.asarray(min(cover, N), pdt)
                sa, rank, rows, m_dev = timing.staged(
                    f"tail_refine[{t}](m={m}, cover={cover})" if dbg
                    else None,
                    lambda cdev=cdev: _tail_refine(sa, rank, rows, cdev),
                )
                m = int(m_dev)
                cover *= MAX_RANK_KEYS
                t += 1
            break
        if _is_full(rnd, cover):
            args = (
                text, ranks[cover], jnp.asarray(cover, pdt),
                len(rnd.rank_keys), need_rank, sort_impl, force_u32,
            )
            run = lambda args=args: full_fn(*args)  # noqa: E731
        else:
            level_ids = tuple(
                sorted(lv for lv in ranks if lv in save_levels or lv == cover)
            )
            rank_arrays = tuple(ranks[lv] for lv in level_ids)
            args = (
                text, rank_arrays, level_ids, rnd.rank_keys,
                rnd.tail_chars, rnd.tail_offset, alphabet, need_rank,
                sort_impl, force_u32,
            )
            run = lambda args=args: block_fn(*args)  # noqa: E731
        if collect_flag:
            # reset/take inside the branch: the accumulated tracer is
            # RETURNED from the cond instead of leaking via the closure
            def run_f(run=run):
                sort_impl.reset_flag()
                sa2, rank2, done2 = run()
                return sa2, rank2, done2, sort_impl.take_flag()

            sa, rank, done, f = lax.cond(
                done,
                lambda sa=sa, rank=rank, done=done: (
                    sa, rank, done, jnp.asarray(False)
                ),
                run_f,
            )
            flag = jnp.logical_or(flag, f)
        elif jittable:
            # skip the round entirely when already fully resolved
            sa, rank, done = lax.cond(
                done,
                lambda sa=sa, rank=rank, done=done: (sa, rank, done),
                run,
            )
        else:
            sa, rank, done = timing.staged(
                f"wide_round[{i}](cover {cover}->{rnd.new_cover})" if dbg
                else None,
                run,
            )
        if need_rank:
            if cover not in save_levels:
                ranks.pop(cover, None)
            ranks[rnd.new_cover] = rank
        cover = rnd.new_cover
    return (sa, flag) if collect_flag else sa


def _plan_shape(strategy: str, alphabet: pack.Alphabet):
    """(seed_chars, max_keys) for a strategy name. "wide" is the
    PARALLEL_SORTING shape (widest seed, 8-key rounds); "doubling" is
    the PREFIX_DOUBLING shape (one super-char seed -- 16 DNA bases per
    uint32, reference: kiss2_core.hpp:862-863 -- and 2-key doubling
    rounds, reference: kiss2_core.hpp:251,764-785). Both produce the
    identical exact-k + position-tiebreak order; they differ in round
    structure and cost."""
    if strategy == "doubling":
        return (16 if alphabet is pack.DNA else alphabet.chars_per_word, 2)
    assert strategy == "wide", strategy
    return (None, MAX_RANK_KEYS)


def k_ordered_suffix_array(
    ref, k=256, alphabet: pack.Alphabet = pack.DNA, as_numpy: bool = True,
    force_u32: bool = False, strategy: str = "wide",
):
    """Host entry point: int8 text -> uint32 SA (length n+1).

    Ordering contract (reference: kiss1_core.hpp:94-135): suffixes sorted
    by first k characters; a suffix that ends within k characters sorts
    before any longer suffix sharing its prefix; full-k ties broken by
    ascending text position; SA[0] = n (sentinel, reference:
    kiss_common.hpp:479).

    ``as_numpy=False`` leaves the result on device (callers composing
    with further device work should prefer this; device->host transfer
    of a genome-scale SA is expensive). ``force_u32`` runs the whole
    pipeline with uint32 positions/ranks on a small corpus -- the dtype
    a chm13-scale text (n >= 2**31) selects automatically.
    """
    if not isinstance(ref, jnp.ndarray):
        ref = np.ascontiguousarray(ref, dtype=np.int8)
    n = ref.shape[0]
    if n == 0:
        sa0 = np.zeros(1, dtype=np.uint32)
        return sa0 if as_numpy else jnp.asarray(sa0)
    seed_chars, max_keys = _plan_shape(strategy, alphabet)
    plan = _make_plan(n, _normalize_k(k), alphabet, seed_chars, max_keys)

    with timing.stage("k_ordered_suffix_array") as out:
        text = jnp.asarray(ref)
        sa = _run_plan(
            text, plan, alphabet, jittable=False, force_u32=force_u32
        )
        out["block_on"] = sa
    if as_numpy:
        return np.asarray(sa).astype(np.uint32)
    return sa


@partial(jax.jit, static_argnames=("k", "alphabet", "strategy"))
def k_ordered_suffix_array_device(
    text: jnp.ndarray, k: int | None = 256,
    alphabet: pack.Alphabet = pack.DNA, strategy: str = "wide",
) -> jnp.ndarray:
    """Fully-jitted single-program core: int8 text of length n -> int32
    SA of length n+1. Same ordering contract as the host path; useful
    inside larger jitted programs (SPMD pipelines, fused index builds).
    """
    n = text.shape[0]
    seed_chars, max_keys = _plan_shape(strategy, alphabet)
    plan = _make_plan(n, _normalize_k(k), alphabet, seed_chars, max_keys)
    return _run_plan(text, plan, alphabet, jittable=True)


def _normalize_k(k) -> int | None:
    if k is None:
        return None
    k = int(k)
    if k < 0 or k >= 2**63:  # reference: -1 parsed as size_t wraps to max
        return None
    return k


def _mesh_size_for(num_threads) -> int:
    """Map the reference's thread knob onto the device parallelism knob
    (SURVEY.md P9: TBB global_control thread cap -> mesh size): the
    effective device count is min(num_threads, visible devices), so
    reference habits like ``-t 24`` on a single chip degrade gracefully
    to the single-device path."""
    if not num_threads or num_threads <= 1:
        return 1
    avail = len(jax.devices())
    d = min(int(num_threads), avail)
    if d < num_threads:
        timing.log_debug(
            "-t %d clamped to %d visible device(s)", num_threads, d
        )
    return d


class _SorterBase:
    """API facade matching the reference sorter contract
    (reference: include/biovoltron/algo/sort/sorter.hpp:7-10,
    kiss1_sorter.hpp:8-50): static ``get_suffix_array_dna`` /
    ``get_suffix_array`` / ``prepare_aligned_ref``.

    ``num_threads`` maps onto the device parallelism knob, the mesh
    (reference: src/main.cpp:23-26 caps TBB threads): values above 1
    run the distributed sort over a mesh of min(num_threads, visible
    devices); 0/1/None run the single-device pipeline.
    """

    SA_dtype = np.uint32
    strategy = "wide"

    @staticmethod
    def prepare_aligned_ref(seq) -> np.ndarray:
        return np.ascontiguousarray(seq, dtype=np.int8)

    @classmethod
    def get_suffix_array_dna(cls, ref, k=256, num_threads=None) -> np.ndarray:
        d = _mesh_size_for(num_threads)
        if d > 1:
            from kiss_tpu.parallel import make_mesh
            from kiss_tpu.parallel.dsort import (
                sharded_k_ordered_suffix_array,
            )

            sa = sharded_k_ordered_suffix_array(
                make_mesh(d), jnp.asarray(np.ascontiguousarray(
                    ref, dtype=np.int8)), k, strategy=cls.strategy,
            )
            return np.asarray(sa).astype(np.uint32)
        return k_ordered_suffix_array(
            ref, k, pack.DNA, strategy=cls.strategy
        )

    @classmethod
    def get_suffix_array(cls, ref, k=256, num_threads=None) -> np.ndarray:
        return k_ordered_suffix_array(
            ref, k, pack.GENERAL, strategy=cls.strategy
        )


class Kiss1Sorter(_SorterBase):
    """PARALLEL_SORTING strategy facade (reference: kiss1_sorter.hpp):
    widest raw-word seed (64 DNA chars in 4 words + the fused end/pos
    word), then up-to-8-key rank-block rounds -- the device re-expression
    of the reference's bucketed direct sort (kiss1_core.hpp:23-145)."""

    strategy = "wide"


class Kiss2Sorter(_SorterBase):
    """PREFIX_DOUBLING strategy facade (reference: kiss2_sorter.hpp):
    a single 16-char super-char seed (exactly kISS-2's 16-bases-per-
    uint32 encoding, reference: kiss2_core.hpp:862-863) followed by
    2-key doubling rounds sorting (rank[p], rank[p + cover], pos) with
    coverage x2 per round -- the dataflow form of kISS-2's
    sort_sa_blocks / prefix_doubling loop (kiss2_core.hpp:251,764-785).

    Both strategies implement the SAME (stronger-than-reference)
    ordering contract -- exact-k cut, position tiebreaks -- so their
    outputs are bit-identical; they differ in round structure and cost
    (the wide strategy sorts fewer total words and is the default,
    mirroring the reference where kISS-1 wins at
    small k and kISS-2 at k = -1)."""

    strategy = "doubling"
