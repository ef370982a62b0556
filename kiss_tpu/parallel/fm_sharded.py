"""Row-sharded FM-index queries: the index split across the mesh.

:func:`kiss_tpu.parallel.mesh.sharded_batch_query` shards the QUERY axis
and replicates the index -- right whenever the index fits one chip. At
chm13 scale the device tables (packed BWT ~0.8 GB, fused LF table
~3.9 GB, sampled SA ~3.1 GB, marks) crowd a single chip's HBM, and the
reference has no answer at all (single shared-memory node, SURVEY.md
section 2.5). This module shards the INDEX over the sequence axis
instead: device d holds row-block d of every row-indexed table, queries
are replicated, and each LF step resolves its gathers with one ``psum``:

    every device gathers the rows of its own block (others contribute
    zero) and the partial results are summed over the mesh -- the
    distributed form of the occ/bwt word lookups in compute_occ
    (reference: fm_index.hpp:166-182).

Only the fused tables (``lf_tab``, ``b_tab``) and the sampled SA go on
device; the serialization-layout tables (occ1/occ2/b_words/b_occ) are
NEVER device-resident here -- occ2 alone is ~3.1 GB at chm13 and is
fully redundant with lf_tab (see :func:`shard_fm_arrays`).

Cost model: an LF step is one psum of a 5-lane Q-sized row block over
the interconnect instead of a local gather -- latency-bound, so
throughput still scales with the query batch; memory per device scales
1/D.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kiss_tpu.models import fm_index as fm
from kiss_tpu.ops import pack

SEQ_AXIS = "seq"


class ShardedFMQuery:
    """Mesh-wide query facade with the FMIndex query surface the CLI
    uses (``get_range`` / ``get_ranges`` / ``get_offsets`` /
    ``batch_query_stats``): this is the product wiring of the
    reference's ``-t`` knob (reference: src/main.cpp:22-26 caps the TBB
    thread pool; here the knob is the device mesh) onto the row-sharded
    index, so ``fmindex_query -t N`` actually uses N devices. Results
    are identical to the single-device
    :class:`kiss_tpu.models.fm_index.FMIndex` paths
    (tests/test_cli.py::test_cli_num_threads_sharded_query).

    Locate routing mirrors the single-device rules: the fast
    row-sharded LF walk for full-sort indexes, the order-robust range
    BFS (replicated tables -- exact for k-ordered archives) otherwise.
    """

    def __init__(self, mesh: Mesh, fmi):
        self.mesh = mesh
        self.fmi = fmi
        self.arrays = shard_fm_arrays(mesh, fmi.arrays)

    # -- ranges -----------------------------------------------------------

    def get_ranges(self, queries: np.ndarray):
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        qwords = jnp.asarray(pack.np_pack_queries_2bit(queries))
        beg, end, offs = sharded_get_ranges(
            self.mesh, self.arrays, qwords, queries.shape[1],
            self.fmi.lookup_len,
        )
        return np.asarray(beg), np.asarray(end), np.asarray(offs)

    def get_range(self, query: np.ndarray):
        beg, end, offs = self.get_ranges(
            np.asarray(query, dtype=np.int8)[None, :]
        )
        return int(beg[0]), int(end[0]), int(offs[0])

    # -- locate -----------------------------------------------------------

    def _locate(self, rows: np.ndarray) -> np.ndarray:
        if rows.size == 0:
            return np.empty(0, dtype=np.uint32)
        idt = np.dtype(self.fmi.index_dtype)
        # same capacity buckets as FMIndex.locate_rows (shared helper:
        # the single-device and mesh paths must not diverge)
        padded = np.zeros(fm._pow2_cap(rows.size, 64), dtype=idt)
        padded[: rows.size] = rows
        out = sharded_locate_rows(
            self.mesh, self.arrays, jnp.asarray(padded), self.fmi.sa_intv
        )
        return np.asarray(out[: rows.size]).astype(np.uint32)

    def get_offsets(self, beg: int, end: int) -> np.ndarray:
        if self.fmi.sa_intv == 1 or self.fmi.full_sa:
            return self._locate(np.arange(beg, end, dtype=np.int64))
        from kiss_tpu.utils import timing

        timing.log_debug(
            "sharded query: range-BFS locate runs on the replicated "
            "single-device tables (order-robust path)"
        )
        return self.fmi._bfs_positions(beg, end)

    # -- batch ------------------------------------------------------------

    def batch_query_stats(self, queries: np.ndarray) -> tuple[int, int]:
        """(total occurrences, location checksum): the two accumulators
        of the reference batch loop (reference: include/command/
        fmindex_query.hpp:87-94), with the backward search and (for
        full-sort indexes) the locate walk running over the mesh."""
        queries = np.ascontiguousarray(queries, dtype=np.int8)
        if queries.size == 0:
            return 0, 0
        beg, end, _ = self.get_ranges(queries)
        lens = (end.astype(np.int64) - beg.astype(np.int64))
        total = int(lens.sum())
        if total == 0:
            return 0, 0
        if self.fmi.sa_intv != 1 and not self.fmi.full_sa:
            positions = self.fmi._bfs_positions(beg, end)
        else:
            rows, _starts = fm._ragged_rows(beg, lens)
            positions = self._locate(rows)
        return total, int(positions.astype(np.int64).sum())


def _pad_rows(x: jnp.ndarray, d: int) -> jnp.ndarray:
    r = (-x.shape[0]) % d
    if r:
        x = jnp.concatenate([x, jnp.zeros((r,) + x.shape[1:], x.dtype)])
    return x


def shard_fm_arrays(mesh: Mesh, arrays: fm.FMArrays) -> fm.FMArrays:
    """Lay the row-indexed tables out sharded over the mesh (padded to
    the device count) and the small tables replicated. The result is
    what :func:`sharded_get_ranges` / :func:`sharded_locate_rows`
    consume; padding rows are zeros and are never selected.

    The serialization-layout tables (occ1/occ2/b_words/b_occ) become
    zero-size placeholders: the sharded query paths read only the fused
    ``lf_tab``/``b_tab`` rows, and replicating occ2 (int32[N/16+1, 4],
    ~3.1 GB at chm13) per chip would defeat the 1/D memory scaling this
    module exists for. Serialize from the original (host) arrays, not
    from this sharded view.
    """
    d = mesh.devices.size
    row_sh = NamedSharding(mesh, P(SEQ_AXIS))
    row2_sh = NamedSharding(mesh, P(SEQ_AXIS, None))
    repl = NamedSharding(mesh, P())

    def put(x, sh):
        return jax.device_put(x, sh)

    def empty_like(x):
        return put(jnp.zeros((0,) + x.shape[1:], x.dtype), repl)

    return fm.FMArrays(
        bwt_words=empty_like(arrays.bwt_words),  # lf_tab col 4 has it
        occ1=empty_like(arrays.occ1),
        occ2=empty_like(arrays.occ2),
        cnt=put(arrays.cnt, repl),
        pri=put(arrays.pri, repl),
        sa_samp=put(_pad_rows(arrays.sa_samp, d), row_sh),
        b_words=empty_like(arrays.b_words),  # b_tab cols 1-2 have them
        b_occ=empty_like(arrays.b_occ),  # b_tab col 0 has it
        lookup=put(arrays.lookup, repl),
        lf_tab=put(_pad_rows(arrays.lf_tab, d), row2_sh),
        b_tab=put(_pad_rows(arrays.b_tab, d), row2_sh),
    )


def _block_gather(table: jnp.ndarray, idx: jnp.ndarray, axis: str):
    """Masked local gather of ``table`` rows (this device's block of a
    globally row-sharded table) at GLOBAL indices ``idx``; rows owned by
    other devices contribute 0. Summing over the mesh (the caller's
    psum) completes the distributed gather."""
    rows = table.shape[0]
    base = (lax.axis_index(axis) * rows).astype(idx.dtype)
    local = idx - base
    mine = (local >= 0) & (local < rows)
    safe = jnp.clip(local, 0, rows - 1)
    vals = table[safe]
    if vals.ndim > mine.ndim:
        mine = mine[..., None]
    return jnp.where(mine, vals, jnp.zeros((), vals.dtype))


def _occ_sharded(lf_tab, pri, axis, c, i):
    """compute_occ against a row-sharded fused LF table: ONE psum of the
    gathered [*, 5] row block resolves the per-symbol counts and the
    packed BWT word together (reference: fm_index.hpp:166-182)."""
    row = lax.psum(
        _block_gather(lf_tab, i // fm.OCC2_INTV, axis), axis
    )
    word = row[..., 4]
    partial_cnt = pack.count_symbol_prefix(word, c, i % fm.OCC2_INTV)
    beg = i - i % fm.OCC2_INTV
    pass_pri = (c == 0) & (beg <= pri) & (pri < i)
    return (fm._sel4(row[..., :4], c) + partial_cnt).astype(
        pri.dtype
    ) - pass_pri.astype(pri.dtype)


@partial(jax.jit, static_argnames=("mesh", "qlen", "lookup_len"))
def sharded_get_ranges(mesh: Mesh, arrays: fm.FMArrays,
                       qwords: jnp.ndarray, qlen: int, lookup_len: int = 0):
    """Backward search over 2-bit packed patterns against a row-sharded
    index (tables from :func:`shard_fm_arrays`). Same results as
    :func:`kiss_tpu.models.fm_index.get_range_packed_device`."""

    def body(lf_tab, cnt, pri, lookup, qwords):
        q = qwords.shape[0]
        idt = lookup.dtype
        beg = jnp.zeros(q, idt)
        end = jnp.full(q, lookup[-1], idt)
        steps = qlen
        if lookup_len and qlen >= lookup_len:
            key = jnp.zeros(q, jnp.int32)
            for j in range(qlen - lookup_len, qlen):
                key = (key << 2) | (
                    (qwords[:, j // 16] >> jnp.uint32(2 * (j % 16))) & 3
                ).astype(jnp.int32)
            beg = lookup[key]
            end = lookup[key + 1]
            steps = qlen - lookup_len
        offs = jnp.full(q, steps, jnp.int32)

        def step(t, carry):
            beg, end, offs = carry
            j = steps - 1 - t
            w = lax.dynamic_slice_in_dim(qwords, j // 16, 1, axis=1)[:, 0]
            c = ((w >> (2 * (j % 16)).astype(jnp.uint32)) & 3).astype(
                jnp.int32
            )
            # both bounds resolved by ONE psum: the two row gathers ride
            # the same collective as a stacked [2Q, 5] block
            iv = jnp.concatenate([beg, end])
            occv = _occ_sharded(lf_tab, pri, SEQ_AXIS,
                                jnp.concatenate([c, c]), iv)
            nbeg = cnt[c] + occv[:q]
            nend = cnt[c] + occv[q:]
            alive = end > beg
            return (
                jnp.where(alive, nbeg, beg),
                jnp.where(alive, nend, end),
                jnp.where(alive, j, offs),
            )

        return lax.fori_loop(0, steps, step, (beg, end, offs))

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SEQ_AXIS, None), P(), P(), P(), P()),
        out_specs=(P(), P(), P()),
    )(arrays.lf_tab, arrays.cnt, arrays.pri, arrays.lookup, qwords)


@partial(jax.jit, static_argnames=("mesh", "sa_intv"))
def sharded_locate_rows(mesh: Mesh, arrays: fm.FMArrays,
                        rows: jnp.ndarray, sa_intv: int):
    """Row-sharded form of ``locate_rows_device`` (vectorized compute_sa,
    reference: fm_index.hpp:210-222): each LF-walk step needs one fused
    LF row and one mark row -- two block gathers, each completed by one
    psum."""

    def body(lf_tab, b_tab, cnt, pri, sa_samp, rows):
        idt = cnt.dtype

        def b_row(i):
            return lax.psum(
                _block_gather(b_tab, i // fm.B_OCC_INTV, SEQ_AXIS), SEQ_AXIS
            )

        def b_at(i):
            row = b_row(i)
            odd = ((i // 32) % 2) == 1
            w = jnp.where(odd, row[..., 2], row[..., 1])
            return ((w >> (i % 32).astype(jnp.uint32)) & 1) == 1

        def lf_own(i):
            row = lax.psum(
                _block_gather(lf_tab, i // fm.OCC2_INTV, SEQ_AXIS), SEQ_AXIS
            )
            word = row[..., 4]
            off = (i % fm.OCC2_INTV).astype(jnp.uint32)
            c = ((word >> (2 * off)) & 3).astype(jnp.int32)
            partial_cnt = pack.count_symbol_prefix(word, c, i % fm.OCC2_INTV)
            beg = i - i % fm.OCC2_INTV
            pass_pri = (c == 0) & (beg <= pri) & (pri < i)
            return cnt[c] + (
                (fm._sel4(row[..., :4], c) + partial_cnt).astype(idt)
                - pass_pri.astype(idt)
            )

        def b_rank(i):
            row = b_row(i)
            off = i - (i // fm.B_OCC_INTV) * fm.B_OCC_INTV
            lo = jnp.minimum(off, 32).astype(jnp.uint32)
            hi = jnp.where(
                off > 32, off - 32, jnp.zeros((), off.dtype)
            ).astype(jnp.uint32)
            m0 = jnp.where(
                lo >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << lo) - 1
            )
            m1 = jnp.where(
                hi >= 32, jnp.uint32(0xFFFFFFFF), (jnp.uint32(1) << hi) - 1
            )
            cnt_bits = pack.popcount_u32(row[..., 1] & m0) + pack.popcount_u32(
                row[..., 2] & m1
            )
            return (row[..., 0] + cnt_bits).astype(idt)

        i = rows.astype(idt)
        steps = jnp.zeros_like(i)
        done = b_at(i)
        for _ in range(sa_intv - 1):
            nxt = lf_own(i)
            i = jnp.where(done, i, nxt)
            steps = steps + jnp.where(
                done, jnp.zeros((), idt), jnp.ones((), idt)
            )
            done = b_at(i)
        samp = lax.psum(
            _block_gather(sa_samp, b_rank(i), SEQ_AXIS), SEQ_AXIS
        )
        return samp + steps

    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(SEQ_AXIS, None), P(SEQ_AXIS, None), P(), P(),
                  P(SEQ_AXIS), P()),
        out_specs=P(),
    )(arrays.lf_tab, arrays.b_tab, arrays.cnt, arrays.pri, arrays.sa_samp,
      rows)
