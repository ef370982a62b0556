"""Distributed multi-key sort over a device mesh.

The reference's only sort parallelism is TBB ``par_unseq`` inside one
address space (reference: kiss1_core.hpp:216-224, src/main.cpp:23-26).
Scaling a genome-scale sort across chips needs an explicit algorithm
over the interconnect; this module implements two, sharing one
``lax.sort``-compatible facade:

  - **columnsort** (Leighton 1985; the default for D >= 3): each device
    block is one column of an B x D matrix. Eight steps -- sort
    columns; transpose-deal (a UNIFORM ``lax.all_to_all``: element i of
    each sorted block goes to device i mod D); sort; untranspose
    (inverse all_to_all); sort; half-block shift to the next device
    (``ppermute``); boundary merge; unshift. Exactly 4 local sorts of B
    + 2 full-block all_to_alls + one half-block neighbor exchange,
    INDEPENDENT of D -- and deterministic: no sampling, no splitters,
    no overflow fallback. Valid whenever B >= 2*(D-1)^2 (always true at
    genome scale; the facade pads tiny inputs up to it). Works for ANY
    device count, powers of two or not.
  - **block-bitonic** (kept for D = 2 and as a cross-check): a bitonic
    network over the D blocks runs compare-exchange as *merge-split*:
    partners exchange whole blocks (``lax.ppermute``), each sorts the
    2B concatenation and keeps a half. log2(D)*(log2(D)+1)/2 rounds of
    2B-sized local sorts -- asymptotically log^2 more local sort work
    and interconnect traffic than columnsort.

All operands are treated as sort keys (callers append a unique
tiebreaker -- the text position -- as the last operand, which makes the
sort total and position-stable by construction, the same ``i < j`` rule
as the reference comparator kiss1_core.hpp:131-133).

This is the explicit device counterpart of SURVEY.md section-2.5
P2/P4: histogram+scatter bucket shuffles and shared-memory merges
become deterministic block exchanges between devices, with columnsort's
transpose-deal as the promised all_to_all bucket shuffle (SURVEY.md
section 7 step 5). It composes with the rank-block sorter:
:func:`make_sharded_sort_impl` returns a drop-in replacement for
``lax.sort`` that the pipeline threads through, so the single-chip and
multi-chip paths share one implementation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_MAXVALS = {
    jnp.uint32.dtype: jnp.uint32(0xFFFFFFFF),
    jnp.int32.dtype: jnp.int32(2**31 - 1),
}


def _merge_split(ops, axis: str, j: int, k: int):
    """One bitonic compare-exchange round between partners i and i^j."""
    i = lax.axis_index(axis)
    nd = lax.axis_size(axis)
    partner = i ^ j
    perm = [(s, s ^ j) for s in range(nd)]
    theirs = [lax.ppermute(x, axis, perm) for x in ops]
    both = [jnp.concatenate([a, b]) for a, b in zip(ops, theirs)]
    merged = lax.sort(tuple(both), num_keys=len(both), is_stable=False)
    b = ops[0].shape[0]
    ascending = (i & k) == 0
    keep_lo = (i < partner) == ascending
    return [jnp.where(keep_lo, m[:b], m[b:]) for m in merged]


def _block_bitonic(*ops, axis: str, n_devices: int):
    """Bitonic network over n_devices locally-sorted blocks."""
    ops = list(lax.sort(tuple(ops), num_keys=len(ops), is_stable=False))
    k = 2
    while k <= n_devices:
        j = k // 2
        while j >= 1:
            ops = _merge_split(ops, axis, j, k)
            j //= 2
        k *= 2
    return tuple(ops)


def _lsort(ops):
    return list(lax.sort(tuple(ops), num_keys=len(ops), is_stable=False))


def _deal(ops, axis: str, n_devices: int):
    """Columnsort step 2, the transpose-deal: element t*D + c of each
    sorted block goes to device c, landing contiguously in source-block
    order -- one uniform ``all_to_all`` per operand (with s | r the
    column-major pickup / row-major laydown of Leighton's transpose
    reduces to exactly this deal)."""
    D = n_devices
    out = []
    for x in ops:
        y = x.reshape(-1, D).T  # [D, q]; row c = elements congruent c mod D
        z = lax.all_to_all(y, axis, split_axis=0, concat_axis=0)
        out.append(z.reshape(-1))  # concat received chunks by source id
    return out


def _undeal(ops, axis: str, n_devices: int):
    """Columnsort step 4, the inverse deal: chunk j of each block returns
    to device j; received chunks re-interleave by source id."""
    D = n_devices
    out = []
    for x in ops:
        y = x.reshape(D, -1)  # chunk j -> device j
        z = lax.all_to_all(y, axis, split_axis=0, concat_axis=0)
        out.append(z.T.reshape(-1))  # element (src c, row t) -> slot t*D+c
    return out


def _boundary_merge(ops, axis: str, n_devices: int):
    """Columnsort steps 6-8 (shift by B/2, sort, unshift), expressed as
    one neighbor merge-split of half-blocks: device j merges its
    predecessor's bottom half with its own top half; the merged low half
    returns to the predecessor. Leighton's two sentinel columns
    (-inf above column 0, +inf below column D-1) reduce to keeping those
    two halves unchanged."""
    D = n_devices
    i = lax.axis_index(axis)
    half = ops[0].shape[0] // 2
    top = [x[:half] for x in ops]
    bot = [x[half:] for x in ops]
    fwd = [(s, s + 1) for s in range(D - 1)]
    prev_bot = [lax.ppermute(x, axis, fwd) for x in bot]  # zeros at dev 0
    merged = _lsort([jnp.concatenate([a, b]) for a, b in zip(prev_bot, top)])
    lo = [m[:half] for m in merged]
    hi = [m[half:] for m in merged]
    back = [(s, s - 1) for s in range(1, D)]
    next_lo = [lax.ppermute(x, axis, back) for x in lo]  # zeros at dev D-1
    new_top = [jnp.where(i == 0, t, h) for t, h in zip(top, hi)]
    new_bot = [jnp.where(i == D - 1, b, r) for b, r in zip(bot, next_lo)]
    return [jnp.concatenate([t, b]) for t, b in zip(new_top, new_bot)]


def _block_columnsort(*ops, axis: str, n_devices: int):
    """Leighton's columnsort over n_devices blocks (columns). The caller
    guarantees B % (2 * n_devices) == 0 and B >= 2 * (n_devices - 1)**2
    (the columnsort validity condition r >= 2*(s-1)^2)."""
    ops = _lsort(list(ops))  # 1
    if n_devices == 1:
        return tuple(ops)
    ops = _deal(ops, axis, n_devices)  # 2
    ops = _lsort(ops)  # 3
    ops = _undeal(ops, axis, n_devices)  # 4
    ops = _lsort(ops)  # 5
    ops = _boundary_merge(ops, axis, n_devices)  # 6-8
    return tuple(ops)


_IMPL_CACHE: dict = {}


class SampleSortOverflow(RuntimeError):
    """A sample-sort pipeline overflowed its bucket capacity or drift
    bound and poisoned its output (see kiss_tpu/parallel/ssort.py
    overflow contract). The result was discarded, never returned.
    Re-run with ``algorithm="columnsort"`` (deterministic, no sampling
    assumptions) or raise the slack."""


def _block_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def make_sharded_sort_impl(mesh: Mesh, axis: str, algorithm: str = "auto"):
    """Return a ``lax.sort``-compatible callable that sorts 1-D arrays
    sharded over ``axis`` of ``mesh``.

    ``algorithm``: "columnsort", "bitonic", "sample", or "auto"
    (columnsort for 3+ devices -- 4 local sorts + 2 all_to_alls
    regardless of D; bitonic's single merge round wins at D == 2).
    "sample" is the splitter sample sort (1 local sort + capacity-
    padded exchange + merge, ~1.8x less local sort work than
    columnsort -- see :mod:`kiss_tpu.parallel.ssort` incl. its
    poison-on-overflow contract); opt-in until validated on real
    multi-chip hardware. The sample impl exposes ``reset_flag()`` /
    ``take_flag()``: the accumulated overflow flag of every sort since
    the last reset or take (a traced value when called under jit;
    ``take_flag`` clears on read so a tracer never outlives its
    trace), so pipeline entry points can return it and raise
    :class:`SampleSortOverflow` on the host instead of handing callers
    poisoned output. Sample also asserts global N < 2**31 at entry
    (its row accounting is int32; columnsort has no such limit).

    Caller contract (satisfied by every sort in the rank-block sorter):
    the operand tuple, taken in full as a lexicographic key, is a total
    order (the last operand is a unique position/row id). ``num_keys``
    and ``is_stable`` are accepted for signature parity; all operands
    participate as keys, which subsumes stability.
    """
    cached = _IMPL_CACHE.get((mesh, axis, algorithm))
    if cached is not None:
        return cached
    n_devices = mesh.devices.size
    algo = algorithm
    if algo == "auto":
        algo = "bitonic" if n_devices <= 2 else "columnsort"
    if algo == "bitonic":
        assert n_devices & (n_devices - 1) == 0, (
            "block-bitonic needs a power-of-2 mesh; use columnsort"
        )

    flag_state = {"flag": False}

    def sharded_sort(operands, num_keys=None, is_stable=True):
        del num_keys, is_stable
        operands = tuple(operands)
        n = operands[0].shape[0]
        with_flag = False
        if algo == "columnsort":
            # B must be even, divisible by D, and >= 2*(D-1)^2
            B = _block_multiple(-(-n // n_devices), 2 * n_devices)
            B = max(B, _block_multiple(2 * (n_devices - 1) ** 2,
                                       2 * n_devices))
            n_pad = B * n_devices
            body = _block_columnsort
        elif algo == "sample":
            from kiss_tpu.parallel import ssort

            # B % 2D == 0: the decorrelating deal reshapes by D
            B = _block_multiple(-(-n // n_devices), 2 * n_devices)
            n_pad = B * n_devices
            if n_pad >= 2**31:
                raise ValueError(
                    f"sample sort row accounting is int32: global "
                    f"N = {n_pad} (padded) must be < 2**31; use "
                    f'algorithm="columnsort" at this scale'
                )
            body = ssort.block_sample_sort_flag
            with_flag = True
        else:
            n_pad = _block_multiple(n, n_devices)
            body = _block_bitonic
        if n_pad != n:
            # pads carry maximal keys so they sort to the global end
            # (a pad, not a concatenation: GSPMD keeps a padded operand
            # sharded, where it gathers a concatenated one whole onto
            # every device)
            operands = tuple(
                jnp.pad(x, (0, n_pad - n), constant_values=_MAXVALS[x.dtype])
                for x in operands
            )

        out_specs = tuple(P(axis) for _ in operands)
        if with_flag:
            out_specs = out_specs + (P(axis),)
        shardmapped = jax.shard_map(
            partial(body, axis=axis, n_devices=n_devices),
            mesh=mesh,
            in_specs=tuple(P(axis) for _ in operands),
            out_specs=out_specs,
        )
        out = shardmapped(*operands)
        if with_flag:
            *out, flagv = out
            flag_state["flag"] = jnp.logical_or(
                flag_state["flag"], jnp.any(flagv != 0)
            )
            out = tuple(out)
        if n_pad != n:
            out = tuple(x[:n] for x in out)
        return out

    def cummax(x):
        """Running maximum of a 1-D array, sharded like the sorts: a
        local cummax per block, raised by the maximum of the blocks
        before it. (GSPMD partitions a global ``lax.cummax`` into a
        reduce_window over the whole gathered array on every device,
        quadratic in its length.)"""
        n = x.shape[0]
        n_pad = _block_multiple(n, n_devices)
        lowest = jnp.iinfo(x.dtype).min

        def body(block):
            local = lax.cummax(block)
            tops = lax.all_gather(local[-1], axis)
            before = jnp.arange(n_devices) < lax.axis_index(axis)
            return jnp.maximum(local, jnp.max(jnp.where(before, tops, lowest)))

        out = jax.shard_map(
            body, mesh=mesh, in_specs=P(axis), out_specs=P(axis)
        )(jnp.pad(x, (0, n_pad - n)))
        return out[:n]

    sharded_sort.cummax = cummax

    def reset_flag():
        flag_state["flag"] = False

    def take_flag():
        # clear-on-read: a traced flag must never outlive its trace --
        # leaving it in flag_state would poison the globally cached impl
        # for later eager use (UnexpectedTracerError on the next OR)
        f = flag_state["flag"]
        flag_state["flag"] = False
        return jnp.asarray(f, bool)

    if algo == "sample":
        sharded_sort.reset_flag = reset_flag
        sharded_sort.take_flag = take_flag
    _IMPL_CACHE[(mesh, axis, algorithm)] = sharded_sort
    return sharded_sort


def sharded_k_ordered_suffix_array(mesh: Mesh, text, k, axis: str = "seq",
                                   algorithm: str = "auto",
                                   strategy: str = "wide"):
    """k-ordered SA with the text and every intermediate sharded over
    the sequence axis and all global sorts on the distributed sort
    network (columnsort by default, see :func:`make_sharded_sort_impl`).

    Bit-identical to the single-device sorter (tests/test_sharded.py).
    Columnsort and bitonic run the rounds from the host, as the
    single-device sorter does: the seed and each round shape compile
    once (an unbounded sort reuses one traced-cover round program) and
    the loop stops at the first all-singleton round.
    With ``algorithm="sample"`` the whole plan is one jitted program so
    that the pipeline's accumulated overflow flag can be returned; it
    is synced on the host and :class:`SampleSortOverflow` is raised
    when any sort poisoned -- an all-max permutation is never returned.
    """
    from kiss_tpu.ops import pack, suffix_sort

    sort_impl = make_sharded_sort_impl(mesh, axis, algorithm)
    seed_chars, max_keys = suffix_sort._plan_shape(strategy, pack.DNA)
    plan = suffix_sort._make_plan(
        text.shape[0], suffix_sort._normalize_k(k), pack.DNA,
        seed_chars, max_keys,
    )
    with_flag = hasattr(sort_impl, "take_flag")
    if not with_flag:
        return suffix_sort._run_plan(
            text, plan, pack.DNA, jittable=False, sort_impl=sort_impl
        )

    key = (mesh, axis, algorithm, plan)
    run = _IMPL_CACHE.get(key)
    if run is None:
        # no forced in/out shardings: N = n+1 is generally not divisible
        # by the mesh; the sort facade pads and shards internally
        run = jax.jit(
            lambda t: suffix_sort._run_plan(
                t, plan, pack.DNA, jittable=True, sort_impl=sort_impl,
                collect_flag=True,
            )
        )
        _IMPL_CACHE[key] = run

    sa, flag = run(text)
    if bool(flag):
        raise SampleSortOverflow(SampleSortOverflow.__doc__)
    return sa
