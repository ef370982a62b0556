"""Multi-device (8 virtual CPU) sharding tests: the N-shard logic the
reference cannot express (it is single-node shared memory, SURVEY.md
section 2.5) must produce bit-identical results to single-device runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kiss_tpu.models import fm_index as fm
from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu.parallel import (
    make_mesh,
    sharded_batch_query,
    sharded_pipeline_step,
    sharded_suffix_sort,
)
from tests import oracle


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(8)


def test_sharded_sort_bit_identical(mesh):
    text = oracle.genome_like_dna(8192, ancestral=1 << 11, seed=4)
    sa_sharded = np.asarray(sharded_suffix_sort(mesh, jnp.asarray(text), 64))
    sa_single = k_ordered_suffix_array(text, 64)
    np.testing.assert_array_equal(sa_sharded, sa_single)


@pytest.mark.parametrize("strategy", ["wide", "doubling"])
def test_sharded_unbounded_reuses_one_round_program(mesh, strategy,
                                                    monkeypatch):
    """k = -1 on the mesh runs its rounds from the host: every round
    calls the one traced-cover round program, which compiles once."""
    from kiss_tpu.ops import suffix_sort
    from kiss_tpu.parallel.dsort import sharded_k_ordered_suffix_array

    text = oracle.repeat_heavy_dna(6_000, unit=23, seed=9)
    full_round = suffix_sort._full_round
    compiled = full_round._cache_size()
    calls = []

    def counting(*args):
        calls.append(args[3])  # n_keys
        return full_round(*args)

    monkeypatch.setattr(suffix_sort, "_full_round", counting)
    sa = sharded_k_ordered_suffix_array(
        mesh, jnp.asarray(text), -1, strategy=strategy
    )
    monkeypatch.undo()
    assert len(calls) >= 2
    assert full_round._cache_size() - compiled <= 1
    np.testing.assert_array_equal(
        np.asarray(sa).astype(np.uint32),
        k_ordered_suffix_array(text, -1, strategy=strategy),
    )


def test_sharded_query_matches(mesh):
    text = oracle.random_dna(4096, seed=5)
    fmi = fm.FMIndex(sa_intv=4, lookup_len=0).build(text)
    rng = np.random.default_rng(0)
    queries = rng.integers(0, 4, (16, 9)).astype(np.int8)
    beg_s, end_s, _ = sharded_batch_query(
        mesh, fmi.arrays, jnp.asarray(queries)
    )
    beg, end, _ = fmi.get_ranges(queries)
    np.testing.assert_array_equal(np.asarray(beg_s), beg)
    np.testing.assert_array_equal(np.asarray(end_s), end)


def test_pipeline_step(mesh):
    text = oracle.random_dna(1024, seed=6)
    rng = np.random.default_rng(1)
    queries = rng.integers(0, 4, (16, 8)).astype(np.int8)
    sa, beg, cnt = sharded_pipeline_step(
        mesh, jnp.asarray(text), jnp.asarray(queries)
    )
    sa = np.asarray(sa)
    assert sa[0] == 1024
    np.testing.assert_array_equal(np.sort(sa), np.arange(1025))
    # counts agree with brute force
    for qi in range(len(queries)):
        assert int(cnt[qi]) == len(oracle.search_all(text, queries[qi]))


def test_row_sharded_index_queries(mesh):
    """Index sharded over rows (memory-scaling form): counts and located
    positions must equal the replicated-index path bit for bit."""
    import jax.numpy as jnp

    from kiss_tpu.ops import pack as kpack
    from kiss_tpu.parallel import fm_sharded

    text = oracle.genome_like_dna(6000, ancestral=1 << 10, seed=12)
    fmi = fm.FMIndex(sa_intv=4, lookup_len=0).build(text)
    rng = np.random.default_rng(2)
    qlen = 13
    queries = np.stack(
        [
            text[p : p + qlen]
            for p in rng.integers(0, len(text) - qlen, 24)
        ]
        + [rng.integers(0, 4, qlen).astype(np.int8) for _ in range(8)]
    )
    sharded = fm_sharded.shard_fm_arrays(mesh, fmi.arrays)
    qwords = jnp.asarray(kpack.np_pack_queries_2bit(queries))
    beg_s, end_s, offs_s = fm_sharded.sharded_get_ranges(
        mesh, sharded, qwords, qlen, 0
    )
    beg, end, offs = fmi.get_ranges(queries)
    np.testing.assert_array_equal(np.asarray(beg_s), beg)
    np.testing.assert_array_equal(np.asarray(end_s), end)
    np.testing.assert_array_equal(np.asarray(offs_s), offs)

    # locate every row of the non-empty ranges
    rows = np.concatenate(
        [np.arange(b, e) for b, e in zip(beg, end)] or [np.array([], int)]
    ).astype(np.int32)
    want = fmi.locate_rows(rows)
    got = fm_sharded.sharded_locate_rows(
        mesh, sharded, jnp.asarray(rows), fmi.sa_intv
    )
    np.testing.assert_array_equal(np.asarray(got).astype(np.uint32), want)


def test_row_sharded_with_lookup(mesh):
    from kiss_tpu.ops import pack as kpack
    from kiss_tpu.parallel import fm_sharded
    import jax.numpy as jnp

    text = oracle.random_dna(4000, seed=13)
    fmi = fm.FMIndex(sa_intv=4, lookup_len=3).build(text)
    rng = np.random.default_rng(3)
    queries = rng.integers(0, 4, (20, 9)).astype(np.int8)
    sharded = fm_sharded.shard_fm_arrays(mesh, fmi.arrays)
    qwords = jnp.asarray(kpack.np_pack_queries_2bit(queries))
    beg_s, end_s, _ = fm_sharded.sharded_get_ranges(
        mesh, sharded, qwords, 9, 3
    )
    beg, end, _ = fmi.get_ranges(queries)
    np.testing.assert_array_equal(np.asarray(beg_s), beg)
    np.testing.assert_array_equal(np.asarray(end_s), end)
