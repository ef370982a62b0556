"""Sample sort: partition logic units + mesh integration, incl. the
poison-on-overflow contract and the full sharded suffix pipeline."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kiss_tpu.parallel import make_mesh
from kiss_tpu.parallel.dsort import make_sharded_sort_impl
from kiss_tpu.parallel.ssort import _lex_less_count, _sizes

needs8 = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def _rand_ops(n, w, seed, dtype=np.uint32):
    rng = np.random.default_rng(seed)
    ops = [
        rng.integers(0, 50, n).astype(dtype) for _ in range(w - 1)
    ]  # narrow range -> many ties
    ops.append(np.arange(n, dtype=dtype))  # unique tail: total order
    return ops


def test_lex_less_count_unit():
    rng = np.random.default_rng(0)
    B, W, T = 500, 3, 7
    ops = [rng.integers(0, 8, B).astype(np.uint32) for _ in range(W)]
    spl = [rng.integers(0, 8, T).astype(np.uint32) for _ in range(W)]
    rows = np.stack(ops, axis=1)
    srows = np.stack(spl, axis=1)
    for t in range(T):
        want = sum(
            1 for r in rows if tuple(r) < tuple(srows[t])
        )
        got = int(_lex_less_count(
            [jnp.asarray(x) for x in ops],
            [jnp.asarray(x) for x in spl], t,
        ))
        assert got == want


def test_sizes_invariants():
    for B, D in [(1000, 8), (4096, 4), (64, 2), (30, 8)]:
        C, M, S = _sizes(B, D, 1.5)
        assert M == C * D and S == M - B and 0 < S <= B


@needs8
@pytest.mark.parametrize("n", [4096, 5000, 100_000])
@pytest.mark.parametrize("w", [2, 5])
def test_matches_lax_sort(n, w):
    mesh = make_mesh(8)
    impl = make_sharded_sort_impl(mesh, "seq", algorithm="sample")
    ops = [jnp.asarray(x) for x in _rand_ops(n, w, seed=n + w)]
    got = impl(tuple(ops), num_keys=w)
    want = jax.lax.sort(tuple(ops), num_keys=w, is_stable=False)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@needs8
def test_mixed_dtype_operands():
    # the pipeline's rank-rebuild sorts (int32 sa, int32 rank) pairs
    mesh = make_mesh(8)
    impl = make_sharded_sort_impl(mesh, "seq", algorithm="sample")
    n = 9000
    rng = np.random.default_rng(3)
    sa = rng.permutation(n).astype(np.int32)
    rank = rng.integers(0, n, n).astype(np.int32)
    got = impl((jnp.asarray(sa), jnp.asarray(rank)), num_keys=1)
    want = jax.lax.sort(
        (jnp.asarray(sa), jnp.asarray(rank)), num_keys=1, is_stable=False
    )
    for g, x in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(x))


@needs8
def test_overflow_poisons():
    """Adversarial keys aligned with the deal's residue classes: after
    the decorrelating deal, device c holds ONLY key value c, so its
    whole block lands in one bucket (>> capacity) -> every output must
    be poisoned, never a silently wrong permutation."""
    mesh = make_mesh(8)
    impl = make_sharded_sort_impl(mesh, "seq", algorithm="sample")
    n = 8192  # multiple of D^2 so position % D survives the deal
    i = np.arange(n, dtype=np.uint32)
    ops = (jnp.asarray(i % 8), jnp.asarray(i))
    got = impl(ops, num_keys=2)
    assert bool((np.asarray(got[0]) == 0xFFFFFFFF).all())


@needs8
def test_sorted_input_now_balanced():
    """Globally pre-sorted input overflowed the pre-deal design (device
    0's block -> bucket 0); the decorrelating deal must handle it."""
    mesh = make_mesh(8)
    impl = make_sharded_sort_impl(mesh, "seq", algorithm="sample")
    n = 8192
    ops = (
        jnp.asarray(np.arange(n, dtype=np.uint32)),
        jnp.asarray(np.arange(n, dtype=np.uint32)),
    )
    got = impl(ops, num_keys=2)
    np.testing.assert_array_equal(
        np.asarray(got[0]), np.arange(n, dtype=np.uint32)
    )


@needs8
def test_overflow_flag_surfaces_eagerly():
    """The impl exposes the accumulated overflow flag (the poison must
    be loud at the API boundary, not just deterministic)."""
    mesh = make_mesh(8)
    impl = make_sharded_sort_impl(mesh, "seq", algorithm="sample")
    impl.reset_flag()
    n = 8192
    i = np.arange(n, dtype=np.uint32)
    impl((jnp.asarray(i % 8), jnp.asarray(i)), num_keys=2)
    assert bool(impl.take_flag())
    impl.reset_flag()
    impl((jnp.asarray(i), jnp.asarray(i)), num_keys=2)  # benign
    assert not bool(impl.take_flag())


@needs8
def test_pipeline_overflow_raises(monkeypatch):
    """A poisoned sort anywhere in the pipeline must raise at the
    facade -- an all-max 'SA' is never returned (ADVICE r4 medium)."""
    from kiss_tpu.parallel import ssort
    from kiss_tpu.parallel.dsort import (
        SampleSortOverflow, sharded_k_ordered_suffix_array,
    )
    from tests import oracle

    real = ssort.block_sample_sort_flag

    def always_overflow(*ops, axis, n_devices, **kw):
        outs = real(*ops, axis=axis, n_devices=n_devices, **kw)
        poisoned = tuple(
            jnp.full_like(x, 0xFFFFFFFF)
            if x.dtype == jnp.uint32
            else jnp.full_like(x, 2**31 - 1)
            for x in outs[:-1]
        )
        return poisoned + (jnp.ones(1, jnp.int32),)

    monkeypatch.setattr(ssort, "block_sample_sort_flag", always_overflow)
    text = oracle.random_dna(5_000, seed=11)
    mesh = make_mesh(8)
    with pytest.raises(SampleSortOverflow):
        # k=192: unique plan so no cached compiled program is reused
        sharded_k_ordered_suffix_array(
            mesh, jnp.asarray(text), 192, algorithm="sample"
        )


@needs8
def test_sample_sort_int32_row_guard():
    """Global N >= 2**31 must be rejected at entry (sample-sort row
    accounting is int32). eval_shape: no 8 GB
    allocation needed."""
    mesh = make_mesh(8)
    impl = make_sharded_sort_impl(mesh, "seq", algorithm="sample")
    big = jax.ShapeDtypeStruct((2**31 + 8,), jnp.uint32)
    with pytest.raises(ValueError, match="int32"):
        jax.eval_shape(lambda o: impl((o,), num_keys=1), big)


@needs8
def test_sharded_pipeline_with_sample_sort():
    """Full k-ordered suffix sort over the mesh with every global sort
    routed through the sample sort: bit-identical to the single-device
    pipeline."""
    from kiss_tpu.ops import suffix_sort
    from kiss_tpu.parallel.dsort import sharded_k_ordered_suffix_array
    from tests import oracle

    unit = oracle.random_dna(13, seed=3)
    text = np.tile(unit, 800)[:10_000].copy()
    text[6_000:] = oracle.random_dna(4_000, seed=5)
    mesh = make_mesh(8)
    got = sharded_k_ordered_suffix_array(
        mesh, jnp.asarray(text), 256, algorithm="sample"
    )
    want = suffix_sort.k_ordered_suffix_array(text, 256)
    np.testing.assert_array_equal(
        np.asarray(got).astype(np.uint32), want
    )
