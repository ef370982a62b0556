"""Unit tests for the distributed sorts (columnsort + block-bitonic)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kiss_tpu.parallel.dsort import make_sharded_sort_impl
from kiss_tpu.parallel.mesh import make_mesh


def _impl(n_devices, algorithm):
    if len(jax.devices()) < n_devices:
        pytest.skip(f"needs {n_devices} (virtual) devices")
    return make_sharded_sort_impl(make_mesh(n_devices), "seq", algorithm)


@pytest.fixture(
    scope="module",
    params=[(8, "bitonic"), (8, "columnsort"), (2, "auto"),
            (3, "columnsort"), (6, "columnsort")],
    ids=lambda p: f"D{p[0]}-{p[1]}",
)
def impl(request):
    return _impl(*request.param)


@pytest.mark.parametrize("n", [8, 4096, 4097, 12345])
def test_matches_lax_sort(impl, n):
    rng = np.random.default_rng(n)
    # few distinct keys force heavy ties; pos payload makes order total
    key = jnp.asarray(rng.integers(0, 7, n).astype(np.uint32))
    pos = jnp.arange(n, dtype=jnp.int32)
    got = impl((key, pos), num_keys=1, is_stable=True)
    want = jax.lax.sort((key, pos), num_keys=1, is_stable=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("dtype", [np.int32, np.uint32])
@pytest.mark.parametrize("n", [1, 5, 4097])
def test_cummax_matches_lax(impl, n, dtype):
    rng = np.random.default_rng(n)
    x = jnp.asarray(rng.integers(0, 1 << 20, n).astype(dtype))
    np.testing.assert_array_equal(
        np.asarray(impl.cummax(x)), np.asarray(jax.lax.cummax(x))
    )


def test_sharded_seed_has_no_global_reduce_window():
    """The rank scan of a sharded sort stays per block: GSPMD would
    partition a global cummax into a reduce_window over the gathered
    array, quadratic in N."""
    from kiss_tpu.ops import pack, suffix_sort

    impl = _impl(4, "columnsort")
    text = jnp.zeros(10_001, jnp.int8)
    hlo = suffix_sort._seed_sort.lower(
        text, 64, pack.DNA, True, impl, False
    ).compile().as_text()
    windows = [
        int(np.prod([int(s) for s in size.split("x")]))
        for size in re.findall(r"window=\{size=([\dx]+)", hlo)
    ]
    assert windows and max(windows) < 10_001 // 4


def test_multikey(impl):
    rng = np.random.default_rng(0)
    n = 5000
    a = jnp.asarray(rng.integers(0, 5, n).astype(np.int32))
    b = jnp.asarray(rng.integers(0, 2**20, n).astype(np.uint32))
    pos = jnp.arange(n, dtype=jnp.int32)
    got = impl((a, b, pos), num_keys=2, is_stable=True)
    want = jax.lax.sort((a, b, pos), num_keys=2, is_stable=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_columnsort_adversarial_orders():
    """Presorted / reversed / constant / organ-pipe inputs (the classic
    columnsort boundary cases) on a non-power-of-2 mesh."""
    impl = _impl(6, "columnsort")
    n = 7777
    pos = jnp.arange(n, dtype=jnp.int32)
    cases = [
        np.arange(n, dtype=np.uint32),
        np.arange(n, dtype=np.uint32)[::-1].copy(),
        np.zeros(n, dtype=np.uint32),
        np.minimum(np.arange(n), np.arange(n)[::-1]).astype(np.uint32),
    ]
    for arr in cases:
        key = jnp.asarray(arr)
        got = impl((key, pos), num_keys=1, is_stable=True)
        want = jax.lax.sort((key, pos), num_keys=1, is_stable=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
