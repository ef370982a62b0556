"""Multi-chip execution over a jax.sharding.Mesh.

The reference is single-process shared-memory OpenMP (SURVEY.md section
2.5): its only parallelism knob is a thread count. The device
equivalent is a 1-D device mesh over the *sequence axis* -- the text, the
suffix array, the rank arrays and the BWT/occ tables are all length-N
arrays, so the sequence axis IS the parallel axis:

  - key extraction is shard-local up to a halo of O(seed_chars)
    characters at shard edges (GSPMD inserts the collective-permute);
  - per-shard histogram/count phases become psum-style reductions;
  - the global sorts run on the explicit distributed sort networks of
    :mod:`kiss_tpu.parallel.dsort` (columnsort, sample sort,
    block-bitonic);
  - batch queries are embarrassingly data-parallel over the query axis.

The mesh is 1-D over ``jax.devices()``: it follows the algorithm, not a
physical topology.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kiss_tpu.models import fm_index as fm
from kiss_tpu.ops import pack, suffix_sort

SEQ_AXIS = "seq"


def make_mesh(n_devices: int | None = None, axis: str = SEQ_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"mesh of {n_devices} devices requested but only "
                f"{len(devs)} visible ({devs[0].platform}); for a virtual "
                "CPU mesh set XLA_FLAGS=--xla_force_host_platform_device_"
                "count=N and jax.config.update('jax_platforms', 'cpu') "
                "before first jax use"
            )
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_suffix_sort(mesh: Mesh, text: jnp.ndarray, k: int | None):
    """k-ordered SA with the text sharded over the sequence axis and all
    global sorts on the explicit distributed sort network
    (:mod:`kiss_tpu.parallel.dsort`)."""
    from kiss_tpu.parallel import dsort

    return dsort.sharded_k_ordered_suffix_array(mesh, text, k, SEQ_AXIS)


def sharded_batch_query(mesh: Mesh, arrays: fm.FMArrays, queries, lookup_len=0):
    """Backward search with queries sharded (data parallel) and the index
    replicated across the mesh."""
    qshard = NamedSharding(mesh, P(SEQ_AXIS, None))
    repl = NamedSharding(mesh, P())
    fn = jax.jit(
        partial(fm.get_range_device, lookup_len=lookup_len),
        in_shardings=(
            jax.tree.map(lambda _: repl, arrays),
            qshard,
        ),
        out_shardings=NamedSharding(mesh, P(SEQ_AXIS)),
    )
    return fn(arrays, queries)


def sharded_pipeline_step(mesh: Mesh, text: jnp.ndarray, queries: jnp.ndarray):
    """The full flagship pipeline as ONE jitted SPMD program: sharded
    k-ordered sort -> FM-index build -> data-parallel batch query.

    This is the multi-chip "step" the driver dry-runs: text sharded over
    the sequence axis, queries sharded over the query axis, index arrays
    produced and consumed on-device.
    """
    text_sh = NamedSharding(mesh, P(SEQ_AXIS))
    q_sh = NamedSharding(mesh, P(SEQ_AXIS, None))

    from kiss_tpu.parallel import dsort

    sort_impl = dsort.make_sharded_sort_impl(mesh, SEQ_AXIS)
    plan = suffix_sort._make_plan(
        text.shape[0], suffix_sort._normalize_k(fm.SORT_LEN), pack.DNA
    )

    @partial(
        jax.jit,
        in_shardings=(text_sh, q_sh),
        out_shardings=None,
    )
    def step(text, queries):
        sa = suffix_sort._run_plan(
            text, plan, pack.DNA, jittable=True, sort_impl=sort_impl
        )
        arrays = fm.build_index_device(text, sa, 4)
        beg, end, offs = fm.get_range_device(arrays, queries, 0)
        return sa, beg, end - beg

    return step(text, queries)
