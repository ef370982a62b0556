"""kiss-tpu: k-ordered suffix sorting and FM-indexing on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of jhhung/kISS
(k-ordered suffix arrays + k-ordered FM-indexes for genome-scale texts).
The CPU reference (C++20, OpenMP/TBB/AVX2) expresses its parallelism as
fork-join threads, per-thread histograms and AVX2 comparator sorts; this
library re-expresses the same pipeline as packed-integer keys, stable
`lax.sort` passes, segmented scans and gathers that XLA compiles for the
device, with `jax.sharding` meshes for multi-device scale-out.

Public API mirrors the reference's user-facing surface:
  - suffix sorting: :mod:`kiss_tpu.ops.suffix_sort`
    (reference: include/biovoltron/algo/sort/kiss{1,2}_core.hpp)
  - FM-index: :mod:`kiss_tpu.models.fm_index`
    (reference: include/biovoltron/algo/align/exact_match/fm_index.hpp)
  - CLI: ``python -m kiss_tpu suffix_sort|fmindex_build|fmindex_query``
    (reference: src/main.cpp, include/command/*.hpp)
"""

VERSION = "1.0.0"

BANNER = (
    r""" _     ___  ____  ____        _
| | __|_ _|/ ___|/ ___|      | |_ _ __  _   _
| |/ / | | \___ \\___ \ _____| __| '_ \| | | |
|   <  | |  ___) |___) |_____| |_| |_) | |_| |
|_|\_\|___||____/|____/       \__| .__/ \__,_|
                                 |_|          """
    + VERSION
    + "\n"
)

from kiss_tpu.ops.lms_native import LmsSorter  # noqa: E402,F401
from kiss_tpu.ops.suffix_sort import (  # noqa: E402,F401
    Kiss1Sorter,
    Kiss2Sorter,
    k_ordered_suffix_array,
)
