"""Multi-host runtime initialization.

The reference has NO distributed backend -- it is single-node shared
memory with a TBB thread cap as its only knob (reference:
src/main.cpp:22-26; SURVEY.md section 2.5 P9/P10). Scaling beyond one
host is a new first-class subsystem here: ``jax.distributed`` across
hosts, with the sequence axis sharded across all devices of all hosts.

Typical multi-host launch (same program on every host):

    from kiss_tpu.parallel import distributed
    distributed.initialize("host0:1234", num_processes=2, process_id=i)
    mesh = distributed.global_mesh()    # 1-D mesh over every device
    sa = sharded_suffix_sort(mesh, text, k)

For CPU-based multi-process testing, pass coordinator/process counts
explicitly (mirrors jax.distributed.initialize's contract).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from kiss_tpu.parallel.mesh import SEQ_AXIS

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    **kwargs,
) -> None:
    """Bring up the jax.distributed runtime (idempotent).

    Pass the coordinator address, process count and process id
    explicitly: nothing in a plain GPU or CPU host's environment
    supplies them.
    """
    global _initialized
    if _initialized:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )
    _initialized = True


def global_mesh(axis: str = SEQ_AXIS) -> Mesh:
    """1-D mesh over every device of every participating process.

    jax.devices() is globally consistent across processes after
    initialize(), so each host builds the same mesh and pjit/GSPMD
    handles cross-host collectives over DCN transparently.
    """
    return Mesh(np.array(jax.devices()), (axis,))


def process_info() -> dict:
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
