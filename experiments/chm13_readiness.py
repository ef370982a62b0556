"""chm13-scale readiness run:

  - build the FM-index for a 1e8-char text on an 8-virtual-device CPU
    mesh with force_u32 (the index dtype a real chm13 text selects),
  - assert the sharded build is bit-identical to the single-device
    build on every canonical table,
  - account the per-chip resident bytes of the sharded index and
    compare against (total index bytes) / D,
  - extrapolate the byte budget to N = 3,117,292,071 (chm13v2.0), D = 8.

Writes experiments/results_chm13_readiness.md. Runs on CPU devices
(JAX_PLATFORMS=cpu, xla_force_host_platform_device_count=8) so it can
execute anywhere; the arithmetic is platform-independent.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
import numpy as np  # noqa: E402

N_TEXT = 100_000_000
D = 8
CHM13_N = 3_117_292_070 + 1
SA_INTV = 4


def fmt_gb(b: float) -> str:
    return f"{b / 2**30:.3f} GiB"


def main() -> None:
    import jax
    import jax.numpy as jnp

    from kiss_tpu.models import fm_index as fm
    from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array
    from kiss_tpu.parallel import fm_build
    from kiss_tpu.parallel.mesh import make_mesh

    assert len(jax.devices()) >= D, jax.devices()

    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, N_TEXT, dtype=np.int8)
    N = N_TEXT + 1

    t0 = time.perf_counter()
    sa = k_ordered_suffix_array(text, -1, force_u32=True, as_numpy=False)
    sa = sa.astype(jnp.uint32)
    jax.block_until_ready(sa)
    t_sort = time.perf_counter() - t0
    print(f"suffix sort (unbounded, u32): {t_sort:.1f}s", flush=True)

    t0 = time.perf_counter()
    single = fm.build_index_device(jnp.asarray(text), sa, SA_INTV, True)
    jax.block_until_ready(single)
    t_single = time.perf_counter() - t0
    print(f"single-device build: {t_single:.1f}s", flush=True)

    mesh = make_mesh(D)
    t0 = time.perf_counter()
    sharded = fm_build.build_index_sharded(
        mesh, jnp.asarray(text), sa, SA_INTV, True
    )
    jax.block_until_ready(sharded)
    t_sharded = time.perf_counter() - t0
    print(f"sharded build (D={D}): {t_sharded:.1f}s", flush=True)

    trimmed = fm_build.trim_canonical(sharded, N, SA_INTV)
    for name in single._fields:
        x = np.asarray(getattr(trimmed, name))
        y = np.asarray(getattr(single, name))
        np.testing.assert_array_equal(x, y, err_msg=name)
    print("bit-identical: PASS (all canonical tables)", flush=True)

    # ---- per-chip accounting of the sharded index
    dev0 = jax.devices()[0]
    rows = []
    per_chip = 0
    total = 0
    for name in sharded._fields:
        x = getattr(sharded, name)
        mine = sum(
            s.data.nbytes for s in x.addressable_shards if s.device == dev0
        )
        rows.append((name, x.nbytes, mine))
        per_chip += mine
        total += x.nbytes

    lines = [
        "# chm13-scale readiness: sharded FM-index build",
        "",
        f"Run: N_text = {N_TEXT:,} (N = {N:,}), D = {D} CPU devices,",
        f"force_u32, sa_intv = {SA_INTV}. Timings on 2 host cores (CPU",
        "devices measure correctness + memory, not speed).",
        "",
        f"- unbounded u32 suffix sort: {t_sort:.1f}s",
        f"- single-device build: {t_single:.1f}s",
        f"- sharded build: {t_sharded:.1f}s",
        "- bit-identity vs single-device: PASS on every canonical table",
        "  (bwt words, occ1, occ2, cnt, pri, sampled SA, mark words,",
        "  b_occ, fused lf/b tables)",
        "",
        "## Per-chip resident bytes (sharded index, device 0)",
        "",
        "| table | global bytes | device-0 bytes |",
        "|---|---|---|",
    ]
    for name, tot, mine in rows:
        lines.append(f"| {name} | {tot:,} | {mine:,} |")
    lines += [
        f"| **sum** | **{total:,}** | **{per_chip:,}** |",
        "",
        f"per-chip / (total / D) = {per_chip / (total / D):.3f}",
        "(1.0 = perfect 1/D scaling; small excess = replicated cnt/pri/",
        "lookup scalars + block-alignment padding)",
        "",
        "## Extrapolated byte budget, chm13v2.0 (N = 3,117,292,071), D = 8",
        "",
        "Resident index tables, per chip (P('seq') sharded):",
        "",
        "| table | formula | global | per chip |",
        "|---|---|---|---|",
    ]
    specs = [
        ("bwt_words", "N/16 * 4B", CHM13_N / 16 * 4),
        ("lf_tab", "N/16 * 20B", CHM13_N / 16 * 20),
        ("b_tab", "N/64 * 12B", CHM13_N / 64 * 12),
        ("sa_samp", "N/4 * 4B", CHM13_N / 4 * 4),
        ("occ1 (serialization only)", "N/256 * 16B", CHM13_N / 256 * 16),
        ("occ2 (serialization only)", "N/16 * 16B", CHM13_N / 16 * 16),
        ("b_words (serialization only)", "N/32 * 4B", CHM13_N / 32 * 4),
        ("b_occ (serialization only)", "N/64 * 4B", CHM13_N / 64 * 4),
    ]
    query_total = 0.0
    for name, formula, b in specs:
        lines.append(
            f"| {name} | {formula} | {fmt_gb(b)} | {fmt_gb(b / 8)} |"
        )
        if "serialization" not in name:
            query_total += b
    lines += [
        "",
        f"Query-path tables total {fmt_gb(query_total)} global = "
        f"{fmt_gb(query_total / 8)}/chip at D = 8, the per-device share",
        "of the query state. The serialization-layout",
        "tables are intermediate build outputs; they stream to the host",
        "for the `.fmi` archive and are dropped from device (the",
        "row-sharded query path zero-sizes them, parallel/fm_sharded.py).",
        "",
        "Transient build peak per chip: the 2-operand columnsort blocks",
        "(~16B per row-block element during the neighbor merge) ~=",
        f"{fmt_gb(CHM13_N / 8 * 16)} on top of the inputs -- the build",
        "is feasible at D = 8 and trivial at D = 16+.",
        "",
        "Produced by experiments/chm13_readiness.py; also enforced at",
        "1e8 scale by tests/test_fm_build_sharded.py::",
        "test_sharded_build_1e8_chm13_readiness (KISS_BIG_TESTS=1).",
    ]
    out = os.path.join(os.path.dirname(__file__),
                       "results_chm13_readiness.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}", flush=True)


if __name__ == "__main__":
    main()
