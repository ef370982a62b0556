"""Benchmark: all three reference workloads on an NVIDIA GPU.

Headline metric mirrors the reference's flagship number: suffix_sort of a
drosophila-chr1_2-sized text (n = 48,800,648) at k = 256, which the
reference does in 0.4809 s on 24 CPU threads = ~101.5 Mbp/s
(reference: README.md:87-89; BASELINE.md). The bundled corpus is stripped
from the mirror, so we synthesize a text of the same length with
drosophila-like repeat structure: ~70% fresh sequence, ~25% segments
copied from earlier in the text with ~1% mutations (transposon-like
dispersed repeats), ~5% tandem repeats -- long approximate repeats are
exactly what makes real genomes hard to suffix-sort.

The other two workloads (reference: fmindex_build / batch fmindex_query,
include/command/fmindex_{build,query}.hpp) are measured on the same
corpus: device index build seconds (full-sort SA + BWT/occ/marks/SA
sample; the `.fmi` disk serialization is excluded), and 1M len-25
pattern counts per second end-to-end
(host patterns -> 2-bit packed transfer -> backward search -> per-query
uint32 counts pulled back to the host, chunk-overlapped), with the
count+locate checksum printed for conformance.

Timing covers the full device pipeline (host-driven rounds included);
the SA stays on device (a genome-scale device->host pull is not part of
the reference's measured suffix_sort either -- it keeps the SA in RAM).
Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"extra_metrics": [...]} -- the extra metrics carry the build/query
numbers in the same {metric, value, unit, vs_baseline} shape
(vs_baseline null where BASELINE.md has no reference number).

The device, its card name and power limit are printed first; the
benchmark refuses to run without a GPU. Times are not comparable across
cards or power limits.
"""

import json
import sys
import time

import numpy as np

N = 48_800_648
K = 256
NQ = 1_000_000
QLEN = 25
BASELINE_MBP_S = 48.800648 / 0.4809  # reference: README.md:87-89


def synth_genome(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.int8)
    pos = 0
    # seed the text with fresh sequence so early copies have a source
    boot = min(1 << 20, n)
    out[:boot] = rng.integers(0, 4, boot, dtype=np.int8)
    pos = boot
    while pos < n:
        r = rng.random()
        if r < 0.70 or pos < (1 << 21):
            seg = min(int(rng.integers(2_000, 30_000)), n - pos)
            out[pos : pos + seg] = rng.integers(0, 4, seg, dtype=np.int8)
        elif r < 0.95:
            # dispersed repeat: copy an earlier segment, ~1% mutations
            seg = min(int(rng.integers(500, 8_000)), n - pos, pos)
            start = int(rng.integers(0, pos - seg + 1))
            chunk = out[start : start + seg].copy()
            nmut = max(1, seg // 100)
            mi = rng.integers(0, seg, nmut)
            chunk[mi] = rng.integers(0, 4, nmut, dtype=np.int8)
            out[pos : pos + seg] = chunk
        else:
            # tandem repeat: short unit tiled
            unit = rng.integers(0, 4, int(rng.integers(2, 200)), dtype=np.int8)
            seg = min(int(rng.integers(200, 5_000)), n - pos)
            reps = -(-seg // len(unit))
            out[pos : pos + seg] = np.tile(unit, reps)[:seg]
        pos += seg
    return out


def sample_patterns(text: np.ndarray, nq: int, qlen: int,
                    seed: int = 7) -> np.ndarray:
    """90% patterns sampled from the text (hits), 10% random (mostly
    misses) -- the reference batch protocol samples real reads; misses
    exercise the early-stop path."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - qlen, nq)
    idx = starts[:, None] + np.arange(qlen)[None, :]
    pats = text[idx]
    miss = rng.random(nq) < 0.10
    pats[miss] = rng.integers(0, 4, (int(miss.sum()), qlen), dtype=np.int8)
    return np.ascontiguousarray(pats, dtype=np.int8)


def bench_suffix_sort(text_dev) -> float:
    import jax

    from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array_device

    def run():
        # single-dispatch jitted pipeline: one program, no host round
        # trips
        sa = k_ordered_suffix_array_device(text_dev, K)
        jax.block_until_ready(sa)
        return sa

    sa = run()  # compile + warm every capacity bucket
    assert int(sa[0]) == N

    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    best = min(times)
    print(
        f"# suffix_sort n={N} k={K} best={best:.4f}s "
        f"times={[round(t, 4) for t in times]}",
        file=sys.stderr,
    )
    return best


def bench_suffix_sort_lms_host(text_host):
    """The round-5 native HOST strategy (-s LMS_INDUCED,
    csrc/kiss_lms.cpp): the reference's LMS + induced-sort core on the
    tier the reference runs it on. One timed run (serial induced
    passes), or None when no C++ toolchain is present."""
    import time

    from kiss_tpu.ops.lms_native import LmsSorter
    from kiss_tpu.utils import native

    if native.lms_induced_sort(
        __import__("numpy").zeros(0, "int8"), 1
    ) is None:
        return None
    t0 = time.perf_counter()
    sa = LmsSorter.get_suffix_array_dna(text_host, 256)
    dt = time.perf_counter() - t0
    assert int(sa[0]) == N
    print(f"# suffix_sort LMS_INDUCED host k=256 {dt:.3f}s", flush=True)
    return dt


def bench_suffix_sort_unbounded(text_dev):
    """k = -1 (full suffix sort) for BOTH strategies -- kISS-2's entire
    reason to exist is unbounded-k stability (reference:
    experiment/README.md:20-27, README.md:56). Host-driven pipeline
    (tail refinement needs host syncs), 3 repeats after a warm run,
    best-of reported."""
    import jax

    from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array

    out = {}
    for strategy, label in (
        ("wide", "PARALLEL_SORTING"),
        ("doubling", "PREFIX_DOUBLING"),
    ):
        def run(strategy=strategy):
            sa = k_ordered_suffix_array(
                text_dev, -1, as_numpy=False, strategy=strategy
            )
            jax.block_until_ready(sa)
            return sa

        sa = run()  # compile + warm every tail-capacity bucket
        assert int(sa[0]) == N
        best, _ = _min_of(3, run, f"suffix_sort k=-1 {label}")
        out[strategy] = best
    return out


def _min_of(k, fn, label):
    """Run fn() k times after the caller's warmup; return (best, last
    result). Device-side paths are stable, so min over repeats is the
    machine number."""
    times, out = [], None
    for _ in range(k):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    print(f"# {label} times={[round(t, 4) for t in times]}", file=sys.stderr)
    return min(times), out


def _median_of(k, fn, label):
    """Median over k warm repeats, for END-TO-END metrics: host<->device
    legs vary run to run, and best-of-N systematically understates what
    a user sees. The caller warms first, so every rep is warm; the full
    rep list is printed for spread inspection."""
    times, out = [], None
    for _ in range(k):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    print(
        f"# {label} median={med:.4f}s times={[round(t, 4) for t in times]}"
        f" (warm)",
        file=sys.stderr,
    )
    return med, out


def bench_fmindex(text_dev, text_host):
    """Build + query metrics, with device-side and end-to-end timings
    reported separately.

    Paths measured:
      - build (full-sort default) and build -k 32 (reference parity,
        fm_index.hpp:384-386);
      - 1M len-25 counts: end-to-end (host->host) and device-only;
      - 1M stats (count+locate+checksum, fmindex_query.hpp:87-94) via
        the fast per-row walk (full-sort index): e2e and device-only;
      - same stats via the range BFS on the -k 32 index -- the locate
        path every reference-written archive routes through;
      - same stats on an archive saved to disk and loaded back (the
        CLI-real path, sidecar-routed to the walk).
    """
    import io

    import jax
    import jax.numpy as jnp

    from kiss_tpu.models import fm_index as fm
    from kiss_tpu.ops.pack import np_pack_queries_2bit
    from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array_device

    def build(sort_len):
        fmi = fm.FMIndex(sa_intv=4, lookup_len=0)
        sa = k_ordered_suffix_array_device(text_dev, sort_len)
        arrays = fm.build_index_device(text_dev, sa, fmi.sa_intv)
        fmi.arrays = arrays
        fmi.n_rows = N + 1
        fmi.full_sa = sort_len is None
        fmi._build_lookup()
        jax.block_until_ready(fmi.arrays)
        return fmi

    build(fm.SORT_LEN)  # compile
    build_s, fmi = _min_of(2, lambda: build(fm.SORT_LEN), "fmindex_build")
    build(32)  # compile
    build32_s, fmi32 = _min_of(2, lambda: build(32), "fmindex_build -k 32")

    pats = sample_patterns(text_host, NQ, QLEN)

    # ---- counts: end-to-end (pack+ship+search+pull), then device-only;
    # median-of-9 here (vs 5 elsewhere): this path ships 8 MB up + 4 MB
    # down per rep, so its spread is the widest
    fmi.counts(pats)  # compile + warm
    count_s, cnts = _median_of(9, lambda: fmi.counts(pats),
                               "fmindex_query counts e2e")
    assert int(cnts.sum()) > 0
    qwords_dev = jax.device_put(jnp.asarray(np_pack_queries_2bit(pats)))
    jax.block_until_ready(qwords_dev)

    def counts_dev():
        c = fm.counts_packed_device(fmi.arrays, qwords_dev, QLEN, 0)
        jax.block_until_ready(c)
        return c

    counts_dev()  # compile
    count_dev_s, _ = _min_of(3, counts_dev, "fmindex_query counts device")

    # lookup-accelerated counts: a depth-12 seed table (fmindex_build
    # --lookup-len 12, 64 MB) skips 12 of the 25 LF steps per pattern
    # (reference FMIndex LOOKUP_LEN parameter, fm_index.hpp:237-269;
    # the reference CLI hardcodes 0, so this is an opt-in lever)
    LLEN = 12
    fmi_l = fm.FMIndex(sa_intv=4, lookup_len=LLEN)
    fmi_l.arrays, fmi_l.n_rows, fmi_l.full_sa = fmi.arrays, N + 1, True
    fmi_l._build_lookup()
    jax.block_until_ready(fmi_l.arrays.lookup)

    def counts_lookup_dev():
        c = fm.counts_packed_device(fmi_l.arrays, qwords_dev, QLEN, LLEN)
        jax.block_until_ready(c)
        return c

    cl = counts_lookup_dev()  # compile
    assert np.array_equal(np.asarray(cl), np.asarray(cnts))
    count_lookup_dev_s, _ = _min_of(
        3, counts_lookup_dev, "fmindex_query counts device(lookup12)"
    )

    # ---- stats via the fast walk (full-sort index): device-only
    beg, end, _ = fm.get_range_packed_device(fmi.arrays, qwords_dev, QLEN, 0)
    total = int(jnp.sum(end - beg))
    cap = 128
    while cap < total:
        cap *= 2

    def stats_walk_dev():
        b, e, _ = fm.get_range_packed_device(
            fmi.arrays, qwords_dev, QLEN, 0
        )
        lo, hi = fm.batch_locate_stats_device(fmi.arrays, b, e, 4, cap)
        occ = int(jnp.sum(e - b))
        chk = int(np.asarray(lo, dtype=np.int64).sum()) + (
            int(np.asarray(hi, dtype=np.int64).sum()) << 16
        )
        return occ, chk

    stats_walk_dev()  # compile
    stats_dev_s, (occ, checksum) = _min_of(
        3, stats_walk_dev, "fmindex_query stats device(walk)"
    )

    # ---- stats end-to-end (host patterns in, two scalars out)
    fmi.batch_query_stats(pats)  # warm every capacity bucket
    stats_s, (occ_e, chk_e) = _median_of(
        5, lambda: fmi.batch_query_stats(pats), "fmindex_query stats e2e"
    )
    assert (occ_e, chk_e) == (occ, checksum)

    # ---- stats via the range BFS (the k-ordered-archive locate path)
    def stats_bfs_dev():
        b, e, _ = fm.get_range_packed_device(
            fmi32.arrays, qwords_dev, QLEN, 0
        )
        lo, hi = fm.batch_bfs_stats_device(fmi32.arrays, b, e, 4, cap)
        occ = int(jnp.sum(e - b))
        chk = int(np.asarray(lo, dtype=np.int64).sum()) + (
            int(np.asarray(hi, dtype=np.int64).sum()) << 16
        )
        return occ, chk

    stats_bfs_dev()  # compile
    stats_bfs_dev_s, (occ_b, chk_b) = _min_of(
        2, stats_bfs_dev, "fmindex_query stats device(bfs)"
    )
    assert (occ_b, chk_b) == (occ, checksum), (occ_b, chk_b, occ, checksum)
    fmi32.batch_query_stats(pats)
    stats_bfs_s, (occ_b2, chk_b2) = _median_of(
        5, lambda: fmi32.batch_query_stats(pats),
        "fmindex_query stats e2e(bfs)",
    )
    assert (occ_b2, chk_b2) == (occ, checksum)

    # ---- the CLI-real path: archive round-trip, sidecar-routed locate
    buf = io.BytesIO()
    fmi.save(buf)
    buf.seek(0)
    fmil = fm.FMIndex(sa_intv=4).load(buf)
    fmil.full_sa = True  # what the `.meta` sidecar records for this build
    fmil.batch_query_stats(pats)  # warm
    stats_loaded_s, (occ_l, chk_l) = _median_of(
        5, lambda: fmil.batch_query_stats(pats),
        "fmindex_query stats e2e(loaded archive)",
    )
    assert (occ_l, chk_l) == (occ, checksum)

    print(
        f"# fmindex_query stats: occ={occ} checksum={checksum}",
        file=sys.stderr,
    )
    return {
        "build_s": build_s,
        "build32_s": build32_s,
        "counts_per_s": NQ / count_s,
        "counts_device_s": count_dev_s,
        "counts_lookup12_device_s": count_lookup_dev_s,
        "stats_s": stats_s,
        "stats_device_s": stats_dev_s,
        "stats_bfs_s": stats_bfs_s,
        "stats_bfs_device_s": stats_bfs_dev_s,
        "stats_loaded_s": stats_loaded_s,
        "occ": occ,
        "checksum": checksum,
    }


def main() -> None:
    import jax
    import jax.numpy as jnp

    from chip_smoke import card_lines, require_gpu
    from kiss_tpu.utils import compile_cache

    devices = jax.devices()
    require_gpu(devices, 1)
    d = devices[0]
    print(f"# platform {d.platform} device_kind {d.device_kind} "
          f"count {len(devices)}", flush=True)
    for line in card_lines():
        print(f"# card (name, power limit): {line}", flush=True)
    compile_cache.enable()

    text_host = synth_genome(N)
    text_dev = jax.device_put(jnp.asarray(text_host))
    jax.block_until_ready(text_dev)

    best = bench_suffix_sort(text_dev)
    mbps = N / 1e6 / best
    unb = bench_suffix_sort_unbounded(text_dev)
    lms_s = bench_suffix_sort_lms_host(text_host)
    r = bench_fmindex(text_dev, text_host)

    def m(name, value, unit, **kw):
        return {
            "metric": name,
            "value": round(value, 3 if unit == "s" else 1),
            "unit": unit,
            "vs_baseline": None,  # reference publishes no number for these
            **kw,
        }

    extra = [
        # unbounded (k = -1, full SA) throughput, both strategies --
        # the reference kISS-2 headline regime (experiment/README.md:
        # 20-27); no absolute reference number exists for this corpus
        m(
            "suffix_sort_k-1_parallel_sorting_Mbp_s",
            N / 1e6 / unb["wide"], "Mbp/s", seconds=round(unb["wide"], 3),
        ),
        m(
            "suffix_sort_k-1_prefix_doubling_Mbp_s",
            N / 1e6 / unb["doubling"], "Mbp/s",
            seconds=round(unb["doubling"], 3),
        ),
        *(
            [
                m(
                    "suffix_sort_k256_lms_host_Mbp_s",
                    N / 1e6 / lms_s, "Mbp/s", seconds=round(lms_s, 3),
                    note="native host strategy; device strategies are "
                    "the headline",
                )
            ]
            if lms_s
            else []
        ),
        m("fmindex_build_seconds_drosophila", r["build_s"], "s"),
        # reference-parity sort depth (fm_index.hpp:384-386 hardcodes 32)
        m("fmindex_build_k32_seconds_drosophila", r["build32_s"], "s"),
        m(
            "fmindex_query_1M_len25_counts_per_s",
            r["counts_per_s"],
            "patterns/s",
            occ=int(r["occ"]),
            checksum=int(r["checksum"]),
            timing="median-of-9-warm",
        ),
        m(
            "fmindex_query_1M_len25_counts_device_s",
            r["counts_device_s"],
            "s",
        ),
        # opt-in --lookup-len 12 seed table (skips 12 of 25 LF steps)
        m(
            "fmindex_query_1M_len25_counts_lookup12_device_s",
            r["counts_lookup12_device_s"],
            "s",
        ),
        # full reference batch-loop accumulators: count + locate +
        # Sum(positions) checksum for 1M patterns
        # (fmindex_query.hpp:87-94); *_device_s excludes the host<->device
        # transfers, the e2e variants include them
        m("fmindex_query_1M_len25_stats_seconds", r["stats_s"], "s",
          timing="median-of-5-warm"),
        m("fmindex_query_1M_len25_stats_device_s", r["stats_device_s"], "s"),
        # the locate path of k-ordered (e.g. reference-written) archives
        m("fmindex_query_1M_len25_stats_bfs_seconds", r["stats_bfs_s"], "s",
          timing="median-of-5-warm"),
        m(
            "fmindex_query_1M_len25_stats_bfs_device_s",
            r["stats_bfs_device_s"],
            "s",
        ),
        # archive round-trip + sidecar-routed stats: the CLI-real path
        m(
            "fmindex_query_1M_len25_stats_loaded_seconds",
            r["stats_loaded_s"],
            "s",
            timing="median-of-5-warm",
        ),
    ]
    print(
        json.dumps(
            {
                "metric": "suffix_sort_throughput_drosophila_k256",
                "value": round(mbps, 3),
                "unit": "Mbp/s",
                "vs_baseline": round(mbps / BASELINE_MBP_S, 3),
                "extra_metrics": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
