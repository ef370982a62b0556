"""chm13-scale end-to-end run: suffix sort + FM build + query stats at
n = 3,117,292,070 -- the reference's headline corpus size
(reference: README.md:94-101: 34.71 s total on 24 CPU threads).

Executes the big-N paths for real:
  - the out-of-core sorter at full chm13 scale (uint32 positions
    everywhere; bucket/batch machinery at 48 batches);
  - the in-core seed sort at n = 2^31 + 4096, where `_pos_dtype`
    auto-selects uint32 (no force_u32 hook);
  - `_compact_rows`' N >= 2^31 - 2^16 two-level nonzero branch;
  - `build_index_device` + FMIndex queries at N >= 2^31, where
    `_index_dtype` auto-selects uint32.

Checks (all hard assertions):
  - SA is a permutation of [0, n] (bitmap);
  - full ordering contract on 2M sampled adjacent row pairs
    (256-char windows, end-of-text-smallest, position tiebreak);
  - FM counts + location checksum over 200k len-25 sampled patterns
    equal an independent suffix-array searchsorted oracle;
  - planted len-25 patterns located at exactly their known positions.

Runs on the CPU backend (a 60+ GB working set stays host-resident).
Stage timings + peak RSS are
appended to experiments/results_chm13_full.md. Stages checkpoint to
--workdir so an interrupted run resumes. Expect ~2-3 h on 2 cores.
"""

from __future__ import annotations

import argparse
import gc
import os
import resource
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_CHM13 = 3_117_292_070
K = 256
QLEN = 25
NQ = 200_000


def plant_positions(n: int) -> list[int]:
    return [int(f * n) for f in (0.0001, 0.31, 0.62, 0.75, 0.962)]

STAGES: list[tuple[str, float, float]] = []


def _rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def stage(name):
    class _S:
        def __enter__(self):
            self.t0 = time.perf_counter()
            print(f"[chm13] {name} ...", file=sys.stderr, flush=True)
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter() - self.t0
            STAGES.append((name, dt, _rss_gb()))
            print(
                f"[chm13] {name}: {dt:.1f}s  peakRSS={_rss_gb():.1f}GB",
                file=sys.stderr, flush=True,
            )

    return _S()


def synth(n: int, workdir: str) -> np.ndarray:
    path = os.path.join(workdir, "text.bin")
    if os.path.exists(path) and os.path.getsize(path) == n:
        with stage("load text checkpoint"):
            return np.fromfile(path, dtype=np.int8)
    from bench import synth_genome

    with stage("synthesize genome"):
        text = synth_genome(n, seed=0)
        # plant a distinctive len-25 pattern at known positions
        rng = np.random.default_rng(424242)
        pat = rng.integers(0, 4, QLEN).astype(np.int8)
        for p in plant_positions(n):
            text[p : p + QLEN] = pat
        text.tofile(path)
    return text


def run_sort(text: np.ndarray, workdir: str) -> np.ndarray:
    from kiss_tpu.ops.external_sort import external_k_ordered_suffix_array

    path = os.path.join(workdir, "sa.bin")
    if os.path.exists(path) and os.path.getsize(path) == 4 * (len(text) + 1):
        with stage("load SA checkpoint"):
            return np.fromfile(path, dtype=np.uint32)
    with stage(f"suffix_sort k={K} (out-of-core)"):
        sa = external_k_ordered_suffix_array(
            text, K, batch_rows=1 << 26, bucket_chars=8, verbose=True
        )
    with stage("checkpoint SA"):
        sa.tofile(path)
    return sa


def check_permutation(sa: np.ndarray, n: int) -> None:
    with stage("check: SA is a permutation"):
        seen = np.zeros(n + 1, dtype=bool)
        chunk = 1 << 27
        for lo in range(0, n + 1, chunk):
            seen[sa[lo : lo + chunk]] = True
        for lo in range(0, n + 1, chunk):
            assert seen[lo : lo + chunk].all(), "SA misses some position"
        del seen
        gc.collect()


def check_order(text: np.ndarray, sa: np.ndarray, k: int,
                samples: int = 2_000_000, seed: int = 5) -> None:
    """Full ordering contract on sampled adjacent pairs: k-char window
    compare over -1-padded text (end-of-text sorts smallest), ties
    require ascending position."""
    with stage(f"check: ordering contract ({samples} pairs, k={k})"):
        n = len(text)
        rng = np.random.default_rng(seed)
        i = rng.integers(1, n + 1, samples)
        pad = np.full(n + k, -1, dtype=np.int8)
        pad[:n] = text
        a = sa[i - 1].astype(np.int64)
        b = sa[i].astype(np.int64)
        wa = pad[a[:, None] + np.arange(k)[None, :]]
        wb = pad[b[:, None] + np.arange(k)[None, :]]
        neq = wa != wb
        anyneq = neq.any(axis=1)
        first = np.argmax(neq, axis=1)
        r = np.arange(samples)
        lt = wa[r, first] < wb[r, first]
        ok = np.where(anyneq, lt, a < b)
        bad = np.flatnonzero(~ok)
        assert bad.size == 0, (
            f"{bad.size} misordered pairs, first at row {i[bad[0]]}"
        )


def oracle_counts_checksum(text, sa, pats, workdir):
    """Independent oracle: counts + Sum(positions) per pattern via
    searchsorted on the 50-bit (25-char) prefix keys along the SA,
    corrected for near-end suffixes shorter than the pattern."""
    from kiss_tpu.ops.external_sort import _np_word0_padded

    n = len(text)
    with stage("oracle: build sorted 25-char keys"):
        w0p = _np_word0_padded(text, 16)
        # built in place: a naive hi|lo would hold three 8N-byte
        # temporaries at once (~75 GB at chm13 scale)
        key = w0p[sa].astype(np.uint64)
        key <<= np.uint64(32)
        tmp = (w0p[sa + np.uint32(16)] & np.uint32(0xFFFFC000)).astype(
            np.uint64
        )
        key |= tmp
        del tmp
        gc.collect()
    with stage("oracle: position cumsum"):
        cs = np.zeros(len(sa) + 1, dtype=np.uint64)
        np.cumsum(sa, dtype=np.uint64, out=cs[1:])
    with stage("oracle: key monotonicity spot check"):
        chunk = 1 << 27
        for lo in range(0, len(key) - 1, chunk):
            seg = key[lo : lo + chunk + 1]
            assert (seg[1:] >= seg[:-1]).all(), "oracle keys unsorted"
    with stage("oracle: pattern counts + checksum"):
        # pattern keys in the same 50-bit space
        shifts = np.uint64(62) - np.uint64(2) * np.arange(QLEN, dtype=np.uint64)
        pk = (pats.astype(np.uint64)[:, :] << shifts[None, :]).sum(
            axis=1, dtype=np.uint64
        )
        # inclusive upper bound avoids u64 wrap for all-T prefixes
        tail = (np.uint64(1) << np.uint64(64 - 2 * QLEN)) - np.uint64(1)
        lo_i = np.searchsorted(key, pk, side="left")
        hi_i = np.searchsorted(key, pk | tail, side="right")
        counts = (hi_i - lo_i).astype(np.int64)
        sums = (cs[hi_i] - cs[lo_i]).astype(np.uint64)
        # exact located set for the planted pattern (row 0), short
        # suffixes excluded
        p0 = sa[lo_i[0] : hi_i[0]]
        planted_set = np.sort(p0[p0 <= np.uint32(n - QLEN)])
        # subtract suffixes shorter than QLEN whose zero-padded raw key
        # collides with a pattern (they are not true occurrences)
        for p in range(max(0, n - QLEN + 1), n + 1):
            kk = (w0p[p].astype(np.uint64) << np.uint64(32)) | (
                (w0p[p + 16] & np.uint32(0xFFFFC000)).astype(np.uint64)
            )
            m = pk == kk
            counts[m] -= 1
            sums[m] -= np.uint64(p)
        del w0p, key, cs
        gc.collect()
    return counts, sums, planted_set


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/chm13")
    ap.add_argument("-n", type=int, default=N_CHM13)
    ap.add_argument("--skip-incore", action="store_true")
    args = ap.parse_args()
    os.makedirs(args.workdir, exist_ok=True)
    n = args.n

    import jax

    jax.config.update("jax_platforms", "cpu")

    text = synth(n, args.workdir)
    rng = np.random.default_rng(424242)
    pat = rng.integers(0, 4, QLEN).astype(np.int8)

    sa = run_sort(text, args.workdir)
    check_permutation(sa, n)
    check_order(text, sa, K)

    # sampled patterns (mostly hits) + the planted pattern first
    nq = min(NQ, max(1000, n // 1000))
    rng2 = np.random.default_rng(7)
    starts = rng2.integers(0, n - QLEN, nq - 1)
    pats = np.empty((nq, QLEN), dtype=np.int8)
    pats[0] = pat
    idx = starts[:, None] + np.arange(QLEN)[None, :]
    pats[1:] = text[idx]
    del idx

    want_counts, want_sums, planted_set = oracle_counts_checksum(
        text, sa, pats, args.workdir
    )
    planted_expected = np.sort(
        np.array(plant_positions(n), dtype=np.uint64)
    )
    assert want_counts[0] >= len(planted_expected)
    assert set(planted_expected.tolist()) <= set(
        planted_set.astype(np.uint64).tolist()
    )

    # ---- FM build + queries through the real device path ----------------
    import jax.numpy as jnp

    from kiss_tpu.models import fm_index as fm

    with stage("FM build (build_index_device, uint32 rows)"):
        text_d = jnp.asarray(text)
        sa_d = jnp.asarray(sa)
        # free the host copies: both are device-resident now (and both
        # are checkpointed in --workdir); the build's sort buffers need
        # the headroom at chm13 scale
        del sa, text
        gc.collect()
        fmi = fm.FMIndex(sa_intv=4, lookup_len=0)
        fmi.arrays = fm.build_index_device(text_d, sa_d, 4)
        fmi.n_rows = n + 1
        fmi.full_sa = False  # k-ordered source SA -> BFS locate
        fmi._build_lookup()
        jax.block_until_ready(fmi.arrays)
        if n + 1 >= 2**31:
            # the automatic uint32 switch (_index_dtype), no force hook
            assert fmi.arrays.cnt.dtype == jnp.uint32
        del sa_d
    with stage(f"FM counts ({NQ} x len-{QLEN})"):
        got_counts = fmi.counts(pats).astype(np.int64)
    assert np.array_equal(got_counts, want_counts), (
        f"count mismatch: {np.sum(got_counts != want_counts)} of {NQ}"
    )
    with stage(f"FM stats (count+locate+checksum, {NQ} patterns)"):
        occ, checksum = fmi.batch_query_stats(pats)
    want_occ = int(want_counts.sum())
    want_chk = int(want_sums.sum())  # u64 accumulate, like the reference
    assert occ == want_occ, (occ, want_occ)
    assert checksum == want_chk, (checksum, want_chk)

    with stage("FM locate planted pattern"):
        beg, end, offs = fmi.get_range(pat)
        assert offs == 0 and end - beg == want_counts[0]
        pos = np.sort(fmi.get_offsets(beg, end).astype(np.uint64))
        # exact position-set equality vs the SA oracle, which in turn
        # contains every planted site
        assert np.array_equal(pos, planted_set.astype(np.uint64))

    with stage("save .fmi archive"):
        fmi_path = os.path.join(args.workdir, "chm13.fmi")
        with open(fmi_path, "wb") as f:
            fmi.save(f)
        fmi_bytes = os.path.getsize(fmi_path)
    with stage("reload .fmi header check"):
        fmi2 = fm.FMIndex(sa_intv=4)
        with open(fmi_path, "rb") as f:
            fmi2.load(f)
        assert fmi2.n_rows == n + 1
        assert np.array_equal(
            np.asarray(fmi2.arrays.cnt), np.asarray(fmi.arrays.cnt)
        )
        c2 = fmi2.counts(pats[:1024]).astype(np.int64)
        assert np.array_equal(c2, want_counts[:1024])
        del fmi2
        gc.collect()
    os.remove(fmi_path)

    del fmi, text_d
    gc.collect()

    # ---- targeted in-core big-N paths ------------------------------------
    if not args.skip_incore and n > 2**31:
        from kiss_tpu.ops import suffix_sort as ss

        m = 2**31 + 4096
        with stage(f"in-core seed sort at n={m} (auto uint32)"):
            sub = np.fromfile(
                os.path.join(args.workdir, "text.bin"), dtype=np.int8,
                count=m,
            )
            sa31 = ss.k_ordered_suffix_array(sub, 16)
            assert sa31.dtype == np.uint32
        check_order(sub, sa31, 16, samples=1_000_000, seed=11)
        check_permutation(sa31, m)
        del sa31, sub
        gc.collect()

        with stage("_compact_rows N>=2^31 branch"):
            import jax.numpy as jnp2

            Nbig = 2**31 + (1 << 17)
            rows_t = np.sort(
                np.random.default_rng(3).integers(
                    0, Nbig, 3000
                ).astype(np.int64)
            )
            rows_t = np.unique(rows_t)
            act = np.zeros(Nbig, bool)
            act[rows_t] = True
            got = ss._compact_rows(jnp2.asarray(act), 4096)
            got = np.asarray(got)[: rows_t.size]
            assert got.dtype == np.uint32
            assert np.array_equal(got.astype(np.int64), rows_t)
            del act
            gc.collect()

    # ---- report -----------------------------------------------------------
    out = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results_chm13_full.md"
    )
    with open(out, "a") as f:
        f.write(
            f"\n## Run {time.strftime('%Y-%m-%d %H:%M')} "
            f"(n={n}, k={K}, host=2-core CPU backend)\n\n"
        )
        f.write("| stage | seconds | peak RSS (GB) |\n|---|---|---|\n")
        for name, dt, rss in STAGES:
            f.write(f"| {name} | {dt:.1f} | {rss:.1f} |\n")
        f.write(
            f"\n- queries: {NQ} len-{QLEN}; occ={want_occ} "
            f"checksum={want_chk} (FM == SA-oracle, bit-exact)\n"
            f"- planted pattern found {int(want_counts[0])}x incl. all "
            f"{len(planted_expected)} planted sites\n"
            f"- .fmi archive: {fmi_bytes} bytes, reloaded + re-queried\n"
        )
    print("[chm13] DONE", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
