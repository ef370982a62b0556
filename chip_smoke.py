#!/usr/bin/env python3
"""Run the kISS commands on an NVIDIA GPU at drosophila scale and check
every answer against a plain reference.

    python chip_smoke.py                  # one card: phases 0-4
    python chip_smoke.py --four-cards     # four cards: the -t 4 paths only
    python chip_smoke.py --profile DIR    # also trace every CLI command

Everything runs in this one process. The CLI is driven in-process through
``kiss_tpu.cli.main`` (and ``serve_main`` with injected stdin/stdout),
because a second JAX process could not open the card: the first one
reserves most of its memory. The text is synthesized from ``--seed`` at
the length of the reference's headline corpus (drosophila chr1_2,
n = 48,800,648) with ``bench.synth_genome``.

Phases (one card):
  0. device: refuse anything but a GPU; print the card's name and power
     limit as nvidia-smi reports them.
  1. golden fixtures: the reference binary's own outputs
     (tests/golden/*.npz), exact.
  2. suffix_sort at k = 256, three ways (default, PREFIX_DOUBLING,
     --external): identical permutations that pass an independent numpy
     check of adjacent pairs.
  3. fmindex_build (full sort) and fmindex_build -k 32, with the same
     check on their suffix arrays.
  4. fmindex_query -q / -b against both archives and serve, against a
     numpy k-mer reference.

All checks are exact integer comparisons. A failed check raises, and the
script exits non-zero; it also exits non-zero, printing no result, when
JAX finds no GPU. Phase times include compilation and are not a
benchmark. The last line of standard output is one JSON object naming
the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "tests", "golden")

N_DROSOPHILA = 48_800_648  # reference README.md:87-89
K = 256
PLANT = "GATTACAGATTACA"
NQ, QLEN = 100_000, 25
PAIRS = 1_000_000
EDGE_ROWS = 10_000
BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class SmokeError(AssertionError):
    """A check of the smoke run failed."""


def expect(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


# ---------------------------------------------------------------------------
# plain references (numpy only, independent of the code under test)
# ---------------------------------------------------------------------------


def unordered_pairs(text: np.ndarray, a: np.ndarray, b: np.ndarray,
                    k: int | None, chunk: int = 1 << 16) -> np.ndarray:
    """Indices q at which suffix ``a[q]`` does not belong before suffix
    ``b[q]`` in a k-ordered suffix array: its first k characters must
    compare smaller, a suffix that ends inside the window counting as
    smaller, or the two windows must be equal with ``a[q] < b[q]``.
    ``k = None`` compares whole suffixes."""
    n = len(text)
    pad = np.empty(n + 1, np.int16)
    pad[:n] = text
    pad[n] = -1  # end of text sorts before every character
    limit = n + 1 if k is None else k
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    ok = np.zeros(len(a), bool)
    live = np.arange(len(a))
    off = 0
    while live.size and off < limit:
        cols = off + np.arange(min(256, limit - off))
        undecided = []
        for s in range(0, live.size, chunk):
            q = live[s : s + chunk]
            ca = pad[np.minimum(a[q, None] + cols, n)]
            cb = pad[np.minimum(b[q, None] + cols, n)]
            diff = ca != cb
            first = diff.argmax(axis=1)
            rows = np.arange(q.size)
            decided = diff[rows, first]
            ok[q[decided]] = (ca[rows, first] < cb[rows, first])[decided]
            undecided.append(q[~decided])
        live = np.concatenate(undecided)
        off += cols.size
    ok[live] = a[live] < b[live]
    return np.flatnonzero(~ok)


def check_suffix_array(text: np.ndarray, sa: np.ndarray, k: int | None,
                       rng: np.random.Generator, pairs: int = PAIRS,
                       edge: int = EDGE_ROWS) -> None:
    """Raise unless ``sa`` is a permutation of [0, n] with SA[0] = n whose
    adjacent pairs hold the k-ordered contract, on ``pairs`` random rows
    plus the first and last ``edge`` rows."""
    n = len(text)
    expect(sa.shape == (n + 1,), f"SA shape {sa.shape}, want {(n + 1,)}")
    expect(int(sa[0]) == n, f"SA[0] = {int(sa[0])}, want n = {n}")
    expect(int(sa.max()) == n, "SA holds values above n")
    seen = np.zeros(n + 1, bool)
    seen[sa] = True
    expect(bool(seen.all()), "SA is not a permutation of [0, n]")
    if n == 0:
        return
    rows = np.unique(np.concatenate([
        np.arange(min(edge, n)),
        np.arange(max(n - edge, 0), n),
        rng.integers(0, n, pairs),
    ]))
    bad = unordered_pairs(text, sa[rows], sa[rows + 1], k)
    expect(
        bad.size == 0,
        f"{bad.size} of {rows.size} adjacent pairs out of order, first at "
        f"row {int(rows[bad[0]]) if bad.size else -1}",
    )


def tie_groups(text: np.ndarray, sa: np.ndarray, k: int) -> np.ndarray:
    """Equal-k-prefix group id of every SA row."""
    n = len(text)
    pad = np.full(n + k, -1, np.int16)
    pad[:n] = text
    win = np.lib.stride_tricks.sliding_window_view(pad, k)[: n + 1][sa]
    neq = np.any(win[1:] != win[:-1], axis=1)
    return np.concatenate([[0], np.cumsum(neq)])


def check_tie_groups(text: np.ndarray, ours: np.ndarray, ref: np.ndarray,
                     k: int, what: str) -> None:
    """Same equal-k-prefix group structure and the same members in every
    group (the order inside a group is the reference's own artifact)."""
    g_ref = tie_groups(text, ref, k)
    g_ours = tie_groups(text, ours, k)
    expect(np.array_equal(g_ref, g_ours), f"{what}: tie groups differ")
    expect(
        np.array_equal(ref[np.lexsort((ref, g_ref))],
                       ours[np.lexsort((ours, g_ours))]),
        f"{what}: tie-group membership differs",
    )


def find_all(text: np.ndarray, pattern: np.ndarray) -> np.ndarray:
    """Every start position of ``pattern`` in ``text``, ascending."""
    m = len(pattern)
    if m == 0 or m > len(text):
        return np.empty(0, np.int64)
    cand = np.flatnonzero(text[: len(text) - m + 1] == pattern[0])
    for j in range(1, m):
        cand = cand[text[cand + j] == pattern[j]]
    return cand


def kmer_codes(symbols: np.ndarray, m: int) -> np.ndarray:
    """u64 code of every length-m window of 2-bit ``symbols`` (rows of a
    2-D array, or the windows of a 1-D text)."""
    s = np.asarray(symbols).astype(np.uint64)
    if s.ndim == 2:
        cols = [s[:, j] for j in range(m)]
    else:
        count = len(s) - m + 1
        cols = [s[j : j + count] for j in range(m)]
    code = np.zeros(len(cols[0]), np.uint64)
    for c in cols:
        code <<= np.uint64(2)
        code |= c
    return code


class KmerReference:
    """Occurrence counts and position sums of fixed-length patterns: all
    m-mers of the text, encoded as u64 and sorted stably, then per pattern
    a ``searchsorted`` range and a prefix sum of positions over it."""

    def __init__(self, text: np.ndarray, m: int):
        self.m = m
        codes = kmer_codes(text, m)
        order = np.argsort(codes, kind="stable")
        self.sorted_codes = codes[order]
        self.position_sums = np.zeros(len(order) + 1, np.int64)
        np.cumsum(order, out=self.position_sums[1:])

    def stats(self, patterns: np.ndarray) -> tuple[int, int]:
        """(number of matched locations, location checksum), the two
        numbers ``fmindex_query -b`` logs."""
        q = kmer_codes(patterns, self.m)
        lo = np.searchsorted(self.sorted_codes, q, side="left")
        hi = np.searchsorted(self.sorted_codes, q, side="right")
        checksum = self.position_sums[hi] - self.position_sums[lo]
        return int((hi - lo).sum()), int(checksum.sum())


# ---------------------------------------------------------------------------
# device, logging and phase bookkeeping
# ---------------------------------------------------------------------------


def require_gpu(devices, count: int) -> None:
    """Refuse to run on anything but ``count`` or more GPUs."""
    expect(bool(devices), "JAX reports no device")
    expect(
        devices[0].platform == "gpu",
        f"JAX found no GPU (platform {devices[0].platform!r}); this check "
        "runs only on the card",
    )
    expect(len(devices) >= count,
           f"{count} GPUs needed, JAX reports {len(devices)}")


def card_lines() -> list[str]:
    """nvidia-smi's name and power limit of every card, one line each."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    expect(bool(lines), "nvidia-smi listed no card")
    return lines


class LogCapture(logging.Handler):
    """Keeps the messages the CLI logs. Installed on the root logger:
    ``cli.main`` replaces the ``kiss_tpu`` logger's own handlers on every
    call, and its records propagate to the root."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: list[str] = []

    def emit(self, record):
        if record.name.startswith("kiss_tpu"):
            self.lines.append(record.getMessage())


class CompileCounter:
    """Backend compilations and their seconds, from JAX's own events."""

    def __init__(self):
        import jax

        self.count = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, *args, **kwargs):
        if event == BACKEND_COMPILE_EVENT:
            self.count += 1
            self.seconds += duration


class Run:
    """State shared by the phases: devices, captured log, compile counts."""

    def __init__(self, workdir: str, devices, profile: str | None = None):
        self.workdir = workdir
        self.devices = devices
        self.profile = profile
        self.traces = 0
        self.log = LogCapture()
        logging.getLogger().addHandler(self.log)
        self.compiles = CompileCounter()

    def close(self) -> None:
        import jax

        logging.getLogger().removeHandler(self.log)
        jax.monitoring.unregister_event_duration_listener(self.compiles._on)

    def peaks(self) -> list[int]:
        out = []
        for d in self.devices:
            stats = d.memory_stats() or {}
            out.append(int(stats.get("peak_bytes_in_use", 0)))
        return out

    @contextlib.contextmanager
    def timed(self, label: str):
        """Print ``label``'s wall seconds and backend compilations."""
        c0, s0 = self.compiles.count, self.compiles.seconds
        t0 = time.perf_counter()
        yield
        print(
            f"{label}: {time.perf_counter() - t0:.3f} s wall (including "
            f"compile, not a benchmark); {self.compiles.count - c0} "
            f"compilations, {self.compiles.seconds - s0:.3f} s backend "
            "compile",
            flush=True,
        )

    @contextlib.contextmanager
    def phase(self, name: str, n: int | None = None):
        print(f"== {name}", flush=True)
        with self.timed(name):
            yield
        self.print_peaks(name, n)

    def print_peaks(self, name: str, n: int | None = None) -> None:
        from kiss_tpu import cli

        for i, peak in enumerate(self.peaks()):
            line = f"{name}: device {i} peak_bytes_in_use {peak}"
            if n:
                line += (
                    f" = {peak / n:.3f} B/char (in-core model "
                    f"{cli.IN_CORE_BYTES_PER_CHAR} B/char)"
                )
            print(line, flush=True)

    def cli(self, *argv: str) -> list[str]:
        """Run ``kISS argv`` in-process; return the lines it logged. With
        a profile directory each command writes its own trace under it."""
        from kiss_tpu import cli

        if self.profile:
            self.traces += 1
            trace = os.path.join(self.profile,
                                 f"{self.traces:02d}_{argv[0]}")
            argv = (argv[0], "--profile", trace, *argv[1:])
        start = len(self.log.lines)
        with self.timed(f"  kISS {' '.join(argv)}"):
            rc = cli.main(list(argv))
        expect(rc == 0, f"kISS {' '.join(argv)} returned {rc}")
        return self.log.lines[start:]

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)


def logged_int(lines: list[str], pattern: str) -> int:
    """The one integer that ``pattern``'s group captures in the log."""
    vals = [int(m.group(1)) for ln in lines if (m := re.search(pattern, ln))]
    expect(len(vals) == 1, f"want one log line matching {pattern!r}, "
           f"got {vals}")
    return vals[0]


def batch_stats(lines: list[str]) -> tuple[int, int]:
    return (logged_int(lines, r"number of matched locations: (\d+)"),
            logged_int(lines, r"location checksum: (\d+)"))


def query_positions(lines: list[str], pattern: str) -> tuple[int, list[int]]:
    """(count, printed positions) of one ``-q`` answer in the log."""
    found = logged_int(lines, rf"query = {pattern} found (\d+) times")
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(f"query = {pattern} "))
    pos = []
    for ln in lines[start + 1 :]:
        m = re.match(r"The \d+-\w+ position is (\d+)", ln)
        if not m:
            break
        pos.append(int(m.group(1)))
    return found, pos


def expect_positions(lines: list[str], pattern: str, want: np.ndarray,
                     headn: int) -> None:
    """The logged answer to ``pattern`` names ``len(want)`` matches and
    prints min(headn, len(want)) of the positions in ``want``."""
    found, pos = query_positions(lines, pattern)
    expect(
        found == len(want) and len(pos) == min(headn, found)
        and set(pos) <= set(want.tolist()),
        f"query {pattern}: found {found} at {sorted(pos)[:10]}..., want "
        f"{len(want)} at {want[:10].tolist()}...",
    )


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------


def make_corpus(n: int, seed: int):
    """(text, planted positions): the synthesized genome with PLANT
    written at three fixed places."""
    import bench
    from kiss_tpu.utils import codec

    text = bench.synth_genome(n, seed)
    pat = codec.to_istring(PLANT)
    planted = [n // 7, n // 2, n - 3 * len(pat)]
    for p in planted:
        text[p : p + len(pat)] = pat
    return text, planted


def write_fasta(path: str, text: np.ndarray) -> str:
    from kiss_tpu.utils import fasta

    fasta.write_fasta(path, [fasta.FastaRecord("chr1_2", text)])
    return path


def write_batch(path: str, patterns: np.ndarray) -> str:
    """The ``-b`` file: u32 query_len, u32 num_query, ASCII patterns."""
    from kiss_tpu.utils import codec

    nq, qlen = patterns.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        f.write(codec.to_string(patterns.reshape(-1)).encode())
    return path


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def golden_phase() -> None:
    """Phase 1: the reference binary's own outputs, exact."""
    from kiss_tpu.models.fm_index import FMIndex
    from kiss_tpu.ops.suffix_sort import Kiss1Sorter, Kiss2Sorter

    for name in ("genome20k", "random4k", "repeat3k"):
        data = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
        text = data["text"]
        for sorter in (Kiss1Sorter, Kiss2Sorter):
            sa = sorter.get_suffix_array_dna(text, -1)
            for algo in ("kiss1", "kiss2"):
                expect(np.array_equal(sa, data[f"sa_{algo}_k-1"]),
                       f"{name} {sorter.__name__} k=-1 differs from {algo}")
        for k in (16, 32, 256):
            sa = Kiss1Sorter.get_suffix_array_dna(text, k)
            for algo in ("kiss1", "kiss2"):
                check_tie_groups(text, sa, data[f"sa_{algo}_k{k}"], k,
                                 f"{name} k={k} vs {algo}")
        raw = data["patterns"].tobytes()
        qlen, nq = struct.unpack("<II", raw[:8])
        queries = np.frombuffer(raw[8:], np.int8).reshape(nq, qlen)
        want = tuple(int(x) for x in data["query_stats"])
        built = FMIndex(sa_intv=4, lookup_len=0).build(text)
        loaded = FMIndex(sa_intv=4).load(io.BytesIO(data["fmi"].tobytes()))
        for what, fmi in (("built", built), ("reference archive", loaded)):
            got = fmi.batch_query_stats(queries)
            expect(got == want, f"{name} {what} query stats {got} != {want}")
        if name == "random4k":
            buf = io.BytesIO()
            built.save(buf)
            expect(buf.getvalue() == data["fmi"].tobytes(),
                   "random4k .fmi differs from the reference's bytes")
        print(f"  {name}: SA, tie groups and query stats match", flush=True)


def suffix_sort_phase(run: Run, text: np.ndarray, fa: str,
                      rng: np.random.Generator) -> None:
    """Phase 2: suffix_sort at k = 256 three ways, one SA."""
    from kiss_tpu.ops.external_sort import external_k_ordered_suffix_array
    from kiss_tpu.ops.suffix_sort import Kiss1Sorter, Kiss2Sorter

    n = len(text)
    runs = (
        ([], lambda: Kiss1Sorter.get_suffix_array_dna(text, K, 0)),
        (["-s", "PREFIX_DOUBLING"],
         lambda: Kiss2Sorter.get_suffix_array_dna(text, K, 0)),
        (["--external"], lambda: external_k_ordered_suffix_array(text, K)),
    )
    for i, (argv, collect) in enumerate(runs):
        lines = run.cli("suffix_sort", "-k", str(K), *argv, fa)
        logged = logged_int(lines, r"n = (\d+), k = 256, suffix sorting")
        expect(logged == n, f"suffix_sort logged n = {logged}, want {n}")
        run.print_peaks("  after suffix_sort " + " ".join(argv), n)
        sa = collect()
        if i == 0:
            first = sa
            check_suffix_array(text, sa, K, rng)
            print("  default SA: permutation, SA[0] = n, adjacent pairs "
                  "k-ordered", flush=True)
        else:
            expect(np.array_equal(sa, first),
                   f"suffix_sort {' '.join(argv)} SA differs from default")
            print(f"  suffix_sort {' '.join(argv)}: SA identical", flush=True)


def fmindex_build_phase(run: Run, text: np.ndarray, fa: str, fa32: str,
                        rng: np.random.Generator) -> None:
    """Phase 3: the full-sort archive and the -k 32 archive."""
    from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array

    n = len(text)
    run.cli("fmindex_build", fa)
    run.print_peaks("  after fmindex_build", n)
    check_suffix_array(text, k_ordered_suffix_array(text, -1), None, rng)
    print("  full SA: permutation, SA[0] = n, adjacent pairs ordered",
          flush=True)
    run.cli("fmindex_build", "-k", "32", fa32)
    run.print_peaks("  after fmindex_build -k 32", n)
    check_suffix_array(text, k_ordered_suffix_array(text, 32), 32, rng)
    print("  32-ordered SA: permutation, SA[0] = n, adjacent pairs "
          "32-ordered", flush=True)


def query_phase(run: Run, text: np.ndarray, fa: str, fa32: str,
                planted: list[int]) -> None:
    """Phase 4: -q, -b on both archives, and serve."""
    import bench
    from kiss_tpu import cli
    from kiss_tpu.utils import codec

    n = len(text)
    want_q = find_all(text, codec.to_istring(PLANT))
    expect(set(planted) <= set(want_q.tolist()), "planting failed")
    lines = run.cli("fmindex_query", "-q", PLANT, "-n", "100", fa)
    expect_positions(lines, PLANT, want_q, 100)
    print(f"  -q {PLANT}: {len(want_q)} positions, planted at {planted}",
          flush=True)

    patterns = bench.sample_patterns(text, NQ, QLEN)
    batch = write_batch(run.path("patterns.bin"), patterns)
    ref = KmerReference(text, QLEN)
    want = ref.stats(patterns)
    for archive in (fa, fa32):
        got = batch_stats(run.cli("fmindex_query", "-b", batch, archive))
        expect(got == want, f"-b on {os.path.basename(archive)}: (occ, "
               f"checksum) {got} != numpy reference {want}")
    print(f"  -b {NQ} x {QLEN}: occ {want[0]}, checksum {want[1]} on both "
          "archives, equal to the numpy reference", flush=True)

    second = codec.to_string(text[n // 3 : n // 3 + len(PLANT)])
    want_second = find_all(text, codec.to_istring(second))
    args = cli.build_parser().parse_args(
        ["serve", "--warm", str(len(PLANT)), "-n", "100", fa]
    )
    stdin = io.StringIO(f"{PLANT}\n{second}\nbatch {batch}\nquit\n")
    stdout = io.StringIO()
    start = len(run.log.lines)
    cli.serve_main(args, stdin=stdin, stdout=stdout)
    lines = run.log.lines[start:]
    out = stdout.getvalue().splitlines()
    expect(len(out) == 4 and out[0] == "ready"
           and all(ln.startswith("ok ") for ln in out[1:]),
           f"serve printed {stdout.getvalue()!r}")
    expect_positions(lines, PLANT, want_q, 100)
    expect_positions(lines, second, want_second, 100)
    expect(batch_stats(lines) == want, "serve batch stats differ")
    print(f"  serve: {out}, same answers", flush=True)


def device_phase(devices) -> None:
    """Phase 0: name the device, the card and the host library."""
    import jax

    from kiss_tpu.utils import compile_cache, native, timing

    # the CLI's stderr log, so that a failed native build says why
    timing.setup_logging()
    print(f"jax {jax.__version__}; platform {devices[0].platform}; "
          f"device_kind {devices[0].device_kind}; device count "
          f"{len(devices)} (of {len(jax.devices())} visible)")
    print("card name, power limit (nvidia-smi):")
    for line in card_lines():
        print(line)
    print(f"native host library built: {native.available()}; compile "
          f"cache: {compile_cache.cache_dir()}", flush=True)


def one_card(run: Run, n: int, seed: int, golden: bool = True) -> None:
    rng = np.random.default_rng(seed + 1)
    if golden:
        with run.phase("phase 1 golden fixtures"):
            golden_phase()
    text, planted = make_corpus(n, seed)
    fa = write_fasta(run.path("ref.fa"), text)
    fa32 = run.path("ref_k32.fa")
    shutil.copyfile(fa, fa32)
    with run.phase(f"phase 2 suffix_sort n={n} k={K}", n):
        suffix_sort_phase(run, text, fa, rng)
    with run.phase(f"phase 3 fmindex_build n={n}", n):
        fmindex_build_phase(run, text, fa, fa32, rng)
    with run.phase(f"phase 4 fmindex_query and serve n={n}", n):
        query_phase(run, text, fa, fa32, planted)


@contextlib.contextmanager
def returns_of(cls, name: str):
    """Collect what the classmethod ``cls.name`` returns while the block
    runs, so that an array the CLI computes and drops can be checked
    without computing it again."""
    own = cls.__dict__.get(name)
    orig = getattr(cls, name)
    got: list = []

    def spy(*args, **kwargs):
        got.append(orig(*args, **kwargs))
        return got[-1]

    setattr(cls, name, spy)
    try:
        yield got
    finally:
        if own is None:
            delattr(cls, name)
        else:
            setattr(cls, name, own)


def four_cards(run: Run, n: int, seed: int) -> None:
    """The -t 4 paths, each compared with one card in this process. The
    sharded runs go first so the per-device peaks show their own split;
    ``--verbose`` logs the time of each of their sort rounds."""
    import bench
    import jax
    import jax.numpy as jnp

    from kiss_tpu.ops.suffix_sort import Kiss1Sorter
    from kiss_tpu.parallel import make_mesh
    from kiss_tpu.parallel.dsort import sharded_k_ordered_suffix_array

    text, _ = make_corpus(n, seed)
    fa1 = write_fasta(run.path("ref.fa"), text)
    fa4 = run.path("ref_t4.fa")
    shutil.copyfile(fa1, fa4)
    batch = write_batch(run.path("patterns.bin"),
                        bench.sample_patterns(text, NQ, QLEN))
    with run.phase(f"four cards: sharded paths n={n}", n):
        with returns_of(Kiss1Sorter, "get_suffix_array_dna") as got:
            run.cli("suffix_sort", "--verbose", "-t", "4", "-k", str(K), fa4)
        (sa_col,) = got
        run.print_peaks("  after suffix_sort -t 4 (columnsort)", n)
        run.cli("fmindex_build", "--verbose", "-t", "4", fa4)
        run.print_peaks("  after fmindex_build -t 4", n)
        stats4 = batch_stats(run.cli("fmindex_query", "-t", "4", "-b",
                                     batch, fa4))
        run.print_peaks("  after fmindex_query -t 4", n)
        trace = (jax.profiler.trace(os.path.join(run.profile, "sample"))
                 if run.profile else contextlib.nullcontext())
        with run.timed("  sample sort -t 4 -k 256"), trace:
            sa_smp = np.asarray(sharded_k_ordered_suffix_array(
                make_mesh(4), jnp.asarray(text), K, algorithm="sample"
            )).astype(np.uint32)
        run.print_peaks("  after sample sort", n)
    with run.phase(f"four cards: one-card comparison n={n}", n):
        with returns_of(Kiss1Sorter, "get_suffix_array_dna") as got:
            run.cli("suffix_sort", "-k", str(K), fa1)
        (sa1,) = got
        expect(np.array_equal(sa_col, sa1), "columnsort SA != one card")
        expect(np.array_equal(sa_smp, sa1), "sample-sort SA != one card")
        print("  suffix_sort -t 4: columnsort and sample SA identical to "
              "one card", flush=True)
        run.cli("fmindex_build", fa1)
        with open(fa1 + ".fmi", "rb") as f1, open(fa4 + ".fmi", "rb") as f4:
            expect(f1.read() == f4.read(), ".fmi -t 4 differs from one card")
        print("  fmindex_build -t 4: .fmi byte-identical to one card",
              flush=True)
        stats1 = batch_stats(run.cli("fmindex_query", "-b", batch, fa1))
        expect(stats4 == stats1, f"-t 4 query {stats4} != one card {stats1}")
        print(f"  fmindex_query -t 4 -b: occ {stats1[0]}, checksum "
              f"{stats1[1]}, equal to one card", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the -t 4 paths and their one-card "
                    "comparison, on four GPUs")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthesized text and patterns")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a jax.profiler trace of every CLI command "
                    "to its own directory under DIR")
    args = ap.parse_args(argv)
    expect(os.path.isdir(os.path.join(HERE, "kiss_tpu")),
           "chip_smoke.py runs from a checkout of the repository")

    import jax

    devices = jax.devices()
    want = 4 if args.four_cards else 1
    require_gpu(devices, want)
    devices = devices[:want]
    d = devices[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        run = Run(workdir, devices, args.profile)
        with run.phase("phase 0 device"):
            device_phase(devices)
        if args.four_cards:
            four_cards(run, N_DROSOPHILA, args.seed)
        else:
            one_card(run, N_DROSOPHILA, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
