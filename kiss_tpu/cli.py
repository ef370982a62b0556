"""Command-line interface mirroring the reference ``kISS`` binary.

Reference surface (reference: src/main.cpp:19-40,
include/utils/options.hpp:20-300): three subcommands with a two-stage
option parse, generic options ``-h -v -g -t --verbose``, positional FASTA
argument, and per-command flags. Same commands, same flags, same
defaults, same log lines here -- so scripts written against the
reference binary keep working.
"""

from __future__ import annotations

import argparse
import struct
import sys

import numpy as np

from kiss_tpu import BANNER, VERSION
from kiss_tpu.models import fm_index as fm_meta
from kiss_tpu.models.fm_index import FMIndex
from kiss_tpu.ops.lms_native import LmsSorter
from kiss_tpu.ops.suffix_sort import Kiss1Sorter, Kiss2Sorter
from kiss_tpu.utils import codec, fasta, timing

SORTING_ALGORITHMS = {
    "PARALLEL_SORTING": Kiss1Sorter,
    "PREFIX_DOUBLING": Kiss2Sorter,
    "LMS_INDUCED": LmsSorter,
}


def _add_generic(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "-g",
        "--generic",
        action="store_true",
        help="(Under construction) input contains bases other than ATCG",
    )
    p.add_argument(
        "-t",
        "--num_threads",
        type=int,
        default=0,
        metavar="NUM",
        help="number of threads (accepted for parity; the device mesh "
        "is the parallelism knob)",
    )
    p.add_argument(
        "--verbose", action="store_true", help="print more information"
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        help="write a jax.profiler device trace for this command to DIR "
        "(the device analog of the reference's per-stage spdlog "
        "stopwatches)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kISS", add_help=True)
    p.add_argument("-v", "--version", action="store_true", help="print version")
    sub = p.add_subparsers(dest="command")

    ss = sub.add_parser("suffix_sort", help="build a k-ordered suffix array")
    _add_generic(ss)
    ss.add_argument(
        "-k",
        "--kordered",
        type=int,
        default=256,
        metavar="NUM",
        help="sort each suffix by its first k characters; -1 = unbounded",
    )
    ss.add_argument(
        "-s",
        "--sorting-algorithm",
        dest="sorting_algorithm",
        type=str.upper,
        choices=sorted(SORTING_ALGORITHMS),
        default="PARALLEL_SORTING",
        metavar="ALGO",
        help="PARALLEL_SORTING: 64-char raw-word seed + 8-key rank "
        "rounds (kISS-1's bucketed direct sort re-expressed; the fast "
        "default). PREFIX_DOUBLING: 16-char super-char seed + 2-key "
        "doubling rounds (kISS-2's prefix doubling re-expressed). "
        "Identical output order either way (exact-k cut, position "
        "tiebreaks). LMS_INDUCED: the reference's LMS direct sort + "
        "induced L/S passes as native host C++ (csrc/kiss_lms.cpp; "
        "reference kiss_common.hpp:40-579) -- the reference's weaker "
        "contract: tie-group order unspecified at bounded k, "
        "bit-identical at -1; -t caps its OpenMP threads; runs "
        "host-resident (never routed out-of-core).",
    )
    ss.add_argument(
        "--external",
        action="store_true",
        help="use the out-of-core sorter (host-staged MSD buckets + "
        "batch device sorts): for texts too large for the in-core "
        "pipeline's device buffers (chm13-scale). Auto-selected when "
        "the text exceeds the device-memory-derived in-core capacity "
        "(40 B/char vs device memory x mesh size); this flag forces it.",
    )
    ss.add_argument("fasta", help="FASTA/text file path")

    fb = sub.add_parser("fmindex_build", help="build and save an FM-index")
    _add_generic(fb)
    fb.add_argument(
        "-k",
        "--kordered",
        type=int,
        default=None,
        metavar="NUM",
        help="sort depth of the underlying suffix array; -1 = unbounded. "
        "The reference declares this flag but hardcodes sort_len = 32 "
        "(reference: include/utils/options.hpp:133-141 vs "
        "fm_index.hpp:384-386); here it is honored as the sort depth. "
        "Default (omitted): a FULLY sorted SA, which keeps locate exact "
        "for every pattern length (see models/fm_index.py SORT_LEN note).",
    )
    fb.add_argument(
        "-l", "--lookup-len", type=int, default=0, dest="lookup_len",
        help="seed-table depth: precompute ranges of all 4^L length-L "
        "seeds so queries skip their last L backward-search steps "
        "(reference FMIndex LOOKUP_LEN parameter, fm_index.hpp:237-269; "
        "the reference CLI uses 0). Queries read it from the archive.",
    )
    fb.add_argument("fasta", help="FASTA/text file path")

    fq = sub.add_parser("fmindex_query", help="query a saved FM-index")
    _add_generic(fq)
    fq.add_argument(
        "--assume-full-sa",
        action="store_true",
        dest="assume_full_sa",
        help="treat the archive as built from a FULLY sorted suffix "
        "array: locate uses the fast per-row LF walk instead of the "
        "order-robust range BFS. Archives built by this tool's "
        "fmindex_build record this in a `.meta` sidecar and route "
        "automatically; the flag exists for archives whose sidecar was "
        "lost. WRONG positions on long repeats if the SA was only "
        "k-ordered (e.g. reference-binary archives, which are 32-ordered"
        " -- reference: fm_index.hpp:384-386).",
    )
    fq.add_argument("-q", "--query", type=str, help="single pattern to search")
    fq.add_argument(
        "-n", "--headn", type=int, default=10, metavar="NUM",
        help="print at most this many positions",
    )
    fq.add_argument(
        "-b", "--batch", type=str,
        help="binary pattern file: u32 query_len, u32 num_query, then "
        "fixed-length ASCII patterns",
    )
    fq.add_argument("fasta", help="FASTA/text file path")

    sv = sub.add_parser(
        "serve",
        help="long-lived query server: load the index and pay the jit "
        "compile ONCE, then answer patterns from stdin until EOF. "
        "Avoids the per-invocation load and compile latency of "
        "fmindex_query. Protocol: one pattern per "
        "line (answered like -q); 'batch <file>' runs a -b pattern "
        "file; blank line or 'quit' exits. Prints 'ready' after "
        "warmup and 'ok <seconds>' after each request on stdout.",
    )
    _add_generic(sv)
    sv.add_argument(
        "--assume-full-sa", action="store_true", dest="assume_full_sa",
        help="same as the fmindex_query flag",
    )
    sv.add_argument(
        "-n", "--headn", type=int, default=10, metavar="NUM",
        help="print at most this many positions per pattern",
    )
    sv.add_argument(
        "--warm", type=int, default=0, metavar="LEN",
        help="pre-compile the search+locate programs for patterns of "
        "this length before signalling ready (first real query then "
        "runs at steady-state latency)",
    )
    sv.add_argument("fasta", help="FASTA/text file path")
    return p


def _read_folded(path: str) -> np.ndarray:
    """read_sequence + the c % 4 alphabet fold every command applies
    (reference: include/command/suffix_sort.hpp:29-33)."""
    seq = fasta.read_sequence(path)
    return codec.fold_to_acgt(seq)


def _reject_generic(args) -> None:
    if getattr(args, "generic", False):
        # reference: every command throws on --generic
        # (include/command/suffix_sort.hpp:26-28)
        raise SystemExit(
            "Generic sorting and indexing are currently not supported."
        )


# in-core device-buffer cost model of suffix_sort, the one command it
# routes: peak device bytes per character, 37.0 measured with
# peak_bytes_in_use on an H100 at n = 48.8M, k = 256 (chip_smoke.py),
# plus a margin; the routing threshold is derived from the device's
# memory limit so no text that passes the in-core route can exceed the
# device budget. fmindex_build is not routed by it.
IN_CORE_BYTES_PER_CHAR = 40
# safety margin against the cost model (runtime reserves, fragmentation)
IN_CORE_MEM_FRACTION = 0.9
# the CPU backend reports no memory limit: a fixed capacity for it
EXTERNAL_THRESHOLD_FALLBACK = 350_000_000


def in_core_capacity_chars(device=None) -> int:
    """Largest text (chars) the in-core pipeline should attempt on one
    device: ``bytes_limit`` from ``device.memory_stats()`` on an
    accelerator, a fixed constant on the CPU backend.
    ``KISS_TPU_INCORE_CAP=<chars>`` overrides both."""
    import os

    override = os.environ.get("KISS_TPU_INCORE_CAP")
    if override:
        return int(override)
    if device is None:
        import jax

        device = jax.devices()[0]
    if device.platform == "cpu":
        return EXTERNAL_THRESHOLD_FALLBACK
    limit = (device.memory_stats() or {}).get("bytes_limit")
    if not limit:
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "bytes_limit; set KISS_TPU_INCORE_CAP=<chars> or pass --external"
        )
    return int(int(limit) * IN_CORE_MEM_FRACTION) // IN_CORE_BYTES_PER_CHAR


def suffix_sort_main(args) -> None:
    _reject_generic(args)
    seq = _read_folded(args.fasta)
    sorter = SORTING_ALGORITHMS[args.sorting_algorithm]
    ref = sorter.prepare_aligned_ref(seq)
    from kiss_tpu.ops.suffix_sort import _mesh_size_for

    # the sharded in-core pipeline splits its buffers over the mesh, so
    # a multi-device -t raises the in-core capacity proportionally
    # (a mesh that can hold the text is not auto-routed to the
    # host-staged external sorter). The 1/D per-device scaling is the
    # design contract of the P(seq)-sharded pipeline; if a mesh run
    # runs out of memory, --external (or KISS_TPU_INCORE_CAP) forces
    # the out-of-core path.
    d = _mesh_size_for(args.num_threads)
    capacity = in_core_capacity_chars() * max(d, 1)
    # LMS_INDUCED is host-resident (~10 B/char of host RAM, no device
    # buffers), so the device-memory auto-route does not apply to it;
    # an explicit --external still wins.
    host_resident = args.sorting_algorithm == "LMS_INDUCED"
    sw = timing.Stopwatch()
    if args.external or (len(ref) >= capacity and not host_resident):
        if not args.external:
            timing.log_info(
                "routing: n = %d exceeds the in-core device budget "
                "(%d chars x %d device(s)); using the out-of-core "
                "sorter (host-staged; -s/-t do not apply on this path)",
                len(ref), capacity // max(d, 1), d,
            )
        from kiss_tpu.ops.external_sort import (
            external_k_ordered_suffix_array,
        )

        external_k_ordered_suffix_array(
            ref, args.kordered, verbose=timing.debug_enabled()
        )
    else:
        sorter.get_suffix_array_dna(ref, args.kordered, args.num_threads)
    timing.log_info(
        "n = %d, k = %d, suffix sorting elapsed %.6f",
        len(ref), args.kordered, sw.elapsed(),
    )


def _build_sharded(fmi: FMIndex, seq: np.ndarray, sort_len, d: int) -> None:
    """fmindex_build over a d-device mesh: sharded suffix sort + sharded
    index build, trimmed to the canonical serialization layout -- so the
    written `.fmi` is byte-identical to the single-device build
    (tests/test_cli.py::test_cli_num_threads_sharded_build). The product
    wiring of the reference -t knob (src/main.cpp:22-26) for
    fmindex_build."""
    import jax.numpy as jnp

    from kiss_tpu.parallel import make_mesh
    from kiss_tpu.parallel.dsort import sharded_k_ordered_suffix_array
    from kiss_tpu.parallel.fm_build import build_index_sharded, trim_canonical

    timing.log_debug("fmindex_build: sharded build over %d devices", d)
    mesh = make_mesh(d)
    text = jnp.asarray(np.ascontiguousarray(seq, dtype=np.int8))
    fmi.full_sa = (
        sort_len is None or sort_len < 0 or sort_len >= len(seq)
    )
    with timing.stage("suffix sort (sharded)"):
        sa = sharded_k_ordered_suffix_array(
            mesh, text, -1 if sort_len is None else sort_len
        )
    with timing.stage("fmindex build (sharded)") as out:
        arrays = build_index_sharded(mesh, text, sa, fmi.sa_intv)
        arrays = trim_canonical(arrays, len(seq) + 1, fmi.sa_intv)
        out["block_on"] = arrays
    fmi.arrays = arrays
    fmi.n_rows = len(seq) + 1
    fmi._build_lookup()


def fmindex_build_main(args) -> None:
    _reject_generic(args)
    seq = _read_folded(args.fasta)
    fmi = FMIndex(sa_intv=4, lookup_len=args.lookup_len)
    # -k omitted -> the full-sort default (None); -k N -> N-ordered SA
    # (-1 = unbounded, same wrap rule as suffix_sort, README.md:56)
    sort_len = args.kordered
    if sort_len is not None and sort_len < 0:
        sort_len = None
    from kiss_tpu.ops.suffix_sort import _mesh_size_for

    d = _mesh_size_for(args.num_threads)
    if d > 1:
        _build_sharded(fmi, seq, sort_len, d)
    else:
        fmi.build(seq, sort_len=sort_len)
    fmi_path = args.fasta + ".fmi"
    with open(fmi_path, "wb") as fout:
        fmi.save(fout)
    # provenance sidecar: lets fmindex_query route locate through the
    # fast per-row walk when (and only when) the source SA was fully
    # sorted (the `.fmi` bytes stay reference-compatible; see
    # models/fm_index.py SORT_LEN + META_SUFFIX notes)
    fm_meta.write_meta(
        fmi_path, full_sa=fmi.full_sa, sort_len=sort_len,
        lookup_len=args.lookup_len,
    )


def _ordinal(x: int) -> str:
    # reference: include/command/fmindex_query.hpp:42-53
    x %= 100
    if x // 10 == 1:
        return "th"
    return {1: "st", 2: "nd", 3: "rd"}.get(x % 10, "th")


def _load_query_engine(args):
    """Shared fmindex_query/serve setup: read + load + locate routing +
    mesh selection. Returns (seq, engine)."""
    seq = _read_folded(args.fasta)
    fmi = FMIndex(sa_intv=4, lookup_len=0)
    fmi_path = args.fasta + ".fmi"
    with open(fmi_path, "rb") as fin:
        fmi.load(fin)
    # locate routing: the fast per-row walk is exact only over a fully
    # sorted source SA; trust the build-time sidecar (or the explicit
    # flag) -- otherwise stay on the order-robust BFS (correct for
    # reference-written 32-ordered archives)
    meta = fm_meta.read_meta(fmi_path)
    if args.assume_full_sa or (meta is not None and meta.get("full_sa")):
        fmi.full_sa = True

    # -t N (N > 1): run the search (and, for full-sort indexes, the
    # locate walk) over an N-device mesh with the index row-sharded --
    # the reference -t knob (src/main.cpp:22-26) as a real multi-chip
    # query path. Results identical to -t 1.
    from kiss_tpu.ops.suffix_sort import _mesh_size_for

    d = _mesh_size_for(args.num_threads)
    engine = fmi
    if d > 1:
        from kiss_tpu.parallel import make_mesh
        from kiss_tpu.parallel.fm_sharded import ShardedFMQuery

        timing.log_debug("fmindex_query: index sharded over %d devices", d)
        engine = ShardedFMQuery(make_mesh(d), fmi)
    return seq, engine


def _single_query(engine, seq, pattern: str, headn: int) -> None:
    """The -q path (reference: include/command/fmindex_query.hpp:34-64)."""
    iq = codec.fold_to_acgt(codec.to_istring(pattern))
    beg, end, _ = engine.get_range(iq)
    positions = engine.get_offsets(beg, end)
    timing.log_info(
        "query = %s found %d times",
        codec.to_string(iq), len(positions),
    )
    for i in range(min(headn, len(positions))):
        loc = int(positions[i])
        timing.log_info(
            "The %d-%s position is %d, content of substring is %s",
            i + 1, _ordinal(i + 1), loc,
            codec.to_string(seq[loc : loc + len(iq)]),
        )


def _batch_query(engine, batch_path: str) -> None:
    """The -b path (reference: include/command/fmindex_query.hpp:66-99)."""
    with open(batch_path, "rb") as pfile:
        query_len, num_query = struct.unpack("<II", pfile.read(8))
        timing.log_info(
            "query_len: %d, num_query: %d", query_len, num_query
        )
        raw = pfile.read(query_len * num_query)
    buf = np.frombuffer(raw, dtype=np.uint8).reshape(num_query, query_len)
    queries = codec.fold_to_acgt(codec.to_istring(buf.reshape(-1))).reshape(
        num_query, query_len
    )
    # chunk boundaries land on remaining-count multiples of 100k so
    # the per-100k progress line matches the reference batch loop
    # (reference: include/command/fmindex_query.hpp:92-93 logs
    # "remain: {}, time: {}" whenever num_query % 100000 == 0)
    occ, checksum, elapsed = 0, 0, 0.0
    done = 0
    while done < num_query:
        step = num_query % 100_000 if done == 0 else 100_000
        step = step or min(100_000, num_query)
        sw = timing.Stopwatch()
        o, c = engine.batch_query_stats(queries[done : done + step])
        elapsed += sw.elapsed()
        occ += o
        checksum += c
        done += step
        timing.log_debug("remain: %d, time: %s", num_query - done, elapsed)
    timing.log_info("searching time: %s seconds", elapsed)
    timing.log_info("number of matched locations: %d", occ)
    timing.log_info("location checksum: %d", checksum)


def fmindex_query_main(args) -> None:
    _reject_generic(args)
    seq, engine = _load_query_engine(args)
    if args.query:
        _single_query(engine, seq, args.query, args.headn)
    if args.batch:
        _batch_query(engine, args.batch)


def serve_main(args, stdin=None, stdout=None) -> None:
    """Long-lived query loop: the index load and jit compile are paid
    once per process, so every request after the first runs at
    steady-state latency (the reference binary has no compile step,
    README.md:120-137 shows ms-scale queries). ``stdin``/``stdout`` are
    injectable for tests."""
    _reject_generic(args)
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout
    seq, engine = _load_query_engine(args)
    if args.warm > 0:
        # compile the search + locate programs for this pattern length
        warm = codec.to_string(seq[: args.warm]) if len(seq) >= args.warm \
            else "A" * args.warm
        iq = codec.fold_to_acgt(codec.to_istring(warm))
        beg, end, _ = engine.get_range(iq)
        engine.get_offsets(beg, end)
    print("ready", file=stdout, flush=True)
    for line in stdin:
        line = line.strip()
        if not line or line in ("quit", "exit"):
            break
        sw = timing.Stopwatch()
        # one bad request (missing batch file, malformed pattern) must
        # not kill the server -- the compile investment it amortizes is
        # the whole point; report `err <reason>` and keep serving
        try:
            if line.startswith("batch "):
                _batch_query(engine, line[len("batch "):].strip())
            else:
                _single_query(engine, seq, line, args.headn)
        except Exception as e:  # noqa: BLE001 -- protocol boundary
            timing.log_info("serve: request failed: %s", e)
            print(f"err {type(e).__name__}: {e}", file=stdout, flush=True)
            continue
        print(f"ok {sw.elapsed():.3f}", file=stdout, flush=True)


COMMANDS = {
    "suffix_sort": suffix_sort_main,
    "fmindex_build": fmindex_build_main,
    "fmindex_query": fmindex_query_main,
    "serve": serve_main,
}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.version:
        print(VERSION)
        return 0
    if not args.command:
        print(BANNER)
        parser.print_help()
        return 0
    timing.setup_logging(verbose=getattr(args, "verbose", False))
    from kiss_tpu.utils import compile_cache

    compile_cache.enable()
    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        import jax

        with jax.profiler.trace(profile_dir):
            COMMANDS[args.command](args)
    else:
        COMMANDS[args.command](args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
