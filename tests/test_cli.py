"""End-to-end CLI tests: the reference workloads 1-3 (SURVEY.md intro)
driven through the mirrored command surface."""

import struct

import numpy as np
import pytest

from kiss_tpu import cli
from kiss_tpu.utils import codec, fasta
from tests import oracle


@pytest.fixture(scope="module")
def fa_path(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    text = oracle.random_dna(20_000, seed=99)
    path = tmp / "ref.fa"
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    return str(path), text


def test_suffix_sort_command(fa_path, capsys):
    path, _ = fa_path
    assert cli.main(["suffix_sort", "-k", "64", path]) == 0
    assert (
        cli.main(
            ["suffix_sort", "-s", "prefix_doubling", "-k", "-1", path]
        )
        == 0
    )


def test_suffix_sort_external_flag(fa_path):
    """--external routes through the out-of-core sorter (same contract,
    host-staged; the auto path for chm13-scale inputs)."""
    path, _ = fa_path
    assert cli.main(["suffix_sort", "--external", "-k", "64", path]) == 0


def test_in_core_capacity_from_device_memory():
    """Routing threshold derives from device memory; no text under the
    threshold can exceed the in-core device budget."""

    class Dev:
        platform = "gpu"
        device_kind = "fake accelerator"

        def __init__(self, stats):
            self._stats = stats

        def memory_stats(self):
            return self._stats

    # 16 GB of device memory -> 16e9 * 0.9 / IN_CORE_BYTES_PER_CHAR
    cap16 = cli.in_core_capacity_chars(Dev({"bytes_limit": 16_000_000_000}))
    assert cap16 == int(16_000_000_000 * 0.9) // cli.IN_CORE_BYTES_PER_CHAR
    assert cap16 * cli.IN_CORE_BYTES_PER_CHAR <= 16_000_000_000 * 0.9
    # twice the memory, twice the capacity (up to the integer division)
    cap32 = cli.in_core_capacity_chars(Dev({"bytes_limit": 32_000_000_000}))
    assert cap32 == int(32_000_000_000 * 0.9) // cli.IN_CORE_BYTES_PER_CHAR
    assert cap32 // 2 == cap16


class _CpuDev:
    platform = "cpu"
    device_kind = "cpu"

    def memory_stats(self):
        raise AssertionError("the CPU capacity is a constant")


def test_in_core_capacity_cpu_fallback():
    """The CPU backend reports no memory limit: the fixed constant."""
    assert (
        cli.in_core_capacity_chars(_CpuDev())
        == cli.EXTERNAL_THRESHOLD_FALLBACK
    )
    assert cli.in_core_capacity_chars() == cli.EXTERNAL_THRESHOLD_FALLBACK


@pytest.mark.parametrize("stats", [None, {}, {"bytes_in_use": 1}])
def test_in_core_capacity_accelerator_without_limit_raises(stats):
    """An accelerator that reports no bytes_limit is an error, not a
    guess: routing a text in-core on a made-up budget can run the card
    out of memory."""

    class Gpu:
        platform = "gpu"
        device_kind = "fake GPU"

        def memory_stats(self):
            return stats

    with pytest.raises(RuntimeError, match="bytes_limit"):
        cli.in_core_capacity_chars(Gpu())


def test_in_core_capacity_override(monkeypatch):
    monkeypatch.setenv("KISS_TPU_INCORE_CAP", "1234")
    assert cli.in_core_capacity_chars(_CpuDev()) == 1234


def test_auto_route_logs_and_respects_mesh(tmp_path, monkeypatch, caplog):
    """When n exceeds the derived capacity the CLI logs the routing
    decision (ADVICE r4: never silently ignore -s/-t); a multi-device
    -t scales the in-core capacity so a mesh that can hold the text is
    not auto-routed to the host-staged external path."""
    import logging

    text = oracle.random_dna(4_000, seed=13)
    path = str(tmp_path / "small.fa")
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    monkeypatch.setattr(cli, "in_core_capacity_chars", lambda device=None: 1_000)

    external_calls = []
    import kiss_tpu.ops.external_sort as ext

    real = ext.external_k_ordered_suffix_array

    def spy(ref, k, **kw):
        external_calls.append(len(ref))
        return real(ref, k, **kw)

    monkeypatch.setattr(ext, "external_k_ordered_suffix_array", spy)
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        assert cli.main(["suffix_sort", "-k", "16", path]) == 0
    assert external_calls == [4_000]
    assert any(
        "routing: n = 4000 exceeds" in r.getMessage()
        for r in caplog.records
    )

    # -t 8 on the 8-virtual-device mesh raises capacity to 8k >= n:
    # stays in-core (sharded), external sorter not called
    external_calls.clear()
    assert cli.main(["suffix_sort", "-k", "16", "-t", "8", path]) == 0
    assert external_calls == []


def test_generic_rejected(fa_path):
    path, _ = fa_path
    with pytest.raises(SystemExit):
        cli.main(["suffix_sort", "-g", path])


def test_build_then_query(fa_path, tmp_path):
    path, text = fa_path
    assert cli.main(["fmindex_build", path]) == 0

    q = codec.to_string(text[500:511])
    assert cli.main(["fmindex_query", "-q", q, "-n", "3", path]) == 0

    # batch file: u32 len, u32 count, fixed-length ASCII patterns
    # (reference: include/command/fmindex_query.hpp:66-75)
    rng = np.random.default_rng(1)
    qlen, nq = 11, 40
    pats = []
    for _ in range(nq):
        p = int(rng.integers(0, len(text) - qlen))
        pats.append(codec.to_string(text[p : p + qlen]))
    bpath = tmp_path / "patterns.bin"
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        for p in pats:
            f.write(p.encode())
    assert cli.main(["fmindex_query", "-b", str(bpath), path]) == 0


def test_version():
    assert cli.main(["-v"]) == 0


def test_fmindex_build_lookup_len_roundtrip(tmp_path, capsys):
    """--lookup-len writes the seed table into the archive and queries
    pick it up transparently (counts/positions unchanged)."""
    import numpy as np

    from kiss_tpu.cli import main
    from kiss_tpu.utils import codec, fasta

    rng = np.random.default_rng(5)
    text = rng.integers(0, 4, 3000).astype(np.int8)
    pat = codec.to_istring("GATTACAGA")
    text[700 : 700 + len(pat)] = pat
    text[2200 : 2200 + len(pat)] = pat
    fa = tmp_path / "ref.fa"
    fasta.write_fasta(str(fa), [fasta.FastaRecord("chr", text)])

    assert main(["fmindex_build", str(fa), "--lookup-len", "4"]) == 0
    assert main(["fmindex_query", str(fa), "-q", "GATTACAGA", "-n", "5"]) == 0
    # the loaded index derives lookup_len=4 from the archive
    from kiss_tpu.models.fm_index import FMIndex

    fmi = FMIndex(sa_intv=4)
    with open(str(fa) + ".fmi", "rb") as fin:
        fmi.load(fin)
    assert fmi.lookup_len == 4
    assert fmi.arrays.lookup.shape[0] == 4**4 + 1
    beg, end, _ = fmi.get_range(codec.to_istring("GATTACAGA"))
    assert end - beg == 2
    assert sorted(fmi.get_offsets(beg, end).tolist()) == [700, 2200]


def test_fmindex_build_k_flag(fa_path):
    """The reference declares -k on fmindex_build (reference:
    include/utils/options.hpp:133-141); here it is honored as the sort
    depth (-1 wraps to unbounded like suffix_sort, README.md:56)."""
    path, text = fa_path
    assert cli.main(["fmindex_build", "-k", "32", path]) == 0
    assert cli.main(["fmindex_query", "-q", codec.to_string(text[40:51]),
                     path]) == 0
    assert cli.main(["fmindex_build", "-k", "-1", path]) == 0


def _query_instance(monkeypatch, argv):
    """Run fmindex_query via the CLI, capturing the FMIndex instance so
    routing state (full_sa) is observable."""
    from kiss_tpu.models.fm_index import FMIndex

    seen = {}

    class Spy(FMIndex):
        def load(self, fin):
            out = super().load(fin)
            seen["fmi"] = self
            return out

    monkeypatch.setattr(cli, "FMIndex", Spy)
    assert cli.main(argv) == 0
    return seen["fmi"]


def test_provenance_sidecar_routes_locate(tmp_path, monkeypatch):
    """fmindex_build records full_sa in a `.meta` sidecar and
    fmindex_query routes locate through the fast per-row walk for
    full-sort archives, the BFS for bounded -k builds and sidecar-less
    (reference-written) archives, and honors --assume-full-sa."""
    import json
    import os

    from kiss_tpu.models import fm_index as fm

    # repeat-heavy corpus: walk-vs-BFS routing matters on long repeats
    unit = oracle.random_dna(13, seed=11)
    text = np.tile(unit, 1600)[:16_000]
    path = str(tmp_path / "rep.fa")
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    q = codec.to_string(text[26:37])

    # default build = full sort -> sidecar says full_sa -> fast walk
    assert cli.main(["fmindex_build", path]) == 0
    meta = fm.read_meta(path + ".fmi")
    assert meta is not None and meta["full_sa"] is True
    fmi = _query_instance(monkeypatch, ["fmindex_query", "-q", q, path])
    assert fmi.full_sa is True

    # sidecar lost (reference-binary archive): conservative BFS...
    os.remove(path + ".fmi" + fm.META_SUFFIX)
    fmi = _query_instance(monkeypatch, ["fmindex_query", "-q", q, path])
    assert fmi.full_sa is False
    # ...unless the user asserts provenance explicitly
    fmi = _query_instance(
        monkeypatch, ["fmindex_query", "--assume-full-sa", "-q", q, path]
    )
    assert fmi.full_sa is True

    # bounded-k build: sidecar records the bound; BFS routing stays
    assert cli.main(["fmindex_build", "-k", "32", path]) == 0
    meta = json.load(open(path + ".fmi" + fm.META_SUFFIX))
    assert meta["full_sa"] is False and meta["sort_len"] == 32
    fmi = _query_instance(monkeypatch, ["fmindex_query", "-q", q, path])
    assert fmi.full_sa is False


def test_stale_sidecar_rejected(tmp_path, monkeypatch):
    """A sidecar that no longer matches the archive content must be
    treated as absent (ADVICE r4: an archive rebuilt by the reference
    binary would otherwise inherit a stale full_sa=true and route the
    walk, returning wrong positions on long repeats)."""
    from kiss_tpu.models import fm_index as fm

    text = oracle.random_dna(4_000, seed=51)
    path = str(tmp_path / "s.fa")
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    assert cli.main(["fmindex_build", path]) == 0
    fmi_path = path + ".fmi"
    assert fm.read_meta(fmi_path)["full_sa"] is True

    # "rebuild" the archive out-of-band (what the reference binary
    # would do): same length, different content -- flipped in the
    # MIDDLE of the file, where head/tail-only probing would miss it
    blob = bytearray(open(fmi_path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(fmi_path, "wb").write(bytes(blob))
    assert fm.read_meta(fmi_path) is None

    # different size is also rejected
    open(fmi_path, "ab").write(b"\0" * 8)
    assert fm.read_meta(fmi_path) is None

    # and the query CLI consequently routes the conservative BFS
    # (archive is now corrupt for load, so only check read_meta here);
    # a legitimate rebuild refreshes the sidecar
    assert cli.main(["fmindex_build", "-k", "32", path]) == 0
    meta = fm.read_meta(fmi_path)
    assert meta is not None and meta["full_sa"] is False
    q = codec.to_string(text[10:21])
    fmi = _query_instance(monkeypatch, ["fmindex_query", "-q", q, path])
    assert fmi.full_sa is False


def _batch_file(tmp_path, text, qlen, nq, name="pats.bin"):
    rng = np.random.default_rng(17)
    bpath = tmp_path / name
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        for _ in range(nq):
            p = int(rng.integers(0, len(text) - qlen))
            f.write(codec.to_string(text[p : p + qlen]).encode())
    return str(bpath)


def _stats_from_log(caplog):
    occ = chk = None
    for r in caplog.records:
        m = r.getMessage()
        if m.startswith("number of matched locations: "):
            occ = int(m.rsplit(" ", 1)[1])
        if m.startswith("location checksum: "):
            chk = int(m.rsplit(" ", 1)[1])
    return occ, chk


def test_cli_num_threads_sharded_build_and_query(tmp_path, caplog):
    """-t N > 1 routes fmindex_build through the sharded mesh build and
    fmindex_query through the row-sharded mesh search (the product
    commands must be able to use more than one device).
    The -t 8 archive is byte-identical to -t 1, and batch occ/checksum
    match exactly."""
    import logging

    # repeat-heavy: locate routing and multi-occurrence ranges matter
    unit = oracle.random_dna(13, seed=41)
    text = np.tile(unit, 1300)[:13_000].copy()
    text[9_000:] = oracle.random_dna(4_000, seed=42)
    p1 = str(tmp_path / "a.fa")
    p8 = str(tmp_path / "b.fa")
    fasta.write_fasta(p1, [fasta.FastaRecord("chr1", text)])
    fasta.write_fasta(p8, [fasta.FastaRecord("chr1", text)])

    assert cli.main(["fmindex_build", "-t", "1", p1]) == 0
    assert cli.main(["fmindex_build", "-t", "8", p8]) == 0
    b1 = open(p1 + ".fmi", "rb").read()
    b8 = open(p8 + ".fmi", "rb").read()
    assert b1 == b8, "sharded-built .fmi must be byte-identical"

    bpath = _batch_file(tmp_path, text, 11, 64)
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        assert cli.main(["fmindex_query", "-b", bpath, p1]) == 0
    occ1, chk1 = _stats_from_log(caplog)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        assert cli.main(["fmindex_query", "-b", bpath, "-t", "8", p8]) == 0
    occ8, chk8 = _stats_from_log(caplog)
    assert occ1 is not None and occ1 > 0
    assert (occ8, chk8) == (occ1, chk1)

    # single-pattern path over the mesh: same positions as -t 1
    q = codec.to_string(text[26:37])
    assert cli.main(["fmindex_query", "-q", q, "-n", "3", "-t", "8", p8]) == 0


def test_cli_num_threads_sharded_build_with_lookup(tmp_path):
    """-t 8 build with --lookup-len: the batched lookup construction
    runs against mesh-sharded tables (GSPMD gathers) and must still
    produce a byte-identical archive."""
    text = oracle.random_dna(6_000, seed=45)
    p1 = str(tmp_path / "l1.fa")
    p8 = str(tmp_path / "l8.fa")
    fasta.write_fasta(p1, [fasta.FastaRecord("chr1", text)])
    fasta.write_fasta(p8, [fasta.FastaRecord("chr1", text)])
    assert cli.main(["fmindex_build", "--lookup-len", "4", p1]) == 0
    assert cli.main(
        ["fmindex_build", "--lookup-len", "4", "-t", "8", p8]
    ) == 0
    assert open(p1 + ".fmi", "rb").read() == open(p8 + ".fmi", "rb").read()


def test_cli_num_threads_sharded_query_bounded_archive(tmp_path, caplog):
    """-t 8 query against a bounded -k build: the order-robust BFS
    locate path still yields identical stats to -t 1."""
    import logging

    unit = oracle.random_dna(13, seed=43)
    text = np.tile(unit, 1000)[:10_000].copy()
    text[7_000:] = oracle.random_dna(3_000, seed=44)
    path = str(tmp_path / "c.fa")
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    assert cli.main(["fmindex_build", "-k", "32", path]) == 0
    bpath = _batch_file(tmp_path, text, 11, 48, name="p2.bin")
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        assert cli.main(["fmindex_query", "-b", bpath, path]) == 0
    occ1, chk1 = _stats_from_log(caplog)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        assert cli.main(["fmindex_query", "-b", bpath, "-t", "8", path]) == 0
    assert _stats_from_log(caplog) == (occ1, chk1)
    assert occ1 > 0


def test_serve_mode(tmp_path, caplog, monkeypatch):
    """The serve command loads once and answers many requests from
    stdin (load and jit compile are paid once, not per invocation).
    Single patterns,
    a batch file, warmup, and clean shutdown."""
    import io
    import logging

    text = oracle.random_dna(6_000, seed=61)
    pat = codec.to_istring("GATTACAGATTACA")
    for p in (500, 4_200):
        text[p : p + len(pat)] = pat
    path = str(tmp_path / "srv.fa")
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    assert cli.main(["fmindex_build", path]) == 0
    bpath = _batch_file(tmp_path, text, 11, 16, name="srv.bin")

    stdin = io.StringIO(
        f"GATTACAGATTACA\nbatch {bpath}\nTTTTTTTTTTTTTT\nquit\n"
    )
    stdout = io.StringIO()
    args = cli.build_parser().parse_args(
        ["serve", "--warm", "14", "-n", "5", path]
    )
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        cli.serve_main(args, stdin=stdin, stdout=stdout)
    out_lines = stdout.getvalue().splitlines()
    assert out_lines[0] == "ready"
    assert sum(1 for l in out_lines if l.startswith("ok ")) == 3
    msgs = [r.getMessage() for r in caplog.records]
    assert any("found 2 times" in m for m in msgs), msgs
    assert any(m.startswith("number of matched locations: ") for m in msgs)
    # the all-T pattern was planted nowhere
    assert any("found 0 times" in m for m in msgs)

    # serve over the 8-device mesh: same answers through ShardedFMQuery
    stdin = io.StringIO("GATTACAGATTACA\nquit\n")
    stdout = io.StringIO()
    args = cli.build_parser().parse_args(["serve", "-t", "8", path])
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="kiss_tpu"):
        cli.serve_main(args, stdin=stdin, stdout=stdout)
    assert stdout.getvalue().splitlines()[0] == "ready"
    msgs = [r.getMessage() for r in caplog.records]
    assert any("found 2 times" in m for m in msgs), msgs


def test_batch_progress_log(fa_path, tmp_path, caplog):
    """Batch mode emits the reference's per-100k progress debug line
    'remain: N, time: T' (reference: include/command/
    fmindex_query.hpp:92-93)."""
    import logging

    path, text = fa_path
    assert cli.main(["fmindex_build", path]) == 0
    qlen, nq = 11, 16
    bpath = tmp_path / "pat.bin"
    with open(bpath, "wb") as f:
        f.write(struct.pack("<II", qlen, nq))
        for i in range(nq):
            f.write(codec.to_string(text[i : i + qlen]).encode())
    with caplog.at_level(logging.DEBUG, logger="kiss_tpu"):
        assert cli.main(
            ["fmindex_query", "-b", str(bpath), "--verbose", path]
        ) == 0
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("remain: 0, time: ") for m in msgs), msgs


def test_suffix_sort_stage_log_shape(tmp_path, caplog):
    """--verbose suffix_sort prints a per-stage timing table with stable
    names (the reference's per-phase spdlog stopwatches, reference:
    include/biovoltron/algo/sort/kiss1_core.hpp:244-267 /
    README.md:94-101 stage table)."""
    import logging
    import re

    # tandem-repeat text: 64-char-seed ties persist, so the wide round
    # actually runs (a random text resolves at the seed and skips it)
    unit = oracle.random_dna(13, seed=3)
    text = np.tile(unit, 2000)[:20_000]
    path = str(tmp_path / "rep.fa")
    fasta.write_fasta(path, [fasta.FastaRecord("chr1", text)])
    with caplog.at_level(logging.DEBUG, logger="kiss_tpu"):
        assert cli.main(["suffix_sort", "-k", "256", "--verbose", path]) == 0
    msgs = [r.getMessage() for r in caplog.records]
    pat = re.compile(r"^(seed_sort|wide_round|tail_refine).* elapsed \d+\.\d+$")
    staged = [m for m in msgs if pat.match(m)]
    # k=256 needs the 64-char seed plus at least one wide round
    assert any(m.startswith("seed_sort(chars=64)") for m in staged), msgs
    assert any(m.startswith("wide_round[0]") for m in staged), msgs
