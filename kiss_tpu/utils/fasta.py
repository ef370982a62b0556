"""FASTA / plain-text sequence ingest.

Bulk counterpart of the reference's stream-based reader
(reference: include/utils/io.hpp:6-18 ``read_sequence`` and
include/biovoltron/file_io/fasta.hpp:14-176 ``FastaRecord``): if the input
starts with '>', every record's sequence lines are concatenated; otherwise
each line is treated as raw sequence text. Parsing is bulk numpy over the
whole file instead of per-record iostream extraction.
"""

from __future__ import annotations

import io
import os
from dataclasses import dataclass

import numpy as np

from kiss_tpu.utils import codec


@dataclass
class FastaRecord:
    """One FASTA record; ``name`` is the first whitespace token of the
    header (reference: fasta.hpp name parsing)."""

    name: str
    seq: np.ndarray  # int8 istring codes


def _read_bytes(src) -> bytes:
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return f.read()
    if isinstance(src, io.IOBase):
        data = src.read()
        return data.encode() if isinstance(data, str) else data
    if isinstance(src, (bytes, bytearray)):
        return bytes(src)
    raise TypeError(f"unsupported source type {type(src)!r}")


def parse_fasta(src) -> list[FastaRecord]:
    """Parse all records of a FASTA file into encoded istrings."""
    data = _read_bytes(src)
    records: list[FastaRecord] = []
    name = None
    chunks: list[bytes] = []
    for line in data.split(b"\n"):
        line = line.strip()
        if not line:
            continue
        if line.startswith(b">"):
            if name is not None:
                records.append(
                    FastaRecord(name, codec.to_istring(b"".join(chunks)))
                )
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        records.append(FastaRecord(name, codec.to_istring(b"".join(chunks))))
    return records


def read_sequence(src) -> np.ndarray:
    """Read a FASTA, FASTQ, or plain-text file into one concatenated
    istring.

    Mirrors the reference dispatch on the first byte
    (reference: include/utils/io.hpp:6-18): '>' selects FASTA mode (all
    records concatenated), anything else treats each line as sequence;
    '@' additionally selects FASTQ (reference: fasta.hpp:119-176
    FastqRecord). Gzip input (magic 1f 8b) is transparently decompressed
    (reference vendors gzstream for this, utility/archive/gzstream.hpp).
    Returns an int8 array with values 0..4.

    The parse runs through the native C++ library when available
    (csrc/kiss_io.cpp) with a pure-numpy fallback.
    """
    data = _read_bytes(src)
    if data[:2] == b"\x1f\x8b":
        import gzip

        data = gzip.decompress(data)

    from kiss_tpu.utils import native

    out = native.parse_sequence(data)
    if out is not None:
        return out

    if data[:1] == b">":
        parts = [r.seq for r in parse_fasta(data)]
        if not parts:
            return np.empty(0, dtype=np.int8)
        return np.concatenate(parts)
    if data[:1] == b"@":  # FASTQ: 4-line records, line 2 is the read
        lines = data.split(b"\n")
        seqs = [lines[i] for i in range(1, len(lines), 4)]
        return codec.to_istring(b"".join(s.strip() for s in seqs))
    # text mode: strip newlines, encode everything else
    lines = [ln.strip() for ln in data.split(b"\n")]
    return codec.to_istring(b"".join(lines))


def write_fasta(path, records: list[FastaRecord], width: int = 70) -> None:
    """Write records (helper for tests/benchmarks; no reference analog)."""
    with open(path, "w") as f:
        for rec in records:
            f.write(f">{rec.name}\n")
            s = codec.to_string(rec.seq)
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")
