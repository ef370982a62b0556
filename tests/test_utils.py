"""Tests for codec / FASTA ingest / serializer bit layouts."""

import io

import numpy as np

from kiss_tpu.utils import codec, fasta, serializer


def test_codec_roundtrip():
    s = "ACGTacgtNNX"
    enc = codec.to_istring(s)
    np.testing.assert_array_equal(
        enc, [0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 4]
    )
    assert codec.to_string(enc[:8]) == "ACGTACGT"


def test_codec_hash_rhash():
    seq = codec.to_istring("GATTACA")
    key = codec.hash(seq)
    # first char most significant (reference: istring.hpp:59-65)
    assert key == int("2033010", 4)
    np.testing.assert_array_equal(codec.rhash(key, 7), seq)


def test_rev_comp():
    seq = codec.to_istring("ACGTN")
    np.testing.assert_array_equal(codec.rev_comp(seq), codec.to_istring("NACGT"))


def test_fold():
    np.testing.assert_array_equal(
        codec.fold_to_acgt(codec.to_istring("ACGTN")), [0, 1, 2, 3, 0]
    )


def test_fasta_mode(tmp_path):
    p = tmp_path / "x.fa"
    p.write_text(">chr1 description here\nACGT\nACG\n>chr2\nTTTT\n")
    seq = fasta.read_sequence(str(p))
    np.testing.assert_array_equal(seq, codec.to_istring("ACGTACGTTTT"))
    recs = fasta.parse_fasta(str(p))
    assert [r.name for r in recs] == ["chr1", "chr2"]


def test_text_mode(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("ACGT\nacgt\n")
    seq = fasta.read_sequence(str(p))
    np.testing.assert_array_equal(seq, codec.to_istring("ACGTACGT"))


def test_dibit_pack_layout():
    # LSB-first within the byte (reference: xbit_vector.hpp XbitReference)
    vals = np.array([1, 0, 2, 3, 3], dtype=np.int8)
    blocks = serializer.pack_dibits(vals)
    # byte 0: 1 | 0<<2 | 2<<4 | 3<<6 = 0b11_10_00_01
    assert blocks[0] == 0b11100001
    assert blocks[1] == 0b00000011
    np.testing.assert_array_equal(serializer.unpack_dibits(blocks, 5), vals)


def test_bit_pack_layout():
    vals = np.zeros(70, bool)
    vals[0] = vals[65] = True
    blocks = serializer.pack_bits_u64(vals)
    assert blocks[0] == 1
    assert blocks[1] == 2
    np.testing.assert_array_equal(serializer.unpack_bits_u64(blocks, 70), vals)


def test_save_load_range():
    buf = io.BytesIO()
    arr = np.arange(10, dtype=np.uint32)
    serializer.save_range(buf, len(arr), arr)
    serializer.save_range(buf, 0, b"")  # empty writes nothing
    buf.seek(0)
    count, raw = serializer.load_range(buf, serializer.scalar_bytes(4))
    assert count == 10
    np.testing.assert_array_equal(np.frombuffer(raw, np.uint32), arr)
    assert buf.read() == b""


def test_compile_cache_dir_follows_jax_env(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache; the code sets
    no other directory."""
    from kiss_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)
    calls = []
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.delenv("KISS_TPU_NO_CACHE", raising=False)
    import jax

    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    compile_cache.enable()
    assert calls == []


def test_compile_cache_dir_defaults_to_repo(monkeypatch):
    """Without the env var the cache sits at the fixed in-repo path (the
    directory is part of the cache key, so it must not move)."""
    import os

    import jax

    from kiss_tpu.utils import compile_cache

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == os.path.join(repo, ".jax_cache")
    calls = []
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.delenv("KISS_TPU_NO_CACHE", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    compile_cache.enable()
    assert calls == [("jax_compilation_cache_dir",
                      os.path.join(repo, ".jax_cache"))]
    # idempotent: a second call changes nothing
    compile_cache.enable()
    assert len(calls) == 1


def test_compile_cache_off_in_tests(monkeypatch):
    """KISS_TPU_NO_CACHE (set by conftest.py) keeps the cache off."""
    import os

    import jax

    from kiss_tpu.utils import compile_cache

    assert os.environ.get("KISS_TPU_NO_CACHE")
    calls = []
    monkeypatch.setattr(compile_cache, "_enabled", False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    compile_cache.enable()
    assert calls == []
