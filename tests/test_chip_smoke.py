"""CPU tests of chip_smoke.py: its plain references against the
brute-force oracles, its refusal to run without a GPU, and its phases
end to end at a small n on the CPU backend."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke as cs
from tests import oracle

CORPORA = {
    "random": oracle.random_dna(3_000, seed=21),
    "repeat": oracle.repeat_heavy_dna(3_000, unit=23, seed=22),
    "genome": bench.synth_genome(4_000, seed=23),
}


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_kmer_reference_matches_brute_force(name):
    text = CORPORA[name]
    m = 12
    pats = bench.sample_patterns(text, 300, m, seed=5)
    pats[:5] = text[100 : 100 + m]  # duplicate patterns count each time
    occ, checksum = cs.KmerReference(text, m).stats(pats)
    hits = [oracle.search_all(text, p) for p in pats]
    assert occ == sum(len(h) for h in hits)
    assert checksum == sum(int(h.sum()) for h in hits)


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_find_all_matches_brute_force(name):
    text = CORPORA[name]
    for start in (0, 77, len(text) - 9):
        pat = text[start : start + 9]
        np.testing.assert_array_equal(
            cs.find_all(text, pat), oracle.search_all(text, pat)
        )


@pytest.mark.parametrize("k", [None, 1, 7, 64])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_pair_check_accepts_oracle_sa(name, k):
    text = CORPORA[name]
    sa = oracle.k_ordered_sa(text, k)
    rng = np.random.default_rng(0)
    cs.check_suffix_array(text, sa, k, rng, pairs=2_000, edge=50)
    # every adjacent pair, not only a sample
    assert cs.unordered_pairs(text, sa[:-1], sa[1:], k).size == 0


@pytest.mark.parametrize("k", [None, 7, 64])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_pair_check_catches_swapped_pair(name, k):
    text = CORPORA[name]
    sa = oracle.k_ordered_sa(text, k).copy()
    r = len(sa) // 2
    sa[r], sa[r + 1] = sa[r + 1], sa[r]
    bad = cs.unordered_pairs(text, sa[:-1], sa[1:], k)
    assert r in bad.tolist()
    rng = np.random.default_rng(0)
    with pytest.raises(cs.SmokeError, match="out of order"):
        cs.check_suffix_array(text, sa, k, rng, pairs=0, edge=len(text))


def test_pair_check_unbounded_deep_repeat():
    """Whole-suffix comparison past many 256-char windows."""
    text = np.tile(np.array([0, 1, 2, 3, 3, 2, 1], np.int8), 200)
    sa = oracle.k_ordered_sa(text, None)
    assert cs.unordered_pairs(text, sa[:-1], sa[1:], None).size == 0
    sa = sa.copy()
    sa[5], sa[6] = sa[6], sa[5]
    assert 5 in cs.unordered_pairs(text, sa[:-1], sa[1:], None).tolist()


def test_check_suffix_array_rejects_non_permutations():
    text = CORPORA["random"]
    sa = oracle.k_ordered_sa(text, 16)
    rng = np.random.default_rng(0)
    dup = sa.copy()
    dup[-1] = dup[-2]
    with pytest.raises(cs.SmokeError, match="permutation"):
        cs.check_suffix_array(text, dup, 16, rng)
    with pytest.raises(cs.SmokeError, match="SA\\[0\\]"):
        cs.check_suffix_array(text, np.roll(sa, 1), 16, rng)


def test_tie_group_check():
    text = CORPORA["repeat"]
    k = 16
    sa = oracle.k_ordered_sa(text, k)
    gids = cs.tie_groups(text, sa, k)
    # reverse the order inside every tie group: same groups, same members
    perm = np.lexsort((-np.arange(len(sa)), gids))
    cs.check_tie_groups(text, sa[perm], sa, k, "reordered")
    bad = sa.copy()
    bad[1], bad[-1] = bad[-1], bad[1]
    with pytest.raises(cs.SmokeError, match="tie groups"):
        cs.check_tie_groups(text, bad, sa, k, "corrupted")


def test_returns_of_collects_and_restores():
    from kiss_tpu.ops.suffix_sort import Kiss1Sorter

    text = CORPORA["random"]
    with cs.returns_of(Kiss1Sorter, "get_suffix_array_dna") as got:
        sa = Kiss1Sorter.get_suffix_array_dna(text, 16)
    assert len(got) == 1 and got[0] is sa
    assert "get_suffix_array_dna" not in vars(Kiss1Sorter)
    np.testing.assert_array_equal(sa, oracle.k_ordered_sa(text, 16))


class _FakeGpu:
    platform = "gpu"
    device_kind = "fake GPU"


def test_require_gpu_refuses_cpu():
    with pytest.raises(cs.SmokeError, match="no GPU"):
        cs.require_gpu(jax.devices(), 1)
    with pytest.raises(cs.SmokeError, match="no device"):
        cs.require_gpu([], 1)


def test_require_gpu_counts_cards():
    cs.require_gpu([_FakeGpu()], 1)
    cs.require_gpu([_FakeGpu()] * 4, 4)
    with pytest.raises(cs.SmokeError, match="4 GPUs needed"):
        cs.require_gpu([_FakeGpu()], 4)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_cpu_and_prints_no_result(argv, capsys):
    with pytest.raises(cs.SmokeError, match="no GPU"):
        cs.main(argv)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    """Outside a checkout the script fails before it touches a device."""
    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "checkout" in res.stderr


@pytest.fixture
def run(tmp_path, monkeypatch):
    monkeypatch.setattr(cs, "PAIRS", 5_000)
    r = cs.Run(str(tmp_path), jax.devices()[:4])
    yield r
    r.close()


def test_golden_phase_on_cpu():
    cs.golden_phase()


def test_one_card_phases_small(run, capsys):
    cs.one_card(run, 20_000, seed=3, golden=False)
    out = capsys.readouterr().out
    for needle in ("default SA: permutation", "PREFIX_DOUBLING: SA identical",
                   "--external: SA identical", "full SA: permutation",
                   "32-ordered SA", "on both archives", "serve: ['ready'"):
        assert needle in out


def test_four_cards_small(run, capsys):
    """The --four-cards path on four virtual CPU devices."""
    cs.four_cards(run, 20_000, seed=4)
    out = capsys.readouterr().out
    assert "columnsort and sample SA identical" in out
    assert ".fmi byte-identical" in out
    assert "equal to one card" in out
    assert out.count("device 3 peak_bytes_in_use") >= 4


@pytest.fixture
def gpu_devices():
    """The visible GPUs; skips the test when JAX found none (the suite
    runs on the CPU unless KISS_TPU_TEST_PLATFORM=gpu)."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return devs


@pytest.mark.gpu
def test_card_is_named(gpu_devices, capsys):
    cs.require_gpu(gpu_devices, 1)
    lines = cs.card_lines()
    assert len(lines) == len(gpu_devices)
    print(json.dumps(lines))


def test_device_phase_names_card_and_cache(monkeypatch, capsys):
    monkeypatch.setattr(cs, "card_lines",
                        lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"])
    cs.device_phase(jax.devices()[:1])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"jax {jax.__version__}; platform cpu")
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in out
    assert out[-1].startswith("native host library built: ")
