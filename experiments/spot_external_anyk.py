"""500M-char spot run of the out-of-core sorter at an ARBITRARY
bounded k (default k=100): exercises the raw-tail refinement rounds
(external_sort._np_tail_words) at a scale the CLI actually auto-routes
through the external path (the reference supports every k at genome
scale; its protocol sweeps k in 2..256, reference:
experiment/experiment_a.sh:10-39).

Checks (hard assertions, reusing the chm13 harness):
  - the plan really contains a raw-tail round (k=100 = 64-seed + 36);
  - SA is a permutation of [0, n];
  - full k-char ordering contract + position tiebreak on 2M sampled
    adjacent pairs.

CPU backend (host-resident working set, same rationale as
chm13_full.py). Appends a stage table to results_chm13_full.md.
Usage: python experiments/spot_external_anyk.py [--n N] [--k K]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=500_000_000)
    ap.add_argument("--k", type=int, default=100)
    args = ap.parse_args()

    if os.environ.get("JAX_PLATFORMS") == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    from bench import synth_genome
    from experiments.chm13_full import (
        STAGES, check_order, check_permutation, stage,
    )
    from kiss_tpu.ops import external_sort, pack, suffix_sort

    n, k = args.n, args.k
    plan = suffix_sort._make_plan(n, suffix_sort._normalize_k(k), pack.DNA)
    tails = [r.tail_chars for r in plan.rounds]
    assert any(tails), (
        f"k={k} plan has no raw-tail round; pick k not a multiple of "
        f"the {plan.seed_chars}-char seed"
    )
    print(
        f"[spot] n={n} k={k}: plan seed={plan.seed_chars}, rounds="
        f"{[(r.rank_keys, r.tail_chars) for r in plan.rounds]}",
        file=sys.stderr, flush=True,
    )

    with stage("synthesize genome"):
        text = synth_genome(n)
    with stage(f"external suffix_sort k={k} (raw-tail path)"):
        sa = external_sort.external_k_ordered_suffix_array(
            text, k, verbose=True
        )
    check_permutation(sa, n)
    check_order(text, sa, k)

    md = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "results_chm13_full.md"
    )
    with open(md, "a") as f:
        f.write(
            f"\n## Spot run {time.strftime('%Y-%m-%d %H:%M')}: external "
            f"sorter, ARBITRARY k={k} (raw-tail rounds), n={n}\n\n"
        )
        f.write("| stage | seconds | peak RSS (GB) |\n|---|---|---|\n")
        for name, dt, rss in STAGES:
            f.write(f"| {name} | {dt:.1f} | {rss:.1f} |\n")
        f.write(
            f"\n- plan: seed={plan.seed_chars}, tail rounds with "
            f"tail_chars={[t for t in tails if t]}; all permutation + exact-k ordering checks passed.\n"
        )
    print("[spot] ALL CHECKS PASSED", file=sys.stderr)


if __name__ == "__main__":
    main()
