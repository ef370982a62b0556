"""Benchmark sweep harness, mirroring the reference experiment protocol.

The reference drives its paper figures with shell scripts that sweep
k at fixed threads and threads at fixed k, 3 repeats, CSV rows
``algo,test,k,num-threads,time,space``
(reference: experiment/experiment_a.sh:10-39, experiment_b.sh:10-39).
This harness produces the same CSV shape: "threads" is reported as the
device count (the mesh size), "space" as peak device memory when the
platform exposes it, else peak host RSS.

Usage:
    python experiments/run_experiments.py --n 48800648 --out results.csv
    python experiments/run_experiments.py --quick   # small smoke sweep
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

sys.path.insert(0, ".")

def device_peak_bytes():
    """Peak memory for the CSV ``space`` column (reference parity:
    experiment_a.sh:34-35 records getPeakRSS). Peak device memory when
    the platform exposes memory_stats (the CPU backend does not); host
    peak RSS otherwise -- the latter is exactly what the reference
    records."""
    import resource

    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    peak = int(stats.get("peak_bytes_in_use", 0))
    if peak:
        return peak
    # ru_maxrss: kilobytes on Linux, bytes on macOS (ADVICE r4)
    scale = 1 if sys.platform == "darwin" else 1024
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * scale


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48_800_648)
    ap.add_argument("--out", default="experiments/results.csv")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument(
        "--ks", default="2,4,8,16,32,64,128,256,-1",
        help="comma-separated k values (-1 = unbounded)",
    )
    ap.add_argument("--quick", action="store_true")
    ap.add_argument(
        "--strategy", default="wide", choices=["wide", "doubling"],
        help="sort strategy for the k sweep: wide = PARALLEL_SORTING, "
        "doubling = PREFIX_DOUBLING (the algo column records it)",
    )
    ap.add_argument(
        "--devices", default="",
        help="comma-separated device counts: sweep the mesh size at "
        "fixed k=256 over the distributed block-bitonic sort (the "
        "experiment_b.sh thread-sweep analog; device counts must be "
        "powers of two and <= available devices)",
    )
    args = ap.parse_args()
    if args.quick:
        args.n = min(args.n, 1_000_000)
        args.ks = "16,256,-1"
        args.repeats = 1

    import jax
    import jax.numpy as jnp

    from bench import synth_genome
    from kiss_tpu.ops.suffix_sort import k_ordered_suffix_array
    from kiss_tpu.utils import compile_cache

    compile_cache.enable()

    test_name = f"synth{args.n}"
    n_devices = len(jax.devices())
    text = jax.device_put(jnp.asarray(synth_genome(args.n)))
    jax.block_until_ready(text)

    rows = []
    if args.devices:
        # experiment_b analog: fixed k, sweep the parallelism knob
        # (reference: experiment/experiment_b.sh:10-39 sweeps threads;
        # here the knob is the mesh size over the sequence axis)
        from kiss_tpu.parallel import make_mesh, sharded_suffix_sort

        for d in (int(x) for x in args.devices.split(",")):
            mesh = make_mesh(d)
            jax.block_until_ready(sharded_suffix_sort(mesh, text, 256))  # warm
            for _ in range(args.repeats):
                t0 = time.perf_counter()
                sa = sharded_suffix_sort(mesh, text, 256)
                jax.block_until_ready(sa)
                dt = time.perf_counter() - t0
                rows.append(
                    ["kiss-tpu", test_name, 256, d, f"{dt:.4f}",
                     device_peak_bytes()]
                )
                print(",".join(str(x) for x in rows[-1]), flush=True)
        args.ks = ""
    algo = (
        "kiss-tpu"
        if args.strategy == "wide"
        else "kiss-tpu-doubling"
    )
    for k in (int(x) for x in args.ks.split(",") if x):
        # warm (compile all round variants for this k)
        jax.block_until_ready(k_ordered_suffix_array(
            text, k, as_numpy=False, strategy=args.strategy
        ))
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            sa = k_ordered_suffix_array(
                text, k, as_numpy=False, strategy=args.strategy
            )
            jax.block_until_ready(sa)
            dt = time.perf_counter() - t0
            rows.append(
                [algo, test_name, k, n_devices, f"{dt:.4f}",
                 device_peak_bytes()]
            )
            print(",".join(str(x) for x in rows[-1]), flush=True)

    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["algo", "test", "k", "num-threads", "time", "space"])
        w.writerows(rows)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
