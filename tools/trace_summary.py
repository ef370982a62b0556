"""Sum the device time of every kernel in a jax.profiler trace.

    python tools/trace_summary.py DIR [--top 40]

DIR is the directory given to ``kISS ... --profile DIR`` (or to
``jax.profiler.trace``); the newest ``*.xplane.pb`` under it is read.
Prints, per device plane, the busy time, then kernel families by total
device time (an XLA op's launches share its name up to a ``__N``
suffix; a library kernel is named up to its template arguments), then
the single kernels. Works with nothing but JAX.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import re


def newest_xplane(root: str) -> str:
    paths = glob.glob(os.path.join(root, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {root}")
    return max(paths, key=os.path.getmtime)


def kernel_totals(path: str) -> dict[str, collections.Counter]:
    """{device plane name: Counter(kernel name -> total ns)}, plus a
    ``"#count"`` Counter per plane under ``<plane>#count``."""
    from jax.profiler import ProfileData

    out: dict[str, collections.Counter] = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        ns = out.setdefault(plane.name, collections.Counter())
        cnt = out.setdefault(plane.name + "#count", collections.Counter())
        for line in plane.lines:
            # stream lines hold the kernels; skip XLA's op/module summaries
            if "stream" not in line.name.lower():
                continue
            for ev in line.events:
                ns[ev.name] += ev.duration_ns
                cnt[ev.name] += 1
    return out


def family(name: str) -> str:
    """sort_26_0__135 -> sort_26_0; cub::...Kernel<...> -> cub::...Kernel"""
    return re.sub(r"__\d+$", "", name.split("<", 1)[0])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args(argv)
    path = newest_xplane(args.trace_dir)
    print(f"trace {path}")
    totals = kernel_totals(path)
    for plane, ns in totals.items():
        if plane.endswith("#count"):
            continue
        cnt = totals[plane + "#count"]
        print(f"{plane}: {sum(ns.values()) / 1e6:.3f} ms over "
              f"{sum(cnt.values())} kernel launches")
        fam_ns, fam_cnt = collections.Counter(), collections.Counter()
        for name, t in ns.items():
            fam_ns[family(name)] += t
            fam_cnt[family(name)] += cnt[name]
        print("  families:")
        for name, t in fam_ns.most_common(args.top):
            print(f"  {fam_cnt[name]:6d}  {t / 1e6:10.3f} ms  {name[:160]}")
        print("  kernels:")
        for name, t in ns.most_common(args.top):
            print(f"  {cnt[name]:6d}  {t / 1e6:10.3f} ms  {name[:160]}")


if __name__ == "__main__":
    main()
