"""Trace-profile the large-map CG BA: state what bounds the GN iters/s at
10k keyframes / 500k landmarks / 1M obs.

Runs ba_cg.solve on the bench_suite config-5 problem under a device
trace and prints the hlo_stats category/op split, same method as
tools/profile_trace.py.

    python tools/profile_cg.py [--small] [--top 30]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TRACE_DIR = "/tmp/jaxtrace_cg"


def _sync(x):
    """Wait until the device has produced ``x``."""
    import jax

    return jax.block_until_ready(x)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--gn-iters", type=int, default=5)
    ap.add_argument("--cg-iters", type=int, default=20)
    ap.add_argument("--layout", default="scatter",
                    choices=["scatter", "padded"])
    ap.add_argument("--platform", default="",
                    help="force jax platform (cpu)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure(args.platform)

    from slam_robot_tpu.ops import ba_cg
    from slam_robot_tpu.utils import synthetic

    nf, npts, opf = (200, 5000, 60) if args.small else (10000, 500000, 100)
    prob = synthetic.build_large_problem(nf, npts, obs_per_frame=opf)
    cgc = ba_cg.CGConfig(max_free_frames=nf, gn_iters=args.gn_iters,
                         cg_iters=args.cg_iters, precond="diag",
                         layout=args.layout)
    keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
            "point_uncertainty", "obs_frame", "obs_point", "obs_px",
            "obs_ok", "present", "free_frame")
    a = tuple(prob[k] for k in keys)
    print(f"device: {jax.devices()[0]}  problem: {nf} kf / {npts} lm / "
          f"{a[6].shape[0]} obs  gn={args.gn_iters} cg={args.cg_iters}",
          flush=True)

    t0 = time.time()
    res = ba_cg.solve(*a, cgc)
    _sync(res.cost)
    print(f"compile+first: {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    res = ba_cg.solve(*a, cgc)
    _sync(res.cost)
    dt = time.time() - t0
    print(f"solve: {dt:.2f}s = {args.gn_iters/dt:.2f} GN iters/s "
          f"(cost {float(res.cost):.1f})", flush=True)

    os.system(f"rm -rf {TRACE_DIR}")
    jax.profiler.start_trace(TRACE_DIR)
    res = ba_cg.solve(*a, cgc)
    _sync(res.cost)
    jax.profiler.stop_trace()

    planes = glob.glob(f"{TRACE_DIR}/**/*.xplane.pb", recursive=True)
    if not planes:
        print("NO DEVICE TRACE CAPTURED", flush=True)
        return

    from xprof.convert import raw_to_tool_data as rtd

    params = {"tqx": "out:json;", "use_saved_result": False}
    data, _ = rtd.xspace_to_tool_data(planes, "hlo_stats", params)
    if isinstance(data, bytes):
        data = data.decode()
    obj = json.loads(data)
    cols = [c["label"] for c in obj["cols"]]
    rows = [[c["v"] if c else None for c in r["c"]] for r in obj["rows"]]

    def col(label):
        for i, c in enumerate(cols):
            if label.lower() in c.lower():
                return i
        return None

    i_cat = col("HLO op category") or col("category")
    i_name = col("HLO op name") or col("op name")
    i_self = col("Total self time (us)") or col("self time")

    rows.sort(key=lambda r: -(r[i_self] or 0.0))
    total = sum(r[i_self] or 0.0 for r in rows)
    n_gn = args.gn_iters
    print(f"\ntotal device self time: {total/1000:.1f} ms "
          f"({total/1000/n_gn:.1f} ms/GN iter)", flush=True)

    buckets = {}
    for r in rows:
        cat = str(r[i_cat])
        buckets[cat] = buckets.get(cat, 0.0) + (r[i_self] or 0.0)
    print("\n-- by category (ms/GN iter) --", flush=True)
    for k, v in sorted(buckets.items(), key=lambda kv: -kv[1]):
        print(f"{k:40s} {v/1000/n_gn:8.2f}", flush=True)

    print(f"\n-- top {args.top} ops (us total | ms/GN | name) --", flush=True)
    for r in rows[: args.top]:
        nm = str(r[i_name])[:110]
        print(f"{r[i_self] or 0.0:10.0f} {(r[i_self] or 0.0)/1000/n_gn:8.2f}  "
              f"[{str(r[i_cat])[:18]:18s}] {nm}", flush=True)


if __name__ == "__main__":
    main()
