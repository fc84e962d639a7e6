"""Capture an XLA device trace of the headline-bench scan and attribute
device time per HLO op (via xprof/tensorboard_plugin_profile).

Bootstraps the bench mid-sweep state (cached in /tmp/bench_state.npz so
re-profiling skips the ~2-15 min eager warm), traces ONE 64-frame scan,
and prints the top ops by total self time plus a coarse bucket split
(gather / dot / conv / fusion / pallas / scatter / while-overhead).

    python tools/profile_trace.py [--refresh-state] [--top 40]
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

STATE_CACHE = "/tmp/bench_state.npz"
TRACE_DIR = "/tmp/jaxtrace"




def _sync(x):
    """Wait until the device has produced ``x``."""
    import jax

    return jax.block_until_ready(x)


def get_state(cfg, frames, n_warm, refresh=False):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.models import pipeline

    ps0 = pipeline.init(cfg)
    leaves0, treedef = jax.tree_util.tree_flatten(ps0)
    if not refresh and os.path.exists(STATE_CACHE):
        data = np.load(STATE_CACHE)
        leaves = [jnp.asarray(data[f"a{i}"]) for i in range(len(leaves0))]
        print("state: loaded cache", flush=True)
        return jax.tree_util.tree_unflatten(treedef, leaves)
    ps = ps0
    t0 = time.time()
    for i in range(n_warm):
        ps, _ = pipeline.step(ps, frames[i], cfg)
    _sync(ps.map.frame_trans)
    print(f"state: bootstrapped in {time.time()-t0:.0f}s", flush=True)
    leaves = jax.tree_util.tree_leaves(ps)
    np.savez(STATE_CACHE, **{f"a{i}": np.asarray(x)
                             for i, x in enumerate(leaves)})
    return ps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--refresh-state", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    args = ap.parse_args()

    import jax

    from slam_robot_tpu.utils import cachedir

    cachedir.configure()

    import jax.numpy as jnp

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import benchscene

    cfg = SlamConfig()
    n_warm, n_timed = 96, 64
    frames = benchscene.make_frames(cfg, n_warm + n_timed)
    print(f"device: {jax.devices()[0]}", flush=True)
    ps = get_state(cfg, frames, n_warm, refresh=args.refresh_state)
    imgs = jnp.stack(frames[n_warm:])

    @jax.jit
    def run_scan(ps, imgs):
        def body(ps, img):
            ps, met = pipeline.step(ps, img, cfg)
            return ps, met["mean_reproj_err"]

        return jax.lax.scan(body, ps, imgs)

    # compile + one warm rep outside the trace
    t0 = time.time()
    _, errs = run_scan(ps, imgs)
    _sync(errs)
    print(f"compile+first: {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    _, errs = run_scan(ps, imgs)
    _sync(errs)
    ms = (time.time() - t0) / n_timed * 1000
    print(f"scan: {ms:.2f} ms/frame", flush=True)

    os.system(f"rm -rf {TRACE_DIR}")
    jax.profiler.start_trace(TRACE_DIR)
    _, errs = run_scan(ps, imgs)
    _sync(errs)
    jax.profiler.stop_trace()

    planes = glob.glob(f"{TRACE_DIR}/**/*.xplane.pb", recursive=True)
    print("xplanes:", planes, flush=True)
    if not planes:
        print("NO DEVICE TRACE CAPTURED", flush=True)
        return

    from xprof.convert import raw_to_tool_data as rtd

    params = {"tqx": "out:json;", "use_saved_result": False}
    data, _ = rtd.xspace_to_tool_data(planes, "hlo_stats", params)
    if isinstance(data, bytes):
        data = data.decode()
    obj = json.loads(data)
    # gviz table json: cols + rows
    cols = [c["label"] for c in obj["cols"]]
    rows = [[c["v"] if c else None for c in r["c"]] for r in obj["rows"]]
    print("columns:", cols, flush=True)

    def col(label):
        for i, c in enumerate(cols):
            if label.lower() in c.lower():
                return i
        return None

    i_cat = col("HLO op category") or col("category")
    i_name = col("HLO op name") or col("op name")
    i_self = col("Total self time (us)") or col("self time")
    i_prog = col("program")

    rows.sort(key=lambda r: -(r[i_self] or 0.0))
    total = sum(r[i_self] or 0.0 for r in rows)
    print(f"\ntotal device self time: {total/1000:.1f} ms "
          f"({total/1000/n_timed:.3f} ms/frame)", flush=True)

    buckets = {}
    for r in rows:
        cat = str(r[i_cat])
        buckets[cat] = buckets.get(cat, 0.0) + (r[i_self] or 0.0)
    print("\n-- by category (ms/frame) --", flush=True)
    for k, v in sorted(buckets.items(), key=lambda kv: -kv[1]):
        print(f"{k:40s} {v/1000/n_timed:8.3f}", flush=True)

    print(f"\n-- top {args.top} ops (us total | us/frame | name) --",
          flush=True)
    for r in rows[: args.top]:
        nm = str(r[i_name])[:110]
        print(f"{r[i_self] or 0.0:10.0f} {(r[i_self] or 0.0)/n_timed:8.1f}  "
              f"[{str(r[i_cat])[:18]:18s}] {nm}", flush=True)


if __name__ == "__main__":
    main()
