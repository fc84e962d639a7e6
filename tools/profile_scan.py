"""Time the headline-bench scan under config variants, on the real chip.

Reproduces bench.py's mid-sweep state per variant (bootstrap on the warm
frames with the SAME config, so the state is what that config would have
built), then times the 64-frame lax.scan continuation and reports fps plus
the accuracy stats the variant trades against (median enabled reprojection
error, trajectory ATE, match/keyframe counts).

    python tools/profile_scan.py [--variants default,backoff4,noslam]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))




def _sync(x):
    """Wait until the device has produced ``x``."""
    import jax

    return jax.block_until_ready(x)


def run_variant(name, cfg, frames, n_warm, run_slam=True):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import benchscene, dump

    ps = pipeline.init(cfg)
    t0 = time.time()
    for i in range(n_warm):
        ps, _ = pipeline.step(ps, frames[i], cfg, run_slam=run_slam)
        ps = pipeline.maybe_polish(ps, i, cfg, run_slam)
    _sync(ps.map.frame_trans)
    warm_s = time.time() - t0

    @jax.jit
    def run_scan(ps, imgs):
        def body(ps, img):
            ps, met = pipeline.step(ps, img, cfg, run_slam=run_slam)
            return ps, (met["mean_reproj_err"], met["n_matches"],
                        met["is_keyframe"], met["fast_iters"],
                        met["slow_iters"])

        return jax.lax.scan(body, ps, imgs)

    imgs = jnp.stack(frames[n_warm:])
    n_timed_frames = imgs.shape[0]
    t0 = time.time()
    ps2, (errs, nm, kf, fit, sit) = run_scan(ps, imgs)
    _sync(errs)
    compile_s = time.time() - t0

    n_rep = 2
    t0 = time.time()
    for _ in range(n_rep):
        ps2, (errs, nm, kf, fit, sit) = run_scan(ps, imgs)
    _sync(errs)
    ms = (time.time() - t0) / (n_rep * n_timed_frames) * 1000

    m2 = ps2.map
    no = int(m2.n_obs)
    errn = np.linalg.norm(np.asarray(m2.obs_err[:no]), axis=1)
    dis = np.asarray(m2.obs_disabled[:no])
    median_err = float(np.median(errn[~dis])) if (~dis).any() else 0.0
    nf = int(m2.n_frames)
    true_t = np.stack([benchscene.sweep_pose(i)[1] for i in range(nf)])
    est_t = np.asarray(m2.frame_trans[:nf])
    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    out = {
        "variant": name,
        "scan_step_ms": round(ms, 2),
        "fps": round(1000.0 / ms, 2),
        "warm_s": round(warm_s, 1),
        "scan_compile_s": round(compile_s, 1),
        "median_enabled_err_px": round(median_err, 3),
        "ate_mm": round(ate, 1),
        "ate_pct_of_path": round(100.0 * ate / max(path, 1e-9), 2),
        # gauge-aligned companion (TUM-style Umeyama Sim(3), PERF fndg 42)
        "ate_pct_aligned": round(
            100.0 * dump.ate_aligned(est_t, true_t) / max(path, 1e-9), 2),
        "n_points": int(m2.n_points),
        "mean_matches": round(float(np.asarray(nm).mean()), 1),
        "keyframes_in_scan": int(np.asarray(kf).sum()),
        "mean_fast_iters": round(float(np.asarray(fit).mean()), 1),
        "mean_slow_iters": round(float(np.asarray(sit).mean()), 1),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="default,backoff2,backoff4,noslam")
    ap.add_argument("--platform", default="")
    ap.add_argument("--seed", type=int, default=0,
                    help="bench-scene world seed: same trajectory, fresh "
                         "landmark texture — an independent cadence draw "
                         "for ATE A/Bs (keyframe cadence is chaotically "
                         "sensitive; single-draw deltas conflate the "
                         "intervention with the draw)")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed scan repetitions (1 for ATE-only A/Bs)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure()

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.utils import benchscene

    base = SlamConfig()
    n_warm, n_timed = 96, 64
    frames = benchscene.make_frames(base, n_warm + n_timed, seed=args.seed)
    print(f"device: {jax.devices()[0]} seed: {args.seed}", flush=True)

    for name in args.variants.split(","):
        if name == "default":
            run_variant(name, base, frames, n_warm)
        elif name.startswith("backoff"):
            k = int(name[len("backoff"):])
            cfg = dataclasses.replace(base, find_fail_backoff=k)
            run_variant(name, cfg, frames, n_warm)
        elif name == "noslam":
            run_variant(name, base, frames, n_warm, run_slam=False)
        elif name.startswith("rt"):  # rt0 = full backward cascade, rtN = cap
            cfg = dataclasses.replace(base, roundtrip_levels=int(name[2:]))
            run_variant(name, cfg, frames, n_warm)
        elif name == "ladder":
            cfg = dataclasses.replace(base, retry_mode="ladder")
            run_variant(name, cfg, frames, n_warm)
        elif name == "sweeps2":
            cfg = dataclasses.replace(base, retry_sweeps=2)
            run_variant(name, cfg, frames, n_warm)
        elif name.startswith("fast"):  # fastN = ba_iters_fast cap
            cfg = dataclasses.replace(base, ba_iters_fast=int(name[4:]))
            run_variant(name, cfg, frames, n_warm)
        elif name.startswith("giveup"):
            cfg = dataclasses.replace(base, find_fail_give_up=int(name[6:]))
            run_variant(name, cfg, frames, n_warm)
        elif name == "nowincache":
            cfg = dataclasses.replace(base, bwd_window_cache=False)
            run_variant(name, cfg, frames, n_warm)
        elif name.startswith("bo"):  # boN = find_fail_backoff
            cfg = dataclasses.replace(base, find_fail_backoff=int(name[2:]))
            run_variant(name, cfg, frames, n_warm)
        elif name.startswith("set:"):
            # generic override: set:key=val[;key=val...] with field-typed
            # coercion, e.g. set:ba_iters_slow=40;slow_every=4
            kv = {}
            for pair in name[4:].split(";"):
                k, v = pair.split("=")
                ftype = type(getattr(base, k))
                if ftype is bool:
                    kv[k] = v == "True"
                elif ftype is tuple:
                    # e.g. set:solve_xslow=24x32 (x-separated ints)
                    kv[k] = tuple(int(t) for t in v.split("x"))
                else:
                    kv[k] = ftype(v)
            cfg = dataclasses.replace(base, **kv)
            run_variant(name, cfg, frames, n_warm)
        else:
            raise SystemExit(f"unknown variant {name}")


if __name__ == "__main__":
    main()
