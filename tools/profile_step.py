"""Per-stage timing of the pipeline step ON THE BENCH'S MID-SWEEP STATE.

This tool times stages on the exact live-exploration state the headline
bench scans, so the numbers add up to the bench's scan_step_ms (modulo
per-call dispatch).

    python tools/profile_step.py [--backoff N]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, n=20, warmup=3):
    import jax

    for _ in range(warmup):
        out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backoff", type=int, default=0,
                    help="override find_fail_backoff (0 = config default)")
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure()

    import dataclasses

    import jax.numpy as jnp

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import localmap as lm
    from slam_robot_tpu.models import matcher as matcher_mod
    from slam_robot_tpu.models import pipeline, slam
    from slam_robot_tpu.ops import pyramid as pyr
    from slam_robot_tpu.utils import benchscene

    cfg = SlamConfig()
    if args.backoff:
        cfg = dataclasses.replace(cfg, find_fail_backoff=args.backoff)

    n_warm = 96
    frames = benchscene.make_frames(cfg, n_warm + 4)
    print(f"device: {jax.devices()[0]}", flush=True)

    ps = pipeline.init(cfg)
    for i in range(n_warm):
        ps, _ = pipeline.step(ps, frames[i], cfg)
    jax.block_until_ready(ps.map.frame_trans)
    print(f"state: n_points={int(ps.map.n_points)} n_obs={int(ps.map.n_obs)} "
          f"n_frames={int(ps.map.n_frames)}", flush=True)

    img = frames[n_warm]
    m = ps.map
    camera = ps.camera ^ 1

    # whole step (eager per-call reference)
    t = timeit(lambda: pipeline.step(ps, img, cfg)[0].map.n_obs, n=10)
    print(f"step (full, eager):   {t:8.2f} ms", flush=True)

    # pyramid
    t = timeit(lambda: pyr.build_pyramid(
        img, cfg.pyramid_depth, cfg.blur_sigma0, cfg.blur_sigma_down).data)
    print(f"pyramid:              {t:8.2f} ms", flush=True)

    # matcher.track on the mid-sweep state (includes pyramid)
    m2, frame_idx = lm.add_frame(m, camera, m.frame_quat[int(m.n_frames) - 2],
                                 m.frame_trans[int(m.n_frames) - 2])
    jax.block_until_ready(m2.frame_trans)

    t = timeit(lambda: matcher_mod.track(
        ps.matcher, m2, img, frame_idx, camera, cfg)[1].n_obs)
    print(f"matcher.track:        {t:8.2f} ms", flush=True)

    # BA windows on the live state. Every closure below is jit-wrapped:
    # eager library calls dispatch dozens of small ops one by one and
    # would measure the dispatch, not the solve
    fast = jax.jit(lambda m: slam.solve_frames(
        m, cfg.solve_fast[0], cfg.solve_fast[1], cfg.ba_range, cfg,
        max_iters=cfg.ba_iters_fast, window_obs=cfg.window_obs_fast,
    )[1].cost)
    t = timeit(lambda: fast(m), n=10)
    print(f"BA fast (2,5):        {t:8.2f} ms", flush=True)
    slow = jax.jit(lambda m: slam.solve_frames(
        m, cfg.solve_slow[0], cfg.solve_slow[1], cfg.ba_range, cfg,
        max_iters=cfg.ba_iters_slow,
    )[1].cost)
    t = timeit(lambda: slow(m), n=10)
    print(f"BA slow (10,20):      {t:8.2f} ms", flush=True)

    rw = cfg.reproject_window or None
    repro = jax.jit(lambda m: lm.reproject(m, cfg.cheirality_eps, window=rw)[1])
    t = timeit(lambda: repro(m))
    print(f"reproject:            {t:8.2f} ms", flush=True)
    cleanf = jax.jit(lambda m: lm.clean(m, cfg.error_threshold, cfg)[0].n_obs)
    t = timeit(lambda: cleanf(m))
    print(f"clean:                {t:8.2f} ms", flush=True)
    epi = jax.jit(lambda m: lm.apply_epipolar_constraint(m, cfg).n_obs)
    t = timeit(lambda: epi(m))
    print(f"epipolar:             {t:8.2f} ms", flush=True)
    norm = jax.jit(lambda m: lm.normalize(m).frame_trans)
    t = timeit(lambda: norm(m))
    print(f"normalize:            {t:8.2f} ms", flush=True)


if __name__ == "__main__":
    main()
