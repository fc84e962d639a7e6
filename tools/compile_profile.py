"""Decompose pipeline compile latency.

Phases per target: trace+lower (Python/jaxpr side), compile (XLA).
Targets isolate the
suspects: the full step, matcher.track alone (retry ladder x lane-bucket
switches x 6 traced kernel levels), ba.solve alone, tracker sweep alone.

    python tools/compile_profile.py [--targets step,matcher] [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--targets", default="matcher,ba,step")
    ap.add_argument("--platform", default="")
    ap.add_argument("--no-cache", action="store_true",
                    help="skip the persistent compile cache (true costs)")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    if not args.no_cache:
        from slam_robot_tpu.utils import cachedir

        cachedir.configure(args.platform)
    import jax.numpy as jnp

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import localmap as lm
    from slam_robot_tpu.models import matcher as matcher_mod
    from slam_robot_tpu.models import pipeline, slam

    cfg = SlamConfig()
    print(f"device: {jax.devices()[0]}", flush=True)

    img = jnp.zeros((cfg.image_height, cfg.image_width), jnp.float32)
    ps = pipeline.init(cfg)

    def phase(name, fn, *a, **kw):
        t0 = time.time()
        lowered = jax.jit(fn, **kw).lower(*a)
        t_lower = time.time() - t0
        t0 = time.time()
        compiled = lowered.compile()
        t_compile = time.time() - t0
        try:
            hlo = lowered.as_text()
            n_lines = hlo.count("\n")
        except Exception:
            n_lines = -1
        print(json.dumps({
            "target": name,
            "trace_lower_s": round(t_lower, 1),
            "xla_compile_s": round(t_compile, 1),
            "stablehlo_lines": n_lines,
        }), flush=True)
        return compiled

    targets = args.targets.split(",")
    if "matcher" in targets:
        phase(
            "matcher.track",
            lambda ms, m, im: matcher_mod.track(ms, m, im, jnp.int32(1),
                                                jnp.int32(0), cfg),
            ps.matcher, ps.map, img,
        )
    if "ba" in targets:
        phase(
            "slam.solve_frames(fast)",
            lambda m: slam.solve_frames(
                m, cfg.solve_fast[0], cfg.solve_fast[1], cfg.ba_range, cfg,
                max_iters=cfg.ba_iters_fast, window_obs=cfg.window_obs_fast,
                max_free_points=cfg.ba_free_points_fast,
            )[0],
            ps.map,
        )
    if "step" in targets:
        phase(
            "pipeline.step",
            lambda ps_, im: pipeline._step(ps_, im, cfg, True),
            ps, img,
        )
    if "scan" in targets:
        imgs = jnp.zeros((8, cfg.image_height, cfg.image_width), jnp.float32)

        def run_scan(ps_, imgs_):
            def body(p, im):
                p, met = pipeline._step(p, im, cfg, True)
                return p, met["mean_reproj_err"]

            return jax.lax.scan(body, ps_, imgs_)

        phase("scan(step)", run_scan, ps, imgs)


if __name__ == "__main__":
    main()
