"""Fused-tracker stage timing on the card: Newton sweep (kernel and plain
XLA form), gathers, stacks, full cascades.

    python tools/profile_tracker.py
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timeit(fn, *args, n=20, warmup=2):
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure()

    import functools

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.ops import patch as patch_ops
    from slam_robot_tpu.ops import pyramid as pyr
    from slam_robot_tpu.ops import tracker_fused
    from slam_robot_tpu.ops.pallas import newton

    print("device:", jax.devices()[0].device_kind)
    rng = np.random.default_rng(0)
    cfg = SlamConfig()
    F, S = cfg.max_features, cfg.patch_size
    WEIGHT = patch_ops.radial_mask(S)

    img = jnp.asarray(rng.uniform(0, 1, size=(480, 640)).astype(np.float32))
    pa = pyr.build_pyramid(img, depth=6)
    pb = pyr.build_pyramid(img, depth=6)
    pts = jnp.asarray(rng.uniform(50, 400, size=(F, 2)).astype(np.float32))
    lvls = jnp.full((F,), 3, jnp.int32)
    active = jnp.ones((F,), bool)

    # 1. kernel alone at [F,32,32]
    win = jnp.asarray(rng.uniform(0, 1, size=(F, 32, 32)).astype(np.float32))
    ref = jnp.asarray(rng.uniform(0, 1, size=(F, S, S)).astype(np.float32))
    pos0 = jnp.full((F, 2), 14.3)
    org = jnp.zeros((F, 2), jnp.float32)
    rv = jnp.ones((F, S, S), jnp.float32)
    rm = jnp.mean(ref, axis=(1, 2))
    rs = jnp.mean(ref * ref, axis=(1, 2))

    bounds = jnp.broadcast_to(jnp.asarray([640.0, 480.0]), (F, 2))
    for backend in sorted({"xla", tracker_fused.default_backend()}):
        kern = jax.jit(functools.partial(
            newton.newton_level, org=org, ref=ref, ref_valid=rv,
            ref_mean=rm, ref_sumsq=rs, active=jnp.ones((F,)), wmask=WEIGHT,
            bounds=bounds, max_iters=6, backend=backend))
        print(f"newton_level {backend:6s} [F={F}]: "
              f"{timeit(kern, win, pos0):8.3f} ms")

    # 2. window gather for one level
    @jax.jit
    def gather(pts):
        return tracker_fused._gather_windows(pa, 0, pts, 32, 32)

    print(f"window gather [F={F}]:         {timeit(gather, pts):8.3f} ms")

    # 3. ref patch stacks
    @jax.jit
    def stacks(pts):
        return tracker_fused.get_patch_stacks(pa, pts, S)

    print(f"patch stacks [F={F},L=6]:      {timeit(stacks, pts):8.3f} ms")

    # 4. one full track_feature_batch (6-level cascade)
    patches = stacks(pts)

    @jax.jit
    def tf(pts):
        return tracker_fused.track_feature_batch(
            pb, patches, pts, lvls, WEIGHT, max_iters=6, active=active)

    print(f"track_feature_batch (3 lvl):   {timeit(tf, pts):8.3f} ms")

    # 5. bidirectional
    @jax.jit
    def tb(pts):
        return tracker_fused.track_bidirectional_batch(
            pa, pb, pts, pts, lvls, WEIGHT, max_iters=6, active=active)

    print(f"track_bidirectional_batch:     {timeit(tb, pts):8.3f} ms")


if __name__ == "__main__":
    main()
