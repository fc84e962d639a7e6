"""On-card bit-identity check: keyframe refpack via window re-reads
(tracker_fused.get_patch_stacks_from_windows) vs per-lane plane extraction
(get_patch_stacks). The one-hot selection matmuls must be EXACT under
Precision.HIGHEST (each output = 1.0*pixel + exact zeros) — any fp-level
difference in reference patches forks the keyframe cadence (PERF.md), so
this must hold on the card, not just XLA:CPU. Also times both at the
keyframe-branch shape.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import jax

    from slam_robot_tpu.utils import cachedir

    cachedir.configure()
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.ops import pyramid as pyr_mod
    from slam_robot_tpu.ops import tracker_fused

    print("device:", jax.devices()[0].device_kind, flush=True)
    rng = np.random.default_rng(0)
    img = jnp.asarray(rng.uniform(0, 1, (480, 640)).astype(np.float32))
    pyr = pyr_mod.build_pyramid(img, depth=6)
    K = 192  # the keyframe branch's kneed bucket
    pts = jnp.asarray(np.stack(
        [rng.uniform(-5, 645, K), rng.uniform(-5, 485, K)], -1
    ).astype(np.float32))

    wins, orgs = jax.jit(tracker_fused.get_window_stacks)(pyr, pts)
    plane = jax.jit(
        lambda p: tracker_fused.get_patch_stacks(pyr, p, 13))
    winrd = jax.jit(
        lambda p, w, o: tracker_fused.get_patch_stacks_from_windows(
            pyr, p, w, o, 13))

    a = plane(pts)
    b = winrd(pts, wins, orgs)
    for f in ("data", "valid", "mean", "sumsq"):
        av = np.asarray(getattr(a, f))
        bv = np.asarray(getattr(b, f))
        eq = np.array_equal(av, bv)
        d = (np.abs(av.astype(np.float64) - bv.astype(np.float64)).max()
             if not eq else 0.0)
        print(f"{f}: bit-identical={eq} max|d|={d:g}", flush=True)

    def timeit(fn, *args, n=30):
        np.asarray(fn(*args).data)
        reps = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(n):
                out = fn(*args)
            np.asarray(out.data)
            reps.append((time.perf_counter() - t0) / n * 1e3)
        return min(reps)

    print(f"plane extraction [K={K},L=6]: {timeit(plane, pts):7.3f} ms")
    print(f"window re-read   [K={K},L=6]: "
          f"{timeit(winrd, pts, wins, orgs):7.3f} ms")


if __name__ == "__main__":
    main()
