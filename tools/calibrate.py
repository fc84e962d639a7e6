"""Camera intrinsics calibration: the SolveCameras flow (main.cpp:269-328).

Replays a sequence, then runs full bundle adjustment with the camera
intrinsics free (CameraStabilization regularizers active) and prints the
solved k rows in the reference's format.

    python tools/calibrate.py --synthetic 20 [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--load", default="")
    ap.add_argument("--synthetic", type=int, default=20)
    ap.add_argument("--platform", default="")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure()

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.io import sources
    from slam_robot_tpu.models import localmap as lm
    from slam_robot_tpu.models import pipeline, slam

    cfg = SlamConfig(image_width=args.width, image_height=args.height)
    src = (sources.FileSource(args.load) if args.load
           else sources.SyntheticSource(cfg, n_frames=args.synthetic))
    src.init()

    ps = pipeline.init(cfg)
    for cam, fid, img in sources.prefetch(src):
        ps, _ = pipeline.step(ps, jnp.asarray(img), cfg)

    m = ps.map

    def print_k(m, label):
        print(f"k1 k2 k3 fx fy cx cy   ({label})")
        for c in range(cfg.num_cameras):
            k = np.asarray(m.cam_k[c])
            print(" " + ", ".join(f"{v:9.5f}" for v in k))

    print_k(m, "initial")
    # Reset() then full BA with intrinsics free (main.cpp:276-283)
    m = lm.reset_cameras(m)
    m, res = slam.solve_all_frames(m, 2.0, solve_cameras=True, cfg=cfg)
    m, err = lm.reproject(m)
    print_k(m, f"solved, {int(res.iters)} iters, reproj {float(err):.3f}px")
    return 0


if __name__ == "__main__":
    sys.exit(main())
