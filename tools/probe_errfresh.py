"""Stored-vs-fresh obs-error audit on the bench workload.

BENCH r4 showed enabled-obs p90 = 15.5 px (historically sub-px mass):
either match quality genuinely rotted, or the STORED obs_err table is
stale — polish/xslow solves move old frames/points but only the windowed
reproject refreshes rows, so rows outside any recent window keep errors
measured against geometry that has since moved (slam.cpp:523-548 recomputes
the mean over the window only, so stored-staleness is reference-faithful —
but our clean/epipolar maintenance reads obs_err, so staleness there is a
real liability, and the bench's err_split should not report it as match
quality).

Replays the exact bench warm+scan, then recomputes EVERY obs row's error
against the final geometry and prints stored vs fresh quantiles for
enabled rows.

    python tools/probe_errfresh.py [--platform cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure()

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.ops import projection as proj
    from slam_robot_tpu.utils.benchscene import make_frames

    cfg = SlamConfig()
    n_warm, n_timed = 96, 64
    frames = make_frames(cfg, n_warm + n_timed)
    ps = pipeline.init(cfg)
    for i in range(n_warm):
        ps, _ = pipeline.step(ps, frames[i], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)

    @jax.jit
    def run_scan(ps, imgs):
        def body(ps, img):
            ps, met = pipeline.step(ps, img, cfg)
            return ps, met["mean_reproj_err"]

        return jax.lax.scan(body, ps, imgs)

    ps2, _ = run_scan(ps, jnp.stack(frames[n_warm:]))
    m = ps2.map

    @jax.jit
    def fresh_err(m):
        f = m.obs_frame.clip(0)
        p = m.obs_point.clip(0)
        q = m.frame_quat[f]
        t = m.frame_trans[f]
        k = m.cam_k[m.frame_cam[f]]
        loc = m.point_loc[p]
        px, valid = jax.vmap(
            proj.project_point, in_axes=(0, 0, 0, 0, None)
        )(q, t, k, loc, cfg.cheirality_eps)
        return jnp.linalg.norm(px - m.obs_px, axis=-1), valid

    fresh, valid = fresh_err(m)
    no = int(np.asarray(m.n_obs))
    fresh = np.asarray(fresh)[:no]
    valid = np.asarray(valid)[:no]
    stored = np.linalg.norm(np.asarray(m.obs_err[:no]), axis=1)
    dis = np.asarray(m.obs_disabled[:no])
    mask = np.asarray(m.obs_mask[:no])
    en = mask & ~dis & valid
    # are the high-error enabled rows BA inputs at all? obs of points no
    # longer slam-usable stay "enabled" in the table but are excluded from
    # every solve (localmap.slam_usable; localmap.cpp:328-356 flags them)
    from slam_robot_tpu.models.localmap import slam_usable

    pu = np.asarray(slam_usable(m.point_flags) & m.point_mask)
    op = np.asarray(m.obs_point[:no]).clip(0)
    en_usable = en & pu[op]
    q = lambda a, p: round(float(np.quantile(a, p)), 3) if a.size else 0.0
    stats = lambda a: {"p50": q(a, 0.5), "p90": q(a, 0.9),
                       "p99": q(a, 0.99), "mean": round(float(a.mean()), 3)}
    # which frames own the stale mass: split rows by |stored - fresh|
    stale = np.abs(stored - fresh) > 0.5
    of = np.asarray(m.obs_frame[:no])
    print(json.dumps({
        "n_obs": no,
        "n_enabled": int(en.sum()),
        "stored_enabled": stats(stored[en]),
        "fresh_enabled": stats(fresh[en]),
        "stale_rows_enabled": int((stale & en).sum()),
        "stale_frame_range": [int(of[stale & en].min()),
                              int(of[stale & en].max())]
        if (stale & en).any() else [],
        "fresh_enabled_gt3px": int((fresh[en] > 3.0).sum()),
        "stored_enabled_gt3px": int((stored[en] > 3.0).sum()),
        "n_enabled_usable": int(en_usable.sum()),
        "fresh_usable": stats(fresh[en_usable]),
        "fresh_usable_gt3px": int((fresh[en_usable] > 3.0).sum()),
    }))


if __name__ == "__main__":
    main()
