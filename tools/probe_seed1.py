"""Seed-1 match-quality diagnosis.

The shipped config's 3-seed ATE campaign read 0.76 / 3.60 / 1.45 %
— seed 1 is a hard texture draw in EVERY config (~48 mean matches ->
keyframe storms, 29 kf in the 64-frame scan). The diagnosis named match
QUALITY, not solver policy. This probe decomposes the per-frame match
economy on any bench-scene seed:

per frame: n_matches, keyframe?, n_added, live feature lanes, lanes with a
stored view, backed-off lanes (fail streak), map points; at each keyframe:
how many corners the detector accepted and how many got grid-suppressed.

    python tools/probe_seed1.py --seed 1 [--frames 160] [--platform cpu]
    python tools/probe_seed1.py --seed 1 --set min_matches=48
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=160)
    ap.add_argument("--platform", default="")
    ap.add_argument("--set", default="", help="key=val[;key=val...] overrides")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure(args.platform)

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.ops import corners as corner_ops
    from slam_robot_tpu.ops import pyramid as pyr
    from slam_robot_tpu.utils import benchscene

    cfg = SlamConfig()
    if args.set:
        kv = {}
        for pair in args.set.split(";"):
            k, v = pair.split("=")
            ftype = type(getattr(cfg, k))
            if ftype is bool:
                kv[k] = v == "True"
            elif ftype is tuple:
                kv[k] = tuple(int(t) for t in v.split("x"))
            else:
                kv[k] = ftype(v)
        cfg = dataclasses.replace(cfg, **kv)

    frames = benchscene.make_frames(cfg, args.frames, seed=args.seed)
    ps = pipeline.init(cfg)

    rows = []
    for i in range(args.frames):
        ps, met = pipeline.step(ps, frames[i], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
        ms = ps.matcher
        live = np.asarray(ms.feat_point) >= 0
        has_view = np.asarray(ms.feat_valid).any(axis=1)
        fail = np.asarray(ms.feat_fail)
        row = {
            "f": i,
            "matches": int(np.asarray(met["n_matches"])),
            "kf": bool(np.asarray(met["is_keyframe"])),
            "added": int(np.asarray(met["n_added"])),
            "pts": int(np.asarray(met["n_points"])),
            "lanes_live": int(live.sum()),
            "lanes_viewed": int((live & has_view).sum()),
            "lanes_failing": int((live & (fail > 0)).sum()),
            "pts_live": int(np.asarray(ps.map.point_mask).sum()),
            "err": round(float(np.asarray(met["mean_reproj_err"])), 3),
        }
        if row["kf"]:
            # re-run the detector on this frame for the corner economy
            g = pyr.build_pyramid(
                jnp.asarray(frames[i]), 1, cfg.blur_sigma0
            ).data[0, pyr.PAD:-pyr.PAD, pyr.PAD:-pyr.PAD]
            cpts, cval = corner_ops.detect(
                g, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist)
            occ = corner_ops.occupancy_grid(
                np.asarray(met["feat_px"]), np.asarray(met["feat_matched"]),
                cfg.image_width, cfg.image_height, cfg.suppress_grid)
            kept = corner_ops.suppress_by_grid(
                cpts, cval, occ, cfg.image_width, cfg.image_height,
                cfg.suppress_grid)
            row["corners_detected"] = int(np.asarray(cval).sum())
            row["corners_after_grid"] = int(np.asarray(kept).sum())
        rows.append(row)
        print(json.dumps(row), flush=True)

    nf = int(ps.map.n_frames)
    true_t = np.stack([benchscene.sweep_pose(i)[1] for i in range(nf)])
    est_t = np.asarray(ps.map.frame_trans[:nf])
    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    # error-accrual curve: where along the trajectory the final-state error
    # lives (early segments locked in by windowed BA vs tail drift)
    perr = np.sqrt(((est_t - true_t) ** 2).sum(1))
    for lo in range(0, nf, 16):
        seg = perr[lo:lo + 16]
        print(json.dumps({
            "seg": [lo, min(lo + 16, nf)],
            "mean_err_mm": round(float(seg.mean()), 2),
            "max_err_mm": round(float(seg.max()), 2),
        }), flush=True)
    # gauge decomposition: how much of the final error is a GLOBAL scale
    # (weakly observable: only the 150mm frame-distance prior pins it) vs
    # rotation vs residual shape. Fit scale-only, then rotation+scale
    # (both anchored at the origin like the trajectory itself).
    num = float((est_t * true_t).sum())
    den = float((est_t * est_t).sum())
    s_fit = num / max(den, 1e-9)
    perr_s = np.sqrt((((s_fit * est_t) - true_t) ** 2).sum(1))
    # Kabsch about the origin (no centroid shift: frame 0 is the anchor)
    H = est_t.T @ true_t
    U, S, Vt = np.linalg.svd(H)
    d = np.sign(np.linalg.det(Vt.T @ U.T))
    Rk = Vt.T @ np.diag([1, 1, d]) @ U.T
    sr = float((S * [1, 1, d]).sum()) / max(den, 1e-9)
    perr_rs = np.sqrt((((sr * (Rk @ est_t.T).T) - true_t) ** 2).sum(1))
    print(json.dumps({
        "gauge": {
            "scale_fit": round(s_fit, 4),
            "ate_mm_raw": round(float(perr.mean()), 2),
            "ate_mm_after_scale": round(float(perr_s.mean()), 2),
            "ate_mm_after_rot_scale": round(float(perr_rs.mean()), 2),
            "rot_angle_deg": round(float(np.degrees(np.arccos(
                np.clip((np.trace(Rk) - 1) / 2, -1, 1)))), 3),
        }
    }), flush=True)

    kfs = [r for r in rows if r["kf"]]
    tail = rows[96:]
    print(json.dumps({
        "summary": {
            "seed": args.seed,
            "ate_pct_of_path": round(100.0 * ate / max(path, 1e-9), 2),
            "keyframes_total": len(kfs),
            "keyframes_in_scan_window": sum(r["kf"] for r in tail),
            "mean_matches_scan": round(
                float(np.mean([r["matches"] for r in tail])), 1),
            "min_matches_cfg": cfg.min_matches,
        }
    }, indent=None), flush=True)


if __name__ == "__main__":
    main()
