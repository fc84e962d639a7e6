"""Sharded large-map CG: validation on virtual CPU meshes.

ba_cg.solve_sharded splits the observation tables 1/D over a 'model' mesh
axis (gather plans are per-shard) and psums the [P,4] landmark sums + the
[W,6] reduced camera system over the axis. This tool checks it on virtual
CPU meshes of 1/2/4/8 devices against the single-device solver (cost +
trajectory agreement). Wall-clock on a virtual mesh is meaningless — all
"devices" share the host's cores — so no speed numbers are reported; the
four-card run on GPUs is ``python chip_smoke.py --four-cards``.

    python tools/profile_cg_sharded.py [--small]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true",
                    help="CI-sized problem (200 kf / 5k lm)")
    ap.add_argument("--devices", default="1,2,4,8")
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from slam_robot_tpu.utils import cachedir

    cachedir.configure("cpu", 5.0)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from slam_robot_tpu.ops import ba_cg
    from slam_robot_tpu.utils import synthetic

    nf, npts, opf = (64, 2000, 40) if args.small else (256, 8000, 60)
    prob = synthetic.build_large_problem(nf, npts, obs_per_frame=opf)
    keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
            "point_uncertainty", "obs_frame", "obs_point", "obs_px",
            "obs_ok", "present", "free_frame")
    solve_args = tuple(prob[k] for k in keys)
    cgc = ba_cg.CGConfig(max_free_frames=nf, gn_iters=3, cg_iters=12,
                         precond="diag")

    ref = ba_cg.solve(*solve_args, cgc)
    ref_cost = float(np.asarray(ref.cost))
    ref_trans = np.asarray(ref.frame_trans)

    rows = []
    devs = jax.devices()
    for d in (int(x) for x in args.devices.split(",")):
        if d > len(devs):
            continue
        mesh = Mesh(np.array(devs[:d]), ("model",))
        res = ba_cg.solve_sharded(mesh, *solve_args, cfg=cgc)
        cost = float(np.asarray(res.cost))
        dtr = float(np.max(np.abs(np.asarray(res.frame_trans) - ref_trans)))
        rows.append({
            "devices": d,
            "cost": round(cost, 4),
            "cost_rel_err": round(abs(cost - ref_cost) / max(ref_cost, 1e-9), 8),
            "trans_max_diff_mm": round(dtr, 5),
            "ok": bool(np.asarray(res.ok)),
        })
        print(json.dumps(rows[-1]), flush=True)

    print(json.dumps({
        "validation": rows,
        "note": "virtual-mesh wall times are not reported: all virtual "
                "devices share the host's cores",
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
