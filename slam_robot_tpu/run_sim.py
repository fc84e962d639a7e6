"""Closed-loop simulation driver (BASELINE config 4).

    python -m slam_robot_tpu.run_sim --goals 8            # rollout fleet
    python -m slam_robot_tpu.run_sim --slam               # SLAM in the loop
    python -m slam_robot_tpu.run_sim --goals 64 --mesh    # shard over devices

Prints per-rollout goal distances and a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--goals", type=int, default=8, help="number of rollouts")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--slam", action="store_true", help="SLAM-in-the-loop (1 rollout)")
    ap.add_argument("--mesh", action="store_true", help="shard rollouts over devices")
    ap.add_argument("--platform", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure(args.platform)

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import sim
    from slam_robot_tpu.utils import synthetic

    rng = np.random.default_rng(args.seed)
    t0 = time.time()

    if args.slam:
        cfg = SlamConfig(
            image_width=160, image_height=120, pyramid_depth=4,
            levels_unsure=4, max_features=96, max_corners=48, min_matches=12,
            max_frames=64, max_points=384, max_obs=8192, max_obs_per_point=16,
            ba_max_iters=10, window_obs=2048,
        )
        k = synthetic.reference_intrinsics(cfg)
        world = sim.make_world(400, seed=args.seed)
        goal = jnp.array([3.0, 2.0, 0.0])
        traj, est, dist = sim.rollout_slam(
            goal, world, cfg, [k, k], n_steps=min(args.steps, 30)
        )
        print(json.dumps({
            "mode": "slam_in_loop",
            "steps": int(traj.shape[0]),
            "final_dist_m": round(float(dist), 3),
            "est_final_mm": np.asarray(est[-1]).round(1).tolist(),
            "wall_s": round(time.time() - t0, 1),
        }))
        return 0

    goals = jnp.asarray(
        np.concatenate(
            [rng.uniform(2, 7, (args.goals, 2)),
             rng.uniform(-3.14, 3.14, (args.goals, 1))], axis=1
        ).astype(np.float32)
    )
    if args.mesh:
        from slam_robot_tpu.parallel import mesh as mesh_mod
        from slam_robot_tpu.parallel import rollouts

        m = mesh_mod.make_mesh()
        traj, dist = rollouts.fleet(m, goals, n_steps=args.steps)
    else:
        traj, dist = jax.jit(
            jax.vmap(lambda g: sim.rollout(g, n_steps=args.steps))
        )(goals)
    jax.block_until_ready(dist)
    d = np.asarray(dist)
    print(json.dumps({
        "mode": "fleet",
        "rollouts": args.goals,
        "steps": args.steps,
        "reached(<0.5m)": int((d < 0.5).sum()),
        "median_dist_m": round(float(np.median(d)), 3),
        "wall_s": round(time.time() - t0, 1),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
