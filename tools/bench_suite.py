"""The five BASELINE.json benchmark configs, one JSON line each.

1. recorded monocular replay: tracking only, ~300 features, no BA
2. sliding-window BA: 10 keyframes x 500 landmarks
3. full 640x480 pipeline with keyframe insertion (the headline; = bench.py)
4. closed-loop sim: 64 vmapped rollouts
5. large-scale mapping: batched BA at 10k keyframes / 500k landmarks
   (implicit-Schur CG), plus a multi-robot shared-map solve

    python tools/bench_suite.py [--platform cpu] [--configs 1,2,4]
    python tools/bench_suite.py --small        # CI-sized shapes
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))




def _sync(x):
    """Wait until the device has produced ``x``."""
    import jax

    return jax.block_until_ready(x)


def emit(name, value, unit, **detail):
    print(json.dumps({"config": name, "value": round(value, 3), "unit": unit,
                      "detail": detail}))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", default="")
    ap.add_argument("--configs", default="1,2,3,4,5")
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from slam_robot_tpu.utils import cachedir

    cachedir.configure(args.platform)

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import localmap as lm
    from slam_robot_tpu.models import pipeline, renderer, sim, slam
    from slam_robot_tpu.ops import ba, ba_cg
    from slam_robot_tpu.ops import quaternion as quat
    from slam_robot_tpu.utils import synthetic

    configs = {int(c) for c in args.configs.split(",")}
    small = args.small

    def frames_for(cfg, n, n_pts=600):
        k = jnp.asarray(synthetic.reference_intrinsics(cfg))
        world, bright = renderer.make_world(n_pts, seed=0)
        out = []
        for i in range(n):
            pair = i // 2
            q = quat.from_axis_angle(jnp.array([0.0, 1.0, 0.0]), 0.004 * pair)
            t = jnp.array([150.0 * (i % 2), 0.0, 15.0 * pair])
            out.append(renderer.render(q, t, k, world, bright,
                                       height=cfg.image_height,
                                       width=cfg.image_width))
        return [jax.device_put(f) for f in out]

    # ---- config 1: replay, tracking only ----
    if 1 in configs:
        cfg = SlamConfig() if not small else SlamConfig(
            image_width=160, image_height=120, pyramid_depth=4,
            max_features=64, max_points=256, max_obs=4096)
        frames = frames_for(cfg, 10)
        ps = pipeline.init(cfg)
        for i in range(3):
            ps, _ = pipeline.step(ps, frames[i], cfg, run_slam=False)
        _sync(ps.map.n_obs)
        n = 8
        t0 = time.time()
        for i in range(n):
            ps, _ = pipeline.step(ps, frames[(3 + i) % len(frames)], cfg,
                                  run_slam=False)
        _sync(ps.map.n_obs)
        dt = (time.time() - t0) / n
        emit("1_replay_track_only", 1.0 / dt, "fps", step_ms=round(dt * 1000, 2))

    # ---- config 2: sliding-window BA 10kf x 500 landmarks ----
    if 2 in configs:
        cfg = SlamConfig(max_frames=32, max_points=512, max_obs=8192,
                         max_obs_per_point=32)
        scene = synthetic.build_scene(cfg, n_frames=20, n_points=500,
                                      pixel_noise=0.3, point_noise=30.0)
        s = scene.state

        def run():
            s2, res = slam.solve_frames(s, 10, 20, 2.0, cfg)
            return res.cost

        run()
        _sync(run())
        n = 5
        t0 = time.time()
        for _ in range(n):
            c = run()
        _sync(c)
        dt = (time.time() - t0) / n
        _, res = slam.solve_frames(s, 10, 20, 2.0, cfg)
        emit("2_window_ba_10x500", 1.0 / dt, "solves/s",
             solve_ms=round(dt * 1000, 2), lm_iters=int(res.iters),
             iters_per_s=round(int(res.iters) / dt, 1))

    # ---- config 3: headline (bench.py) ----
    if 3 in configs:
        import bench

        bench.main()

    # ---- config 4: 64 rollouts ----
    if 4 in configs:
        n_roll = 16 if small else 64
        goals = jnp.asarray(
            np.concatenate(
                [np.random.default_rng(2).uniform(2, 7, (n_roll, 2)),
                 np.zeros((n_roll, 1))], axis=1).astype(np.float32))
        run = jax.jit(jax.vmap(lambda g: sim.rollout(g, n_steps=300)))
        traj, dist = run(goals)
        _sync(dist)
        t0 = time.time()
        traj, dist = run(goals)
        _sync(dist)
        dt = time.time() - t0
        d = np.asarray(dist)
        emit("4_closed_loop_64_rollouts", n_roll * 300 / dt, "sim steps/s",
             wall_s=round(dt, 3), reached=int((d < 0.5).sum()), rollouts=n_roll)

    # ---- config 5: large-scale mapping ----
    if 5 in configs:
        nf, npts = (200, 5000) if small else (10000, 500000)
        prob = synthetic.build_large_problem(nf, npts, obs_per_frame=60 if small else 100)
        cgc = ba_cg.CGConfig(max_free_frames=nf, gn_iters=5, cg_iters=20,
                             precond="diag")
        keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
                "point_uncertainty", "obs_frame", "obs_point", "obs_px",
                "obs_ok", "present", "free_frame")
        args5 = tuple(prob[k] for k in keys)
        res = ba_cg.solve(*args5, cgc)
        _sync(res.cost)
        t0 = time.time()
        res = ba_cg.solve(*args5, cgc)
        _sync(res.cost)
        dt = time.time() - t0
        ate = float(jnp.sqrt(jnp.mean(jnp.sum(
            (res.frame_trans - prob["true_trans"]) ** 2, axis=1))))
        emit("5_large_ba", cgc.gn_iters / dt, "GN iters/s",
             wall_s=round(dt, 2), frames=nf, landmarks=npts,
             obs=int(prob["obs_frame"].shape[0]), ate_mm=round(ate, 2),
             cost=float(res.cost))

        # sharded large-map CG (SURVEY §5 scale-out): obs tables split over
        # a 'model' mesh of all local devices; landmark sums + the reduced
        # camera system psum over the axis. One real chip = mesh of 1 (the
        # multi-device form is validated on the virtual CPU mesh by
        # tests/test_parallel.py and tools/profile_cg_sharded.py; the
        # matvec is HBM-bandwidth-bound — finding 34 — so per-chip GN
        # iters/s projects ~linearly with the 1/D obs stream).
        from slam_robot_tpu.parallel import mesh as mesh_mod

        D = len(jax.devices())
        msh = mesh_mod.make_mesh({"model": D})
        res_s = ba_cg.solve_sharded(msh, *args5, cfg=cgc)
        _sync(res_s.cost)
        t0 = time.time()
        res_s = ba_cg.solve_sharded(msh, *args5, cfg=cgc)
        _sync(res_s.cost)
        dt = time.time() - t0
        ate_s = float(jnp.sqrt(jnp.mean(jnp.sum(
            (res_s.frame_trans - prob["true_trans"]) ** 2, axis=1))))
        emit("5_large_ba_sharded", cgc.gn_iters / dt, "GN iters/s",
             wall_s=round(dt, 2), devices=D, frames=nf, landmarks=npts,
             obs=int(prob["obs_frame"].shape[0]), ate_mm=round(ate_s, 2),
             cost=float(res_s.cost))

        # multi-robot shared map (the declared config-5 secondary axis:
        # a device number, not just CPU tests)
        from slam_robot_tpu.parallel import multi_robot

        R = 2 if small else 8
        mcfg = SlamConfig(max_frames=32, max_points=512, max_obs=16384,
                          max_obs_per_point=32)
        scenes = [synthetic.build_scene(mcfg, n_frames=24, n_points=400,
                                        seed=0, pose_noise=0.005)
                  for _ in range(R)]
        rng5 = np.random.default_rng(5)
        locs = scenes[0].state.point_loc.at[:400, :3].add(jnp.asarray(
            rng5.normal(scale=60.0, size=(400, 3)).astype(np.float32)))
        packs = []
        for sc in scenes:
            s5 = sc.state
            free5, present5 = slam.window_masks(s5, 8, 24)
            ok5 = slam._obs_ok(s5, s5.n_frames - 24)
            packs.append((s5.frame_quat, s5.frame_trans, s5.frame_cam,
                          s5.obs_frame, s5.obs_point, s5.obs_px, ok5,
                          present5, free5))
        st = lambda i: jnp.stack([p[i] for p in packs])
        sweeps = 3
        args_mr = (st(0), st(1), st(2), scenes[0].state.cam_k, locs,
                   scenes[0].state.point_uncertainty, st(3), st(4), st(5),
                   st(6), st(7), st(8))
        fq5, ft5, locs5 = multi_robot.solve_shared_map(
            *args_mr, cfg=ba.BAConfig(max_iters=5, max_free_frames=8),
            sweeps=sweeps)
        _sync(locs5)
        t0 = time.time()
        fq5, ft5, locs5 = multi_robot.solve_shared_map(
            *args_mr, cfg=ba.BAConfig(max_iters=5, max_free_frames=8),
            sweeps=sweeps)
        _sync(locs5)
        dt = time.time() - t0
        pos5 = np.asarray(locs5[:400, :3] / locs5[:400, 3:])
        perr = float(np.linalg.norm(
            pos5 - np.asarray(scenes[0].true_points[:, :3]), axis=1).mean())
        emit("5_multi_robot_shared_map", sweeps / dt, "GS sweeps/s",
             wall_s=round(dt, 2), robots=R,
             obs=R * int(packs[0][3].shape[0]),
             shared_landmarks=400, mean_point_err_mm=round(perr, 2))


if __name__ == "__main__":
    main()
