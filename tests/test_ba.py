import jax.numpy as jnp
import numpy as np

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.models import slam
from slam_robot_tpu.utils import synthetic

CFG = SlamConfig(max_frames=16, max_points=64, max_obs=2048, max_obs_per_point=16)


def reproj_err(state):
    _, mean = lm.reproject(state)
    return float(mean)


def test_point_only_recovery():
    # frames exact, points perturbed; new points have uncertainty 1e8 > 100
    # so they stay free even with no free frame (slam.cpp:346-348)
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=20, point_noise=100.0)
    assert reproj_err(scene.state) > 5.0
    s2, res = slam.solve_frames(scene.state, 0, 6, 2.0, CFG)
    assert bool(res.ok)
    assert reproj_err(s2) < 0.1
    pos = np.asarray(s2.point_loc[:20, :3] / s2.point_loc[:20, 3:])
    np.testing.assert_allclose(pos, np.asarray(scene.true_points[:, :3]), atol=5.0)


def test_pose_recovery():
    # points exact, poses 2.. perturbed; first two frames form the gauge
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=30, pose_noise=0.01)
    # freeze the points by giving them small uncertainty
    s = scene.state._replace(
        point_uncertainty=jnp.full_like(scene.state.point_uncertainty, 1.0)
    )
    assert reproj_err(s) > 1.0
    s2, res = slam.solve_frames(s, 4, 6, 2.0, CFG)
    assert bool(res.ok)
    assert reproj_err(s2) < 0.05
    ate = np.linalg.norm(
        np.asarray(s2.frame_trans[:6]) - np.asarray(scene.true_trans), axis=1
    )
    assert ate.max() < 2.0  # mm


def test_joint_window_solve():
    scene = synthetic.build_scene(
        CFG, n_frames=8, n_points=40, pixel_noise=0.2, point_noise=30.0
    )
    s = scene.state
    before = reproj_err(s)
    s, res = slam.solve_frames(s, 2, 5, 2.0, CFG)
    assert bool(res.ok)
    after = reproj_err(s)
    assert after < before
    # with 0.2px pixel noise the floor is ~0.2-0.4 px
    assert after < 1.0


def test_robust_loss_resists_outlier():
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=20, point_noise=20.0)
    s = scene.state
    # corrupt one observation of point 0 massively
    row = int(s.recent_obs_index(1)[0])
    s = s._replace(obs_px=s.obs_px.at[row].add(jnp.array([300.0, -200.0])))
    s2, res = slam.solve_frames(s, 0, 6, 2.0, CFG)
    pos = np.asarray(s2.point_loc[1:20, :3] / s2.point_loc[1:20, 3:])
    # all other points still converge to truth
    np.testing.assert_allclose(pos, np.asarray(scene.true_points[1:, :3]), atol=10.0)


def test_abort_too_few_frames():
    scene = synthetic.build_scene(CFG, n_frames=1, n_points=5)
    s, res = slam.solve_frames(scene.state, 2, 5, 2.0, CFG)
    assert not bool(res.ok)
    np.testing.assert_array_equal(
        np.asarray(s.frame_trans), np.asarray(scene.state.frame_trans)
    )


def test_confident_points_stay_const_outside_window():
    scene = synthetic.build_scene(CFG, n_frames=8, n_points=20, point_noise=50.0)
    # give points small uncertainty so the >100 rule doesn't free them, and
    # present only frames where they are NOT seen by a free frame: window
    # (2,5) -> points seen by frames 6,7 are fluid. All points are seen by
    # all frames here, so instead mark uncertainty small and free no frames:
    s = scene.state._replace(
        point_uncertainty=jnp.full_like(scene.state.point_uncertainty, 1.0)
    )
    s2, res = slam.solve_frames(s, 0, 6, 2.0, CFG)
    # nothing was free: points must be unchanged
    np.testing.assert_array_equal(np.asarray(s2.point_loc), np.asarray(s.point_loc))


def test_solve_all_frames_with_cameras():
    # Perturb radial distortion k1: the only intrinsic a full-free BA can
    # genuinely recover. Focal error is a near-perfect scale gauge and a
    # cx/cy shift is absorbable by a small common rotation of the (all
    # free) frames — measured: both stay put under either LM policy, and
    # the reference has the same degeneracies (its gauge-fixing block at
    # slam.cpp:474-478 is `#if 0`; CameraStabilization's 0.1/0.01-weight
    # focal/center pulls under CauchyLoss(5) are ~inert at a few px).
    # k1 warps the image NON-uniformly — unabsorbable by pose — and the
    # 1000-weight stabilization (slam.cpp:113-115) pulls the same way.
    scene = synthetic.build_scene(CFG, n_frames=8, n_points=40)
    s = scene.state
    k_bad = s.cam_k.at[:, 0].add(0.08)
    s = s._replace(cam_k=k_bad)
    before = reproj_err(s)
    assert before > 1.0
    s2, res = slam.solve_all_frames(s, 2.0, solve_cameras=True, cfg=CFG)
    assert bool(res.ok)
    after = reproj_err(s2)
    assert after < 0.5 * before
    # distortion pulled back toward truth (0): both the reprojection terms
    # and the 1000-weight stabilization demand it. Free points absorb part
    # of the warp (measured ~45% recovery on this scene), so the bar is
    # "meaningfully pulled", not "fully recovered".
    assert abs(float(s2.cam_k[0, 0])) < 0.75 * 0.08


def test_solve_frame_pose_is_noop():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=10)
    s, ok = slam.solve_frame_pose(scene.state)
    assert ok is False


def test_epipolar_pose_solve_recovers_rotation():
    # perturb the newest frame's rotation; the intended SolveFramePose
    # (epipolar-only) should pull it back
    import jax.numpy as jnp
    from slam_robot_tpu.ops import quaternion as quat

    scene = synthetic.build_scene(CFG, n_frames=6, n_points=40)
    s = scene.state
    f2 = int(s.n_frames) - 1
    bad_q = quat.retract(s.frame_quat[f2], jnp.array([0.02, -0.015, 0.01]))
    s = s._replace(frame_quat=s.frame_quat.at[f2].set(bad_q))

    s2, ok = slam.solve_frame_pose_epipolar(s, CFG)
    assert bool(ok)
    err_before = float(quat.angle_between(bad_q, scene.true_quat[f2]))
    err_after = float(quat.angle_between(s2.frame_quat[f2], scene.true_quat[f2]))
    assert err_after < 0.3 * err_before


def test_epipolar_pose_solve_aborts_few_points():
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=4)
    s2, ok = slam.solve_frame_pose_epipolar(scene.state, CFG, min_count=8)
    assert not bool(ok)


def test_inv4x4_matches_linalg(rng):
    from slam_robot_tpu.ops.ba import inv4x4

    m = rng.normal(size=(32, 4, 4)).astype(np.float32)
    m = m @ m.transpose(0, 2, 1) + 0.5 * np.eye(4)  # SPD, well-conditioned
    out = np.asarray(inv4x4(jnp.asarray(m)))
    np.testing.assert_allclose(out, np.linalg.inv(m), rtol=2e-3, atol=2e-4)


def test_cg_solver_matches_dense():
    from slam_robot_tpu.ops import ba_cg

    scene = synthetic.build_scene(CFG, n_frames=8, n_points=40, point_noise=40.0)
    s = scene.state
    free, present = slam.window_masks(s, 6, 8)
    obs_ok = slam._obs_ok(s, s.n_frames - 8)
    res = ba_cg.solve(
        s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k,
        s.point_loc, s.point_uncertainty,
        s.obs_frame, s.obs_point, s.obs_px, obs_ok, present, free,
        ba_cg.CGConfig(max_free_frames=8, gn_iters=15, cg_iters=50),
    )
    assert bool(res.ok)
    s2 = s._replace(frame_quat=res.frame_quat, frame_trans=res.frame_trans,
                    point_loc=res.point_loc)
    assert reproj_err(s2) < 0.1
    pos = np.asarray(res.point_loc[:40, :3] / res.point_loc[:40, 3:])
    np.testing.assert_allclose(pos, np.asarray(scene.true_points[:, :3]), atol=10.0)


def test_cg_solver_larger_map():
    # a map far beyond the dense solver's A-matrix comfort zone per point
    cfg = SlamConfig(max_frames=64, max_points=4096, max_obs=32768,
                     max_obs_per_point=16)
    scene = synthetic.build_scene(cfg, n_frames=30, n_points=2000,
                                  point_noise=30.0, pixel_noise=0.2)
    from slam_robot_tpu.ops import ba_cg
    from slam_robot_tpu.models import slam as slam_mod

    s = scene.state
    free, present = slam_mod.window_masks(s, 30, 30)
    obs_ok = slam_mod._obs_ok(s, s.n_frames - 30)
    res = ba_cg.solve(
        s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k,
        s.point_loc, s.point_uncertainty,
        s.obs_frame, s.obs_point, s.obs_px, obs_ok, present, free,
        ba_cg.CGConfig(max_free_frames=32, gn_iters=10),
    )
    s2 = s._replace(frame_quat=res.frame_quat, frame_trans=res.frame_trans,
                    point_loc=res.point_loc)
    before = reproj_err(s)
    after = reproj_err(s2)
    assert after < 0.1 * before and after < 1.0


def test_termination_reason_codes():
    """BAResult.term: the per-solve Ceres BriefReport analog
    (slam.cpp:510-518). Converged solves report ftol, capped solves report
    the iteration cap, aborted solves report not-run; cost0 >= cost."""
    from slam_robot_tpu.ops import ba

    scene = synthetic.build_scene(CFG, n_frames=6, n_points=20,
                                  point_noise=100.0)
    s = scene.state
    # plenty of iterations: this easy problem converges. Which convergence
    # exit fires is fp-rounding-sensitive: ftol (small accepted decrease),
    # xtol (step below f32 resolution) or stall (at machine precision every
    # further step is rejected, collapsing the trust region) — all three
    # are converged ends; assert the near-total cost reduction explicitly.
    s2, res = slam.solve_frames(s, 0, 6, 2.0, CFG)
    assert bool(res.ok)
    assert int(res.term) in (ba.TERM_FTOL, ba.TERM_XTOL, ba.TERM_STALL)
    assert float(res.cost0) >= float(res.cost)
    assert float(res.cost0) > 0.0
    assert float(res.cost) < 1e-3 * float(res.cost0)

    # a 1-iteration cap exits via the cap
    _, res1 = slam.solve_frames(s, 0, 6, 2.0, CFG, max_iters=1)
    assert int(res1.term) == ba.TERM_MAX_ITERS
    assert int(res1.iters) == 1

    # unsolvable (too few frames) reports not-run
    tiny = synthetic.build_scene(CFG, n_frames=1, n_points=5)
    _, res0 = slam.solve_frames(tiny.state, 2, 5, 2.0, CFG)
    assert int(res0.term) == ba.TERM_NOT_RUN


def test_obs_window_truncation_counter():
    """The fixed-size obs tail window must COUNT participating rows it
    excludes (the reference includes every enabled obs of presented frames,
    slam.cpp:279-299). A window smaller than the presented workload reports
    the overflow; a window that holds everything reports zero."""
    scene = synthetic.build_scene(CFG, n_frames=8, n_points=40)
    s = scene.state
    n_part = int(jnp.sum(slam._obs_ok(s, s.n_frames - 5)))
    assert n_part > 64

    _, res_small = slam.solve_frames(s, 2, 5, 2.0, CFG, window_obs=64)
    assert int(res_small.obs_dropped) == n_part - 64 > 0

    _, res_big = slam.solve_frames(s, 2, 5, 2.0, CFG,
                                   window_obs=CFG.max_obs)
    assert int(res_big.obs_dropped) == 0


def test_free_point_compaction_matches_uncompacted():
    """max_free_points compaction: identical solve when capacity holds all
    free points; graceful const degradation past capacity."""
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=20,
                                  point_noise=100.0)
    s = scene.state
    full, _ = slam.solve_frames(s, 0, 6, 2.0, CFG)
    comp, res = slam.solve_frames(s, 0, 6, 2.0, CFG, max_free_points=32)
    assert bool(res.ok)
    np.testing.assert_allclose(
        np.asarray(comp.point_loc), np.asarray(full.point_loc),
        rtol=1e-4, atol=1e-4,
    )

    # capacity 8 < 20 free points: priority is newest-first, so the LAST
    # 8 points solve and the older 12 stay const
    part, res2 = slam.solve_frames(s, 0, 6, 2.0, CFG, max_free_points=8)
    assert bool(res2.ok)
    moved = np.any(
        np.asarray(part.point_loc) != np.asarray(s.point_loc), axis=1
    )
    assert moved[12:20].all() and not moved[:12].any()


def test_compact_obs_matches_uncompacted():
    # Row compaction (slam._run compact_obs) moves participating rows to
    # the front and truncates; excluded rows have IRLS weight 0, so the
    # solve must match up to fp summation order. Also: deliberate
    # overflow (cap below the active count) is COUNTED, never silent.
    scene = synthetic.build_scene(
        CFG, n_frames=8, n_points=40, pixel_noise=0.2, point_noise=30.0
    )
    s0 = scene.state
    n_active = int(jnp.sum(slam._obs_ok(s0, s0.n_frames - 5)))
    assert n_active > 8
    a, ra = slam.solve_frames(s0, 2, 5, 2.0, CFG)
    b, rb = slam.solve_frames(s0, 2, 5, 2.0, CFG, compact_obs=n_active + 7)
    assert int(rb.obs_dropped) == 0
    # fp summation order changes and the LM ftol/stall exits may fire an
    # iteration apart (measured: 24 vs 22 iters, 3.5e-3 mm max pose diff)
    np.testing.assert_allclose(
        np.asarray(b.frame_trans), np.asarray(a.frame_trans), atol=0.05
    )
    pa, pb = np.asarray(a.point_loc), np.asarray(b.point_loc)
    np.testing.assert_allclose(
        pb[:40, :3] / pb[:40, 3:4], pa[:40, :3] / pa[:40, 3:4], atol=0.5
    )
    assert abs(float(rb.cost) - float(ra.cost)) < 1e-3 * max(float(ra.cost), 1.0)
    # overflow: cap below the active count is surfaced in obs_dropped
    _, res_c = slam.solve_frames(s0, 2, 5, 2.0, CFG, compact_obs=n_active - 5)
    assert int(res_c.obs_dropped) == 5


def test_cg_padded_layout_matches_scatter():
    # the padded gather layout (sort once, gather+reduce per segment sum)
    # must match the scatter layout up to fp summation order, including
    # when segments overflow the per-segment K into the compacted spill
    from slam_robot_tpu.ops import ba_cg
    from slam_robot_tpu.utils import synthetic as syn

    prob = syn.build_large_problem(24, 300, obs_per_frame=40)
    keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
            "point_uncertainty", "obs_frame", "obs_point", "obs_px",
            "obs_ok", "present", "free_frame")
    args = tuple(prob[k] for k in keys)
    base = ba_cg.CGConfig(max_free_frames=24, gn_iters=3, cg_iters=10,
                          precond="diag")
    rs = ba_cg.solve(*args, base)
    # pad_obs_per_point=2 forces heavy spill traffic (avg ~3.2 obs/point)
    for k_p in (8, 2):
        rp = ba_cg.solve(*args, base._replace(
            layout="padded", pad_obs_per_point=k_p, pad_obs_per_frame=64,
            pad_spill=4096))
        assert bool(rp.ok), f"spill overflow at K={k_p}"
        np.testing.assert_allclose(
            np.asarray(rp.frame_trans), np.asarray(rs.frame_trans),
            atol=0.05, err_msg=f"K={k_p}")
        assert abs(float(rp.cost) - float(rs.cost)) < 1e-3 * max(
            float(rs.cost), 1.0)
    # spill overflow is REPORTED, not silent: K=1 with a tiny spill cap
    r_ovf = ba_cg.solve(*args, base._replace(
        layout="padded", pad_obs_per_point=1, pad_spill=16))
    assert not bool(r_ovf.ok)


def test_marquardt_policy_converges():
    """The Ceres gain-ratio damping policy (lm_policy="marquardt",
    slam.cpp:482-521's actual Ceres behavior) must solve the same windows
    to the same quality as the classic fixed-factor policy — typically in
    fewer iterations (the classic policy's reject thrash was ~15 of 20
    iterations on the bench fast window)."""
    import dataclasses

    scene = synthetic.build_scene(CFG, n_frames=6, n_points=30,
                                  pose_noise=0.01, point_noise=50.0)
    cfg_m = dataclasses.replace(CFG, lm_policy="marquardt")
    s1, r1 = slam.solve_frames(scene.state, 4, 6, 2.0, CFG)
    s2, r2 = slam.solve_frames(scene.state, 4, 6, 2.0, cfg_m)
    assert bool(r1.ok) and bool(r2.ok)
    e1, e2 = reproj_err(s1), reproj_err(s2)
    assert e2 < max(0.1, 1.5 * e1), (e1, e2)
    # both fully converge on this well-conditioned problem
    assert e2 < 0.1
