"""Bundle-adjustment windows over the map (slam.{h,cpp} rebuilt).

- ``solve_frames(map, S, P)``: sliding window — newest S frames free, next
  P-S presented-but-const (slam.cpp:417-443); cameras always const
- ``solve_all_frames``: every frame free; optionally solve camera
  intrinsics with the CameraStabilization regularizer (slam.cpp:447-480)
- ``reproject`` lives on the map (models/localmap.reproject)
- ``solve_frame_pose``: the reference's 2-frame epipolar pose solver is
  dead code (unconditional ``return false`` at slam.cpp:182 before any
  work); we expose the same no-op contract by default and keep the
  intended behavior available through full BA windows instead

Cumulative iteration/error counters (slam.h:48-49) are returned in the
result for the caller's metrics instead of hidden mutable state.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.ops import ba
from slam_robot_tpu.ops import epipolar as epi_mod
from slam_robot_tpu.ops import projection as proj_mod
from slam_robot_tpu.ops import quaternion as quat


def _ba_cfg(cfg: SlamConfig, range_: float, solve_cameras: bool = False,
            fine: bool = False) -> ba.BAConfig:
    return ba.BAConfig(
        range=range_,
        max_iters=cfg.ba_max_iters,
        ftol=cfg.ba_ftol_fine if fine else cfg.ba_ftol,
        baseline=cfg.baseline_mm,
        frame_dist_weight=cfg.frame_dist_weight,
        frame_dist_loss=cfg.frame_dist_loss,
        uncertainty_free=cfg.uncertainty_confident,
        lm_lambda_init=cfg.lm_lambda_init,
        lm_lambda_up=cfg.lm_lambda_up,
        lm_lambda_down=cfg.lm_lambda_down,
        lm_lambda_min=cfg.lm_lambda_min,
        lm_policy=cfg.lm_policy,
        max_free_frames=16,
        cheirality_eps=cfg.cheirality_eps,
        solve_cameras=solve_cameras,
        camera_loss=cfg.camera_loss,
        stab_focal=cfg.focal,
        stab_cx=cfg.cx,
        stab_cy=cfg.cy,
    )


def window_masks(state: lm.MapState, num_to_solve: int, num_to_present: int):
    """Newest ``num_to_solve`` frames free, next presented const
    (slam.cpp:425-434)."""
    idx = jnp.arange(state.frame_quat.shape[0])
    age = state.n_frames - 1 - idx
    free = (age >= 0) & (age < num_to_solve)
    present = (age >= 0) & (age < num_to_present)
    return free, present


def _obs_ok(state: lm.MapState, present_lo):
    """Participating observations: enabled, of slam-usable points, in a
    presented frame (slam.cpp:279-299).

    Presented frames are the contiguous slot range [present_lo, n_frames)
    (frame slots are assigned sequentially, never ringed), so the per-row
    frame test is a vector compare. The previous ``present[obs_frame]``
    form was a serialized element gather over the whole obs table."""
    usable = lm.slam_usable(state.point_flags)
    return (
        state.obs_mask
        & ~state.obs_disabled
        & usable[state.obs_point.clip(0)]
        & (state.obs_frame >= present_lo)
        & (state.obs_frame < state.n_frames)
        & (state.obs_point >= 0)
    )


def _run(state: lm.MapState, free, present, present_lo,
         bcfg: ba.BAConfig, window_obs: int | None = None,
         compact_obs: int | None = None):
    obs_frame, obs_point, obs_px = state.obs_frame, state.obs_point, state.obs_px
    obs_ok = _obs_ok(state, present_lo)
    obs_dropped = jnp.int32(0)
    if window_obs is not None and window_obs < state.obs_frame.shape[0]:
        # The obs table is append-ordered by frame, so every observation of
        # the presented (= newest) frames lives in the table's tail. Slice a
        # fixed-size tail window: same solution, a fraction of the per-LM-
        # iteration residual/Jacobian work — PROVIDED the window holds every
        # participating row. The reference includes every enabled obs of
        # presented frames (slam.cpp:279-299), so count what the slice
        # excludes and surface it (no silent truncation).
        start = jnp.maximum(state.n_obs - window_obs, 0)
        head = jnp.arange(obs_ok.shape[0]) < start
        obs_dropped = jnp.sum((obs_ok & head).astype(jnp.int32))
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, window_obs, 0)
        obs_frame, obs_point, obs_px, obs_ok = (
            sl(obs_frame), sl(obs_point), sl(obs_px), sl(obs_ok),
        )
    if compact_obs is not None and 0 < compact_obs < obs_ok.shape[0]:
        # Participating rows first (one stable [W] argsort per solve), then
        # truncate: every LM iteration's residual/jacfwd/one-hot-assembly
        # work bills compact_obs rows instead of the whole window, and the
        # masked-out rows it used to bill contributed exactly zero (their
        # IRLS weight is 0), so this is semantics-preserving up to fp
        # summation order. Overflow (ok rows beyond the cap) is counted
        # into obs_dropped like the tail slice's.
        # The four fields ride ONE packed gather (XLA rematerializes the
        # gathered rows inside the LM while_loop, so four separate [512]
        # gathers would each run per iteration; int/bool values
        # round-trip f32 exactly at these magnitudes).
        order = jnp.argsort(~obs_ok)
        keep = order[:compact_obs]
        n_ok = jnp.sum(obs_ok.astype(jnp.int32))
        obs_dropped = obs_dropped + jnp.maximum(n_ok - compact_obs, 0)
        packed = jnp.concatenate(
            [
                obs_frame.astype(jnp.float32)[:, None],
                obs_point.astype(jnp.float32)[:, None],
                obs_px,
                obs_ok.astype(jnp.float32)[:, None],
            ],
            axis=-1,
        )[keep]
        obs_frame = packed[:, 0].astype(jnp.int32)
        obs_point = packed[:, 1].astype(jnp.int32)
        obs_px = packed[:, 2:4]
        obs_ok = packed[:, 4] > 0.5
    res = ba.solve(
        state.frame_quat,
        state.frame_trans,
        state.frame_cam,
        state.cam_k,
        state.point_loc,
        state.point_uncertainty,
        obs_frame,
        obs_point,
        obs_px,
        obs_ok,
        present,
        free,
        bcfg,
    )
    new_state = state._replace(
        frame_quat=res.frame_quat,
        frame_trans=res.frame_trans,
        point_loc=res.point_loc,
        cam_k=res.cam_k,
    )
    return new_state, res._replace(obs_dropped=obs_dropped)


def solve_frames(state: lm.MapState, num_to_solve: int, num_to_present: int,
                 range_: float = 2.0, cfg: SlamConfig | None = None,
                 max_iters: int | None = None, window_obs: int | None = None,
                 max_free_points: int | None = None,
                 compact_obs: int | None = None):
    """Slam::SolveFrames: solve the newest ``num_to_solve`` frame poses (and
    the points they see) against ``num_to_present`` presented frames.
    Returns (state, BAResult)."""
    cfg = cfg or SlamConfig()
    free, present = window_masks(state, num_to_solve, num_to_present)
    bcfg = _ba_cfg(cfg, range_)
    # size the reduced system to THIS window: at most num_to_solve frames
    # can be free, and every per-LM-iteration assembly tensor carries a W
    # axis ([P,W,6,4] coupling blocks, W*6 reduced LU). The fast (2,5)
    # window at W=16 would materialize 8x more coupling than exists;
    # W=2 shrinks it proportionally.
    bcfg = bcfg._replace(
        # at least one slot: point-only solves (num_to_solve=0) still need
        # a well-formed (all-masked) reduced frame system. Sized to the
        # window exactly — undersizing would silently demote free frames
        # to const (ba.py slot overflow guard), which the polish pass
        # (num_to_solve > 16) must not hit
        max_free_frames=max(1, int(num_to_solve))
    )
    if max_free_points is not None:
        bcfg = bcfg._replace(max_free_points=int(max_free_points))
    if max_iters is not None:
        bcfg = bcfg._replace(max_iters=max_iters)
    return _run(state, free, present, state.n_frames - num_to_present, bcfg,
                window_obs=cfg.window_obs if window_obs is None else window_obs,
                compact_obs=compact_obs)


def solve_all_frames(state: lm.MapState, range_: float = 2.0,
                     solve_cameras: bool = False,
                     cfg: SlamConfig | None = None):
    """Slam::SolveAllFrames: every frame free; optionally also the camera
    intrinsics (with stabilization residuals)."""
    cfg = cfg or SlamConfig()
    present = state.frame_mask
    free = present
    bcfg = _ba_cfg(cfg, range_, solve_cameras=solve_cameras, fine=solve_cameras)
    # full solves need slots for every frame
    bcfg = bcfg._replace(max_free_frames=int(state.frame_quat.shape[0]))
    return _run(state, free, present, 0, bcfg)


def solve_frame_pose(state: lm.MapState, *_args, **_kw):
    """Slam::SolveFramePose parity: the reference short-circuits to false
    (slam.cpp:177-182), so the matcher's mid-frame re-solve never fires.
    Kept as an explicit no-op for API parity; the *intended* behavior is
    implemented in :func:`solve_frame_pose_epipolar`."""
    return state, False


def solve_frame_pose_epipolar(state: lm.MapState, cfg: SlamConfig | None = None,
                              iters: int = 20, min_count: int = 8,
                              max_pairs: int = 256):
    """The intended Slam::SolveFramePose (slam.cpp:177-248): re-solve the
    newest frame's pose against its predecessor from epipolar constraints
    alone.

    Parameters: the relative rotation q_rel = q2 q1^-1 on its 3-dof tangent
    and the unit translation direction with the reference's 2-dof
    parameterization r = normalize([x+d0, y-d0-d1, z+d1])
    (UnitVectorParameterization, slam.cpp:162-174). Residual per shared
    point: h2^T skew(t) R h1 in undistorted plane coordinates with
    CauchyLoss(0.01) (slam.cpp:128-158, 188). Fewer than ``min_count``
    shared points aborts (slam.cpp:222-225). On success the new pose is
    q2 = q_rel q1, t2 = t1 - t_dir * |t1 - t2| (slam.cpp:244-245).

    Returns (state, ok).
    """
    cfg = cfg or SlamConfig()
    f2 = jnp.maximum(state.n_frames - 1, 0)
    f1 = jnp.maximum(state.n_frames - 2, 0)

    # shared points: ring positions of observations in f1 and f2
    P = state.point_loc.shape[0]
    frames = state.ring_frame            # mirror: no gather
    pxs, ok_ring, _rows = lm._ring_gather(state, state.obs_px)

    def pick(fid):
        m = ok_ring & (frames == fid)
        j = jnp.argmax(m, axis=1)
        has = jnp.any(m, axis=1)
        px = jnp.take_along_axis(pxs, j[:, None, None], axis=1)[:, 0]
        return px, has

    px1, has1 = pick(f1)
    px2, has2 = pick(f2)
    pair_ok = has1 & has2 & state.point_mask
    count = jnp.sum(pair_ok.astype(jnp.int32))

    k1 = state.cam_k[state.frame_cam[f1]]
    k2 = state.cam_k[state.frame_cam[f2]]
    h1 = proj_mod.pixel_to_plane(px1, k1)
    h2 = proj_mod.pixel_to_plane(px2, k2)
    h1h = jnp.concatenate([h1, jnp.ones((P, 1))], axis=1)
    h2h = jnp.concatenate([h2, jnp.ones((P, 1))], axis=1)
    w_pair = pair_ok.astype(jnp.float32)

    q1 = state.frame_quat[f1]
    t1 = state.frame_trans[f1]
    q2 = state.frame_quat[f2]
    t2 = state.frame_trans[f2]
    q_rel0 = quat.normalize(quat.multiply(q2, quat.conjugate(q1)))
    tvec = t1 - t2
    length = jnp.linalg.norm(tvec)
    t_dir0 = tvec / jnp.maximum(length, 1e-9)

    c = 0.01  # CauchyLoss(0.01), slam.cpp:188

    def residuals(xi, dd, q_rel, t_dir):
        q = quat.retract(q_rel, xi)
        t = t_dir + jnp.stack([dd[0], -dd[0] - dd[1], dd[1]])
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        e = jnp.matmul(epi_mod.skew(t), quat.to_matrix(q),
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.einsum("pi,ij,pj->p", h2h, e, h1h,
                          precision=jax.lax.Precision.HIGHEST)

    def gn_step(carry, _):
        q_rel, t_dir = carry
        z3 = jnp.zeros(3)
        z2 = jnp.zeros(2)
        r = residuals(z3, z2, q_rel, t_dir)
        jxi = jax.jacfwd(residuals, argnums=0)(z3, z2, q_rel, t_dir)
        jdd = jax.jacfwd(residuals, argnums=1)(z3, z2, q_rel, t_dir)
        j = jnp.concatenate([jxi, jdd], axis=1)  # [P,5]
        wr = w_pair / (1.0 + (r * r) / (c * c))
        H = jnp.einsum("pa,pb,p->ab", j, j, wr,
                       precision=jax.lax.Precision.HIGHEST) + 1e-8 * jnp.eye(5)
        g = jnp.einsum("pa,p,p->a", j, wr, r,
                       precision=jax.lax.Precision.HIGHEST)
        d = -jnp.linalg.solve(H, g)
        q_rel = quat.retract(q_rel, d[:3])
        t = t_dir + jnp.stack([d[3], -d[3] - d[4], d[4]])
        t_dir = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        return (q_rel, t_dir), None

    (q_rel, t_dir), _ = jax.lax.scan(gn_step, (q_rel0, t_dir0), None, length=iters)

    ok = (count >= min_count) & (state.n_frames >= 2)
    new_q2 = quat.normalize(quat.multiply(q_rel, q1))
    new_t2 = t1 - t_dir * length
    state = state._replace(
        frame_quat=jnp.where(ok, state.frame_quat.at[f2].set(new_q2), state.frame_quat),
        frame_trans=jnp.where(ok, state.frame_trans.at[f2].set(new_t2), state.frame_trans),
    )
    return state, ok
