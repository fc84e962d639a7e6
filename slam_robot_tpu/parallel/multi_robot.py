"""Multi-robot shared mapping (BASELINE config 5).

R robots each own a trajectory (frames + observations) into ONE shared
landmark table. Joint BA over all robots couples their frames only through
shared points, so a block-coordinate scheme scales cleanly:

  (a) point solve: accumulate landmark normal equations across robots
      (psum over the 'data' axis when robots are sharded) and update the
      shared points in closed form
  (b) frame solve: per-robot windowed BA with points held const — fully
      independent, vmapped/sharded over robots

Alternating (a)/(b) is Gauss-Seidel on the joint problem; for the
workloads here a few sweeps reach the same fixed point as joint LM while
keeping per-device memory flat in R.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from slam_robot_tpu.ops import ba, projection as proj, quaternion as quat

# full f32 for geometry: a reduced-precision default (TF32 on the GPU)
# would quantize residuals and Jacobians
_HI = jax.lax.Precision.HIGHEST


def _point_normal_eqs(frame_quat, frame_trans, frame_cam, cam_k, point_loc,
                      obs_frame, obs_point, obs_px, obs_ok, c: float,
                      cheirality_eps: float = 0.001):
    """Per-robot landmark-block accumulation: C[P,4,4], b[P,4]."""
    P_ = point_loc.shape[0]
    f = obs_frame.clip(0)
    p = obs_point.clip(0)
    q = frame_quat[f]
    t = frame_trans[f]
    k = cam_k[frame_cam[f]]

    def res(loc, q, t, k, px):
        r, valid = proj.reprojection_error(q, t, k, loc, px, cheirality_eps)
        return r, valid

    r, valid = jax.vmap(res)(point_loc[p], q, t, k, obs_px)
    use = obs_ok & valid & jnp.all(jnp.isfinite(r), axis=-1)
    w = jnp.where(use, 1.0 / (1.0 + jnp.sum(r * r, -1) / (c * c)), 0.0)

    jp = jax.vmap(jax.jacfwd(lambda loc, q, t, k, px: res(loc, q, t, k, px)[0]))(
        point_loc[p], q, t, k, obs_px
    )
    # xyz columns only: the homogeneous scale direction is gauge (the
    # closed-form step has no LM accept/reject to contain it)
    jp = jp[..., :3] * use[:, None, None]
    C = jnp.zeros((P_, 3, 3)).at[p].add(
        jnp.einsum("oia,oib,o->oab", jp, jp, w, precision=_HI), mode="drop")
    b = jnp.zeros((P_, 3)).at[p].add(
        -jnp.einsum("oia,oi->oa", jp,
                    w[:, None] * jnp.where(use[:, None], r, 0.0),
                    precision=_HI),
        mode="drop")
    return C, b


@functools.partial(jax.jit, static_argnames=("sweeps", "cfg"))
def solve_shared_map(
    frame_quat,      # [R,F,4] per-robot
    frame_trans,     # [R,F,3]
    frame_cam,       # [R,F]
    cam_k,           # [C,7] shared cameras
    point_loc,       # [P,4] SHARED landmarks
    point_uncertainty,  # [P]
    obs_frame,       # [R,O]
    obs_point,       # [R,O] indices into the shared table
    obs_px,          # [R,O,2]
    obs_ok,          # [R,O]
    present,         # [R,F]
    free_frame,      # [R,F]
    cfg: ba.BAConfig = ba.BAConfig(),
    sweeps: int = 3,
):
    """Alternating multi-robot BA. Returns (frame_quat, frame_trans,
    point_loc) updated."""

    def one_sweep(carry, _):
        fq, ft, locs = carry

        # (a) shared point solve: accumulate across robots
        C, b = jax.vmap(
            lambda q, t, c_, of, op, px, ok: _point_normal_eqs(
                q, t, c_, cam_k, locs, of, op, px, ok, cfg.range,
                cfg.cheirality_eps)
        )(fq, ft, frame_cam, obs_frame, obs_point, obs_px, obs_ok)
        C = jnp.sum(C, axis=0)
        b = jnp.sum(b, axis=0)
        damp = 1e-3 * jnp.eye(3) * jnp.maximum(
            jnp.einsum("pii->p", C)[:, None, None] / 3.0, 1e-6
        ) + 1e-8 * jnp.eye(3)
        seen = jnp.einsum("pii->p", C) > 0
        dp = jnp.einsum("pab,pb->pa", jnp.linalg.inv(C + damp), b,
                        precision=_HI)
        locs = locs.at[:, :3].add(jnp.where(seen[:, None], dp, 0.0))

        # (b) per-robot frame solve with points const (uncertainty tiny
        # keeps them out of the free set)
        tiny_unc = jnp.zeros_like(point_uncertainty)

        def per_robot(q, t, c_, of, op, px, ok, pres, free):
            res = ba.solve(q, t, c_, cam_k, locs, tiny_unc,
                           of, op, px, ok, pres, free, cfg)
            return res.frame_quat, res.frame_trans

        fq, ft = jax.vmap(per_robot)(
            fq, ft, frame_cam, obs_frame, obs_point, obs_px, obs_ok,
            present, free_frame,
        )
        return (fq, ft, locs), None

    (fq, ft, locs), _ = jax.lax.scan(
        one_sweep, (frame_quat, frame_trans, point_loc), None, length=sweeps
    )
    return fq, ft, locs
