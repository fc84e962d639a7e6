"""Large-scale bundle adjustment: implicit Schur complement + CG.

The dense solver (ops/ba.py) materializes the frame-point coupling blocks
A[P, W, 6, 4] — perfect for windows, impossible at 500k landmarks. This is
the scalable path, the analog of the reference's ITERATIVE_SCHUR +
SCHUR_JACOBI configuration (slam.cpp:488-490):

- the reduced camera system S = B - E C^-1 E^T is never formed; CG only
  needs S@x, and every term of that matvec is a gather/segment-sum over the
  observation table:
      t1 = Jf x            (per obs, gather by frame slot)
      u  = seg_p Jp^T w t1 (segment-sum into [P,4])
      v  = C^-1 u          (batched closed-form 4x4)
      y  = seg_slot Jf^T w Jp v   (segment-sum into [W,6])
  Peak memory is O(P*16 + O*...), independent of W*P.
- block-Jacobi preconditioner = inverses of the damped 6x6 frame blocks
  (SCHUR_JACOBI's diagonal).
- Gauss-Newton outer loop with fixed Levenberg damping (large maps are
  solved from good initializations — incremental mapping — so the full LM
  accept/reject machinery of the window solver isn't repeated here).
- obs arrays may be sharded across devices: :func:`solve_sharded` runs the
  SAME solver under shard_map with the 1M-row observation tables (and
  their per-shard gather plans) split over a mesh axis — every obs-derived
  reduction (the [P,4] landmark sums and the reduced [W,6] camera system)
  psums over the mesh axis, which is exactly the "shard keyframes/landmarks across
  devices, all-reduce the Schur-reduced camera system" scale-out of
  SURVEY §5. The matvec streams the obs tables (bandwidth-bound by
  hypothesis, PERF.md), i.e. the per-device stream shrinks 1/D while the
  psums are small ([P,4] + [W,6] per matvec) — the one workload more
  chips genuinely lift.

Same problem semantics as ops/ba.solve (free/const frames and points,
Cauchy IRLS, cheirality masking). Frame-distance priors are supported on
the block diagonal (their off-diagonal coupling is second-order for large
maps and omitted — documented deviation).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from slam_robot_tpu.ops import projection as proj
from slam_robot_tpu.ops import quaternion as quat
from slam_robot_tpu.ops.ba import (
    TERM_MAX_ITERS,
    TERM_NOT_RUN,
    BAResult,
    _cauchy_rho,
    _cauchy_weight,
    inv4x4,
)

_HI = lax.Precision.HIGHEST


def _padded_plan(seg_id, n_segments, K, spill_cap):
    """Gather plan for segment sums into ``[n_segments, D]``.

    seg_id   [O] int32 segment of each obs row; ids >= n_segments are
             dropped from the plan entirely (their values are never read).
    Returns (pad_idx [n_segments, K] row indices with O as the zero-pad
    sentinel, spill_rows [S], spill_seg [S], spill_exceeded bool). Rows
    ranked past K within their segment go to the compacted spill (exact);
    only spill overflow beyond spill_cap loses rows, which the caller
    surfaces via the returned flag.

    Built ONCE per solve (two [O] argsorts + one searchsorted); afterwards
    every segment sum is a row gather + K-tree reduce — the measured-fast
    pattern on this hardware (PERF.md gather economics) — instead of an
    O-row scatter-add.
    """
    O = seg_id.shape[0]
    order = jnp.argsort(seg_id)
    sidx = seg_id[order]
    first = jnp.searchsorted(sidx, sidx, side="left")
    rank = jnp.arange(O) - first
    valid = sidx < n_segments
    in_pad = valid & (rank < K)

    pad_idx = jnp.full((n_segments, K), O, jnp.int32)
    pad_idx = pad_idx.at[
        jnp.where(in_pad, sidx, n_segments),
        jnp.where(in_pad, rank, 0),
    ].set(jnp.where(in_pad, order, O).astype(jnp.int32), mode="drop")

    spill = valid & (rank >= K)
    sp_sel = jnp.argsort(~spill)[:spill_cap]
    sp_is = spill[sp_sel]
    spill_rows = jnp.where(sp_is, order[sp_sel], O).astype(jnp.int32)
    spill_seg = jnp.where(sp_is, sidx[sp_sel], n_segments).astype(jnp.int32)
    exceeded = jnp.sum(spill.astype(jnp.int32)) > spill_cap
    return pad_idx, spill_rows, spill_seg, exceeded


def _padded_seg_sum(vals, pad_idx, spill_rows, spill_seg):
    """Sum ``vals`` rows per segment via the :func:`_padded_plan` tables.
    vals [O, D] -> [n_segments, D]; a zero row is appended so the O
    sentinel contributes nothing."""
    D = vals.shape[-1]
    vz = jnp.concatenate([vals, jnp.zeros((1, D), vals.dtype)])
    out = jnp.sum(vz[pad_idx], axis=1)
    return out.at[spill_seg].add(vz[spill_rows], mode="drop")


class CGConfig(NamedTuple):
    range: float = 2.0
    gn_iters: int = 8             # outer Gauss-Newton steps
    cg_iters: int = 30            # inner CG iterations
    damping: float = 1e-4         # Levenberg diagonal scaling
    baseline: float = 150.0
    frame_dist_weight: float = 0.1
    frame_dist_loss: float = 15.0
    uncertainty_free: float = 100.0
    max_free_frames: int = 64     # frame slots in the reduced system
    cheirality_eps: float = 0.001
    precond: str = "block"        # "block" (6x6 inverses) | "diag" (for
                                  # 10k-frame systems where batched LU hurts)
    layout: str = "padded"        # "scatter": segment sums as .at[].add
                                  # over the obs table (O(1M)-row
                                  # scatter-adds, ~45 of them per GN
                                  # iteration incl. the CG matvecs) |
                                  # "padded": one-time sort of the obs
                                  # table by point and by frame slot into
                                  # [N, K] padded index tables, after
                                  # which every segment sum is a row
                                  # GATHER + tree reduce over K (the
                                  # fast-by-measurement pattern, PERF.md
                                  # gather economics). Rows past K per
                                  # segment spill to a small compacted
                                  # scatter so results stay EXACT.
                                  # Default because it measured faster
                                  # than scatter at 10k kf / 500k lm /
                                  # 1M obs (tools/profile_cg.py) on the
                                  # accelerator this was first built
                                  # for; re-decide on the GPU (ROADMAP
                                  # A8).
    pad_obs_per_point: int = 8    # K for the point-side padded table
    pad_obs_per_frame: int = 128  # K for the frame-slot-side padded table
    pad_spill: int = 4096         # compacted spill capacity (rows beyond
                                  # K of their segment); overflow beyond
                                  # THIS falls back row-exact via a full
                                  # scatter of the spill mask


def _solve_impl(
    frame_quat, frame_trans, frame_cam, cam_k,
    point_loc, point_uncertainty,
    obs_frame, obs_point, obs_px, obs_ok,
    present, free_frame,
    cfg: CGConfig, axis_name: str | None,
) -> BAResult:
    """Solver body. With ``axis_name`` set (inside shard_map), the obs
    arrays are per-device SHARDS and every obs-derived reduction psums
    over the named axis; frame/point arrays are replicated, so all [W,*]
    and [P,*] state stays replicated and the CG runs identically on every
    device."""
    F = frame_quat.shape[0]
    P = point_loc.shape[0]
    O = obs_frame.shape[0]
    W = cfg.max_free_frames

    if axis_name is None:
        def allsum(x):
            return x
    else:
        def allsum(x):
            return lax.psum(x, axis_name)

    f_idx = obs_frame.clip(0)
    p_idx = obs_point.clip(0)
    c_idx = frame_cam[f_idx]

    frame_has_obs = allsum(
        jnp.zeros(F, jnp.int32).at[jnp.where(obs_ok, f_idx, F)].add(1, mode="drop")
    ) > 0
    n_used = jnp.sum((present & frame_has_obs).astype(jnp.int32))
    solvable = n_used >= 2
    free_f = free_frame & frame_has_obs & solvable

    point_in = allsum(
        jnp.zeros(P, jnp.int32).at[jnp.where(obs_ok, p_idx, P)].add(1, mode="drop")
    ) > 0
    fluid = allsum(
        jnp.zeros(P, jnp.int32)
        .at[jnp.where(obs_ok & free_f[f_idx], p_idx, P)]
        .add(1, mode="drop")
    ) > 0
    free_p = point_in & (fluid | (point_uncertainty > cfg.uncertainty_free)) & solvable

    slot_of = jnp.where(free_f, jnp.cumsum(free_f) - 1, W).astype(jnp.int32)
    slot_of = jnp.minimum(slot_of, W)
    obs_slot = slot_of[f_idx]

    prev_present = jnp.roll(present, 1).at[0].set(False)
    prior_f = free_f & prev_present & (jnp.arange(F) >= 1)

    # segment-sum backends for the O -> [P,*] and O -> [W,*] reductions
    # (the assembly sums once per GN iteration and the TWO inside every CG
    # matvec — the hot path). "scatter" is the naive .at[].add; "padded"
    # pre-sorts the obs table once and turns every reduction into a row
    # gather + K-tree reduce (see _padded_plan).
    if cfg.layout == "padded":
        plan_p = _padded_plan(
            jnp.where(obs_ok, p_idx, P).astype(jnp.int32), P,
            cfg.pad_obs_per_point, cfg.pad_spill)
        plan_f = _padded_plan(
            jnp.where(obs_ok & (obs_slot < W), obs_slot, W).astype(jnp.int32),
            W, cfg.pad_obs_per_frame, cfg.pad_spill)
        spill_ok = allsum(
            (plan_p[3] | plan_f[3]).astype(jnp.int32)) == 0

        def seg_p(vals):  # [O, D] -> [P, D]
            return _padded_seg_sum(vals, plan_p[0], plan_p[1], plan_p[2])

        def seg_f(vals):  # [O, D] -> [W, D]
            return _padded_seg_sum(vals, plan_f[0], plan_f[1], plan_f[2])
    else:
        spill_ok = jnp.bool_(True)

        def seg_p(vals):
            return jnp.zeros((P, vals.shape[-1]), vals.dtype).at[p_idx].add(
                vals, mode="drop")

        def seg_f(vals):
            return jnp.zeros(
                (W + 1, vals.shape[-1]), vals.dtype
            ).at[obs_slot].add(vals, mode="drop")[:W]

    def residuals(fq, ft, locs):
        def one(q, t, k, loc, px):
            return proj.reprojection_error(q, t, k, loc, px, cfg.cheirality_eps)

        r, valid = jax.vmap(one)(fq[f_idx], ft[f_idx], cam_k[c_idx],
                                 locs[p_idx], obs_px)
        use = obs_ok & valid & jnp.all(jnp.isfinite(r), axis=-1)
        return jnp.where(use[:, None], r, 0.0), use

    def gn_step(carry, _):
        fq, ft, locs = carry

        def res_params(xi, t, p, q0, px, k):
            qq = quat.retract(q0, xi)
            r, _ = proj.reprojection_error(qq, t, k, p, px, cfg.cheirality_eps)
            return r

        r, use = residuals(fq, ft, locs)
        s = jnp.sum(r * r, axis=-1)
        w = jnp.where(use, _cauchy_weight(s, cfg.range), 0.0)

        zero3 = jnp.zeros(3)
        jxi, jt, jp = jax.vmap(jax.jacfwd(res_params, argnums=(0, 1, 2)))(
            jnp.tile(zero3, (O, 1)), ft[f_idx], locs[p_idx], fq[f_idx],
            obs_px, cam_k[c_idx],
        )
        jf = jnp.concatenate([jxi, jt], axis=-1)
        jf = jf * (use & (obs_slot < W))[:, None, None]
        jp = jp * (use & free_p[p_idx])[:, None, None]
        wr = w[:, None] * r

        # landmark blocks + gradient (psum'd across obs shards BEFORE the
        # replicated prior/damping terms are added once per device)
        Cp = allsum(seg_p(
            jnp.einsum("oia,oib,o->oab", jp, jp, w,
                       precision=_HI).reshape(O, 16))).reshape(P, 4, 4)
        bp = allsum(seg_p(-jnp.einsum("oia,oi->oa", jp, wr, precision=_HI)))
        Hff = allsum(seg_f(
            jnp.einsum("oia,oib,o->oab", jf, jf, w,
                       precision=_HI).reshape(O, 36))).reshape(W, 6, 6)
        bf = allsum(seg_f(-jnp.einsum("oia,oi->oa", jf, wr, precision=_HI)))

        # frame-distance prior: diagonal contributions
        tprev = jnp.roll(ft, 1, axis=0)
        dvec = ft - tprev
        dnorm = jnp.linalg.norm(dvec, axis=-1)
        dhat = dvec / jnp.maximum(dnorm, 1e-9)[:, None]
        rp = cfg.frame_dist_weight * (dnorm - cfg.baseline)
        wp = jnp.where(prior_f, _cauchy_weight(rp * rp, cfg.frame_dist_loss), 0.0)
        jp_t = cfg.frame_dist_weight * dhat
        blk = jnp.einsum("fa,fb,f->fab", jp_t, jp_t, wp, precision=_HI)
        Hff = Hff.at[slot_of, 3:, 3:].add(
            jnp.where(prior_f[:, None, None], blk, 0.0), mode="drop")
        bf = bf.at[slot_of, 3:].add(
            jnp.where(prior_f[:, None], -(wp * rp)[:, None] * jp_t, 0.0), mode="drop")

        # damping
        lam = cfg.damping
        Hff_d = Hff + lam * jnp.eye(6) * jnp.maximum(
            jnp.einsum("fii->f", Hff)[:, None, None] / 6.0, 1e-6) + 1e-8 * jnp.eye(6)
        Cd = Cp + lam * jnp.eye(4) * jnp.maximum(
            jnp.einsum("pii->p", Cp)[:, None, None] / 4.0, 1e-6) + 1e-8 * jnp.eye(4)
        Cinv = jnp.where(free_p[:, None, None], inv4x4(Cd), 0.0)

        slot_active = jnp.arange(W) < jnp.sum(free_f)

        def schur_matvec(x):  # x: [W, 6] (replicated)
            xg = jnp.concatenate([x, jnp.zeros((1, 6))])[obs_slot]  # [O,6]
            t1 = jnp.einsum("oia,oa->oi", jf, xg, precision=_HI)
            u = allsum(
                seg_p(jnp.einsum("oia,oi,o->oa", jp, t1, w, precision=_HI)))
            v = jnp.einsum("pab,pb->pa", Cinv, u, precision=_HI)
            t2 = jnp.einsum("oia,oa->oi", jp, v[p_idx], precision=_HI)
            y = allsum(
                seg_f(jnp.einsum("oia,oi,o->oa", jf, t2, w, precision=_HI)))
            bx = jnp.einsum("wab,wb->wa", Hff_d, x, precision=_HI)
            return jnp.where(slot_active[:, None], bx - y, x)

        # rhs = bf - E C^-1 bp
        v0 = jnp.einsum("pab,pb->pa", Cinv, bp, precision=_HI)
        t2 = jnp.einsum("oia,oa->oi", jp, v0[p_idx], precision=_HI)
        e_cb = allsum(
            seg_f(jnp.einsum("oia,oi,o->oa", jf, t2, w, precision=_HI)))
        rhs = jnp.where(slot_active[:, None], bf - e_cb, 0.0)

        # Jacobi preconditioner (SCHUR_JACOBI)
        if cfg.precond == "block":
            Minv = jnp.where(
                slot_active[:, None, None], jnp.linalg.inv(Hff_d), jnp.eye(6)
            )

            def precond(z):
                return jnp.einsum("wab,wb->wa", Minv, z, precision=_HI)
        else:
            dinv = 1.0 / jnp.maximum(
                jnp.diagonal(Hff_d, axis1=1, axis2=2), 1e-12
            )

            def precond(z):
                return z * dinv

        def cg_body(k, st):
            x, rr, z, pdir, rz = st
            Ap = schur_matvec(pdir)
            alpha = rz / jnp.maximum(jnp.sum(pdir * Ap), 1e-20)
            x = x + alpha * pdir
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = jnp.sum(rr * z)
            beta = rz_new / jnp.maximum(rz, 1e-20)
            pdir = z + beta * pdir
            return (x, rr, z, pdir, rz_new)

        x0 = jnp.zeros((W, 6))
        z0 = precond(rhs)
        st = (x0, rhs, z0, z0, jnp.sum(rhs * z0))
        x, *_ = lax.fori_loop(0, cfg.cg_iters, cg_body, st)

        # back-substitute points
        xg = jnp.concatenate([x, jnp.zeros((1, 6))])[obs_slot]
        t1 = jnp.einsum("oia,oa->oi", jf, xg, precision=_HI)
        u = allsum(
            seg_p(jnp.einsum("oia,oi,o->oa", jp, t1, w, precision=_HI)))
        dp = jnp.einsum("pab,pb->pa", Cinv, bp - u, precision=_HI)
        dp = jnp.where(free_p[:, None], dp, 0.0)

        upd = (free_f & (slot_of < W))[:, None]
        dxi = jnp.where(upd, jnp.concatenate([x, jnp.zeros((1, 6))])[slot_of.clip(0, W), :3], 0.0)
        dt = jnp.where(upd, jnp.concatenate([x, jnp.zeros((1, 6))])[slot_of.clip(0, W), 3:], 0.0)

        fq = jnp.where(upd, jax.vmap(quat.retract)(fq, dxi), fq)
        ft = ft + dt
        locs = locs + dp
        return (fq, ft, locs), None

    r0, use0 = residuals(frame_quat, frame_trans, point_loc)
    s0 = jnp.sum(r0 * r0, axis=-1)
    cost0 = allsum(
        0.5 * jnp.sum(jnp.where(use0, _cauchy_rho(s0, cfg.range), 0.0)))

    (fq, ft, locs), _ = lax.scan(
        gn_step, (frame_quat, frame_trans, point_loc), None, length=cfg.gn_iters
    )

    r, use = residuals(fq, ft, locs)
    s = jnp.sum(r * r, axis=-1)
    cost = allsum(
        0.5 * jnp.sum(jnp.where(use, _cauchy_rho(s, cfg.range), 0.0)))

    return BAResult(
        frame_quat=jnp.where(solvable, fq, frame_quat),
        frame_trans=jnp.where(solvable, ft, frame_trans),
        point_loc=jnp.where(solvable, locs, point_loc),
        cam_k=cam_k,
        # padded layout: ok also reports spill overflow (pad_spill rows
        # beyond the per-segment K exhausted — size pad_* to the workload)
        ok=solvable & spill_ok,
        cost=cost,
        iters=jnp.int32(cfg.gn_iters),
        # fixed-iteration GN: the cap is always the exit reason
        term=jnp.where(solvable, TERM_MAX_ITERS, TERM_NOT_RUN).astype(jnp.int32),
        cost0=cost0,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve(
    frame_quat, frame_trans, frame_cam, cam_k,
    point_loc, point_uncertainty,
    obs_frame, obs_point, obs_px, obs_ok,
    present, free_frame,
    cfg: CGConfig = CGConfig(),
) -> BAResult:
    return _solve_impl(
        frame_quat, frame_trans, frame_cam, cam_k,
        point_loc, point_uncertainty,
        obs_frame, obs_point, obs_px, obs_ok,
        present, free_frame, cfg, None,
    )


def solve_sharded(
    mesh,
    frame_quat, frame_trans, frame_cam, cam_k,
    point_loc, point_uncertainty,
    obs_frame, obs_point, obs_px, obs_ok,
    present, free_frame,
    cfg: CGConfig = CGConfig(),
    obs_axis: str = "model",
) -> BAResult:
    """:func:`solve` with the observation tables sharded over ``obs_axis``
    — the SURVEY §5 large-map scale-out ("shard keyframes across devices
    … all-reduce the Schur-reduced camera system").

    Layout: frame/point parameters replicate (small: 10k frames = 70 KB,
    500k points = 8 MB); the obs tables — the HBM stream that bounds the
    matvec (PERF.md finding 34) — split 1/D per device, and each device
    builds its own per-shard padded gather plan. Per CG matvec the
    collectives are one [P,4] psum (the landmark segment sum; 8 MB at
    500k points) and one [W,6] psum (the reduced camera system); per GN
    iteration one additional assembly psum of the [P,4,4]+[W,6,6] blocks.
    Everything else is replicated compute on [W]/[P]-shaped state.

    Obs arrays are padded host-side with obs_ok=False rows to a multiple
    of the axis size. Results match :func:`solve` up to f32 reduction
    order (the psum splits each segment sum into D partials).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    D = mesh.shape[obs_axis]
    O = obs_frame.shape[0]
    pad = (-O) % D
    if pad:
        obs_frame = jnp.concatenate(
            [obs_frame, jnp.full((pad,), -1, obs_frame.dtype)])
        obs_point = jnp.concatenate(
            [obs_point, jnp.full((pad,), -1, obs_point.dtype)])
        obs_px = jnp.concatenate([obs_px, jnp.zeros((pad, 2), obs_px.dtype)])
        obs_ok = jnp.concatenate([obs_ok, jnp.zeros((pad,), bool)])

    fn = shard_map(
        functools.partial(_solve_impl, cfg=cfg, axis_name=obs_axis),
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(), P(), P(),
            P(obs_axis), P(obs_axis), P(obs_axis), P(obs_axis),
            P(), P(),
        ),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)(
        frame_quat, frame_trans, frame_cam, cam_k,
        point_loc, point_uncertainty,
        obs_frame, obs_point, obs_px, obs_ok,
        present, free_frame,
    )
