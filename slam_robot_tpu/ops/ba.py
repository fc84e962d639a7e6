"""Schur-complement Levenberg-Marquardt bundle adjustment.

Replaces the reference's Ceres solve (slam.cpp:257-521: AutoDiff
ReprojectionError<2,4,3,7,4> blocks with CauchyLoss(range), quaternion local
parameterization, FrameDistance priors, SPARSE_SCHUR + SCHUR_JACOBI,
function_tolerance 1e-7) with a fixed-shape batched solver:

- residuals & Jacobians: one vmapped ``jax.jacfwd`` over the observation
  table; frame rotations are differentiated in the 3-dof tangent space of
  the reference's exp-map retraction, points in raw homogeneous 4-space
  (Ceres gives points no local parameterization either — the scale gauge is
  handled by LM damping)
- robust loss: Cauchy rho(s) = c^2 log(1 + s/c^2) via IRLS weights
  w = rho'(s) = 1/(1 + s/c^2)
- normal equations are never formed densely over points: landmark blocks
  C_p (4x4) are eliminated in a batched Schur complement; the reduced
  camera system is a dense [6*W (+7*C)] matrix assembled with
  one-hot products and one big einsum
- free/const structure reproduces SetupProblem exactly: const frames
  contribute residuals but no columns; points are const unless seen from a
  free frame, except uncertainty > 100 keeps them free (slam.cpp:344-354);
  present frames with no usable observation are skipped, and < 2 usable
  frames aborts the solve (slam.cpp:305-308)
- FrameDistance prior: 0.1 * (||t_f - t_prev|| - 150) under CauchyLoss(15)
  between consecutive solved frames (slam.cpp:383-411)
- optional camera-intrinsics solving with the CameraStabilization
  regularizer (slam.cpp:107-124, 459-471): camera parameters join the
  reduced system as two extra 7-wide column groups

Everything is fixed-shape: the reduced system has capacity
``max_free_frames`` slots; masks do the rest.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from slam_robot_tpu.ops import projection as proj
from slam_robot_tpu.ops import quaternion as quat

_HI = lax.Precision.HIGHEST


class BAConfig(NamedTuple):
    range: float = 2.0            # CauchyLoss scale for reprojection
    max_iters: int = 50
    ftol: float = 1e-7
    xtol: float = 1e-6            # parameter_tolerance analog (Ceres default
                                  # 1e-8 relative; absolute here — mm /
                                  # radians / homogeneous units all sit
                                  # orders of magnitude above 1e-6): a
                                  # proposed damped step this small cannot
                                  # move the f32 state, and on rejection
                                  # lambda only grows (steps shrink), so
                                  # exit instead of counting 5 rejects
    baseline: float = 150.0       # FrameDistance target
    frame_dist_weight: float = 0.1
    frame_dist_loss: float = 15.0
    uncertainty_free: float = 100.0
    lm_lambda_init: float = 1e-4
    lm_lambda_up: float = 4.0
    lm_lambda_down: float = 0.5
    lm_lambda_min: float = 1e-10  # lambda floor. Gain-ratio damping can
                                  # shrink lambda toward zero (near-pure
                                  # Gauss-Newton); in low-parallax
                                  # rotation-dominant regimes those
                                  # confident steps move the weakly-
                                  # observable scale/depth directions
                                  # freely — a floor keeps them damped
    lm_policy: str = "classic"    # "classic": fixed up/down factors per
                                  # reject/accept. "marquardt": Ceres's
                                  # gain-ratio policy (trust_region.cc /
                                  # levenberg_marquardt_strategy.cc — what
                                  # the reference's Ceres solve actually
                                  # runs, slam.cpp:482-521): on accept
                                  # lam *= max(1/3, 1-(2*rho-1)^3) with
                                  # rho = actual/predicted reduction and
                                  # nu reset to 2; on reject lam *= nu,
                                  # nu *= 2. The fixed policy thrashes on
                                  # the bench fast window (~15 of 20
                                  # iterations were rejected steps)
    max_free_frames: int = 16     # reduced-system frame slot capacity
    max_free_points: int = 0      # landmark slot capacity for the per-LM-
                                  # iteration assembly tensors (Cp, bp, A,
                                  # Cinv). 0 = one slot per point row (no
                                  # compaction). A small window touches a
                                  # fraction of the point table, but the
                                  # [P,...] assembly bills all of it every
                                  # iteration; compacting
                                  # free points into PW slots shrinks that
                                  # proportionally. Free points beyond the
                                  # capacity stay CONST for the solve
                                  # (graceful, like frame-slot overflow)
    cheirality_eps: float = 0.001
    solve_cameras: bool = False
    camera_loss: float = 5.0      # CauchyLoss on the stabilization residual
    stab_focal: float = 416.0
    stab_cx: float = 320.0
    stab_cy: float = 240.0


# Termination reasons (the Ceres Brief/FullReport analog, slam.cpp:510-518:
# the reference prints the per-solve report; here the reason is a code the
# caller surfaces in metrics). See BAResult.term.
TERM_NOT_RUN = 0    # solve aborted (< 2 usable frames, slam.cpp:305-308)
TERM_FTOL = 1       # relative cost change below ftol (slam.cpp:493-494)
TERM_XTOL = 2       # damped step too small to move the f32 state
TERM_STALL = 3      # trust region collapsed (5 rejects / lambda cap)
TERM_MAX_ITERS = 4  # iteration cap


class BAResult(NamedTuple):
    frame_quat: jnp.ndarray
    frame_trans: jnp.ndarray
    point_loc: jnp.ndarray
    cam_k: jnp.ndarray
    ok: jnp.ndarray         # solve ran (enough usable frames)
    cost: jnp.ndarray       # final robust cost
    iters: jnp.ndarray      # LM iterations executed
    term: jnp.ndarray       # TERM_* termination-reason code (int32)
    cost0: jnp.ndarray      # robust cost before the solve
    # participating observations excluded by the caller's fixed-size obs
    # window (models/slam._run tail slice). The reference includes EVERY
    # enabled obs of presented frames (slam.cpp:279-299); nonzero here
    # means the window underfits the workload and should be resized.
    # (numpy default, NOT jnp.int32(0): a class-level jnp value initializes
    # the backend at import time — see ops/quaternion.IDENTITY)
    obs_dropped: jnp.ndarray = np.int32(0)


def _cauchy_weight(s, c):
    return 1.0 / (1.0 + s / (c * c))


def inv4x4(m):
    """Batched closed-form 4x4 inverse via the adjugate.

    jnp.linalg.inv lowers to a batched LU; the cofactor expansion is pure
    vectorized elementwise math. m: [..., 4, 4].
    """
    a = m
    # 2x2 sub-determinants of rows 0-1 and rows 2-3 (Laplace on 2x2 blocks)
    s0 = a[..., 0, 0] * a[..., 1, 1] - a[..., 1, 0] * a[..., 0, 1]
    s1 = a[..., 0, 0] * a[..., 1, 2] - a[..., 1, 0] * a[..., 0, 2]
    s2 = a[..., 0, 0] * a[..., 1, 3] - a[..., 1, 0] * a[..., 0, 3]
    s3 = a[..., 0, 1] * a[..., 1, 2] - a[..., 1, 1] * a[..., 0, 2]
    s4 = a[..., 0, 1] * a[..., 1, 3] - a[..., 1, 1] * a[..., 0, 3]
    s5 = a[..., 0, 2] * a[..., 1, 3] - a[..., 1, 2] * a[..., 0, 3]
    c5 = a[..., 2, 2] * a[..., 3, 3] - a[..., 3, 2] * a[..., 2, 3]
    c4 = a[..., 2, 1] * a[..., 3, 3] - a[..., 3, 1] * a[..., 2, 3]
    c3 = a[..., 2, 1] * a[..., 3, 2] - a[..., 3, 1] * a[..., 2, 2]
    c2 = a[..., 2, 0] * a[..., 3, 3] - a[..., 3, 0] * a[..., 2, 3]
    c1 = a[..., 2, 0] * a[..., 3, 2] - a[..., 3, 0] * a[..., 2, 2]
    c0 = a[..., 2, 0] * a[..., 3, 1] - a[..., 3, 0] * a[..., 2, 1]

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    det = jnp.where(jnp.abs(det) > 1e-30, det, jnp.where(det >= 0, 1e-30, -1e-30))
    inv_det = 1.0 / det

    b = jnp.stack([
        a[..., 1, 1] * c5 - a[..., 1, 2] * c4 + a[..., 1, 3] * c3,
        -a[..., 0, 1] * c5 + a[..., 0, 2] * c4 - a[..., 0, 3] * c3,
        a[..., 3, 1] * s5 - a[..., 3, 2] * s4 + a[..., 3, 3] * s3,
        -a[..., 2, 1] * s5 + a[..., 2, 2] * s4 - a[..., 2, 3] * s3,
        -a[..., 1, 0] * c5 + a[..., 1, 2] * c2 - a[..., 1, 3] * c1,
        a[..., 0, 0] * c5 - a[..., 0, 2] * c2 + a[..., 0, 3] * c1,
        -a[..., 3, 0] * s5 + a[..., 3, 2] * s2 - a[..., 3, 3] * s1,
        a[..., 2, 0] * s5 - a[..., 2, 2] * s2 + a[..., 2, 3] * s1,
        a[..., 1, 0] * c4 - a[..., 1, 1] * c2 + a[..., 1, 3] * c0,
        -a[..., 0, 0] * c4 + a[..., 0, 1] * c2 - a[..., 0, 3] * c0,
        a[..., 3, 0] * s4 - a[..., 3, 1] * s2 + a[..., 3, 3] * s0,
        -a[..., 2, 0] * s4 + a[..., 2, 1] * s2 - a[..., 2, 3] * s0,
        -a[..., 1, 0] * c3 + a[..., 1, 1] * c1 - a[..., 1, 2] * c0,
        a[..., 0, 0] * c3 - a[..., 0, 1] * c1 + a[..., 0, 2] * c0,
        -a[..., 3, 0] * s3 + a[..., 3, 1] * s1 - a[..., 3, 2] * s0,
        a[..., 2, 0] * s3 - a[..., 2, 1] * s1 + a[..., 2, 2] * s0,
    ], axis=-1).reshape(m.shape)
    return b * inv_det[..., None, None]


def _cauchy_rho(s, c):
    return c * c * jnp.log1p(s / (c * c))


def _stab_residual(k, cfg: BAConfig):
    """CameraStabilization (slam.cpp:107-124), constants lifted to config."""
    return jnp.stack([
        1000.0 * k[0] * k[0],
        1000.0 * k[1] * k[1],
        1000.0 * k[2] * k[2],
        0.1 * (k[3] - cfg.stab_focal) ** 2,
        0.1 * (k[4] + k[3]) ** 2,
        0.01 * (k[5] - cfg.stab_cx) ** 2,
        0.01 * (k[6] - cfg.stab_cy) ** 2,
    ])


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve(
    frame_quat,      # [F,4]
    frame_trans,     # [F,3]
    frame_cam,       # [F] int32
    cam_k,           # [C,7]
    point_loc,       # [P,4]
    point_uncertainty,  # [P]
    obs_frame,       # [O] int32
    obs_point,       # [O] int32
    obs_px,          # [O,2]
    obs_ok,          # [O] bool: active & enabled & slam_usable & present
    present,         # [F] bool
    free_frame,      # [F] bool (subset of present)
    cfg: BAConfig = BAConfig(),
) -> BAResult:
    F = frame_quat.shape[0]
    P = point_loc.shape[0]
    O = obs_frame.shape[0]
    C = cam_k.shape[0]
    W = cfg.max_free_frames
    DF = 6 * W
    DK = 7 * C if cfg.solve_cameras else 0
    D = DF + DK

    f_idx = obs_frame.clip(0)
    p_idx = obs_point.clip(0)
    c_idx = frame_cam[f_idx]

    # ---- structure masks (slam.cpp:267-308, 344-354) ----
    frame_has_obs = (
        jnp.zeros(F, jnp.int32).at[jnp.where(obs_ok, f_idx, F)].add(1, mode="drop") > 0
    )
    n_used = jnp.sum((present & frame_has_obs).astype(jnp.int32))
    solvable = n_used >= 2
    free_f = free_frame & frame_has_obs & solvable

    point_in = (
        jnp.zeros(P, jnp.int32).at[jnp.where(obs_ok, p_idx, P)].add(1, mode="drop") > 0
    )
    fluid = (
        jnp.zeros(P, jnp.int32)
        .at[jnp.where(obs_ok & free_f[f_idx], p_idx, P)]
        .add(1, mode="drop")
        > 0
    )
    free_p = point_in & (fluid | (point_uncertainty > cfg.uncertainty_free)) & solvable

    # ---- free-point compaction (cfg.max_free_points) ----
    # The per-iteration assembly tensors carry a point axis; a window
    # touches a fraction of the table, so compact the FREE points (the
    # only rows whose Cinv is nonzero) into PW dense slots. Overflow
    # degrades gracefully: points past capacity solve as const.
    if cfg.max_free_points and cfg.max_free_points < P:
        PW = cfg.max_free_points
        # newest-first priority: points are appended in creation order, so
        # on overflow the OLDEST (best-converged) free points are the ones
        # demoted to const, not the fresh seeds that need solving
        rank = jnp.cumsum(free_p[::-1])[::-1] - 1
        free_p = free_p & (rank < PW)
        pslot_of = jnp.where(free_p, rank, PW).astype(jnp.int32)
        obs_pc = pslot_of[p_idx]            # [O]; PW = dropped column
        # merge matrix [P, PW] built ONCE (structure is fixed across LM
        # iterations); dp expands per iteration via one matmul
        merge_p = jax.nn.one_hot(pslot_of, PW + 1, dtype=jnp.float32)[:, :PW]
        free_pc = jnp.arange(PW) < jnp.sum(free_p)
    else:
        PW = P
        obs_pc = p_idx
        merge_p = None
        free_pc = free_p

    # frame -> dense slot
    slot_of = jnp.where(free_f, jnp.cumsum(free_f) - 1, W).astype(jnp.int32)
    slot_of = jnp.minimum(slot_of, W)  # overflow drops (capacity guard)
    obs_slot = slot_of[f_idx]          # W = const/no column

    # frame prior structure (slam.cpp:383-411)
    prev_present = jnp.roll(present, 1).at[0].set(False)
    prior_f = free_f & prev_present & (jnp.arange(F) >= 1)

    def residual_one(q, t, k, loc, px):
        r, valid = proj.reprojection_error(q, t, k, loc, px, cfg.cheirality_eps)
        return r, valid

    def obs_residuals(fq, ft, ks, locs):
        q = fq[f_idx]
        t = ft[f_idx]
        k = ks[c_idx]
        loc = locs[p_idx]
        r, valid = jax.vmap(residual_one)(q, t, k, loc, obs_px)
        # non-finite residuals (corrupt input rows) must not poison the
        # whole solve through the cost comparison — mask them out
        use = obs_ok & valid & jnp.all(jnp.isfinite(r), axis=-1)
        return jnp.where(use[:, None], r, 0.0), use

    def total_cost(fq, ft, ks, locs):
        r, use = obs_residuals(fq, ft, ks, locs)
        s = jnp.sum(r * r, axis=-1)
        cost = jnp.sum(jnp.where(use, _cauchy_rho(s, cfg.range), 0.0))
        # frame prior
        d = jnp.linalg.norm(ft - jnp.roll(ft, 1, axis=0), axis=-1)
        rp = cfg.frame_dist_weight * (d - cfg.baseline)
        cost += jnp.sum(
            jnp.where(prior_f, _cauchy_rho(rp * rp, cfg.frame_dist_loss), 0.0)
        )
        if cfg.solve_cameras:
            rs = jax.vmap(lambda k: _stab_residual(k, cfg))(ks)
            s2 = jnp.sum(rs * rs, axis=-1)
            cost += jnp.sum(_cauchy_rho(s2, cfg.camera_loss))
        return 0.5 * cost

    def build_normal(fq, ft, ks, locs):
        """Assemble every lambda-INDEPENDENT normal-equation block at the
        current state: residual weights, per-obs Jacobians (the expensive
        jacfwd + one-hot einsum reduction over O) and the prior tensors.
        Split from :func:`solve_damped` so REJECTED LM steps — where the
        state did not move — reuse these instead of rebuilding (Ceres
        amortizes the same way via its evaluator/CHOLMOD reuse,
        slam.cpp:482-521; here it halves the cost of every
        reject-then-retry lambda cycle)."""

        # per-obs jacobians wrt (xi[3], t[3], k[7], p[4])
        def res_params(xi, t, k, p, q0, px):
            qq = quat.retract(q0, xi)
            r, _ = proj.reprojection_error(qq, t, k, p, px, cfg.cheirality_eps)
            return r

        q = fq[f_idx]
        t = ft[f_idx]
        k = ks[c_idx]
        loc = locs[p_idx]

        r, use = obs_residuals(fq, ft, ks, locs)
        s = jnp.sum(r * r, axis=-1)
        w = jnp.where(use, _cauchy_weight(s, cfg.range), 0.0)

        zero3 = jnp.zeros(3, fq.dtype)
        argnums = (0, 1, 2, 3) if cfg.solve_cameras else (0, 1, 3)
        jac = jax.vmap(jax.jacfwd(res_params, argnums=argnums))(
            jnp.tile(zero3, (O, 1)), t, k, loc, q, obs_px
        )
        if cfg.solve_cameras:
            jxi, jt, jk, jp = jac  # [O,2,3], [O,2,3], [O,2,7], [O,2,4]
        else:
            jxi, jt, jp = jac
            jk = jnp.zeros((O, 2, 7))
        jf = jnp.concatenate([jxi, jt], axis=-1)  # [O,2,6]

        # zero out const columns and invalid (cheirality-failed) rows
        jf = jf * (use & (obs_slot < W))[:, None, None]
        jp = jp * (use & free_p[p_idx])[:, None, None]
        jk = jk * use[:, None, None]
        wr = w[:, None] * jnp.where(use[:, None], r, 0.0)

        # Block accumulation via one-hot matmuls instead of scatter-adds
        # (a dozen scatters per LM iteration were slow on the accelerator
        # this was first built for; whether segment sums win on the GPU is
        # open, ROADMAP C4). one_hot(sentinel) rows are all-zero, which
        # reproduces mode="drop".
        ohp = jax.nn.one_hot(obs_pc, PW, dtype=jnp.float32)        # [O,PW]
        ohs = jax.nn.one_hot(obs_slot, W + 1, dtype=jnp.float32)[:, :W]  # [O,W]

        # ---- fused block assembly ----
        # ONE per-obs outer product builds every lambda-independent block:
        # jaug = [jf | r | jp] (cols 0-5 | 6 | 7-10), all w-weighted, so
        #   blk[:, :6, :6] = jf'Wjf   blk[:, :6, 6] = jf'Wr  (-> -bf)
        #   blk[:, :6, 7:] = jf'Wjp   blk[:, 7:, 6] = jp'Wr  (-> -bp)
        #   blk[:, 7:, 7:] = jp'Wjp
        # The unfused form ran 3 outer-product + 2 gradient einsums + 5
        # one-hot merges per LM iteration; this is 1 outer + 3 merges
        # with identical contractions.
        rm = jnp.where(use[:, None], r, 0.0)
        jaug = jnp.concatenate([jf, rm[:, :, None], jp], axis=-1)  # [O,2,11]
        blk = jnp.einsum("oia,oib,o->oab", jaug, jaug, w, precision=_HI)

        # landmark merge: [PW,5,5] holds Cp (rows/cols 1:) and bp (col 0)
        mp = jnp.einsum("op,oab->pab", ohp, blk[:, 6:, 6:], precision=_HI)
        Cp = mp[:, 1:, 1:]
        bp = -mp[:, 1:, 0]

        # frame merge: [W,7,7] holds Hff (:6,:6) and bf (col 6)
        mf = jnp.einsum("ow,oab->wab", ohs, blk[:, :7, :7], precision=_HI)
        Hff = mf[:, :6, :6]
        bf = -mf[:, :6, 6]

        # frame-point coupling
        A = jnp.einsum(
            "op,owab->pwab",
            ohp,
            jnp.einsum("ow,oab->owab", ohs, blk[:, :6, 7:], precision=_HI),
            precision=_HI,
        )  # [P,W,6,4]

        # ---- frame distance prior ----
        tprev = jnp.roll(ft, 1, axis=0)
        dvec = ft - tprev
        dnorm = jnp.linalg.norm(dvec, axis=-1)
        dhat = dvec / jnp.maximum(dnorm, 1e-9)[:, None]
        rp = cfg.frame_dist_weight * (dnorm - cfg.baseline)
        wp = jnp.where(prior_f, _cauchy_weight(rp * rp, cfg.frame_dist_loss), 0.0)
        jp_t = cfg.frame_dist_weight * dhat          # d rp / d t_f   [F,3]
        slot_f = slot_of
        slot_prev = jnp.roll(slot_of, 1).at[0].set(W)
        oh_f = jax.nn.one_hot(jnp.where(prior_f, slot_f, W), W + 1,
                              dtype=jnp.float32)[:, :W]            # [F,W]
        oh_prev = jax.nn.one_hot(jnp.where(prior_f, slot_prev, W), W + 1,
                                 dtype=jnp.float32)[:, :W]
        blk = jnp.einsum("fa,fb,f->fab", jp_t, jp_t, wp, precision=_HI)
        prior_diag = (
            jnp.einsum("fw,fab->wab", oh_f, blk, precision=_HI)
            + jnp.einsum("fw,fab->wab", oh_prev, blk, precision=_HI)
        )
        Hff = Hff.at[:, 3:, 3:].add(prior_diag)
        gvec = (wp * rp)[:, None] * jp_t
        prior_b = (
            -jnp.einsum("fw,fa->wa", oh_f, gvec, precision=_HI)
            + jnp.einsum("fw,fa->wa", oh_prev, gvec, precision=_HI)
        )
        bf = bf.at[:, 3:].add(prior_b)

        # prior off-diagonal coupling (lambda-independent)
        off = jnp.einsum("fa,fb,f->fab", jp_t, -jp_t, wp, precision=_HI)
        T = jnp.einsum("fw,fv,fab->wavb", oh_f, oh_prev, off, precision=_HI)

        if cfg.solve_cameras:
            # camera columns: coupling with frames and points — one-hot
            # matmul accumulation like the primary blocks above (one_hot
            # of an OOB sentinel is all-zero = mode="drop")
            ohc = jax.nn.one_hot(c_idx, C, dtype=jnp.float32)      # [O,C]
            blk_kk = jnp.einsum("oia,oib,o->oab", jk, jk, w, precision=_HI)
            Hkk = jnp.einsum("oc,oab->cab", ohc, blk_kk, precision=_HI)
            bk = -jnp.einsum("oc,oia,oi->ca", ohc, jk, wr, precision=_HI)
            blk_fk = jnp.einsum("oia,oib,o->oab", jf, jk, w, precision=_HI)
            Hfk = jnp.einsum(
                "oc,owab->wcab",
                ohc,
                jnp.einsum("ow,oab->owab", ohs, blk_fk, precision=_HI),
                precision=_HI,
            )  # [W,C,6,7]
            blk_kp = jnp.einsum("oia,oib,o->oab", jk, jp, w, precision=_HI)
            Ak = jnp.einsum(
                "op,ocab->pcab",
                ohp,
                jnp.einsum("oc,oab->ocab", ohc, blk_kp, precision=_HI),
                precision=_HI,
            )  # [P,C,7,4]
            # stabilization residuals
            js = jax.vmap(jax.jacfwd(lambda k: _stab_residual(k, cfg)))(ks)  # [C,7,7]
            rs = jax.vmap(lambda k: _stab_residual(k, cfg))(ks)
            s2 = jnp.sum(rs * rs, axis=-1)
            ws = _cauchy_weight(s2, cfg.camera_loss)
            Hkk = Hkk + jnp.einsum("cia,cib,c->cab", js, js, ws, precision=_HI)
            bk = bk - jnp.einsum("cia,ci,c->ca", js, rs, ws, precision=_HI)
        else:
            Hkk = jnp.zeros((C, 7, 7))
            bk = jnp.zeros((C, 7))
            Hfk = jnp.zeros((W, C, 6, 7))
            Ak = jnp.zeros((PW, C, 7, 4))
        return Cp, bp, Hff, bf, A, T, Hkk, bk, Hfk, Ak

    def solve_damped(normal, lam):
        """The lambda-DEPENDENT remainder of one LM step: damping, Schur
        complement, reduced solve, back-substitution. Cheap relative to
        :func:`build_normal` (no O-sized tensors)."""
        Cp, bp, Hff, bf, A, T, Hkk, bk, Hfk, Ak = normal

        # ---- assemble reduced system ----
        lamI4 = lam * jnp.eye(4) * jnp.maximum(
            jnp.einsum("pii->p", Cp)[:, None, None] / 4.0, 1e-6
        ) + 1e-8 * jnp.eye(4)
        Cdamp = Cp + lamI4
        Cinv = jnp.where(free_pc[:, None, None], inv4x4(Cdamp), jnp.zeros((4, 4)))

        eyeW = jnp.eye(6)
        Hff_d = Hff + lam * eyeW * jnp.maximum(
            jnp.einsum("fii->f", Hff)[:, None, None] / 6.0, 1e-6
        ) + 1e-8 * eyeW

        # block-diagonal + prior off-diagonal coupling, all static placement
        S66 = jnp.einsum("wv,wab->wavb", jnp.eye(W), Hff_d, precision=_HI)
        S66 = S66.at[:, 3:, :, 3:].add(T + jnp.transpose(T, (2, 3, 0, 1)))

        # schur: S -= sum_p A C^-1 A^T   ([P,W,6,4] x [P,4,4] x [P,W,6,4])
        ACi = jnp.einsum("pwia,pab->pwib", A, Cinv, precision=_HI)
        S_ff = jnp.einsum("pwib,pvjb->wivj", ACi, A, precision=_HI)
        S66 = S66 - S_ff

        S = jnp.zeros((D, D)).at[:DF, :DF].set(S66.reshape(DF, DF))
        rhs = jnp.zeros((D,))
        rhs = rhs.at[:DF].set(
            (bf - jnp.einsum("pwib,pb->wi", ACi, bp, precision=_HI)).reshape(DF)
        )

        if cfg.solve_cameras:
            Hkk_d = Hkk + lam * jnp.eye(7) * jnp.maximum(
                jnp.einsum("cii->c", Hkk)[:, None, None] / 7.0, 1e-6
            ) + 1e-8 * jnp.eye(7)

            # schur corrections for camera blocks
            AkCi = jnp.einsum("pcia,pab->pcib", Ak, Cinv, precision=_HI)
            S_kk = jnp.einsum("pcib,pdjb->cidj", AkCi, Ak, precision=_HI)
            S_fk = jnp.einsum("pwib,pcjb->wicj", ACi, Ak, precision=_HI)

            S = S.at[DF:, DF:].set(
                jax.scipy.linalg.block_diag(*[Hkk_d[i] for i in range(C)])
                - S_kk.reshape(DK, DK)
            )
            fk = Hfk.reshape(DF, DK) - S_fk.reshape(DF, DK)
            S = S.at[:DF, DF:].add(fk)
            S = S.at[DF:, :DF].add(fk.T)
            rhs = rhs.at[DF:].set(
                bk.reshape(DK) - jnp.einsum("pcib,pb->ci", AkCi, bp, precision=_HI).reshape(DK)
            )

        # inactive slots get identity rows to stay non-singular
        slot_active = jnp.repeat(jnp.arange(W) < jnp.sum(free_f), 6)
        if cfg.solve_cameras:
            slot_active = jnp.concatenate([slot_active, jnp.ones(DK, bool)])
        S = jnp.where(
            slot_active[:, None] & slot_active[None, :], S,
            jnp.eye(D) * 1.0,
        )
        rhs = jnp.where(slot_active, rhs, 0.0)

        delta = jnp.linalg.solve(S, rhs)
        df = delta[:DF].reshape(W, 6)
        dk = delta[DF:].reshape(C, 7) if cfg.solve_cameras else jnp.zeros((C, 7))

        # back-substitute points: dp = Cinv (bp - A^T df - Ak^T dk)
        Atd = jnp.einsum("pwia,wi->pa", A, df, precision=_HI)
        if cfg.solve_cameras:
            Atd = Atd + jnp.einsum("pcia,ci->pa", Ak, dk, precision=_HI)
        dp = jnp.einsum("pab,pb->pa", Cinv, bp - Atd, precision=_HI)

        # predicted model reduction for the gain ratio (Marquardt policy):
        # with (H + lam*D) d = b (b = -g), m(0)-m(d) = (d.b + lam d.D d)/2;
        # D is the scaled-Marquardt diagonal used above (the +1e-8
        # Tikhonov is negligible at this scale)
        d_dot_b = (
            jnp.sum(df * bf)
            + jnp.sum(dp * bp)
            + (jnp.sum(dk * bk) if cfg.solve_cameras else 0.0)
        )
        scale_f = jnp.maximum(jnp.einsum("fii->f", Hff) / 6.0, 1e-6)
        scale_p = jnp.maximum(jnp.einsum("pii->p", Cp) / 4.0, 1e-6)
        d_dot_Dd = (
            jnp.sum(scale_f * jnp.sum(df * df, axis=-1))
            + jnp.sum(scale_p * jnp.sum(dp * dp, axis=-1))
        )
        if cfg.solve_cameras:
            scale_k = jnp.maximum(jnp.einsum("cii->c", Hkk) / 7.0, 1e-6)
            d_dot_Dd = d_dot_Dd + jnp.sum(
                scale_k * jnp.sum(dk * dk, axis=-1))
        pred_red = 0.5 * (d_dot_b + lam * d_dot_Dd)

        if merge_p is not None:
            dp = jnp.matmul(merge_p, dp, precision=_HI)  # [P,4]
        dp = jnp.where(free_p[:, None], dp, 0.0)

        # map frame slots back to frames (slot-capacity overflow stays const)
        upd = (free_f & (slot_of < W))[:, None]
        dxi = jnp.where(upd, df[slot_of.clip(0, W - 1), :3], 0.0)
        dt = jnp.where(upd, df[slot_of.clip(0, W - 1), 3:], 0.0)
        return dxi, dt, dk, dp, pred_red

    def apply(fq, ft, ks, locs, dxi, dt, dk, dp):
        nq = jax.vmap(quat.retract)(fq, dxi)
        nq = jnp.where(free_f[:, None], nq, fq)
        nt = ft + dt
        nk = ks + dk if cfg.solve_cameras else ks
        nl = locs + dp
        return nq, nt, nk, nl

    # ---- LM loop ----
    # `normal` (the lambda-independent blocks) rides the carry; `stale`
    # marks it out of date (step ACCEPTED -> state moved). Rejected steps
    # reuse the blocks and pay only the damped solve — bit-identical
    # results, since the state they describe did not change.
    def lm_body(carry):
        (fq, ft, ks, locs, lam, nu, cost, it, rejects, done, term,
         normal, stale) = carry
        normal = lax.cond(
            stale,
            lambda _: build_normal(fq, ft, ks, locs),
            lambda n: n,
            normal,
        )
        dxi, dt, dk, dp, pred_red = solve_damped(normal, lam)
        step_inf = jnp.maximum(
            jnp.max(jnp.abs(dxi)),
            jnp.maximum(jnp.max(jnp.abs(dt)), jnp.max(jnp.abs(dp))),
        )
        if cfg.solve_cameras:
            step_inf = jnp.maximum(step_inf, jnp.max(jnp.abs(dk)))
        tiny = step_inf < cfg.xtol
        cq, ct, ck, cl = apply(fq, ft, ks, locs, dxi, dt, dk, dp)
        new_cost = total_cost(cq, ct, ck, cl)
        accept = new_cost < cost
        fq = jnp.where(accept, cq, fq)
        ft = jnp.where(accept, ct, ft)
        ks = jnp.where(accept, ck, ks)
        locs = jnp.where(accept, cl, locs)
        if cfg.lm_policy == "marquardt":
            # Ceres's gain-ratio damping (the policy the reference's Ceres
            # solve runs): large rho (model trusted) slashes lambda, rho
            # near 1/2 holds it, rejects escalate geometrically via nu
            rho = (cost - new_cost) / jnp.maximum(pred_red, 1e-20)
            shrink = jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3)
            new_lam = jnp.where(accept, lam * shrink, lam * nu)
            new_nu = jnp.where(accept, jnp.float32(2.0), nu * 2.0)
        else:
            new_lam = jnp.where(
                accept, lam * cfg.lm_lambda_down, lam * cfg.lm_lambda_up)
            new_nu = nu
        new_lam = jnp.clip(new_lam, cfg.lm_lambda_min, 1e8)
        converged = accept & (
            (cost - new_cost) <= cfg.ftol * jnp.maximum(cost, 1e-20)
        )
        # stall: repeated rejections mean the trust region has collapsed
        # (Ceres terminates on min trust-region radius similarly)
        rejects = jnp.where(accept, 0, rejects + 1)
        stalled = (rejects >= 5) | (new_lam >= 1e7)
        cost = jnp.where(accept, new_cost, cost)
        # termination reason (first exit wins; priority ftol > xtol > stall)
        term = jnp.where(
            done,
            term,
            jnp.where(
                converged,
                TERM_FTOL,
                jnp.where(tiny, TERM_XTOL,
                          jnp.where(stalled, TERM_STALL, TERM_MAX_ITERS)),
            ),
        ).astype(jnp.int32)
        return (fq, ft, ks, locs, new_lam, new_nu, cost, it + 1, rejects,
                done | converged | stalled | tiny, term, normal, accept)

    def lm_cond(carry):
        it, done = carry[7], carry[9]
        return (it < cfg.max_iters) & ~done

    cost0 = total_cost(frame_quat, frame_trans, cam_k, point_loc)
    normal0 = (
        jnp.zeros((PW, 4, 4)), jnp.zeros((PW, 4)),
        jnp.zeros((W, 6, 6)), jnp.zeros((W, 6)),
        jnp.zeros((PW, W, 6, 4)), jnp.zeros((W, 3, W, 3)),
        jnp.zeros((C, 7, 7)), jnp.zeros((C, 7)),
        jnp.zeros((W, C, 6, 7)), jnp.zeros((PW, C, 7, 4)),
    )
    init = (
        frame_quat,
        frame_trans,
        cam_k,
        point_loc,
        jnp.float32(cfg.lm_lambda_init),
        jnp.float32(2.0),  # nu: marquardt reject escalation factor
        cost0,
        jnp.int32(0),
        jnp.int32(0),
        ~solvable,  # unsolvable problems skip the loop entirely
        jnp.int32(TERM_MAX_ITERS),  # what the cap exit leaves in place
        normal0,
        jnp.bool_(True),  # first iteration must build the blocks
    )
    fq, ft, ks, locs, _, _, cost, iters, _, _, term, _, _ = lax.while_loop(
        lm_cond, lm_body, init
    )

    return BAResult(
        frame_quat=jnp.where(solvable, fq, frame_quat),
        frame_trans=jnp.where(solvable, ft, frame_trans),
        point_loc=jnp.where(solvable, locs, point_loc),
        cam_k=jnp.where(solvable, ks, cam_k),
        ok=solvable,
        cost=cost,
        iters=iters,
        term=jnp.where(solvable, term, TERM_NOT_RUN).astype(jnp.int32),
        cost0=cost0,
    )
