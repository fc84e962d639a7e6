"""Batched coarse-to-fine Newton patch tracker (hessian.h:147-264 rebuilt).

The reference estimates the 2x2 Hessian and gradient of the photometric
score by 6 finite-difference score evaluations per Newton step
(BruteHessian, hessian.h:147-172) and even leaves itself the TODO to use the
interpolation structure directly (hessian.h:143-146). Here the score is a
closed differentiable function of the sub-pixel position (bilinear sampling
is piecewise-polynomial), so one ``jax.grad`` / forward-over-reverse Hessian
gives the exact in-cell derivatives — fewer FLOPs, no step-size h.

Semantics preserved from Track/TrackFeature (hessian.h:185-264):
- Newton step d = -H^-1 g, clamped to unit length then per-component to
  [-1, 1]. (The reference's unit-clamp normalizes dx first and then divides
  dy by the *already updated* dx — a bug we do not copy; we normalize the
  vector properly.)
- stop when both |dx|,|dy| < threshold, after at most ``max_iters`` steps
- out-of-bounds margin test per iteration -> track failure
- coarse-to-fine: start at level lvls-1 with pt / 2^(lvls-1), x2 upscale
  between levels
- forward/backward verification with a 0.3px round-trip gate happens in the
  matcher (matcher.cpp:173-206) via ``track_bidirectional``

Fixed shapes: pyramids are FlatPyramid ([L, Hp, Wp] with per-level true
sizes), so the level cascade is one ``lax.fori_loop`` whose body is traced
once — the level index, image, and patch are all dynamic. All functions
are single-feature; the matcher vmaps them over feature slots.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from slam_robot_tpu.ops import patch as patch_ops
from slam_robot_tpu.ops.patch import Patch
from slam_robot_tpu.ops.pyramid import FlatPyramid

OK = 0
SMALL_DET = 1       # kept for API parity (hessian.h:48-52); never raised
OUT_OF_BOUNDS = 2

_MARGIN = 0.01  # hessian.h:196


def get_patch_stack(pyr: FlatPyramid, pt, size: int = 13) -> Patch:
    """GetPatches (hessian.h:175-183): patch at pt / 2^i per level, stacked
    along a leading axis. Extracts all levels; callers mask with a
    per-feature level count."""
    levels = jnp.arange(pyr.depth)

    def one(i):
        img, j, w, h = pyr.level_ref(i)
        return patch_ops.extract(
            img, w, h, pt / (2.0 ** i.astype(jnp.float32)), size, index=j
        )

    return jax.vmap(one)(levels)


def _level_patch(stack: Patch, i) -> Patch:
    return Patch(stack.data[i], stack.valid[i], stack.mean[i], stack.sumsq[i])


def track_level(img, width, height, ref_patch: Patch, pt, weight,
                threshold: float = 0.001, max_iters: int = 10,
                size: int = 13, active=True, index=None):
    """Newton iterations against one (possibly dynamically indexed) pyramid
    level (hessian.h:185-241). Returns (new_pt, status).

    ``active=False`` lanes start done: under vmap the while_loop runs until
    every lane finishes, so masked lanes must not burn the full iteration
    budget (they dominate sequential depth otherwise)."""

    def score_at(xy):
        return patch_ops.score(
            ref_patch,
            patch_ops.extract(img, width, height, xy, size, index=index),
            weight,
        )

    grad_fn = jax.grad(score_at)
    hess_fn = jax.jacfwd(jax.grad(score_at))
    wf = jnp.asarray(width, jnp.float32)
    hf = jnp.asarray(height, jnp.float32)

    def oob_at(xy):
        return (
            (xy[0] < _MARGIN)
            | (xy[1] < _MARGIN)
            | (xy[0] + _MARGIN > wf)
            | (xy[1] + _MARGIN > hf)
        )

    def body(carry):
        xy, status, it, done = carry
        oob = oob_at(xy)

        g = grad_fn(xy)
        h = hess_fn(xy)
        det = h[0, 0] * h[1, 1] - h[0, 1] * h[1, 0]
        safe_det = jnp.where(jnp.abs(det) > 1e-20, det, jnp.where(det >= 0, 1e-20, -1e-20))
        d = -jnp.stack(
            [h[1, 1] * g[0] - h[0, 1] * g[1], -h[1, 0] * g[0] + h[0, 0] * g[1]]
        ) / safe_det
        d = jnp.where(jnp.isfinite(d), d, 0.0)

        n = jnp.linalg.norm(d)
        d = jnp.where(n > 1.0, d / jnp.maximum(n, 1e-20), d)
        step = jnp.clip(d, -1.0, 1.0)

        new_xy = jnp.where(oob, xy, xy + step)
        converged = (jnp.abs(d[0]) < threshold) & (jnp.abs(d[1]) < threshold)

        new_status = jnp.where(oob, OUT_OF_BOUNDS, status)
        new_done = done | oob | converged
        return (
            jnp.where(done, xy, new_xy),
            jnp.where(done, status, new_status),
            it + 1,
            new_done,
        )

    def cond(carry):
        _, _, it, done = carry
        return (it < max_iters) & ~done

    pt = jnp.asarray(pt, jnp.float32)
    done0 = ~jnp.asarray(active, bool)
    xy, status, _, _ = lax.while_loop(
        cond, body, (pt, jnp.int32(OK), jnp.int32(0), done0)
    )
    status = jnp.where(oob_at(xy) & jnp.asarray(active, bool), OUT_OF_BOUNDS, status)
    return xy, status


def track_feature(pyr: FlatPyramid, patches: Patch, pt, lvls,
                  weight, threshold: float = 0.001, max_iters: int = 10,
                  active=True):
    """Coarse-to-fine TrackFeature (hessian.h:243-264) with a *dynamic*
    per-feature level count ``lvls`` (the matcher uses 3 or 6 by point
    uncertainty, matcher.cpp:227-229). One fori_loop over levels; levels
    coarser than lvls-1 are skipped by masking.

    Returns (new_pt, ok: bool).
    """
    n_levels = pyr.depth
    lvls = jnp.asarray(lvls, jnp.int32)
    scale0 = (2.0 ** (lvls - 1)).astype(jnp.float32)
    p0 = jnp.asarray(pt, jnp.float32) / scale0

    active = jnp.asarray(active, bool)

    def body(k, carry):
        p, status = carry
        i = n_levels - 1 - k
        lvl_on = i <= lvls - 1
        failed = status != OK
        take = lvl_on & ~failed & active
        img, j, w, h = pyr.level_ref(i)
        new_p, st = track_level(
            img, w, h, _level_patch(patches, i), p, weight, threshold,
            max_iters, active=take, index=j,
        )
        p = jnp.where(take, new_p, p)
        status = jnp.where(take, st, status)
        p = jnp.where(lvl_on & (i > 0), p * 2.0, p)
        return (p, status)

    p, status = lax.fori_loop(0, n_levels, body, (p0, jnp.int32(OK)))
    return p, (status == OK) & active


def track_bidirectional(pyr_from: FlatPyramid, pyr_to: FlatPyramid,
                        from_pt, init_to_pt, lvls, weight,
                        threshold: float = 0.001, max_iters: int = 10,
                        roundtrip_px: float = 0.3,
                        min_variance: float = 1e-5,
                        active=True,
                        track_fn=None):
    """Forward/backward consistency tracking (matcher.cpp:173-206).

    Forward: patches at from_pt in pyr_from, tracked in pyr_to starting at
    init_to_pt. Backward: patches at the forward result in pyr_to, tracked
    in pyr_from starting from from_pt. Accept when both succeed and the
    round trip lands within ``roundtrip_px`` of from_pt.

    ``min_variance`` gates textureless patches: a flat patch has a
    degenerate score Hessian, so Newton reports instant convergence and the
    round trip trivially passes — a false match. The reference has the same
    hole (its SMALL_DET status, hessian.h:50, is never raised); we reject on
    finest-level patch variance instead of copying it.

    Returns (to_pt, ok).
    """
    active = jnp.asarray(active, bool)
    fn = track_fn or track_feature  # swap in ops.klt.track_feature etc.
    p1 = get_patch_stack(pyr_from, from_pt)
    to_pt, ok1 = fn(pyr_to, p1, init_to_pt, lvls, weight, threshold,
                    max_iters, active=active)

    p2 = get_patch_stack(pyr_to, to_pt)
    back_pt, ok2 = fn(pyr_from, p2, from_pt, lvls, weight, threshold,
                      max_iters, active=ok1)

    textured = (p1.sumsq[0] - p1.mean[0] ** 2) >= min_variance
    ok = ok1 & ok2 & textured & (jnp.linalg.norm(from_pt - back_pt) <= roundtrip_px)
    return to_pt, ok
