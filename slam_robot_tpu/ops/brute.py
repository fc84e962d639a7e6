"""Brute-force SAD template tracker (brute.h rebuilt; the reference's
alternate, unused matcher).

Descriptor-free exhaustive match: per pyramid level a grid scan of
gain/bias-normalized SAD over a +-window (SearchBest, brute.h:96-117),
coarse-to-fine with +-3px/1px steps at coarse levels and a shrinking-step
refinement cascade at level 0 (brute.h:144-158), rejecting matches whose
final SAD exceeds a threshold. (The reference tests SAD > 100 on its
[0,1]-scaled patches, brute.h:116 — a bound a 169-pixel patch practically
never hits, so the gate is inert; we keep the literal default and let
callers pass a meaningful one. A well-matched textured patch lands around
0.3-1.0, a decorrelated one an order of magnitude higher.)

Each grid scan is one vmapped extract+SAD over all candidate offsets —
batched and fixed-shape.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_robot_tpu.ops import patch as patch_ops
from slam_robot_tpu.ops.patch import Patch
from slam_robot_tpu.ops.pyramid import FlatPyramid
from slam_robot_tpu.ops.tracker import get_patch_stack, _level_patch  # noqa: F401


def sad(p1: Patch, p2: Patch, eps: float = 1e-12) -> jnp.ndarray:
    """Gain/bias-normalized sum of absolute differences (brute.h:82-94)."""
    alpha = jnp.sqrt(p1.sumsq / jnp.maximum(p2.sumsq, eps))
    beta = p1.mean - alpha * p2.mean
    diff = jnp.abs(p1.data - p2.data * alpha - beta)
    ok = p1.valid & p2.valid
    return jnp.sum(jnp.where(ok, diff, 0.0))


def search_best(img, width, height, ref_patch: Patch, pt, step: float,
                half_steps: int = 3, size: int = 13, index=None):
    """Grid scan: evaluate SAD on a (2h+1)^2 grid of offsets around pt,
    return (best_pt, best_sad) (SearchBest, brute.h:96-117)."""
    offs = jnp.arange(-half_steps, half_steps + 1, dtype=jnp.float32) * step
    dx, dy = jnp.meshgrid(offs, offs)
    cand = pt[None, :] + jnp.stack([dx.ravel(), dy.ravel()], axis=1)

    def one(c):
        return sad(ref_patch,
                   patch_ops.extract(img, width, height, c, size, index=index))

    sads = jax.vmap(one)(cand)
    best = jnp.argmin(sads)
    return cand[best], sads[best]


def track_feature(pyr: FlatPyramid, patches: Patch, pt, lvls,
                  sad_threshold: float = 100.0,
                  size: int = 13):
    """Coarse-to-fine cascade (brute.h:144-158): +-3 integer steps at the
    coarsest active level, +-1 at the rest, then a shrinking sub-pixel
    cascade (1 -> ~0.012 px) at level 0. Returns (pt, ok)."""
    n_levels = pyr.depth
    lvls = jnp.asarray(lvls, jnp.int32)
    p = jnp.asarray(pt, jnp.float32) / (2.0 ** (lvls - 1)).astype(jnp.float32)

    best_sad = jnp.float32(jnp.inf)

    def body(k, carry):
        p, best_sad = carry
        i = n_levels - 1 - k
        active = i <= lvls - 1
        img, j, w, h = pyr.level_ref(i)
        rp = _level_patch(patches, i)
        # two scans per level like the reference: +-3 px integer grid
        # (brute.h:147 SearchBest(3,1)) then +-1 px at 1/3-px resolution
        # (brute.h:148 SearchBest(1, 0.33333))
        new_p, s = search_best(img, w, h, rp, p, jnp.float32(1.0), index=j)
        new_p, s = search_best(img, w, h, rp, new_p, jnp.float32(1.0 / 3.0),
                               index=j)
        p = jnp.where(active, new_p, p)
        best_sad = jnp.where(active & (i == 0), s, best_sad)
        p = jnp.where(active & (i > 0), p * 2.0, p)
        return p, best_sad

    p, best_sad = jax.lax.fori_loop(0, n_levels, body, (p, best_sad))

    # sub-pixel cascade at level 0
    img, j, w, h = pyr.level_ref(0)
    rp = _level_patch(patches, 0)
    for step in (1.0, 1 / 3, 1 / 9, 1 / 27, 1 / 81):
        p, best_sad = search_best(img, w, h, rp, p, jnp.float32(step), index=j)

    ok = best_sad <= sad_threshold
    return p, ok
