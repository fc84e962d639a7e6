"""Shi-Tomasi corner detection + spatial suppression.

Rebuilds the reference's goodFeaturesToTrack call (120 corners max, quality
ratio 0.01, 20px min distance; matcher.cpp:125-130) and the 30x30 occupancy
grid that suppresses new corners near existing matches (matcher.cpp:132-151):

- min-eigenvalue response from a 3x3-windowed structure tensor of Sobel
  gradients — shifted-slice convolutions that fuse elementwise
- 3x3 non-max suppression, quality thresholding against the global max
- min-distance enforcement by greedy acceptance in response order over the
  top-K candidates (a short lax.scan), matching OpenCV's behavior
- ``occupancy_grid``/``suppress_by_grid`` reproduce the matcher's grid with
  its 3x3 dilation

Outputs are fixed-capacity: (pts[K,2], valid[K]).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax


import numpy as _np

_SOBEL_X = _np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]]) / 8.0
_SOBEL_Y = _SOBEL_X.T
_BOX3 = _np.ones((3, 3)) / 9.0


def _conv2(img, k):
    """3x3 correlation, zero-padded SAME, as shifted static slices.

    A single-channel conv_general_dilated has no channel depth to reduce
    over (on the GPU it measured 3.6x slower than shifted slices for the
    pyramid's 5-tap blur, PERF.md); nine shifted adds fuse into one
    elementwise pass. ``k`` is a host-side constant.
    """
    H, W = img.shape
    x = jnp.pad(img, 1)
    out = jnp.zeros_like(img)
    for dy in range(3):
        for dx in range(3):
            kv = float(k[dy, dx])
            if kv != 0.0:
                out = out + kv * x[dy : dy + H, dx : dx + W]
    return out


def min_eig_response(img) -> jnp.ndarray:
    """cornerMinEigenVal: smaller eigenvalue of the 3x3-summed structure
    tensor of Sobel gradients."""
    ix = _conv2(img, _SOBEL_X)
    iy = _conv2(img, _SOBEL_Y)
    a = _conv2(ix * ix, _BOX3)
    b = _conv2(ix * iy, _BOX3)
    c = _conv2(iy * iy, _BOX3)
    half_tr = 0.5 * (a + c)
    disc = jnp.sqrt(jnp.maximum(0.5 * (a - c) * 0.5 * (a - c) + b * b, 0.0))
    return half_tr - disc


@functools.partial(
    jax.jit, static_argnames=("max_corners", "candidates", "border")
)
def detect(img, max_corners: int = 120, quality: float = 0.01,
           min_distance: float = 20.0, candidates: int = 512,
           border: int = 8):
    """goodFeaturesToTrack equivalent. Returns (pts[max_corners,2] f32 (x,y),
    valid[max_corners] bool), corners ordered by decreasing response.

    ``border`` pixels at the image edge are excluded so tracker patches fit.
    """
    h, w = img.shape
    r = min_eig_response(img)

    # border mask
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    r = jnp.where(inside, r, -jnp.inf)

    # 3x3 non-max suppression + quality threshold
    rmax = lax.reduce_window(r, -jnp.inf, lax.max, (3, 3), (1, 1), "SAME")
    thresh = quality * jnp.max(r)
    peak = (r >= rmax) & (r > thresh)
    score = jnp.where(peak, r, -jnp.inf)

    # top-K candidates by response. On the GPU (and the CPU) approx_max_k
    # lowers to an exact top-k, so the candidate set is exact there; the
    # approximate form is allowed because recall ~0.95 on the tail only
    # perturbs candidates far below the acceptance cutoff.
    flat = score.reshape(-1)
    vals, idx = lax.approx_max_k(flat, candidates)
    cy = (idx // w).astype(jnp.float32)
    cx = (idx % w).astype(jnp.float32)
    cand = jnp.stack([cx, cy], axis=1)
    cand_ok = jnp.isfinite(vals)

    # greedy min-distance acceptance in response order. The clash matrix
    # is precomputed so each of the `candidates` sequential steps is two
    # [K]-vector ops and no gather/scatter. The scan processes candidates
    # in blocks of 8
    # with the greedy walk UNROLLED inside each block (row i still checks
    # the acc updated by rows < i — bit-identical to the row-at-a-time
    # scan): the body ops are tiny [K]-vector ANDs, so a 512-iteration
    # while loop is bound by loop machinery; 64 blocked iterations cut
    # exactly that overhead.
    md2 = min_distance * min_distance
    d2 = jnp.sum((cand[:, None, :] - cand[None, :, :]) ** 2, axis=-1)
    clash = d2 < md2
    eye = jnp.eye(candidates, dtype=bool)

    block = 8
    assert candidates % block == 0

    def body(carry, xs):
        acc, n_acc = carry
        clash_rows, one_rows, okb = xs
        for i in range(block):
            take = okb[i] & ~jnp.any(acc & clash_rows[i]) & (n_acc < max_corners)
            acc = acc | (one_rows[i] & take)
            n_acc = n_acc + take.astype(jnp.int32)
        return (acc, n_acc), None

    nb = candidates // block
    (acc, _), _ = lax.scan(
        body, (jnp.zeros(candidates, bool), jnp.int32(0)),
        (clash.reshape(nb, block, candidates),
         eye.reshape(nb, block, candidates),
         cand_ok.reshape(nb, block)),
    )
    sel = jnp.argsort(~acc)[:max_corners]  # stable: response order
    accepted = acc[sel]
    pts = jnp.where(accepted[:, None], cand[sel], 0.0)
    return pts, accepted


def occupancy_grid(match_px, match_valid, width: int, height: int,
                   grid: int = 30) -> jnp.ndarray:
    """30x30 occupancy of existing matches, 3x3 dilated (matcher.cpp:132-151).

    Returns bool[grid+2, grid+2] in the reference's 1-offset indexing.
    """
    gx = (match_px[:, 0] / width * grid).astype(jnp.int32) + 1
    gy = (match_px[:, 1] / height * grid).astype(jnp.int32) + 1
    occ = jnp.zeros((grid + 2, grid + 2), bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ix = jnp.where(match_valid, gx + dx, grid + 2)  # OOB row drops
            iy = jnp.where(match_valid, gy + dy, grid + 2)
            occ = occ.at[ix, iy].set(True, mode="drop")
    return occ


def suppress_by_grid(pts, valid, occ, width: int, height: int,
                     grid: int = 30) -> jnp.ndarray:
    """Drop candidate corners whose (undilated) cell is occupied
    (matcher.cpp:153-166)."""
    gx = (pts[:, 0] / width * grid).astype(jnp.int32) + 1
    gy = (pts[:, 1] / height * grid).astype(jnp.int32) + 1
    hit = occ[gx.clip(0, grid + 1), gy.clip(0, grid + 1)]
    return valid & ~hit
