"""Per-level Newton tracker sweep (hessian.h:147-264 hot loop).

One sweep runs ALL Newton iterations of one pyramid level for every
feature lane at once, against a per-lane 32x32 search window. Per
iteration the 13x13 patch is re-sampled bilinearly from the window, and the
photometric score's exact gradient and Hessian are derived in closed form —
the same quantities ops/tracker.py gets from jax.grad/jacfwd.

Two implementations of one sweep:
  - :func:`newton_window_steps`, plain jnp: the reference, and the path on
    the CPU. The bilinear resampling is two banded products per iteration.
  - :func:`_kernel`, a Pallas kernel through Triton: one program per lane,
    the lane's whole Newton loop inside it, ending as soon as the lane is
    done. The patch is sampled directly from its four bilinear corners on
    a 16x16 tile (13x13 masked), so one launch replaces the per-iteration
    chain of small XLA kernels.

Semantics mirror ops/tracker.track_level exactly: margin OOB test per
iteration, Newton step d = -H^-1 g with unit-norm then per-component
clamp, convergence when both |d| < threshold, done lanes keep their
position, replicate-border patch clamping at window edges (the window is
flush with the level's padded edges whenever clamping bites, so the clamp
reproduces ops/patch.extract's), and validity masks from the raw
(unclamped) support coordinates.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

OK = 0.0
OUT_OF_BOUNDS = 2.0

_MARGIN = 0.01   # hessian.h:196
MARGIN_PX = 12   # window margin: 6 Newton px + 6 patch half + bilinear fits 32
_TILE = 16       # power-of-two tile holding the 13x13 patch in the kernel


def _mean2(a):
    """Mean over the last two axes."""
    return jnp.sum(a, axis=(-2, -1)) / (a.shape[-1] * a.shape[-2])


def _sum2(a):
    return jnp.sum(a, axis=(-2, -1))


def _banded_pair(frac, start, length: int, size: int):
    """[F, 2*size, length] stacked bilinear selection matrix: rows 0..S-1
    select at k = start[f]+i with weights (1-frac, frac); rows S..2S-1 are
    the derivative w.r.t. the fractional coordinate (-1, +1), so the
    interpolation and its derivative come from one batched product."""
    F = frac.shape[0]
    fr = frac[:, None, None]
    st = start[:, None, None]
    i2 = jax.lax.broadcasted_iota(jnp.int32, (F, 2 * size, length), 1)
    k = jax.lax.broadcasted_iota(jnp.int32, (F, 2 * size, length), 2)
    isd = i2 >= size
    i = jnp.where(isd, i2 - size, i2)
    w0 = jnp.where(isd, -1.0, 1.0 - fr)
    w1 = jnp.where(isd, 1.0, fr)
    return jnp.where(k == i + st, w0, 0.0) + jnp.where(k == i + st + 1, w1, 0.0)


def _bdot(a, b):
    # full f32: pixel values and bilinear weights, never TF32
    return jax.lax.dot_general(
        a, b, (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )


def _oob(x, y, width, height):
    return ((x < _MARGIN) | (y < _MARGIN)
            | (x + _MARGIN > width) | (y + _MARGIN > height))


def _newton_update(x, y, status, done, oob, fields, r_mean, r_sumsq,
                   threshold: float, mean, total, bc):
    """Newton step from the sampled patch (shared by both paths).

    ``fields`` = (patch, d/dx, d/dy, d2/dxdy, weight, reference). ``mean``
    and ``total`` reduce a per-pixel field per lane and ``bc`` broadcasts a
    per-lane value back over pixels: the XLA path works on [F,S,S] stacks,
    the kernel on one lane's tile.
    """
    eps = 1e-12
    p2, u, v, puv, w2, ref = fields

    m2 = mean(p2)
    ss2 = mean(p2 * p2)
    ss2s = jnp.maximum(ss2, eps)
    gate = (ss2 > eps).astype(jnp.float32)   # max() gradient gate
    m2x = mean(u)
    m2y = mean(v)
    m2xy = mean(puv)
    ss2x = 2.0 * mean(p2 * u) * gate
    ss2y = 2.0 * mean(p2 * v) * gate
    ss2xx = 2.0 * mean(u * u) * gate
    ss2yy = 2.0 * mean(v * v) * gate
    ss2xy = 2.0 * mean(u * v + p2 * puv) * gate

    alpha = jnp.sqrt(r_sumsq / ss2s)
    rx = ss2x / ss2s
    ry = ss2y / ss2s
    ax = -0.5 * alpha * rx
    ay = -0.5 * alpha * ry
    axx = -0.5 * (ax * rx + alpha * (ss2xx / ss2s - rx * rx))
    ayy = -0.5 * (ay * ry + alpha * (ss2yy / ss2s - ry * ry))
    axy = -0.5 * (ay * rx + alpha * (ss2xy / ss2s - rx * ry))

    bx = -ax * m2 - alpha * m2x
    by = -ay * m2 - alpha * m2y
    bxx = -axx * m2 - 2.0 * ax * m2x
    byy = -ayy * m2 - 2.0 * ay * m2y
    bxy = -axy * m2 - ax * m2y - ay * m2x - alpha * m2xy

    beta = r_mean - alpha * m2
    e = ref - bc(alpha) * p2 - bc(beta)
    ex = -bc(ax) * p2 - bc(alpha) * u - bc(bx)
    ey = -bc(ay) * p2 - bc(alpha) * v - bc(by)
    exx = -bc(axx) * p2 - 2.0 * bc(ax) * u - bc(bxx)
    eyy = -bc(ayy) * p2 - 2.0 * bc(ay) * v - bc(byy)
    exy = (
        -bc(axy) * p2 - bc(ax) * v - bc(ay) * u - bc(alpha) * puv - bc(bxy)
    )

    gx_ = 2.0 * total(w2 * e * ex)
    gy_ = 2.0 * total(w2 * e * ey)
    hxx = 2.0 * total(w2 * (ex * ex + e * exx))
    hyy = 2.0 * total(w2 * (ey * ey + e * eyy))
    hxy = 2.0 * total(w2 * (ex * ey + e * exy))

    det = hxx * hyy - hxy * hxy
    tiny = jnp.where(det >= 0, jnp.float32(1e-20), jnp.float32(-1e-20))
    safe = jnp.where(jnp.abs(det) > 1e-20, det, tiny)
    dx = -(hyy * gx_ - hxy * gy_) / safe
    dy = -(-hxy * gx_ + hxx * gy_) / safe
    finite = (jnp.abs(dx) < 1e20) & (jnp.abs(dy) < 1e20)
    dx = jnp.where(finite, dx, 0.0)
    dy = jnp.where(finite, dy, 0.0)

    n = jnp.sqrt(dx * dx + dy * dy)
    scale = jnp.where(n > 1.0, 1.0 / jnp.maximum(n, 1e-20), 1.0)
    dx = dx * scale
    dy = dy * scale
    sx = jnp.clip(dx, -1.0, 1.0)
    sy = jnp.clip(dy, -1.0, 1.0)

    converged = (jnp.abs(dx) < threshold) & (jnp.abs(dy) < threshold)

    move = (~oob) & (done < 0.5)
    new_x = jnp.where(move, x + sx, x)
    new_y = jnp.where(move, y + sy, y)
    new_status = jnp.where((done < 0.5) & oob, OUT_OF_BOUNDS, status)
    new_done = jnp.maximum(done, (oob | converged).astype(jnp.float32))
    return new_x, new_y, new_status, new_done


def _newton_iter(state, win, org, ref, ref_valid, r_mean, r_sumsq,
                 wmask, width, height, threshold: float, size: int):
    """One Newton step for all lanes (plain XLA). Done lanes pass through
    unchanged, so skipping an all-done iteration is bit-identical to
    running it."""
    F = win.shape[0]
    WH, WW = win.shape[1], win.shape[2]
    S = size
    half = (S - 1) // 2

    pos, status, done = state
    x, y = pos[:, 0], pos[:, 1]
    oob = _oob(x, y, width, height)

    # window-local patch support origin (raw ints for validity, clamped
    # for extraction — exactly ops/patch.extract's clamp)
    lx = x - org[:, 0]
    ly = y - org[:, 1]
    x0f = jnp.floor(lx)
    y0f = jnp.floor(ly)
    fx = lx - x0f
    fy = ly - y0f
    x0 = x0f.astype(jnp.int32) - half
    y0 = y0f.astype(jnp.int32) - half
    x0c = jnp.clip(x0, 0, WW - (S + 1))
    y0c = jnp.clip(y0, 0, WH - (S + 1))

    # one stacked product yields the patch and all its bilinear
    # derivatives: res = [row;drow] @ win @ [col,dcol]
    rowp = _banded_pair(fy, y0c, WH, S)                     # [F,2S,WH]
    colp = _banded_pair(fx, x0c, WW, S).transpose(0, 2, 1)  # [F,WW,2S]
    res = _bdot(_bdot(rowp, win), colp)                     # [F,2S,2S]
    p2 = res[:, :S, :S]        # patch
    u = res[:, :S, S:]         # dp2/dx
    v = res[:, S:, :S]         # dp2/dy
    puv = res[:, S:, S:]       # d2p2/dxdy (d2/dx2 = d2/dy2 = 0: bilinear)

    # validity of the moving patch from RAW support coords (extract's
    # rule: bilinear support inside the true image)
    gxi = jax.lax.broadcasted_iota(jnp.int32, (F, S), 1)
    gx = (x0 + org[:, 0].astype(jnp.int32))[:, None] + gxi
    gy = (y0 + org[:, 1].astype(jnp.int32))[:, None] + gxi
    vx = (gx >= 0) & (gx.astype(jnp.float32) + 1.0 <= width[:, None])
    vy = (gy >= 0) & (gy.astype(jnp.float32) + 1.0 <= height[:, None])
    valid2 = vy.astype(jnp.float32)[:, :, None] * vx.astype(jnp.float32)[:, None, :]
    w2 = wmask[None] * ref_valid * valid2    # [F,S,S]

    nx, ny, new_status, new_done = _newton_update(
        x, y, status, done, oob, (p2, u, v, puv, w2, ref), r_mean, r_sumsq,
        threshold, _mean2, _sum2, lambda s: s[:, None, None])
    return jnp.stack([nx, ny], -1), new_status, new_done


def newton_window_steps(
    win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active,
    wmask, bounds,
    threshold: float, max_iters: int, size: int,
):
    """Run ``max_iters`` Newton steps for all lanes against per-lane windows.

    win        [F, WH, WW] level pixels; window covers absolute level coords
               org[f] + (0..WH, 0..WW) (org may be negative: pad offset)
    pos0       [F, 2] absolute level-coords start (x, y)
    org        [F, 2] window origin (x, y) in absolute level coords
    ref*       reference patch stack data/valid/mean/sumsq for this level
    active     [F] f32 1/0
    bounds     [F, 2] true level extents (w, h) — runtime values so one
               compiled sweep serves every pyramid level of a window shape

    Returns (pos [F,2], status [F] f32, done [F] f32).
    """
    F = pos0.shape[0]
    width = bounds[:, 0]
    height = bounds[:, 1]

    pos = pos0
    status = jnp.zeros((F,), jnp.float32)
    done = 1.0 - active

    def body(_, state):
        return _newton_iter(
            state, win, org, ref, ref_valid, ref_mean, ref_sumsq,
            wmask, width, height, threshold, size,
        )

    pos, status, done = jax.lax.fori_loop(0, max_iters, body, (pos, status, done))

    x, y = pos[:, 0], pos[:, 1]
    status = jnp.where(_oob(x, y, width, height) & (active > 0.5),
                       OUT_OF_BOUNDS, status)
    return pos, status, done


# per-lane scalar slots of the kernel's packed lane table
_LANE = ("x", "y", "org_x", "org_y", "active", "r_mean", "r_sumsq",
         "width", "height")
_LANE_W = 16


def _kernel(win_ref, lane_ref, ref_ref, rv_ref, w_ref, out_ref, *,
            threshold, max_iters, size, wh, ww):
    """One lane's whole Newton loop. Inputs are flat: win [F*wh*ww],
    lane table [F*_LANE_W], ref/valid [F*S*S], weight [S*S]; out [F*4] =
    (x, y, status, 0). The loop stops at the lane's first done iteration —
    a done lane passes through an iteration unchanged, so this is the
    fixed-budget result exactly."""
    f = pl.program_id(0)
    S = size
    half = (S - 1) // 2
    T = _TILE
    i = lax.broadcasted_iota(jnp.int32, (T, T), 0)
    j = lax.broadcasted_iota(jnp.int32, (T, T), 1)
    inside = (i < S) & (j < S)

    def tile(ref, base, stride, row0, col0):
        # masked [T,T] gather; masked-out slots read a safe in-bounds index
        idx = jnp.where(inside, base + (row0 + i) * stride + col0 + j, 0)
        return jnp.where(inside, plgpu.load(ref.at[idx]), 0.0)

    lane = {k: lane_ref[f * _LANE_W + n] for n, k in enumerate(_LANE)}
    ref = tile(ref_ref, f * S * S, S, 0, 0)
    w2_static = tile(rv_ref, f * S * S, S, 0, 0) * tile(w_ref, 0, S, 0, 0)
    width, height = lane["width"], lane["height"]
    org_x, org_y = lane["org_x"], lane["org_y"]
    org_xi = org_x.astype(jnp.int32)
    org_yi = org_y.astype(jnp.int32)
    wbase = f * wh * ww

    def cond(c):
        return (c[0] < max_iters) & (c[4] < 0.5)

    def body(c):
        it, x, y, status, done = c
        oob = _oob(x, y, width, height)
        lx = x - org_x
        ly = y - org_y
        x0f = jnp.floor(lx)
        y0f = jnp.floor(ly)
        fx = lx - x0f
        fy = ly - y0f
        x0 = x0f.astype(jnp.int32) - half
        y0 = y0f.astype(jnp.int32) - half
        x0c = jnp.clip(x0, 0, ww - (S + 1))
        y0c = jnp.clip(y0, 0, wh - (S + 1))

        # the four bilinear corners of every patch pixel
        a = tile(win_ref, wbase, ww, y0c, x0c)
        b = tile(win_ref, wbase, ww, y0c, x0c + 1)
        cc = tile(win_ref, wbase, ww, y0c + 1, x0c)
        d = tile(win_ref, wbase, ww, y0c + 1, x0c + 1)
        p2 = (1.0 - fy) * ((1.0 - fx) * a + fx * b) \
            + fy * ((1.0 - fx) * cc + fx * d)
        u = (1.0 - fy) * (b - a) + fy * (d - cc)
        v = (1.0 - fx) * (cc - a) + fx * (d - b)
        puv = (d - cc) - (b - a)

        gx = x0 + org_xi + j
        gy = y0 + org_yi + i
        vx = (gx >= 0) & (gx.astype(jnp.float32) + 1.0 <= width)
        vy = (gy >= 0) & (gy.astype(jnp.float32) + 1.0 <= height)
        w2 = jnp.where(vx & vy, w2_static, 0.0)

        nx, ny, nst, nd = _newton_update(
            x, y, status, done, oob, (p2, u, v, puv, w2, ref),
            lane["r_mean"], lane["r_sumsq"], threshold,
            lambda a_: jnp.sum(a_) / (S * S), jnp.sum, lambda s: s)
        return it + 1, nx, ny, nst, nd

    active = lane["active"]
    _, x, y, status, _ = lax.while_loop(
        cond, body,
        (jnp.int32(0), lane["x"], lane["y"], jnp.float32(OK), 1.0 - active))
    status = jnp.where(_oob(x, y, width, height) & (active > 0.5),
                       OUT_OF_BOUNDS, status)
    k = lax.broadcasted_iota(jnp.int32, (4,), 0)
    out_ref[pl.ds(f * 4, 4)] = jnp.where(
        k == 0, x, jnp.where(k == 1, y, jnp.where(k == 2, status, 0.0)))


def newton_kernel(win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq,
                  active, wmask, bounds, *, threshold: float,
                  max_iters: int, size: int, interpret: bool = False):
    """The Triton sweep: same arguments and results as
    :func:`newton_window_steps` without ``done``. ``interpret`` runs the
    kernel in the Pallas interpreter (tests on the CPU only)."""
    F, WH, WW = win.shape
    S = int(size)
    if S > _TILE:
        raise ValueError(f"patch size {S} exceeds the kernel tile {_TILE}")
    lane = jnp.zeros((F, _LANE_W), jnp.float32)
    cols = (pos0[:, 0], pos0[:, 1], org[:, 0], org[:, 1], active,
            ref_mean, ref_sumsq, bounds[:, 0], bounds[:, 1])
    lane = lane.at[:, : len(cols)].set(jnp.stack(cols, -1))
    kern = functools.partial(
        _kernel, threshold=float(threshold), max_iters=int(max_iters),
        size=S, wh=WH, ww=WW,
    )
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((F * 4,), jnp.float32),
        grid=(F,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=2, num_stages=1),
        interpret=interpret,
        name="newton_level",
    )(
        win.reshape(-1), lane.reshape(-1), ref.reshape(-1),
        ref_valid.astype(jnp.float32).reshape(-1), wmask.reshape(-1),
    ).reshape(F, 4)
    return out[:, :2], out[:, 2]


@functools.partial(
    jax.jit, static_argnames=("threshold", "max_iters", "size", "backend"),
)
def newton_level(win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active,
                 wmask, bounds, threshold=0.001, max_iters=6,
                 size=13, backend="xla"):
    """Batched per-level Newton refinement. Returns (pos [F,2], status [F]).

    ``bounds`` [F,2]: the level's true (width, height) per lane.
    backend: "xla" (plain jnp), "triton" (the GPU kernel), "interpret"
    (the kernel in the Pallas interpreter, for CPU tests).
    """
    active = jnp.asarray(active, jnp.float32)
    bounds = jnp.asarray(bounds, jnp.float32)
    if backend == "xla":
        pos, status, _ = newton_window_steps(
            win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active,
            wmask, bounds, float(threshold), int(max_iters), int(size),
        )
        return pos, status
    if backend not in ("triton", "interpret"):
        raise ValueError(f"unknown Newton backend {backend!r}")
    return newton_kernel(
        win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active, wmask,
        bounds, threshold=threshold, max_iters=max_iters, size=size,
        interpret=(backend == "interpret"),
    )
