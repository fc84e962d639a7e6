"""Kernel-versus-reference checks at real widths.

Two checks, each run by ``chip_smoke.py`` on the card and by the card-only
tests (``pytest -m gpu``); the CPU tests run them at small sizes:

- :func:`pyramid_error`: ``ops/pyramid.build_pyramid`` against
  :func:`np_build_pyramid`, an independent float64 numpy rebuild of the
  reference recipe (reflect-101 borders, as OpenCV's GaussianBlur/pyrDown).
- :func:`newton_errors`: one Newton level sweep through a chosen backend
  against the plain XLA sweep, on windows and reference patches cut by the
  tracker's own gathers from a textured frame pair, at every level of the
  pyramid.
"""

from __future__ import annotations

import numpy as np

# tolerances: the pyramid is a handful of f32 taps per pixel; Newton
# positions must agree within the tracker's convergence threshold
# (SlamConfig.track_threshold), with identical status on every lane
PYRAMID_TOL = 1e-5
NEWTON_TOL_PX = 1e-3


def _gauss(sigma: float, size: int = 5) -> np.ndarray:
    i = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(i * i) / (2.0 * sigma * sigma))
    return k / k.sum()


def _sep_correlate(img, k, stride: int = 1):
    """Separable correlation with reflect-101 borders, sampled every
    ``stride`` pixels from pixel 0 (pyrDown's (n+1)//2 output)."""
    r = len(k) // 2
    x = np.pad(np.asarray(img, np.float64), r, mode="reflect")
    h, w = img.shape
    rows = sum(k[i] * x[i:i + h, :] for i in range(len(k)))
    out = sum(k[j] * rows[:, j:j + w] for j in range(len(k)))
    return out[::stride, ::stride]


def np_blur(img, sigma: float) -> np.ndarray:
    """GaussianBlur 5x5 (reflect-101) in float64."""
    return _sep_correlate(img, _gauss(sigma))


def np_pyr_down(img) -> np.ndarray:
    """pyrDown: binomial [1,4,6,4,1]/16 in both axes, every second pixel."""
    return _sep_correlate(img, np.array([1, 4, 6, 4, 1], np.float64) / 16.0, 2)


def np_build_pyramid(grey, depth: int = 6, sigma0: float = 1.1,
                     sigma_down: float = 0.8, pad: int = 8) -> np.ndarray:
    """The flat edge-padded [depth, H+2p, W+2p] layout of build_pyramid."""
    g = np_blur(grey, sigma0)
    h0, w0 = g.shape
    flat = np.zeros((depth, h0 + 2 * pad, w0 + 2 * pad))
    for lvl in range(depth):
        if lvl:
            g = np_blur(np_pyr_down(g), sigma_down)
        hl, wl = g.shape
        flat[lvl, :hl + 2 * pad, :wl + 2 * pad] = np.pad(g, pad, mode="edge")
    return flat


def textured_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Multi-scale random texture that tracking locks onto at every level:
    fine noise plus blurred 16-px blocks, in [0, 1]."""
    rng = np.random.default_rng(seed)
    fine = np_blur(rng.uniform(size=(h, w)), 2.0)
    coarse = rng.uniform(size=(h // 16 + 1, w // 16 + 1))
    coarse = np.kron(coarse, np.ones((16, 16)))[:h, :w]
    return (0.5 * fine + 0.5 * np_blur(coarse, 3.0)).astype(np.float32)


def shifted(img, dx: float, dy: float) -> np.ndarray:
    """Bilinear resample so features move by (+dx, +dy)."""
    h, w = img.shape
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    xs = np.clip(x - dx, 0, w - 1.001)
    ys = np.clip(y - dy, 0, h - 1.001)
    x0, y0 = xs.astype(int), ys.astype(int)
    fx, fy = xs - x0, ys - y0
    out = ((1 - fy) * (1 - fx) * img[y0, x0] + (1 - fy) * fx * img[y0, x0 + 1]
           + fy * (1 - fx) * img[y0 + 1, x0] + fy * fx * img[y0 + 1, x0 + 1])
    return out.astype(np.float32)


def pyramid_error(h: int = 480, w: int = 640, depth: int = 6,
                  seed: int = 0) -> float:
    """Max |build_pyramid - numpy reference| over every level and pad."""
    import jax.numpy as jnp

    from slam_robot_tpu.ops import pyramid

    img = np.random.default_rng(seed).uniform(size=(h, w)).astype(np.float32)
    got = np.asarray(pyramid.build_pyramid(jnp.asarray(img), depth=depth).data)
    return float(np.max(np.abs(got - np_build_pyramid(img, depth))))


def newton_errors(backend: str, h: int = 480, w: int = 640, depth: int = 6,
                  lanes: int = 256, max_iters: int = 6, seed: int = 0):
    """Per level: (level, (h, w), max position error px, lanes over
    NEWTON_TOL_PX, lanes whose status differs) of ``backend`` against the
    plain XLA sweep."""
    import jax.numpy as jnp

    from slam_robot_tpu.ops import patch as patch_ops
    from slam_robot_tpu.ops import tracker_fused as tf
    from slam_robot_tpu.ops.pallas import newton
    from slam_robot_tpu.ops.pyramid import PAD, build_pyramid, level_dims

    S = 13
    weight = patch_ops.radial_mask(S)
    a = textured_frame(h, w, seed)
    b = shifted(a, 2.6, -1.7)
    pa = build_pyramid(jnp.asarray(a), depth=depth)
    pb = build_pyramid(jnp.asarray(b), depth=depth)
    rng = np.random.default_rng(seed + 1)
    # level-0 feature locations, a few of them near or past the border so
    # the out-of-bounds path runs too
    pts = np.stack([rng.uniform(-4, w + 4, lanes),
                    rng.uniform(-4, h + 4, lanes)], -1).astype(np.float32)
    pts = jnp.asarray(pts)
    active = jnp.asarray(rng.uniform(size=lanes) > 0.05, jnp.float32)
    offs = jnp.zeros((lanes,), jnp.int32)
    out = []
    for lvl, (hl, wl) in enumerate(level_dims(h, w, depth)):
        wh, ww = min(tf.WIN, hl + 2 * PAD), min(tf.WIN, wl + 2 * PAD)
        pos = pts / (2.0 ** lvl)
        win, org = tf._gather_windows(pb, lvl, pos, wh, ww)
        ref = tf._extract_refs(pa, lvl, pts, offs, S)
        bounds = jnp.broadcast_to(jnp.asarray([float(wl), float(hl)]),
                                  (lanes, 2))
        args = (win, pos, org, ref.data, ref.valid.astype(jnp.float32),
                ref.mean, ref.sumsq, active, weight, bounds)
        kw = dict(threshold=NEWTON_TOL_PX, max_iters=max_iters, size=S)
        p_ref, s_ref = newton.newton_level(*args, backend="xla", **kw)
        p_got, s_got = newton.newton_level(*args, backend=backend, **kw)
        err = np.abs(np.asarray(p_got) - np.asarray(p_ref)).max(axis=1)
        out.append((lvl, (hl, wl), float(err.max()),
                    int((err > NEWTON_TOL_PX).sum()),
                    int((np.asarray(s_got) != np.asarray(s_ref)).sum())))
    return out
