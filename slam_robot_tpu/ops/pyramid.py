"""Gaussian image pyramids (hessian.h:95-126 semantics, fixed shapes).

Reference recipe per MakePyramid: grey f32/255, GaussianBlur 5x5 sigma=1.1 at
level 0; each further level is pyrDown (5x5 [1,4,6,4,1]/16 binomial filter +
2x decimation to size (n+1)/2) followed by GaussianBlur 5x5 sigma=0.8.

Layout choices:
- convolutions are separable 5-tap shifted-slice sums XLA fuses
- the pyramid is stored FLAT: one [L, H0+2*PAD, W0+2*PAD] array with level
  l's (edge-padded) image in the top-left corner and its true size in
  ``heights/widths``. Uniform level shapes mean the coarse-to-fine tracker
  loop is a single traced ``lax.fori_loop`` body with a dynamic level
  index — 6x less tracing/compiling than unrolled per-level shapes.
- edge padding by ``PAD`` gives getRectSubPix's replicate-border semantics
  to a plain dynamic-slice in the patch extractor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# Padding around every pyramid level. Must cover half a patch (6 for 13x13)
# plus one pixel of bilinear support plus the tracker's max single-step
# excursion; 8 is enough and keeps the lane dimension friendly.
PAD = 8


@jax.tree_util.register_pytree_node_class
class FlatPyramid:
    """Edge-padded pyramid stack.

    data [L(*V), H0+2*PAD, W0+2*PAD]; per-entry true sizes in
    heights/widths. ``offset`` is a (possibly traced) base index into the
    leading axis, letting several pyramids live stacked in one array (the
    matcher's view ring) and be selected per lane without gathering whole
    images. ``depth_`` (static) is the level count of one pyramid.
    """

    def __init__(self, data, heights, widths, depth_: int = 0, offset=0):
        self.data = data
        self.heights = heights
        self.widths = widths
        self.depth_ = int(depth_)
        self.offset = offset

    def tree_flatten(self):
        return (self.data, self.heights, self.widths, self.offset), self.depth_

    @classmethod
    def tree_unflatten(cls, depth_, children):
        data, heights, widths, offset = children
        return cls(data, heights, widths, depth_, offset)

    @property
    def depth(self) -> int:
        return self.depth_ or self.data.shape[0]

    def level(self, i):
        """(image2d, width, height) for a (possibly traced) level index.

        Materializes one level image — fine when i is scalar per call site.
        Inside per-lane vmapped code prefer :meth:`level_ref`, which keeps
        the stack unsliced so patch extraction can fold the index into its
        dynamic_slice."""
        j = self.offset + i
        return self.data[j], self.widths[j], self.heights[j]

    def level_ref(self, i):
        """(stack3d, index, width, height) — no image materialization."""
        j = self.offset + i
        return self.data, j, self.widths[j], self.heights[j]


def level_dims(height: int, width: int, depth: int) -> tuple[tuple[int, int], ...]:
    dims = [(height, width)]
    for _ in range(1, depth):
        h, w = dims[-1]
        dims.append(((h + 1) // 2, (w + 1) // 2))
    return tuple(dims)


def to_grey(img) -> jnp.ndarray:
    """RGB (or already-grey) uint8/f32 -> grey f32 in [0,1].

    Uses the CV_RGB2GRAY weights (0.299, 0.587, 0.114) the reference's
    cvtColor applies (hessian.h:100).
    """
    img = jnp.asarray(img)
    if img.dtype == jnp.uint8:
        img = img.astype(jnp.float32) / 255.0
    if img.ndim == 3:
        w = jnp.array([0.299, 0.587, 0.114], img.dtype)
        img = img @ w
    return img


def gaussian_kernel(sigma: float, size: int = 5) -> jnp.ndarray:
    """OpenCV getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), normalized."""
    i = jnp.arange(size, dtype=jnp.float32) - (size - 1) / 2.0
    k = jnp.exp(-(i * i) / (2.0 * sigma * sigma))
    return k / jnp.sum(k)


def _taps(terms):
    """Sum of the five tap products as t4 + ((t0 + t1) + (t2 + t3)), each
    product rounded to f32 first: the association and rounding of
    XLA:CPU's convolution, so CPU results (and the golden trajectories
    built on them) stay bit-identical to the conv form this replaced. The
    NaN-preserving select only stops the CPU compiler from contracting a
    product and a sum into one fused multiply-add."""
    t0, t1, t2, t3, t4 = (jnp.where(jnp.isnan(t), jnp.nan, t) for t in terms)
    return t4 + ((t0 + t1) + (t2 + t3))


def _sep_conv(img, kernel1d, stride: int = 1):
    """Separable 5-tap correlation with reflect-101 border (OpenCV
    default), sampled every ``stride`` pixels from pixel 0, as shifted
    static slices. On the GPU each pass fuses into one elementwise kernel
    (a single-channel conv_general_dilated measured 3.6x slower for the
    pyramid, PERF.md)."""
    k = jnp.asarray(kernel1d, jnp.float32)
    assert k.shape == (5,), "5-tap kernels only"
    h, w = img.shape
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = jnp.pad(img, ((2, 2), (2, 2)), mode="reflect")
    rows = _taps([k[i] * x[i:i + (ho - 1) * stride + 1:stride, :]
                  for i in range(5)])
    return _taps([k[j] * rows[:, j:j + (wo - 1) * stride + 1:stride]
                  for j in range(5)])


def blur(img, sigma: float, size: int = 5):
    return _sep_conv(img, gaussian_kernel(sigma, size))


# numpy, NOT jnp: a module-level jnp constant initializes the backend at
# import, which freezes the CPU virtual-device count before flags are set
# (see ops/quaternion.IDENTITY)
_PYRDOWN_K = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img):
    """OpenCV pyrDown: binomial 5x5 + 2x decimation to size (n+1)//2."""
    return _sep_conv(img, _PYRDOWN_K, stride=2)


def _edge_pad(img, pad: int = PAD):
    return jnp.pad(img, ((pad, pad), (pad, pad)), mode="edge")


@functools.partial(jax.jit, static_argnames=("depth", "sigma0", "sigma_down"))
def build_pyramid(img, depth: int = 6, sigma0: float = 1.1, sigma_down: float = 0.8
                  ) -> FlatPyramid:
    """Full MakePyramid as a FlatPyramid. Level sizes are static functions
    of the input shape, so the pipeline compiles once per resolution."""
    g = to_grey(img)
    g = blur(g, sigma0)
    levels = [g]
    for _ in range(1, depth):
        g = blur(pyr_down(g), sigma_down)
        levels.append(g)

    h0, w0 = levels[0].shape
    dims = level_dims(h0, w0, depth)
    flat = jnp.zeros((depth, h0 + 2 * PAD, w0 + 2 * PAD), jnp.float32)
    for l, img_l in enumerate(levels):
        hl, wl = dims[l]
        flat = flat.at[l, : hl + 2 * PAD, : wl + 2 * PAD].set(_edge_pad(img_l))
    return FlatPyramid(
        data=flat,
        heights=jnp.asarray([d[0] for d in dims], jnp.int32),
        widths=jnp.asarray([d[1] for d in dims], jnp.int32),
        depth_=depth,
    )
