"""The plain XLA pyramid against an independent float64 numpy rebuild of
the reference recipe (reflect-101 borders, OpenCV's GaussianBlur/pyrDown)."""

import jax.numpy as jnp
import numpy as np
import pytest

from slam_robot_tpu.ops import pyramid as pyr
from slam_robot_tpu.utils import kernel_check as kc


@pytest.mark.parametrize("shape", [(48, 64), (480, 640)])
def test_blur_matches_numpy_reflect101(rng, shape):
    img = rng.uniform(size=shape).astype(np.float32)
    out = np.asarray(pyr.blur(jnp.asarray(img), 1.1))
    np.testing.assert_allclose(out, kc.np_blur(img, 1.1),
                               atol=kc.PYRAMID_TOL)


def test_blur_constant_preserved():
    img = np.full((32, 40), 0.7, np.float32)
    out = np.asarray(pyr.blur(jnp.asarray(img), 0.8))
    np.testing.assert_allclose(out, 0.7, atol=1e-6)


def test_pyr_down_matches_numpy_reflect101(rng):
    for h, w in ((48, 64), (47, 63), (480, 640)):
        img = rng.uniform(size=(h, w)).astype(np.float32)
        out = np.asarray(pyr.pyr_down(jnp.asarray(img)))
        ref = kc.np_pyr_down(img)
        assert out.shape == ref.shape == ((h + 1) // 2, (w + 1) // 2)
        np.testing.assert_allclose(out, ref, atol=kc.PYRAMID_TOL)


@pytest.mark.parametrize("shape", [(48, 64), (47, 63)])
def test_build_pyramid_matches_numpy(shape):
    assert kc.pyramid_error(*shape, depth=4) < kc.PYRAMID_TOL
