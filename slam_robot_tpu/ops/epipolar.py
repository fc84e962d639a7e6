"""Essential matrix and epipolar residuals.

Matches localmap.cpp:215-229 (EssentialMatrix) and the residual used by
ApplyEpipolarConstraint (localmap.cpp:253-262): for two frames (q1,t1) ->
(q2,t2), E = R_rel * skew(normalize(t2 - t1)) with R_rel = R2 * R1^-1, and
the residual for plane points h1, h2 (z=1 homogenized) is r = h2^T E h1.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from slam_robot_tpu.ops import quaternion as quat

# These are 3x3 products feeding outlier thresholds at 1e-3 scale; a
# reduced-precision default matmul (TF32 on the GPU) is not accurate
# enough, so pin full f32.
_HI = jax.lax.Precision.HIGHEST


def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = jnp.zeros_like(x)
    m = jnp.stack([o, -z, y, z, o, -x, -y, x, o], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def essential_matrix(q1, t1, q2, t2, eps: float = 1e-12):
    """E = R2 R1^-1 skew(t_hat), t_hat = normalize(t2 - t1) (localmap.cpp:215-229)."""
    r_rel = quat.to_matrix(quat.multiply(q2, quat.conjugate(q1)))
    t = t2 - t1
    t = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), eps)
    return jnp.matmul(r_rel, skew(t), precision=_HI)


def epipolar_residual(e, plane1, plane2):
    """r = h2^T E h1 with h = [x, y, 1] (localmap.cpp:253-262)."""
    h1 = jnp.concatenate([plane1, jnp.ones_like(plane1[..., :1])], axis=-1)
    h2 = jnp.concatenate([plane2, jnp.ones_like(plane2[..., :1])], axis=-1)
    return jnp.einsum("...i,...ij,...j->...", h2, e, h1, precision=_HI)


def epipolar_residual_frames(q1, t1, q2, t2, plane1, plane2):
    return epipolar_residual(essential_matrix(q1, t1, q2, t2), plane1, plane2)
