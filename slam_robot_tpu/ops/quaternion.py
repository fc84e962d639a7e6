"""Quaternion algebra, Eigen storage convention ``[x, y, z, w]``.

The reference stores frame rotations as Eigen quaternions and optimizes them
on the manifold with a sin/cos exponential-map retraction
(QuaternionParameterization::Plus, slam.cpp:30-50):

    q_plus_delta = exp(delta) * q,   exp(d) = [sin(|d|)/|d| * d, cos(|d|)]

We reproduce that convention exactly so pose solves behave the same way, but
as pure jnp functions usable under vmap/jacfwd. All functions take/return
arrays whose trailing axis is the quaternion (4,) or vector (3,) — they
broadcast over leading batch axes.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# numpy, NOT jnp: a module-level jnp.array initializes the JAX backend at
# import time — on CPU that freezes the device count BEFORE callers can set
# --xla_force_host_platform_device_count, forking XLA:CPU codegen (and
# therefore closed-loop trajectories) on import order. Measured: the
# production parity sequence read 2.69% vs 4.37% ATE purely on whether
# utils.dump was imported before run_sequence set the flag.
IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], dtype=np.float32)


def identity(dtype=jnp.float32):
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def normalize(q, eps: float = 1e-12):
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def conjugate(q):
    """Inverse for unit quaternions: negate the vector part."""
    return q * jnp.asarray([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype)


inverse = conjugate


def multiply(a, b):
    """Hamilton product a*b with xyzw storage (matches Eigen's operator*)."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return jnp.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def rotate(q, v):
    """Rotate vector v by unit quaternion q (Eigen's ``q * v``).

    Uses v' = v + 2 w (u x v) + 2 u x (u x v), u = q.vec().
    """
    u = q[..., :3]
    w = q[..., 3:4]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def rotate_inverse(q, v):
    return rotate(conjugate(q), v)


def to_matrix(q):
    """3x3 rotation matrix of a unit quaternion (xyzw)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def exp_map(delta, eps: float = 1e-12):
    """Tangent 3-vector -> unit quaternion, the ref's retraction kernel.

    exp(d) = [sin(|d|)/|d| * d, cos(|d|)] (slam.cpp:37-44). Safe at |d|=0
    (returns identity) and differentiable there via the sinc guard.
    """
    n2 = jnp.sum(delta * delta, axis=-1, keepdims=True)
    n = jnp.sqrt(jnp.maximum(n2, eps * eps))
    sinc = jnp.where(n2 > eps, jnp.sin(n) / n, 1.0 - n2 / 6.0)
    vec = sinc * delta
    w = jnp.where(n2 > eps, jnp.cos(n), 1.0 - n2 / 2.0)
    return jnp.concatenate([vec, w], axis=-1)


def retract(q, delta):
    """Manifold plus: exp(delta) * q, then renormalize for f32 drift."""
    return normalize(multiply(exp_map(delta), q))


def from_axis_angle(axis, angle):
    axis = axis / jnp.maximum(jnp.linalg.norm(axis, axis=-1, keepdims=True), 1e-12)
    half = 0.5 * jnp.asarray(angle)[..., None]
    return jnp.concatenate([axis * jnp.sin(half), jnp.cos(half)], axis=-1)


def angle_between(a, b):
    """Rotation angle of a * b^-1 — a distance on SO(3)."""
    d = jnp.abs(jnp.sum(a * b, axis=-1))
    return 2.0 * jnp.arccos(jnp.clip(d, 0.0, 1.0))
