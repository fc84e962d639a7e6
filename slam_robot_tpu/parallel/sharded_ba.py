"""Sharded bundle adjustment: the observation table split across devices.

The heavy part of every BA iteration is per-observation work — residuals,
Jacobians, and the scatter-add of small blocks into the landmark systems
and the reduced camera system. That axis is embarrassingly parallel, so the
scaling recipe (scaling-book style) is:

    mesh axis 'model' <- observation rows
    replicate         <- frame/point parameters (small)
    XLA inserts psum  <- the scatter-adds reduce across shards

``solve_sharded`` does exactly that with sharding annotations on the jitted
ba.solve — the SPMD partitioner turns our .at[].add into
all-reduced partial sums. No hand-written collectives needed; the explicit
shard_map variant ``assemble_partials`` exists for tests/inspection and for
meshes where manual control beats the partitioner.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from slam_robot_tpu.ops import ba

# full f32 for geometry: a reduced-precision default (TF32 on the GPU)
# would quantize residuals and Jacobians
_HI = jax.lax.Precision.HIGHEST


def solve_sharded(
    mesh: Mesh,
    frame_quat, frame_trans, frame_cam, cam_k,
    point_loc, point_uncertainty,
    obs_frame, obs_point, obs_px, obs_ok,
    present, free_frame,
    cfg: ba.BAConfig = ba.BAConfig(),
    obs_axis: str = "model",
) -> ba.BAResult:
    """ba.solve with the observation table sharded over ``obs_axis``.

    Observation arrays must have length divisible by the axis size (pad
    with obs_ok=False rows). Everything else is replicated; point arrays
    may also be sharded over a second axis by the partitioner if it helps.
    """
    osh = NamedSharding(mesh, P(obs_axis))
    rep = NamedSharding(mesh, P())

    put = jax.device_put
    args = (
        put(frame_quat, rep), put(frame_trans, rep), put(frame_cam, rep),
        put(cam_k, rep), put(point_loc, rep), put(point_uncertainty, rep),
        put(obs_frame, osh), put(obs_point, osh), put(obs_px, osh),
        put(obs_ok, osh), put(present, rep), put(free_frame, rep),
    )
    return ba.solve(*args, cfg)


def assemble_partials(mesh: Mesh, obs_r, obs_w, obs_jf, obs_jp,
                      obs_point, obs_slot, n_points: int, n_slots: int,
                      obs_axis: str = "model"):
    """Explicit shard_map demonstration of the same reduction: each device
    assembles blocks from its observation shard, then psums.

    Inputs are per-observation residuals [O,2], weights [O], frame/point
    Jacobians [O,2,6]/[O,2,4], indices. Returns (Hff[W,6,6], bf[W,6],
    C[P,4,4], bp[P,4]) — identical to what the annotated path produces.
    """
    from jax import shard_map

    def local(r, w, jf, jp, pidx, slot):
        hff = jnp.zeros((n_slots + 1, 6, 6)).at[slot].add(
            jnp.einsum("oia,oib,o->oab", jf, jf, w, precision=_HI), mode="drop")[:n_slots]
        bf = jnp.zeros((n_slots + 1, 6)).at[slot].add(
            -jnp.einsum("oia,oi->oa", jf, w[:, None] * r, precision=_HI), mode="drop")[:n_slots]
        c = jnp.zeros((n_points, 4, 4)).at[pidx].add(
            jnp.einsum("oia,oib,o->oab", jp, jp, w, precision=_HI), mode="drop")
        bp = jnp.zeros((n_points, 4)).at[pidx].add(
            -jnp.einsum("oia,oi->oa", jp, w[:, None] * r, precision=_HI), mode="drop")
        return (
            jax.lax.psum(hff, obs_axis),
            jax.lax.psum(bf, obs_axis),
            jax.lax.psum(c, obs_axis),
            jax.lax.psum(bp, obs_axis),
        )

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(obs_axis), P(obs_axis), P(obs_axis), P(obs_axis),
                  P(obs_axis), P(obs_axis)),
        out_specs=(P(), P(), P(), P()),
    )
    return fn(obs_r, obs_w, obs_jf, obs_jp, obs_point, obs_slot)
