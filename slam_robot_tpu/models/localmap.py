"""The world model: a fixed-capacity, mask-based, struct-of-arrays map state.

This is the fixed-shape rebuild of the reference's LocalMap/Frame/TrackedPoint/
Observation object graph (localmap.{h,cpp}). Pointers become integer indices,
growable vectors become fixed-capacity arrays with fill counters, and every
mutation is a pure function ``MapState -> MapState`` that jits and vmaps.

Layout
------
- cameras:      k[C,7] intrinsics + saved kinit (localmap.h:28-36)
- frames:       quat[F,4] (xyzw), trans[F,3], camera index, keyframe bit,
                per-frame observation start offset (append-only obs table)
- points:       homogeneous location[P,4], uncertainty[P] (init 1e8,
                localmap.h:177-182), flag bitmask (localmap.h:184-190)
- observations: one flat append-only table (frame idx, point idx, pixel,
                disabled bit, cached reprojection error) replacing the
                reference's dual ownership (Frame owns Observation,
                TrackedPoint caches pointers, localmap.h:146+198)
- per-point cache: a ring of observation-table indices per point
                (``point_obs``), giving the reference's negative-index
                accessor observation(-i) (localmap.h:205-218) in O(1)

Capacity semantics: per-point rings keep the most recent
``max_obs_per_point`` observations; statistics that the reference takes over
a point's full history (Clean's avg error, localmap.cpp:351) are taken over
the ring window here. The flat obs table itself is not windowed.

Flag machine: NO_OBSERVATIONS / NO_BASELINE are *clear-only* derived flags
exactly like the reference's CheckFlags (localmap.cpp:44-84): they are set at
AddPoint (localmap.cpp:106-112) and re-set for changed points in Clean
(localmap.cpp:389-395), and cleared when evidence accumulates.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.ops import projection as proj
from slam_robot_tpu.ops import quaternion as quat
from slam_robot_tpu.ops import epipolar as epi

# ---- point flag bits (localmap.h:184-190) ----
BAD_LOCATION = 1 << 0   # too close to a frame origin => entirely unusable
NO_BASELINE = 1 << 1    # insufficient baseline => not (yet) usable for SLAM
NO_OBSERVATIONS = 1 << 2  # insufficient usable observations
MISMATCHED = 1 << 3     # recent mis-matched obs => detach from visual feature
BAD_FEATURE = 1 << 4    # persistent fitting error => suppress from SLAM

_SLAM_BAD = BAD_LOCATION | NO_BASELINE | NO_OBSERVATIONS | BAD_FEATURE
_FEATURE_BAD = MISMATCHED | BAD_LOCATION


def slam_usable(flags):
    """localmap.h:242-248."""
    return (flags & _SLAM_BAD) == 0


def feature_usable(flags):
    """localmap.h:249."""
    return (flags & _FEATURE_BAD) == 0


class MapState(NamedTuple):
    # cameras
    cam_k: jnp.ndarray        # [C, 7] k1,k2,k3,fx,fy,cx,cy
    cam_k_init: jnp.ndarray   # [C, 7]
    # frames
    frame_quat: jnp.ndarray   # [F, 4] xyzw
    frame_trans: jnp.ndarray  # [F, 3] camera position in world
    frame_cam: jnp.ndarray    # [F] int32 camera index
    frame_keyframe: jnp.ndarray  # [F] bool
    frame_obs_start: jnp.ndarray  # [F] int32: n_obs when the frame was added
    n_frames: jnp.ndarray     # int32 scalar
    # points
    point_loc: jnp.ndarray    # [P, 4] homogeneous world location
    point_uncertainty: jnp.ndarray  # [P] f32
    point_flags: jnp.ndarray  # [P] int32 bitmask
    point_free: jnp.ndarray   # [P] bool: slot evicted and reusable. The
                              # reference's point vector grows unboundedly
                              # (C++ heap); the fixed table's equivalent is
                              # pressure-triggered eviction of dead/stale
                              # slots (add_points), without which the map
                              # saturates and the matcher starves (seed-1
                              # keyframe-storm collapse, PERF.md finding 41)
    n_points: jnp.ndarray     # int32 scalar HIGH-WATER mark (monotone);
                              # live count = sum(point_mask)
    # flat observation table
    obs_frame: jnp.ndarray    # [O] int32
    obs_point: jnp.ndarray    # [O] int32
    obs_px: jnp.ndarray       # [O, 2] f32 pixel coordinates
    obs_disabled: jnp.ndarray  # [O] bool
    obs_err: jnp.ndarray      # [O, 2] f32 cached reprojection error
    obs_err_valid: jnp.ndarray  # [O] bool: True iff obs_err holds a genuine
                              # reprojection error (written by reproject for
                              # rows passing the cheirality test); False for
                              # never-reprojected rows and cheirality-fail
                              # sentinels. Kills the err==px / err==0 value
                              # aliasing mean_obs_error / normalize_canary
                              # used to rely on
    obs_slot: jnp.ndarray     # [O] int32 ring slot this row occupies in its
                              # point's ring (-1 = never appended); lets the
                              # clean disable sync run ring->flat as ONE
                              # [O]-row gather instead of a [P,R] scatter
    n_obs: jnp.ndarray        # int32 scalar
    # per-point ring of obs-table indices
    point_obs: jnp.ndarray    # [P, R] int32 (ring; slot = total % R)
    point_obs_total: jnp.ndarray  # [P] int32 lifetime obs count per point
    # ring-layout MIRRORS of per-obs fields the maintenance passes read
    # every frame. A [P,R]-shaped element gather from the obs table is a
    # latency-bound gather per field per call site; these are
    # written in ring layout at the same time the obs row is written, so
    # clean/refresh/epipolar read them for free. Invariant (tested):
    # for live slots, ring_frame[p,k] == obs_frame[point_obs[p,k]] and
    # ring_disabled[p,k] == obs_disabled[point_obs[p,k]].
    ring_frame: jnp.ndarray   # [P, R] int32
    ring_disabled: jnp.ndarray  # [P, R] bool

    # ---- derived helpers ----
    @property
    def frame_mask(self):
        return jnp.arange(self.frame_quat.shape[0]) < self.n_frames

    @property
    def point_mask(self):
        return (jnp.arange(self.point_loc.shape[0]) < self.n_points) \
            & ~self.point_free

    @property
    def obs_mask(self):
        return jnp.arange(self.obs_frame.shape[0]) < self.n_obs

    @property
    def ring_size(self):
        return self.point_obs.shape[1]

    def point_position(self):
        return proj.point_position(self.point_loc)

    def point_ring_count(self):
        """Number of observations available in each point's ring."""
        return jnp.minimum(self.point_obs_total, self.ring_size)

    def recent_obs_index(self, i: int | jnp.ndarray):
        """Obs-table index of observation(-i) per point (localmap.h:205-218).

        i=1 is the most recent. Returns -1 where unavailable.
        """
        total = self.point_obs_total
        slot = jnp.mod(total - i, self.ring_size)
        idx = jax.vmap(lambda row, s: row[s])(self.point_obs, slot)
        ok = (total >= i) & (i >= 1) & (i <= self.point_ring_count())
        return jnp.where(ok, idx, -1)


def empty(cfg: SlamConfig) -> MapState:
    f32 = jnp.float32
    C, F, P, O, R = (
        cfg.num_cameras,
        cfg.max_frames,
        cfg.max_points,
        cfg.max_obs,
        cfg.max_obs_per_point,
    )
    return MapState(
        cam_k=jnp.zeros((C, 7), f32),
        cam_k_init=jnp.zeros((C, 7), f32),
        frame_quat=jnp.tile(jnp.array([0, 0, 0, 1], f32), (F, 1)),
        frame_trans=jnp.zeros((F, 3), f32),
        frame_cam=jnp.zeros((F,), jnp.int32),
        frame_keyframe=jnp.zeros((F,), bool),
        frame_obs_start=jnp.zeros((F,), jnp.int32),
        n_frames=jnp.int32(0),
        point_loc=jnp.tile(jnp.array([0, 0, 1, 1], f32), (P, 1)),
        point_uncertainty=jnp.full((P,), 1e8, f32),
        point_flags=jnp.zeros((P,), jnp.int32),
        point_free=jnp.zeros((P,), bool),
        n_points=jnp.int32(0),
        obs_frame=jnp.full((O,), -1, jnp.int32),
        obs_point=jnp.full((O,), -1, jnp.int32),
        obs_px=jnp.zeros((O, 2), f32),
        obs_disabled=jnp.zeros((O,), bool),
        obs_err=jnp.zeros((O, 2), f32),
        obs_err_valid=jnp.zeros((O,), bool),
        obs_slot=jnp.full((O,), -1, jnp.int32),
        n_obs=jnp.int32(0),
        point_obs=jnp.full((P, R), -1, jnp.int32),
        point_obs_total=jnp.zeros((P,), jnp.int32),
        ring_frame=jnp.full((P, R), -1, jnp.int32),
        ring_disabled=jnp.zeros((P, R), bool),
    )


def set_camera(state: MapState, idx: int, k) -> MapState:
    """AddCamera + Reset (localmap.cpp:101-104, localmap.h:32-36)."""
    k = jnp.asarray(k, state.cam_k.dtype)
    return state._replace(
        cam_k=state.cam_k.at[idx].set(k),
        cam_k_init=state.cam_k_init.at[idx].set(k),
    )


def reset_cameras(state: MapState) -> MapState:
    return state._replace(cam_k=state.cam_k_init)


def add_frame(state: MapState, cam_idx, q=None, t=None) -> tuple[MapState, jnp.ndarray]:
    """Append a frame (localmap.cpp:93-99). Returns (state, frame_idx)."""
    i = state.n_frames
    q = quat.identity() if q is None else q
    t = jnp.zeros(3, state.frame_trans.dtype) if t is None else t
    return (
        state._replace(
            frame_quat=state.frame_quat.at[i].set(q),
            frame_trans=state.frame_trans.at[i].set(t),
            frame_cam=state.frame_cam.at[i].set(jnp.int32(cam_idx)),
            frame_keyframe=state.frame_keyframe.at[i].set(False),
            frame_obs_start=state.frame_obs_start.at[i].set(state.n_obs),
            n_frames=i + 1,
        ),
        i,
    )


def set_frame_pose(state: MapState, idx, q, t) -> MapState:
    return state._replace(
        frame_quat=state.frame_quat.at[idx].set(q),
        frame_trans=state.frame_trans.at[idx].set(t),
    )


def evict_points(state: MapState, deficit, referenced=None,
                 retain_frames: int = 40) -> MapState:
    """Free up to ``deficit`` point slots under capacity pressure.

    The reference's point vector grows unboundedly (localmap.h:317-319 —
    C++ heap); a fixed-capacity table must reclaim slots or the matcher
    starves once the map saturates: measured on the bench's seed-1 draw,
    the table filled at frame 111 and the tail collapsed into a permanent
    keyframe storm (28 kf in 32 frames, 50 live lanes, matches pinned
    under min_matches — PERF.md finding 41). Eviction order:

    1. DEAD points first: not feature-usable (matcher permanently dropped
       them — MISMATCHED/BAD_LOCATION are never cleared) AND not
       slam-usable (contribute nothing to any solve).
    2. then STALE points (LRU): newest ring observation older than
       ``retain_frames`` frames — healthy landmarks that left the view
       long ago. ``retain_frames`` must cover the widest presented window
       (solve_xslow[1]) so no evicted row could still feed a solve.

    Points named in ``referenced`` (live matcher lanes) are never evicted.
    Evicted slots set ``point_free``; their obs-table rows are RETIRED:
    obs_point -> -1, disabled, obs_err_valid cleared (reproject freezes
    and excludes them). Nothing is evicted when ``deficit`` <= 0, so the
    behavior below capacity is bit-identical to no-eviction.
    """
    P = state.point_loc.shape[0]
    flags = state.point_flags
    dead = ~feature_usable(flags) & ~slam_usable(flags)
    last_obs = jnp.max(state.ring_frame, axis=1)  # -1 = never observed
    stale = last_obs < (state.n_frames - retain_frames)
    cand = state.point_mask & (dead | stale)
    if referenced is not None:
        cand = cand & ~referenced
    # dead before stale; older last-obs first within each class
    score = jnp.where(
        cand,
        dead.astype(jnp.float32) * 1e9
        + (state.n_frames - last_obs).astype(jnp.float32),
        -jnp.inf,
    )
    order = jnp.argsort(-score)
    take = (jnp.arange(P) < deficit) & (score[order] > -jnp.inf)
    evict = jnp.zeros(P, bool).at[order].set(take)

    retired = (
        evict[state.obs_point.clip(0)] & (state.obs_point >= 0)
        & state.obs_mask
    )
    return state._replace(
        point_free=state.point_free | evict,
        obs_point=jnp.where(retired, -1, state.obs_point),
        obs_disabled=state.obs_disabled | retired,
        obs_err_valid=state.obs_err_valid & ~retired,
        ring_disabled=state.ring_disabled | evict[:, None],
    )


def add_points(state: MapState, locs, valid, referenced=None,
               evict_retain: int = 0) -> tuple[MapState, jnp.ndarray]:
    """Batched AddPoint (localmap.cpp:106-112). Returns (state, point_idx[K]).

    New points get flags NO_OBSERVATIONS|NO_BASELINE and uncertainty 1e8.
    ``valid`` masks which of the K candidate rows are real; invalid rows get
    index -1 and consume no capacity.

    Allocation takes evicted (``point_free``) slots first in index order,
    then the append region — identical to pure appending while no slot has
    ever been freed. With ``evict_retain`` > 0, a call that would overflow
    the table first reclaims dead/stale slots via :func:`evict_points`
    (never slots in ``referenced``); 0 disables eviction (non-matcher
    callers and reference-exact replays never saturate).
    """
    locs = jnp.asarray(locs)
    valid = jnp.asarray(valid, bool)
    P = state.point_loc.shape[0]

    if evict_retain:
        n_avail = (
            jnp.sum(state.point_free.astype(jnp.int32)) + P - state.n_points
        )
        deficit = jnp.sum(valid.astype(jnp.int32)) - n_avail
        state = evict_points(state, deficit, referenced, evict_retain)

    avail = state.point_free | (jnp.arange(P) >= state.n_points)
    n_avail = jnp.sum(avail.astype(jnp.int32))
    slot_order = jnp.argsort(~avail)  # available slots first, index order
    rank = jnp.cumsum(valid) - valid.astype(jnp.int32)
    in_cap = valid & (rank < n_avail)
    dest = jnp.where(in_cap, slot_order[rank.clip(0, P - 1)], P)  # OOB drops

    new_loc = state.point_loc.at[dest].set(locs, mode="drop")
    flags = state.point_flags.at[dest].set(NO_OBSERVATIONS | NO_BASELINE, mode="drop")
    unc = state.point_uncertainty.at[dest].set(1e8, mode="drop")
    ring = state.point_obs.at[dest].set(-1, mode="drop")
    totals = state.point_obs_total.at[dest].set(0, mode="drop")
    ring_frame = state.ring_frame.at[dest].set(-1, mode="drop")
    ring_disabled = state.ring_disabled.at[dest].set(False, mode="drop")
    point_free = state.point_free.at[dest].set(False, mode="drop")
    n_appended = jnp.sum((in_cap & (dest >= state.n_points)).astype(jnp.int32))
    idx = jnp.where(in_cap, dest, -1).astype(jnp.int32)
    return (
        state._replace(
            point_loc=new_loc,
            point_flags=flags,
            point_uncertainty=unc,
            point_obs=ring,
            point_obs_total=totals,
            ring_frame=ring_frame,
            ring_disabled=ring_disabled,
            point_free=point_free,
            n_points=state.n_points + n_appended,
        ),
        idx,
    )


def add_observations(state: MapState, frame_idx, point_idx, px, valid) -> MapState:
    """Batched Frame::AddObservation + Commit (localmap.h:139-144,
    localmap.cpp:86-90): append rows to the obs table and publish them into
    the per-point rings, then clear evidence flags (CheckFlags,
    localmap.cpp:39-42 calls it per added obs).

    point_idx[K] int32, px[K,2], valid[K] bool. Each point may appear at most
    once per call (one observation per frame, as in the reference matcher).
    """
    point_idx = jnp.asarray(point_idx, jnp.int32)
    valid = jnp.asarray(valid, bool) & (point_idx >= 0)
    O = state.obs_frame.shape[0]
    offs = state.n_obs + jnp.cumsum(valid) - valid.astype(jnp.int32)
    in_cap = valid & (offs < O)
    dest = jnp.where(in_cap, offs, O)  # OOB scatter drops

    obs_frame = state.obs_frame.at[dest].set(jnp.int32(frame_idx), mode="drop")
    obs_point = state.obs_point.at[dest].set(point_idx, mode="drop")
    obs_px = state.obs_px.at[dest].set(px, mode="drop")
    obs_dis = state.obs_disabled.at[dest].set(False, mode="drop")
    obs_err = state.obs_err.at[dest].set(0.0, mode="drop")
    obs_err_valid = state.obs_err_valid.at[dest].set(False, mode="drop")

    # Publish into per-point rings.
    totals = state.point_obs_total[point_idx.clip(0)]
    slot = jnp.mod(totals, state.ring_size)
    obs_slot = state.obs_slot.at[dest].set(slot.astype(jnp.int32), mode="drop")
    pr = jnp.where(in_cap, point_idx, state.point_loc.shape[0])  # OOB drop
    point_obs = state.point_obs.at[pr, slot].set(offs, mode="drop")
    point_obs_total = state.point_obs_total.at[pr].add(1, mode="drop")
    ring_frame = state.ring_frame.at[pr, slot].set(
        jnp.int32(frame_idx), mode="drop"
    )
    ring_disabled = state.ring_disabled.at[pr, slot].set(False, mode="drop")

    new = state._replace(
        obs_frame=obs_frame,
        obs_point=obs_point,
        obs_px=obs_px,
        obs_disabled=obs_dis,
        obs_err=obs_err,
        obs_err_valid=obs_err_valid,
        obs_slot=obs_slot,
        n_obs=state.n_obs + jnp.sum(in_cap.astype(jnp.int32)),
        point_obs=point_obs,
        point_obs_total=point_obs_total,
        ring_frame=ring_frame,
        ring_disabled=ring_disabled,
    )
    return refresh_flags(new)


# ---------------------------------------------------------------------------
# flag evidence (CheckFlags, localmap.cpp:44-84) — clear-only
# ---------------------------------------------------------------------------

def _ring_slots(state: MapState):
    """Per-point ring slots IN STORAGE ORDER: (idx [P,R], ok [P,R], age
    [P,R]).

    ``age`` annotates each slot with its position in arrival order (0 =
    oldest retained observation) computed algebraically from the ring
    counters — the rows are NOT permuted. The age-ordered materialization
    this replaces (take_along_axis over [P,R]) lowered to a 65k-element
    gather at every call site; every
    consumer only needs order-aware reductions, which masked min/argmax
    over ``age`` provide on the raw layout for free.
    """
    P, R = state.point_obs.shape
    total = state.point_obs_total
    cnt = state.point_ring_count()
    start = jnp.mod(total - cnt, R)[:, None]       # oldest slot index
    k = jnp.arange(R)[None, :]
    age = jnp.mod(k - start, R)
    idx = state.point_obs
    ok = (age < cnt[:, None]) & (idx >= 0)
    return idx, ok, age


def _rows_gather(idx, fields):
    """ONE packed gather of several per-row fields at rows ``idx`` [P,R].

    Row gathers are latency-bound per row, so k separate [P,R] gathers
    cost ~k times one packed [P,R,K] gather. Fields are [O] or [O,k]; returns a
    list of [P,R(,k)] f32 arrays (cast back by the caller as needed).
    """
    cols = []
    widths = []
    for f in fields:
        f2 = f.reshape(f.shape[0], -1).astype(jnp.float32)
        cols.append(f2)
        widths.append(f2.shape[1])
    packed = jnp.concatenate(cols, axis=1)  # [O, K]
    vals = packed[idx.clip(0)]              # [P, R, K]
    out = []
    o = 0
    for f, k in zip(fields, widths):
        v = vals[..., o:o + k]
        out.append(v[..., 0] if f.ndim == 1 else v)
        o += k
    return out


def _ring_gather(state: MapState, field):
    """Gather a per-obs field over the ring slots [P, R] with validity.

    Slots come in STORAGE order (see _ring_slots), not age order; callers
    needing age relations should use _ring_slots directly.
    Prefer _ring_slots + _rows_gather when several fields are needed.
    """
    idx, ok, _age = _ring_slots(state)
    vals = field[idx.clip(0)]
    return vals, ok, idx


def _refresh_flags_from(flags, good, pos, age, min_baseline: float = 50.0):
    """Flag-evidence core given pre-gathered ring data: ``good`` [P,R]
    enabled+valid mask, ``pos`` [P,R,3] observing-frame positions, ``age``
    [P,R] slot arrival order (rows come in storage order, NOT age order —
    see _ring_slots)."""
    n_good = jnp.sum(good, axis=1)
    clear_no_obs = n_good >= 2

    # first enabled obs per point = base (the good slot with MINIMUM age)
    R = good.shape[1]
    aged = jnp.where(good, age, R)
    first_slot = jnp.argmin(aged, axis=1)
    first_age = jnp.min(aged, axis=1)
    has_base = jnp.any(good, axis=1)
    base = jnp.take_along_axis(pos, first_slot[:, None, None], axis=1)[:, 0]
    dist = jnp.linalg.norm(pos - base[:, None, :], axis=-1)
    later = good & (age > first_age[:, None])
    clear_no_base = has_base & jnp.any(later & (dist >= min_baseline), axis=1)

    flags = jnp.where(clear_no_obs, flags & ~NO_OBSERVATIONS, flags)
    flags = jnp.where(clear_no_base, flags & ~NO_BASELINE, flags)
    return flags


def refresh_flags(state: MapState, min_baseline: float = 50.0) -> MapState:
    """Clear NO_OBSERVATIONS / NO_BASELINE where evidence justifies it.

    - >= 2 enabled observations clears NO_OBSERVATIONS (localmap.cpp:47-59)
    - an enabled observation whose frame is >= 50mm from the *first* enabled
      observation's frame clears NO_BASELINE (localmap.cpp:62-83)
    """
    idx, ok, age = _ring_slots(state)
    good = ok & ~state.ring_disabled
    pos = state.frame_trans[state.ring_frame.clip(0)]  # [P, R, 3]
    flags = _refresh_flags_from(state.point_flags, good, pos, age, min_baseline)
    return state._replace(point_flags=flags)


# ---------------------------------------------------------------------------
# normalize (localmap.cpp:114-155)
# ---------------------------------------------------------------------------

def normalize(state: MapState, rescale: bool = False, baseline: float = 150.0) -> MapState:
    """Re-anchor frame 0 at origin/identity; optionally re-fix scale.

    New world w' = R0 (w - T0): frames get t' = R0 (t - T0) and
    q' = q * q0^-1; point xyz rotates by R0 after the translation ``move``.
    The reference codes the scale re-fix but forces scale=1
    (localmap.cpp:125-126); ``rescale=True`` enables the intended behavior.
    """
    do = state.n_frames >= 2

    t0 = state.frame_trans[0]
    q0 = state.frame_quat[0]
    pm = state.point_mask[:, None]

    # frame 0 is const in every window solve, so in steady state the
    # anchor transform is EXACTLY identity (its stored bits never change)
    # and the full path below reproduces the inputs bit-for-bit; the only
    # real work left is the homogeneous unit-norm of the points (which
    # clean's w-clamp threshold assumes). Skip the dead pose/point
    # transform math in that case.
    is_id = (
        (jnp.abs(q0[3]) > 1.0 - 1e-7)
        & (jnp.sum(jnp.abs(q0[:3])) + jnp.sum(jnp.abs(t0)) < 1e-7)
        & ~jnp.bool_(rescale)
    )

    def fast(state):
        loc = state.point_loc
        unit = loc / jnp.maximum(
            jnp.linalg.norm(loc, axis=-1, keepdims=True), 1e-12
        )
        # the full path renormalizes every frame quaternion as a side
        # effect of composing with conj(q0); keep that (multiplying by an
        # exact identity is exact, the renorm is not)
        fm = state.frame_mask[:, None]
        new_q = quat.normalize(state.frame_quat)
        return state._replace(
            frame_quat=jnp.where(do & fm, new_q, state.frame_quat),
            point_loc=jnp.where(do & pm, unit, loc),
        )

    def full(state):
        scale = jnp.where(
            rescale,
            baseline
            / jnp.maximum(jnp.linalg.norm(t0 - state.frame_trans[1]), 1e-9),
            1.0,
        ).astype(state.frame_trans.dtype)

        fm = state.frame_mask[:, None]
        new_t = quat.rotate(q0, (state.frame_trans - t0) * scale)
        new_q = quat.normalize(
            quat.multiply(state.frame_quat, quat.conjugate(q0))
        )

        # Points: move(-T0) in world coords, rescale(1/scale), rotate xyz
        # by R0 (localmap.h:226-232, localmap.cpp:133-137,150-153).
        loc = state.point_loc
        xyz = loc[..., :3] - t0 * loc[..., 3:4]
        w = loc[..., 3:4] / scale
        moved = jnp.concatenate([quat.rotate(q0, xyz), w], axis=-1)
        moved = moved / jnp.maximum(
            jnp.linalg.norm(moved, axis=-1, keepdims=True), 1e-12
        )

        return state._replace(
            frame_trans=jnp.where(do & fm, new_t, state.frame_trans),
            frame_quat=jnp.where(do & fm, new_q, state.frame_quat),
            point_loc=jnp.where(do & pm, moved, state.point_loc),
        )

    return jax.lax.cond(is_id, fast, full, state)


def estimate_motion(state: MapState, frame_idx):
    """The intended LocalMap::EstimateMotion (declared at localmap.h:300 but
    never implemented in the reference): constant-velocity prediction for
    the alternating-stereo rig. The pose of the same physical camera two
    frames ago is advanced by the displacement between the last two
    same-camera frames.

    Returns (quat, trans) for the frame at ``frame_idx`` (which should be
    the newest). Falls back to the plain copy rule when fewer than 4 frames
    exist (matching the pose-init rules at main.cpp:540-552).
    """
    i = jnp.asarray(frame_idx, jnp.int32)
    q2 = state.frame_quat[jnp.maximum(i - 2, 0)]
    t2 = state.frame_trans[jnp.maximum(i - 2, 0)]
    q4 = state.frame_quat[jnp.maximum(i - 4, 0)]
    t4 = state.frame_trans[jnp.maximum(i - 4, 0)]
    # velocity of this physical camera over its last stride
    dt = t2 - t4
    dq = quat.normalize(quat.multiply(q2, quat.conjugate(q4)))
    pred_t = t2 + dt
    pred_q = quat.normalize(quat.multiply(dq, q2))
    ok = i >= 4
    return (
        jnp.where(ok, pred_q, q2),
        jnp.where(ok, pred_t, t2),
    )


# ---------------------------------------------------------------------------
# pop_frame / check_not_moving (localmap.cpp:158-187)
# ---------------------------------------------------------------------------

def pop_frame(state: MapState) -> MapState:
    """Remove the most recent frame and its observations (localmap.cpp:158-171).

    Its observations are the tail of the obs table; they are also the most
    recent entry in each affected point's ring, so the ring totals just
    decrement. No flag changes (the reference's RemoveObservation->CheckFlags
    is clear-only and removal never adds evidence).
    """
    has = state.n_frames > 0
    last = jnp.maximum(state.n_frames - 1, 0)
    start = state.frame_obs_start[last]
    O = state.obs_frame.shape[0]
    rows = jnp.arange(O)
    removed = (rows >= start) & (rows < state.n_obs) & has
    # decrement ring totals for the points of removed rows, and clear the
    # ring slot that held each removed row: the removed obs is its point's
    # most recent, i.e. slot (total-1) % R pre-decrement. Without clearing,
    # a point whose ring has wrapped (total > R) would later re-read the
    # stale slot as its oldest observation and fetch the cleared obs row
    # (_ring_gather only guards idx >= 0).
    P = state.point_loc.shape[0]
    R = state.point_obs.shape[1]
    # retired rows (obs_point -1 after their point was evicted) must not
    # wrap to slot P-1 through the scatter
    pts = jnp.where(removed & (state.obs_point >= 0), state.obs_point, P)
    slot = jnp.mod(state.point_obs_total[pts.clip(0, P - 1)] - 1, R)
    point_obs = state.point_obs.at[pts, slot].set(-1, mode="drop")
    point_obs_total = state.point_obs_total.at[pts].add(-1, mode="drop")
    return state._replace(
        n_frames=jnp.where(has, last, state.n_frames),
        n_obs=jnp.where(has, start, state.n_obs),
        obs_frame=jnp.where(removed, -1, state.obs_frame),
        obs_point=jnp.where(removed, -1, state.obs_point),
        obs_err_valid=jnp.where(removed, False, state.obs_err_valid),
        point_obs=point_obs,
        point_obs_total=point_obs_total,
    )


def check_not_moving(state: MapState, d2_threshold: float = 5.0) -> MapState:
    """Drop the last two frames when recent motion is negligible
    (localmap.cpp:173-187): requires >=4 frames, d1^2+d2^2 <= threshold and
    neither of the last two frames being keyframes."""
    n = state.n_frames
    pos = state.frame_trans
    i = jnp.maximum(n, 4)  # avoid negative indexing pre-guard
    d1 = jnp.linalg.norm(pos[i - 1] - pos[i - 3])
    d2 = jnp.linalg.norm(pos[i - 2] - pos[i - 4])
    idle = (d1 * d1 + d2 * d2) <= d2_threshold
    kf = state.frame_keyframe[i - 1] | state.frame_keyframe[i - 2]
    do = (n >= 4) & idle & ~kf
    return jax.lax.cond(do, lambda s: pop_frame(pop_frame(s)), lambda s: s, state)


# ---------------------------------------------------------------------------
# reproject (slam.cpp:523-548)
# ---------------------------------------------------------------------------

def reproject(state: MapState, cheirality_eps: float = 0.001,
              window: int | None = None) -> tuple[MapState, jnp.ndarray]:
    """Recompute observation reprojection errors; return (state, mean).

    Matches Slam::ReprojectMap: error = projected - observed for every row of
    the obs table (enabled or not); rows whose point fails the cheirality
    test keep error = observed pixel and are excluded from the mean
    (slam.cpp:529-545).

    ``window`` limits the recompute to the newest ``window`` rows of the obs
    table (the same tail-slice trick window BA uses): only free frames and
    the points they see move between maintenance passes, so older rows'
    cached errors are already current in steady state. None = full table
    (the reference's exact behavior; run_replay's final pass uses it).
    """
    O = state.obs_frame.shape[0]
    if window is not None and window < O:
        start = jnp.maximum(state.n_obs - window, 0)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, window, 0)
        obs_frame = sl(state.obs_frame)
        obs_point = sl(state.obs_point)
        obs_px = sl(state.obs_px)
        obs_mask_w = sl(state.obs_mask)
    else:
        start = jnp.int32(0)
        obs_frame, obs_point = state.obs_frame, state.obs_point
        obs_px, obs_mask_w = state.obs_px, state.obs_mask

    f = obs_frame.clip(0)
    p = obs_point.clip(0)
    q = state.frame_quat[f]
    t = state.frame_trans[f]
    k = state.cam_k[state.frame_cam[f]]
    loc = state.point_loc[p]
    px, valid = jax.vmap(proj.project_point, in_axes=(0, 0, 0, 0, None))(
        q, t, k, loc, cheirality_eps
    )
    # retired rows (obs_point -1: their point slot was evicted) freeze
    # their stored error and never count
    active = obs_mask_w & (obs_point >= 0)
    err = jnp.where((valid & active)[:, None], px - obs_px, obs_px)
    counted = valid & active
    norms = jnp.linalg.norm(err, axis=-1)
    mean = jnp.sum(jnp.where(counted, norms, 0.0)) / jnp.maximum(
        jnp.sum(counted.astype(jnp.float32)), 1.0
    )
    if window is not None and window < O:
        new_err = jnp.where(active[:, None], err, sl(state.obs_err))
        obs_err = jax.lax.dynamic_update_slice_in_dim(
            state.obs_err, new_err, start, 0
        )
        new_valid = jnp.where(active, counted, sl(state.obs_err_valid))
        obs_err_valid = jax.lax.dynamic_update_slice_in_dim(
            state.obs_err_valid, new_valid, start, 0
        )
    else:
        obs_err = jnp.where(active[:, None], err, state.obs_err)
        obs_err_valid = jnp.where(active, counted, state.obs_err_valid)
    return state._replace(obs_err=obs_err, obs_err_valid=obs_err_valid), mean


def mean_obs_error(state: MapState, window: int | None = None) -> jnp.ndarray:
    """The mean :func:`reproject` would return when nothing has moved since
    the last reproject, computed from the STORED error table.

    reproject stores err = observed pixel for rows failing the cheirality
    test and excludes them from its mean (slam.cpp:529-545); such rows are
    excluded here via the explicit ``obs_err_valid`` bit reproject writes
    (no value-sentinel comparison — a genuine error exactly equal to its
    own observation still counts). ``window`` mirrors reproject's
    tail-window slicing so the averages are drop-in comparable.
    """
    O = state.obs_frame.shape[0]
    if window is not None and window < O:
        start = jnp.maximum(state.n_obs - window, 0)
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, window, 0)
        obs_err, obs_valid, obs_mask = (
            sl(state.obs_err), sl(state.obs_err_valid), sl(state.obs_mask)
        )
    else:
        obs_err, obs_valid, obs_mask = (
            state.obs_err, state.obs_err_valid, state.obs_mask
        )
    counted = obs_mask & obs_valid
    norms = jnp.linalg.norm(obs_err, axis=-1)
    return jnp.sum(jnp.where(counted, norms, 0.0)) / jnp.maximum(
        jnp.sum(counted.astype(jnp.float32)), 1.0
    )


def normalize_canary(state: MapState, rows: int = 64,
                     cheirality_eps: float = 0.001) -> jnp.ndarray:
    """Per-frame invariance canary for :func:`normalize` (main.cpp:602-605).

    The reference CHECKs that the mean reprojection error is unchanged
    across Normalize EVERY frame (+-0.1); the pipeline's fast path reuses
    stored errors instead of re-projecting, which leaves a window where a
    normalize corruption could hide until the next slow/touched frame.
    This re-projects only the newest ``rows`` obs rows against the CURRENT
    (post-normalize) geometry and returns the max per-row difference (px)
    between the fresh error norm and the stored one. Rows failing the
    cheirality test, masked rows, and rows without a genuine stored error
    (``obs_err_valid`` False: never reprojected — e.g. committed on a frame
    whose BA solve aborted — or cheirality-fail at the last reproject) are
    excluded via the explicit validity bit; no value-sentinel comparison.
    """
    O = state.obs_frame.shape[0]
    rows = min(rows, O)
    start = jnp.maximum(state.n_obs - rows, 0)
    sl = lambda a: jax.lax.dynamic_slice_in_dim(a, start, rows, 0)
    obs_frame, obs_point = sl(state.obs_frame), sl(state.obs_point)
    obs_px, obs_err, obs_mask = sl(state.obs_px), sl(state.obs_err), sl(state.obs_mask)
    obs_valid = sl(state.obs_err_valid)

    f = obs_frame.clip(0)
    p = obs_point.clip(0)
    q = state.frame_quat[f]
    t = state.frame_trans[f]
    k = state.cam_k[state.frame_cam[f]]
    loc = state.point_loc[p]
    px, valid = jax.vmap(proj.project_point, in_axes=(0, 0, 0, 0, None))(
        q, t, k, loc, cheirality_eps
    )
    counted = valid & obs_mask & obs_valid
    fresh = jnp.linalg.norm(px - obs_px, axis=-1)
    stored = jnp.linalg.norm(obs_err, axis=-1)
    return jnp.max(jnp.where(counted, jnp.abs(fresh - stored), 0.0))


def clamp_pending(state: MapState, w_min: float = 1e-6) -> jnp.ndarray:
    """True iff :func:`clean`'s homogeneous-w clamp (localmap.cpp:299-306)
    will move any usable point on this state: the clamp replaces w with
    max(|w|, w_min), which changes w exactly when w < w_min (negative or
    tiny). The pipeline uses this to know whether stored reprojection
    errors remain exact across a clean call."""
    usable = slam_usable(state.point_flags) & state.point_mask
    return jnp.any(usable & (state.point_loc[:, 3] < w_min))


# ---------------------------------------------------------------------------
# clean (localmap.cpp:283-398)
# ---------------------------------------------------------------------------

def clean(state: MapState, error_threshold: float = 5.0, cfg: SlamConfig | None = None
          ) -> tuple[MapState, jnp.ndarray]:
    """Disable high-error observations, flag degenerate points.

    Vectorized equivalent of LocalMap::Clean:
    1. clamp homogeneous w to be strictly positive (localmap.cpp:299-306)
    2. BAD_LOCATION for slam-usable points with any cached observation whose
       camera-space depth < 1 (localmap.cpp:328-334)
    3. collect enabled observations of usable (non-newly-bad) points with
       error > threshold; disable those with err >= max(threshold, maxerr/4)
       — the sorted worst-first walk with a fixed bar is order-independent,
       so a mask applies it exactly (localmap.cpp:361-387); mark MISMATCHED
    4. BAD_FEATURE when avg ring error > 1.5 with > 4 observations
       (localmap.cpp:352-356); uncertainty <- avg error (localmap.cpp:358)
    5. changed points get NO_OBSERVATIONS|NO_BASELINE re-set then evidence
       re-clears them (localmap.cpp:389-395)

    Returns (state, all_ok) where all_ok=True iff nothing was disabled.
    """
    cfg = cfg or SlamConfig()
    P = state.point_loc.shape[0]
    pm = state.point_mask
    usable = slam_usable(state.point_flags) & pm

    # 1. force point scale strictly positive
    w = state.point_loc[:, 3]
    w_fixed = jnp.where(jnp.abs(w) < cfg.homogeneous_w_min, cfg.homogeneous_w_min, jnp.abs(w))
    loc = jnp.where(
        usable[:, None],
        jnp.concatenate([state.point_loc[:, :3], w_fixed[:, None]], axis=1),
        state.point_loc,
    )
    state = state._replace(point_loc=loc)

    # ring reads — frame/disabled come from the ring mirrors for free;
    # only the error table still needs a gather (it changes every
    # reproject, obs-major)
    ring_rows, ok, age = _ring_slots(state)
    (errs2,) = _rows_gather(ring_rows, [state.obs_err])
    frames = state.ring_frame
    enabled = ~state.ring_disabled
    errn = jnp.linalg.norm(errs2, axis=-1)  # [P, R]

    # 2. too-close-to-camera test over all cached obs of usable points
    # (one packed [P,R,7] frame gather instead of separate quat/trans)
    fpose = jnp.concatenate([state.frame_quat, state.frame_trans], axis=1)
    fpr = fpose[frames.clip(0)]
    fq = fpr[..., :4]
    ft = fpr[..., 4:]
    pos = state.point_position()[:, None, :]
    z = quat.rotate(fq, pos - ft)[..., 2]
    new_bad_loc = usable & jnp.any(ok & (z < cfg.close_point_z), axis=1)

    # 3. worst-first disable with a fixed bar
    cand = ok & enabled & (errn > error_threshold) & usable[:, None] & ~new_bad_loc[:, None]
    maxerr = jnp.max(jnp.where(cand, errn, 0.0))
    bar = jnp.maximum(error_threshold, maxerr / cfg.clean_maxerr_div)
    to_disable = cand & (errn >= bar)
    any_disabled_pt = jnp.any(to_disable, axis=1)
    all_ok = ~jnp.any(to_disable)
    # ring->flat disable sync WITHOUT a [P,R]-index scatter (a serialized
    # scatter): packed[p,s] names the flat row the ring wants
    # disabled; row o is disabled iff its own ring cell (obs_point[o],
    # obs_slot[o]) names it — ONE [O]-row gather, equivalent row set
    # (rows evicted from a ring can never be named by their old cell).
    # Skipped entirely when nothing is to disable.
    packed = jnp.where(to_disable, ring_rows, -1)
    obs_disabled = jax.lax.cond(
        all_ok,
        lambda od: od,
        lambda od: od | (
            packed[state.obs_point.clip(0), state.obs_slot.clip(0)]
            == jnp.arange(state.obs_frame.shape[0])
        ),
        state.obs_disabled,
    )
    state = state._replace(
        obs_disabled=obs_disabled,
        # the mirror updates scatter-free: to_disable is already [P,R]
        ring_disabled=state.ring_disabled | to_disable,
    )

    # 4. avg error over the ring; BAD_FEATURE; uncertainty update
    cnt = jnp.maximum(state.point_ring_count(), 1)
    avg = jnp.sum(jnp.where(ok, errn, 0.0), axis=1) / cnt
    new_bad_feat = (
        usable
        & (avg > cfg.bad_feature_avg_err)
        & (state.point_ring_count() > cfg.bad_feature_min_obs)
    )
    unc = jnp.where(usable, avg, state.point_uncertainty)

    flags = state.point_flags
    flags = jnp.where(new_bad_loc, flags | BAD_LOCATION, flags)
    flags = jnp.where(any_disabled_pt, flags | MISMATCHED, flags)
    flags = jnp.where(new_bad_feat, flags | BAD_FEATURE, flags)

    # 5. re-derive evidence flags for changed points — reusing this call's
    # ring/pose gathers (the disable mask updates `enabled` in place)
    changed = new_bad_loc | any_disabled_pt | new_bad_feat
    flags = jnp.where(changed, flags | NO_OBSERVATIONS | NO_BASELINE, flags)
    good = ok & enabled & ~to_disable
    flags = _refresh_flags_from(flags, good, ft, age)
    state = state._replace(point_flags=flags, point_uncertainty=unc)
    return state, all_ok


# ---------------------------------------------------------------------------
# epipolar constraint (localmap.cpp:232-276)
# ---------------------------------------------------------------------------

def apply_epipolar_constraint(state: MapState, cfg: SlamConfig | None = None) -> MapState:
    """Gate recent matches on the epipolar constraint.

    Per point: obs1 = most recent observation; obs2 = most recent *enabled*
    earlier observation scanning -2, -3, ... down to -(n-1)
    (localmap.cpp:242-249). Skip when the two frames share a camera or no
    enabled obs2 exists. Residual r = h2^T E h1 in undistorted plane
    coordinates; |r| > 100*0.0015 disables obs1 + MISMATCHED when the point
    has > 8 observations, else BAD_FEATURE (localmap.cpp:260-274).
    """
    cfg = cfg or SlamConfig()
    P, R = state.point_obs.shape
    cnt = state.point_ring_count()
    total = state.point_obs_total

    ring_rows, ok, age = _ring_slots(state)
    enabled = ~state.ring_disabled

    last_age = cnt - 1  # age of observation(-1)
    # obs2 candidates: ages last_age-1 down to 1 == observation(-2..-(n-1));
    # pick the *newest* enabled one (the C++ walk stops at the first enabled).
    cand2 = ok & enabled & (age < last_age[:, None]) & (age >= 1)
    j2 = jnp.argmax(jnp.where(cand2, age, -1), axis=1)  # its SLOT index
    has2 = jnp.any(cand2, axis=1)

    def take(arr, j):
        return jnp.take_along_axis(arr, j[:, None], axis=1)[:, 0]

    j1 = jnp.argmax(jnp.where(ok, age, -1), axis=1)  # newest slot
    row1 = take(ring_rows, j1)
    row2 = take(ring_rows, j2)
    # only the two selected obs per point need their fields: two [P]-row
    # packed gathers instead of three full [P,R] ring gathers
    opack = jnp.concatenate(
        [state.obs_frame[:, None].astype(jnp.float32), state.obs_px], axis=1
    )
    o1 = opack[row1.clip(0)]
    o2 = opack[row2.clip(0)]
    f1 = o1[:, 0].astype(jnp.int32)
    f2 = o2[:, 0].astype(jnp.int32)
    px1 = o1[:, 1:]
    px2 = o2[:, 1:]

    eligible = (
        state.point_mask
        & (total >= 2)
        & feature_usable(state.point_flags)
        & ((state.point_flags & BAD_FEATURE) == 0)
        & has2
        & (state.frame_cam[f1.clip(0)] != state.frame_cam[f2.clip(0)])
    )

    k1 = state.cam_k[state.frame_cam[f1.clip(0)]]
    k2 = state.cam_k[state.frame_cam[f2.clip(0)]]
    h1 = proj.pixel_to_plane(px1, k1)
    h2 = proj.pixel_to_plane(px2, k2)
    r = epi.epipolar_residual_frames(
        state.frame_quat[f1.clip(0)], state.frame_trans[f1.clip(0)],
        state.frame_quat[f2.clip(0)], state.frame_trans[f2.clip(0)],
        h1, h2,
    )

    hard = eligible & (jnp.abs(r) > cfg.epipolar_threshold * cfg.epipolar_hard_mult)
    many = total > cfg.epipolar_mismatch_obs
    disable1 = hard & many
    rows = jnp.where(disable1, row1, state.obs_frame.shape[0])
    obs_disabled = state.obs_disabled.at[rows].set(True, mode="drop")
    # mirror update scatter-free: row1 lives at slot j1 of its point's ring
    R = state.ring_disabled.shape[1]
    ring_disabled = state.ring_disabled | (
        disable1[:, None] & (jnp.arange(R)[None, :] == j1[:, None])
    )

    flags = state.point_flags
    flags = jnp.where(disable1, flags | MISMATCHED, flags)
    flags = jnp.where(hard & ~many, flags | BAD_FEATURE, flags)
    return state._replace(
        obs_disabled=obs_disabled, ring_disabled=ring_disabled,
        point_flags=flags,
    )


# ---------------------------------------------------------------------------
# host-side summary (LocalMap::Stats, localmap.cpp:400-483)
# ---------------------------------------------------------------------------

def stats(state: MapState) -> dict:
    """Structured summary of what the reference prints in Stats()."""
    import numpy as np

    pm = np.asarray(state.point_mask)
    flags = np.asarray(state.point_flags)
    d = {
        "n_frames": int(state.n_frames),
        "n_points": int(np.sum(pm)),
        "n_obs": int(state.n_obs),
        "slam_usable": int(np.sum(np.asarray(slam_usable(state.point_flags)) & pm)),
        "no_baseline": int(np.sum(((flags & NO_BASELINE) != 0) & pm)),
        "no_observations": int(np.sum(((flags & NO_OBSERVATIONS) != 0) & pm)),
        "bad_location": int(np.sum(((flags & BAD_LOCATION) != 0) & pm)),
        "bad_feature": int(np.sum(((flags & BAD_FEATURE) != 0) & pm)),
        "mismatched": int(np.sum(((flags & MISMATCHED) != 0) & pm)),
        "n_disabled_obs": int(
            np.sum(np.asarray(state.obs_disabled) & np.asarray(state.obs_mask))
        ),
    }

    # the reference's per-obs error histograms (localmap.cpp:400-460):
    # observations of NO_BASELINE points are skipped; enabled obs of
    # slam-usable points go to one histogram, the rest to the other
    from slam_robot_tpu.utils.histogram import Histogram

    n = int(state.n_obs)
    if n > 0:
        err = np.linalg.norm(np.asarray(state.obs_err[:n]), axis=1)
        pt = np.asarray(state.obs_point[:n]).clip(0)
        mask = np.asarray(state.obs_mask[:n])
        skip = ((flags[pt] & NO_BASELINE) != 0) | ~mask
        usable = np.asarray(slam_usable(state.point_flags))[pt]
        enabled = ~np.asarray(state.obs_disabled[:n])
        hi_en = Histogram(10)
        hi_dis = Histogram(10)
        sel_en = ~skip & enabled & usable
        sel_dis = ~skip & ~(enabled & usable)
        if sel_en.any():
            hi_en.add_many(err[sel_en])
        if sel_dis.any():
            hi_dis.add_many(err[sel_dis])
        d["enabled_err_hist"] = hi_en.counters.tolist()
        d["disabled_err_hist"] = hi_dis.counters.tolist()

    # per-frame distance / ddist summary (localmap.cpp:461-482)
    nf = int(state.n_frames)
    if nf > 1:
        pos = np.asarray(state.frame_trans[:nf])
        d["frame_dist"] = np.linalg.norm(np.diff(pos, axis=0), axis=1).round(1).tolist()
    return d
