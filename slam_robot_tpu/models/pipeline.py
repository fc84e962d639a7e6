"""The full per-frame SLAM step: the reference's main loop as one jitted
function (main.cpp:503-645 rebuilt).

Per frame:
1. camera ^= 1 (alternating stereo, main.cpp:507)
2. add a frame with the pose init rules (main.cpp:540-552): frame 0 at
   identity, frame 1 at +baseline x, later frames copy the pose from two
   frames ago (same physical camera)
3. matcher.track + observation commit (main.cpp:560-564)
4. fast window BA solve_frames(2,5) -> reproject -> clean (main.cpp:580-584)
5. every 5th frame and the first 10: slow window solve_frames(10,20) ->
   reproject -> clean (main.cpp:587-597)
6. ApplyEpipolarConstraint (main.cpp:599)
7. reproject -> Normalize -> reproject, with the error-invariance check
   surfaced as a metric instead of a CHECK crash (main.cpp:602-605)

Everything below the image fetch is a single jit-compiled function of
(PipelineState, image); the host loop just feeds frames
(io/sources + run_replay).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.models import matcher as matcher_mod
from slam_robot_tpu.models import slam
from slam_robot_tpu.ops import quaternion as quat
from slam_robot_tpu.utils import synthetic


class PipelineState(NamedTuple):
    map: lm.MapState
    matcher: matcher_mod.MatcherState
    camera: jnp.ndarray          # int32: camera of the *previous* frame
    total_ba_iters: jnp.ndarray  # int32 cumulative (slam.h:48)
    last_error: jnp.ndarray      # f32 final BA cost (slam.h:49)


def init(cfg: SlamConfig, intrinsics=None) -> PipelineState:
    """Two cameras with the reference's intrinsics by default
    (main.cpp:474-486)."""
    m = lm.empty(cfg)
    if intrinsics is None:
        intrinsics = [synthetic.reference_intrinsics(cfg)] * cfg.num_cameras
    for i in range(cfg.num_cameras):
        m = lm.set_camera(m, i, intrinsics[i])
    return PipelineState(
        map=m,
        matcher=matcher_mod.init(cfg),
        camera=jnp.int32(0),
        total_ba_iters=jnp.int32(0),
        last_error=jnp.float32(0.0),
    )


def _step(ps: PipelineState, img, cfg: SlamConfig, run_slam: bool = True):
    """One full SLAM step. Returns (PipelineState, metrics dict)."""
    camera = ps.camera ^ 1
    m = ps.map

    # pose init (main.cpp:540-552)
    n = m.n_frames
    q0 = quat.identity()
    t0 = jnp.zeros(3, jnp.float32)
    q1 = m.frame_quat[0]
    t1 = jnp.array([cfg.baseline_mm, 0.0, 0.0], jnp.float32)
    if cfg.motion_model == "constant_velocity":
        qp, tp = lm.estimate_motion(m, n)
    else:
        qp = m.frame_quat[jnp.maximum(n - 2, 0)]
        tp = m.frame_trans[jnp.maximum(n - 2, 0)]
    init_q = jnp.where(n == 0, q0, jnp.where(n == 1, q1, qp))
    init_t = jnp.where(n == 0, t0, jnp.where(n == 1, t1, tp))

    m, frame_idx = lm.add_frame(m, camera, init_q, init_t)

    ms, m, track_metrics = matcher_mod.track(
        ps.matcher, m, img, frame_idx, camera, cfg
    )

    metrics = dict(track_metrics)
    metrics["frame_id"] = frame_idx

    if run_slam:
        rw = cfg.reproject_window or None

        def do_slam(m):
            m, res_fast = slam.solve_frames(
                m, cfg.solve_fast[0], cfg.solve_fast[1], cfg.ba_range, cfg,
                max_iters=cfg.ba_iters_fast, window_obs=cfg.window_obs_fast,
                max_free_points=cfg.ba_free_points_fast,
                compact_obs=cfg.ba_compact_obs_fast or None,
            )
            m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)

            # clean's homogeneous-w clamp (localmap.cpp:299-306) is the ONLY
            # thing that moves geometry between a branch's reproject and the
            # pre-normalize one below; lm.clamp_pending, evaluated on the
            # state each clean call sees, says whether it will fire
            def after_fast(m):
                t = lm.clamp_pending(m, cfg.homogeneous_w_min)
                m, _ok = lm.clean(m, cfg.error_threshold, cfg)
                return m, t

            m, touched = jax.lax.cond(
                res_fast.ok, after_fast, lambda m: (m, jnp.bool_(False)), m
            )

            # slow window on early frames and every 5th (main.cpp:587-597)
            slow_due = (frame_idx < cfg.slow_first_n) | (
                jnp.mod(frame_idx, cfg.slow_every) == 0
            )

            def do_slow(m):
                m, res = slam.solve_frames(
                    m, cfg.solve_slow[0], cfg.solve_slow[1], cfg.ba_range, cfg,
                    max_iters=cfg.ba_iters_slow,
                    max_free_points=cfg.ba_free_points_slow,
                    compact_obs=cfg.ba_compact_obs_slow or None,
                )
                m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
                t = lm.clamp_pending(m, cfg.homogeneous_w_min)
                m, _ok = lm.clean(m, cfg.error_threshold, cfg)
                return m, res, t

            def no_slow(m):
                zero = jax.tree.map(jnp.zeros_like, res_fast)
                # slow branch re-reprojects, superseding the fast clamp;
                # without it the fast branch's clamp still stands
                return m, zero._replace(ok=jnp.bool_(True)), touched

            m, res_slow, touched = jax.lax.cond(slow_due, do_slow, no_slow, m)

            # third BA tier (the rolling polish): every xslow_every frames,
            # a window wide enough to reach back past where the (10,20)
            # tier froze the chain — repairs the scale/heading drift the
            # sliding windows lock in (PERF.md finding 21) while anchor
            # frames are still presented
            polish_due = jnp.bool_(False)
            if cfg.solve_xslow[0]:
                xs, xp = cfg.solve_xslow
                xslow_due = (
                    (jnp.mod(frame_idx, cfg.xslow_every) == 0)
                    & (frame_idx > xp)
                )

                def do_xslow(m):
                    m, _res = slam.solve_frames(
                        m, xs, xp, cfg.ba_range, cfg,
                        max_iters=cfg.ba_iters_xslow,
                        max_free_points=cfg.ba_free_points_slow,
                    )
                    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
                    t = lm.clamp_pending(m, cfg.homogeneous_w_min)
                    m, _ok = lm.clean(m, cfg.error_threshold, cfg)
                    return m, t

                m, touched = jax.lax.cond(
                    xslow_due, do_xslow, lambda m: (m, touched), m
                )
                polish_due = polish_due | xslow_due

            m = lm.apply_epipolar_constraint(m, cfg)

            # ReprojectMap parity (main.cpp:602): epipolar only disabled
            # rows, so unless a w-clamp fired the stored errors ARE the
            # recompute — re-average instead of re-projecting
            def recompute(m):
                return lm.reproject(m, cfg.cheirality_eps, window=rw)

            def reuse(m):
                return m, lm.mean_obs_error(m, window=rw)

            m, err1 = jax.lax.cond(touched | polish_due, recompute, reuse, m)
            m = lm.normalize(m)
            # post-normalize ReprojectMap (main.cpp:604): Normalize is a
            # similarity transform — reprojection errors are INVARIANT
            # (the very property the reference CHECKs to +-0.1). The
            # stored errors are therefore still the recompute; re-run the
            # real projection only where geometry moved (w-clamp) or on
            # slow-window frames, which keeps normalize_err_drift a live
            # guard at the slow cadence instead of every frame
            m, err2 = jax.lax.cond(
                touched | slow_due | polish_due, recompute, reuse, m
            )
            # per-frame normalize invariance canary (main.cpp:602-605
            # CHECKs every frame to +-0.1; the reuse fast path above
            # otherwise leaves normalize unchecked until the next
            # slow/touched frame)
            if cfg.normalize_canary_rows:
                canary = lm.normalize_canary(
                    m, cfg.normalize_canary_rows, cfg.cheirality_eps
                )
            else:
                canary = jnp.float32(0.0)
            if cfg.drop_idle_frames:
                # the reference declares but never calls this
                # (localmap.cpp:173-187); opt-in behavior
                m = lm.check_not_moving(m, cfg.not_moving_d2)

            # truncation guard for the maintenance reproject window: rows
            # of presented (newest solve_slow[1]) frames older than the
            # tail keep stale stored errors — count them
            if rw is not None and rw < m.obs_mask.shape[0]:
                # contiguous presented-slot range compare, not a per-row
                # present[obs_frame] gather over the obs table
                lo = m.n_frames - cfg.solve_slow[1]
                in_presented = (
                    m.obs_mask
                    & (m.obs_frame >= lo)
                    & (m.obs_frame < m.n_frames)
                )
                head = jnp.arange(m.obs_mask.shape[0]) < (m.n_obs - rw)
                repro_dropped = jnp.sum(
                    (in_presented & head).astype(jnp.int32)
                )
            else:
                repro_dropped = jnp.int32(0)
            return m, res_fast, res_slow, err1, err2, repro_dropped, canary

        def skip_slam(m):
            zero_res = slam_zero_result(m, cfg)
            return (m, zero_res, zero_res, jnp.float32(0.0),
                    jnp.float32(0.0), jnp.int32(0), jnp.float32(0.0))

        # the reference skips BA on the very first frame (prev image check,
        # main.cpp:570-573)
        m, res_fast, res_slow, err1, err2, repro_dropped, canary = jax.lax.cond(
            frame_idx >= 1, do_slam, skip_slam, m
        )
        metrics.update(
            # obs-window truncation counters: nonzero = the fixed windows
            # exclude participating rows (ref includes all, slam.cpp:279-299)
            fast_obs_dropped=res_fast.obs_dropped,
            slow_obs_dropped=res_slow.obs_dropped,
            reproject_obs_dropped=repro_dropped,
        )
        metrics.update(
            fast_ok=res_fast.ok,
            fast_iters=res_fast.iters,
            slow_ok=res_slow.ok,
            slow_iters=res_slow.iters,
            mean_reproj_err=err2,
            normalize_err_drift=jnp.abs(err1 - err2),
            normalize_canary_px=canary,
            ba_cost=res_fast.cost,
            # per-solve termination report (the Ceres BriefReport analog,
            # slam.cpp:510-518): ba.TERM_* codes + cost before/after
            fast_term=res_fast.term,
            slow_term=res_slow.term,
            fast_cost0=res_fast.cost0,
            slow_cost0=res_slow.cost0,
            slow_cost=res_slow.cost,
        )
        total_iters = ps.total_ba_iters + res_fast.iters + res_slow.iters
        last_error = res_fast.cost
    else:
        total_iters = ps.total_ba_iters
        last_error = ps.last_error
        metrics.update(
            fast_ok=jnp.bool_(True),
            fast_iters=jnp.int32(0),
            slow_ok=jnp.bool_(True),
            slow_iters=jnp.int32(0),
            mean_reproj_err=jnp.float32(0.0),
            normalize_err_drift=jnp.float32(0.0),
            normalize_canary_px=jnp.float32(0.0),
            ba_cost=jnp.float32(0.0),
            fast_term=jnp.int32(0),
            slow_term=jnp.int32(0),
            fast_cost0=jnp.float32(0.0),
            slow_cost0=jnp.float32(0.0),
            slow_cost=jnp.float32(0.0),
            fast_obs_dropped=jnp.int32(0),
            slow_obs_dropped=jnp.int32(0),
            reproject_obs_dropped=jnp.int32(0),
        )

    metrics["n_points"] = m.n_points
    metrics["n_obs"] = m.n_obs

    return (
        PipelineState(
            map=m,
            matcher=ms,
            camera=camera,
            total_ba_iters=total_iters,
            last_error=last_error,
        ),
        metrics,
    )


step = functools.partial(jax.jit, static_argnames=("cfg", "run_slam"))(_step)


def _polish(ps: PipelineState, cfg: SlamConfig, ns: int = 0):
    """One-time early-trajectory polish (the SolveAllFrames the reference
    keeps for exactly this, slam.cpp:447-480): free every frame except the
    0/1 gauge anchor, with all evidence so far presented, to repair the
    scale/heading the sliding windows locked in before the map had
    baseline (PERF.md finding 21: drifting per-segment scale + early-
    locked rotation).

    HOST-triggered: drivers call :func:`polish` between frames when
    ``frame == cfg.polish_at`` (run_replay, bench.py, tools/profile_scan,
    tools/parity). It fires once, so compiling it into the per-frame step
    as a lax.cond would bill every frame for its cond-boundary state
    copies (measured +14%% scan step on CPU) and bloat the step compile
    for one execution.

    ``ns`` overrides the freed-frame count (static; a distinct ns is a
    distinct compile) — used by the second polish trigger (cfg.polish2_at),
    which re-solves a deeper chain once more evidence exists."""
    ns = ns or cfg.polish_solve or (cfg.polish_at - 1)
    rw = cfg.reproject_window or None
    m, res = slam.solve_frames(
        ps.map, ns, ns + 2, cfg.ba_range, cfg,
        max_iters=cfg.ba_iters_polish,
        max_free_points=cfg.ba_free_points_slow,
    )
    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
    m, _ok = lm.clean(m, cfg.error_threshold, cfg)
    m, _ = lm.reproject(m, cfg.cheirality_eps, window=rw)
    return (
        ps._replace(map=m, total_ba_iters=ps.total_ba_iters + res.iters),
        res,
    )


polish = functools.partial(jax.jit, static_argnames=("cfg", "ns"))(_polish)


def maybe_polish(ps: PipelineState, frame_idx: int, cfg: SlamConfig,
                 run_slam: bool = True):
    """Host-loop helper: run the one-time polish when ``frame_idx`` hits
    ``cfg.polish_at``, and the second deeper polish at ``cfg.polish2_at``
    (0 = disabled). Returns the (possibly) new state."""
    if run_slam and cfg.polish_at and frame_idx == cfg.polish_at:
        ps, _ = polish(ps, cfg)
    if run_slam and cfg.polish2_at and frame_idx == cfg.polish2_at:
        ps, _ = polish(ps, cfg, ns=cfg.polish2_at - 1)
    return ps

# the LIVE per-frame variant (a robot feeds frames one at a time,
# main.cpp:503-645): donating the state lets XLA reuse the ~70 MB of
# state buffers in place instead of allocating + copying fresh outputs
# every call. Callers must not touch the donated `ps` afterwards.
step_donated = functools.partial(
    jax.jit, static_argnames=("cfg", "run_slam"), donate_argnums=(0,)
)(_step)


# packed live-telemetry layout (one f32 row per frame). Indices 8-11 are
# the SAFETY counters: the obs-window truncation
# guards and the normalize-invariance canary the reference CHECKs every
# frame (main.cpp:602-605) — a live robot run must see them, not just
# full-metrics replay. Consumers index rows by name via LIVE_IDX.
LIVE_SCALARS = (
    "n_matches", "is_keyframe", "mean_reproj_err", "slow_ok",
    "n_points", "n_added", "fast_iters", "slow_iters",
    "fast_obs_dropped", "slow_obs_dropped", "reproject_obs_dropped",
    "normalize_canary_px",
)
LIVE_IDX = {k: i for i, k in enumerate(LIVE_SCALARS)}
LIVE_WIDTH = len(LIVE_SCALARS)


def _step_lean(ps: PipelineState, img, cfg: SlamConfig, run_slam: bool = True):
    """Live-loop step with a minimal output surface: the live path returns
    the state plus ONE packed f32[LIVE_WIDTH] the robot loop polls with a
    single fetch — layout in :data:`LIVE_SCALARS` (loop scalars + the
    safety counters)."""
    ps, met = _step(ps, img, cfg, run_slam)
    packed = jnp.stack([met[k].astype(jnp.float32) for k in LIVE_SCALARS])
    return ps, packed


step_live = functools.partial(
    jax.jit, static_argnames=("cfg", "run_slam"), donate_argnums=(0,)
)(_step_lean)


def _step_lean_ring(ps: PipelineState, ring, img, cfg: SlamConfig,
                    run_slam: bool = True):
    """step_live with DEVICE-side telemetry batching: ``ring`` is a caller-
    carried f32[k,LIVE_WIDTH] of the last k frames' packed scalars (row -1
    = this frame). The robot loop fetches the ring once every k frames
    instead of once per frame, and without a separate jitted dispatch to
    stack the scalars. Only the state is donated: the
    ring is a few hundred bytes, and leaving it un-donated keeps a
    submitted-for-fetch ring buffer valid while later steps run (a donated
    ring could be overwritten under a still-pending pool fetch)."""
    ps, packed = _step_lean(ps, img, cfg, run_slam)
    ring = jnp.concatenate([ring[1:], packed[None]], axis=0)
    return ps, ring


step_live_ring = functools.partial(
    jax.jit, static_argnames=("cfg", "run_slam"), donate_argnums=(0,)
)(_step_lean_ring)


def checked_step(ps: PipelineState, img, cfg: SlamConfig, run_slam: bool = True):
    """Numeric-guard wrapper around :func:`step` — the SURVEY §5 sanitizer
    analog. Pure-functional state already removes the reference's C++ race/
    UB classes (set-erase-while-iterating, uninitialized is_keyframe_);
    this adds the float guards: checkify's NaN/Inf and out-of-bounds checks
    over the whole jitted step. ~2x slower; wire via run_replay
    --debug-numerics or jax.config.update("jax_debug_nans", True) for the
    eager-mode variant.

    Returns (error, (state, metrics)); call ``error.throw()`` to raise on
    the host.
    """
    from jax.experimental import checkify

    f = checkify.checkify(
        lambda ps_, img_: step(ps_, img_, cfg, run_slam),
        errors=checkify.float_checks,
    )
    return f(ps, img)


def slam_zero_result(m, cfg):
    from slam_robot_tpu.ops import ba

    return ba.BAResult(
        frame_quat=m.frame_quat,
        frame_trans=m.frame_trans,
        point_loc=m.point_loc,
        cam_k=m.cam_k,
        ok=jnp.bool_(True),
        cost=jnp.float32(0.0),
        iters=jnp.int32(0),
        term=jnp.int32(ba.TERM_NOT_RUN),
        cost0=jnp.float32(0.0),
    )
