"""Feature lifecycle: per-frame tracking orchestration (matcher.cpp rebuilt).

The reference keeps a deque of <=4 keyframe "Views" (pyramid + per-feature
match locations) and, per frame (matcher.cpp:301-405):

1. drops features whose point is no longer feature-usable
2. for each live feature, walks its stored per-view matches and
   forward+backward tracks the first one that succeeds into the new image,
   predicting the start location by projecting the 3D point when its
   uncertainty is low (FindMatches, matcher.cpp:208-271); failures at 3
   pyramid levels retry at 6 (matcher.cpp:248)
3. writes successful matches into the map as observations
4. if matches < 40 the frame becomes a keyframe: matches are stored into a
   new view, Shi-Tomasi corners are detected, suppressed near existing
   matches by a 30x30 occupancy grid, and surviving corners seed new
   TrackedPoints at depth 2000 (matcher.cpp:353-394); the view ring drops
   its oldest entry beyond 4 (matcher.cpp:397-402)

Fixed-shape layout: feature slots are a fixed-capacity table; views are a
fixed ring of stored (padded) pyramids; every per-feature decision is a
mask; the keyframe branch is one lax.cond. View preference order is
newest-first (deterministic) where the reference iterates a pointer-keyed
std::map (indeterminate order, matcher.cpp:221).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.ops import corners as corner_ops
from slam_robot_tpu.ops import patch as patch_ops
from slam_robot_tpu.ops import projection as proj
from slam_robot_tpu.ops import quaternion as quat
from slam_robot_tpu.ops import pyramid as pyr
from slam_robot_tpu.ops import tracker
from slam_robot_tpu.ops import tracker_fused
from slam_robot_tpu.ops.pyramid import PAD, FlatPyramid, level_dims


class MatcherState(NamedTuple):
    view_frame: jnp.ndarray   # [V] int32 map frame index, -1 = empty slot
    view_pyr: jnp.ndarray     # [V, L, H0+2*PAD, W0+2*PAD] flat pyramids
    feat_point: jnp.ndarray   # [NF] int32 map point index, -1 = dead
    feat_px: jnp.ndarray      # [NF, V, 2] stored match per view
    feat_valid: jnp.ndarray   # [NF, V] bool
    # per-(feature, view) reference patch stacks, extracted ONCE when the
    # view is stored (feat_px for a view never changes afterwards): the
    # matcher's forward-track reference patches (matcher.cpp:247 ->
    # hessian.h:175-183) without the 1.5k-lane per-frame regather. Packed
    # (data | valid | mean | sumsq, tracker_fused.pack_stacks) so a level
    # sweep reads its cache rows with ONE latency-bound gather, not four
    feat_refpack: jnp.ndarray  # [NF, V, L, 2*S*S+2] f32
    # per-(feature, view, level) search WINDOWS around the stored match —
    # the backward-consistency pass's windows are fixed the moment a view
    # is stored, so caching them turns its per-sweep per-lane plane slices
    # into flat-table reads. The refpack patches
    # are sampled from these at keyframe time (exact: zero drift then)
    feat_refwin: jnp.ndarray   # [NF, V, L, WIN, WIN] f32
    feat_reforg: jnp.ndarray   # [NF, V, L, 2] f32 window origins
    feat_fail: jnp.ndarray    # [NF] int32 consecutive frames where every
                              # stored-view attempt failed (0 = matched or
                              # untried); drives cfg.find_fail_backoff
    feat_sharp: jnp.ndarray   # [NF] bool: last frame this lane matched
                              # within cfg.adaptive_fwd_px of its
                              # projection prediction — its next
                              # first-choice attempt runs at 1 pyramid
                              # level (the coarse cascade exists for
                              # starts outside the level-0 Newton basin)


def init(cfg: SlamConfig) -> MatcherState:
    V, NF, L = cfg.max_views, cfg.max_features, cfg.pyramid_depth
    S = cfg.patch_size
    h0, w0 = cfg.image_height, cfg.image_width
    return MatcherState(
        view_frame=jnp.full((V,), -1, jnp.int32),
        view_pyr=jnp.zeros((V, L, h0 + 2 * PAD, w0 + 2 * PAD), jnp.float32),
        feat_point=jnp.full((NF,), -1, jnp.int32),
        feat_px=jnp.zeros((NF, V, 2), jnp.float32),
        feat_valid=jnp.zeros((NF, V), bool),
        feat_refpack=jnp.zeros((NF, V, L, 2 * S * S + 2), jnp.float32),
        feat_refwin=jnp.zeros(
            (NF, V, L, tracker_fused.WIN, tracker_fused.WIN), jnp.float32
        ),
        feat_reforg=jnp.zeros((NF, V, L, 2), jnp.float32),
        feat_fail=jnp.zeros((NF,), jnp.int32),
        feat_sharp=jnp.zeros((NF,), bool),
    )


def in_image(pts, cfg: SlamConfig):
    """Half-open image-bounds gate for tracking start points [.., 2]:
    0 <= x < width, 0 <= y < height (matcher.cpp:241-244 semantics; both
    axes exclusive at the far edge)."""
    return (
        (pts[..., 0] >= 0)
        & (pts[..., 1] >= 0)
        & (pts[..., 0] < cfg.image_width)
        & (pts[..., 1] < cfg.image_height)
    )


def _view_pyramid(ms: MatcherState, vi, cfg: SlamConfig) -> FlatPyramid:
    """View ``vi``'s pyramid as a FlatPyramid addressing the stacked ring
    [V*L, Hp, Wp] through a (possibly traced) offset — no image gather."""
    dims = level_dims(cfg.image_height, cfg.image_width, cfg.pyramid_depth)
    V, L = ms.view_pyr.shape[:2]
    h = jnp.tile(jnp.asarray([d[0] for d in dims], jnp.int32), V)
    w = jnp.tile(jnp.asarray([d[1] for d in dims], jnp.int32), V)
    return FlatPyramid(
        data=ms.view_pyr.reshape((V * L,) + ms.view_pyr.shape[2:]),
        heights=h,
        widths=w,
        depth_=L,
        offset=vi * L,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def track(
    ms: MatcherState,
    map_state: lm.MapState,
    img,
    frame_idx,
    camera_idx,
    cfg: SlamConfig,
):
    """One Matcher::Track step. ``img`` is [H,W(,3)] uint8 or f32.

    Returns (matcher_state, map_state, metrics-dict).
    """
    NF, V = cfg.max_features, cfg.max_views
    weight = patch_ops.radial_mask(cfg.patch_size, cfg.mask_bias)

    new_pyr = pyr.build_pyramid(
        img, cfg.pyramid_depth, cfg.blur_sigma0, cfg.blur_sigma_down
    )

    # 1. drop features whose point became unusable (matcher.cpp:327-330,
    #    minus its erase-while-iterating UB)
    pt_idx = ms.feat_point
    pt_ok = (pt_idx >= 0) & lm.feature_usable(map_state.point_flags[pt_idx.clip(0)])
    pt_idx = jnp.where(pt_ok, pt_idx, -1)
    ms = ms._replace(feat_point=pt_idx)
    live = pt_idx >= 0

    # straggler backoff (cfg.find_fail_backoff): a lane whose attempts all
    # failed last frame only re-enters the find ladder every k-th frame
    # (slot-staggered so the straggler load spreads evenly). k=1 is the
    # reference behavior: every stored view re-attempted every frame.
    if cfg.find_fail_backoff > 1:
        due = (ms.feat_fail == 0) | (
            jnp.mod(frame_idx + jnp.arange(NF), cfg.find_fail_backoff) == 0
        )
    else:
        due = jnp.ones((NF,), bool)
    if cfg.find_fail_backoff_deep > 1:
        # the 6-level retry passes re-attempt on their own slower cadence
        due_deep = (ms.feat_fail == 0) | (
            jnp.mod(frame_idx + jnp.arange(NF),
                    cfg.find_fail_backoff_deep) == 0
        )
    else:
        due_deep = jnp.ones((NF,), bool)

    # prediction inputs for the *current* frame pose
    fq = map_state.frame_quat[frame_idx]
    ft = map_state.frame_trans[frame_idx]
    k = map_state.cam_k[camera_idx]
    unc = map_state.point_uncertainty[pt_idx.clip(0)]
    loc = map_state.point_loc[pt_idx.clip(0)]
    lvls3 = jnp.where(unc > cfg.uncertainty_confident, cfg.levels_unsure,
                      cfg.levels_confident).astype(jnp.int32)

    def predictions(fq_, ft_):
        """Predicted start locations from projecting each feature's point
        (matcher.cpp:233-239); used where uncertainty < 100."""
        pred_px, pred_ok = jax.vmap(
            proj.project_point, in_axes=(None, None, None, 0)
        )(fq_, ft_, k, loc)
        use = (unc < cfg.uncertainty_confident) & pred_ok
        return jnp.where(use[:, None], pred_px, 0.0), use

    # 2. FindMatches: walk stored views newest-first with a 6-level retry
    #    pass per view (matcher.cpp:221-269, 248), as one lax.scan so the
    #    tracker traces once. The sequential form is deliberate: a feature
    #    that matched on an earlier view is *skipped* on later ones, and in
    #    steady state most features match on the first view — a fully
    #    parallel (feature x view x pass) batch was measured 10x slower
    #    because it pays for every stored view every frame (PERF.md).
    start_pred, use_pred = predictions(fq, ft)

    if cfg.tracker_kind == "klt":
        from slam_robot_tpu.ops import klt as _klt

        track_fn = _klt.track_feature
    else:
        track_fn = None  # default Hessian/Newton tracker

    use_fused = cfg.tracker_kind == "hessian" and cfg.tracker_impl == "fused"
    L = cfg.pyramid_depth

    if use_fused:
        # PER-LANE VIEW RANKS: the reference walks views newest-first per
        # feature, trying the next view only on failure (matcher.cpp:
        # 221-269). A lane's attempt sequence is exactly its own valid
        # views sorted newest-first, so sweeping with a per-lane view pick
        # is equivalent to the global (view, pass) walk — but in steady
        # state every lane matches at rank 0, so ONE sweep does the work
        # the view walk spread over V cond-guarded sweeps.
        key = jnp.where(
            ms.feat_valid & (ms.view_frame >= 0)[None, :],
            ms.view_frame[None, :], -1,
        )  # [NF, V]
        lane_order = jnp.argsort(-key, axis=1)          # [NF, V] view idx
        key_sorted = jnp.take_along_axis(key, lane_order, axis=1)
        lanes = jnp.arange(NF)
        bwd_cap = (jnp.int32(cfg.roundtrip_levels)
                   if cfg.roundtrip_levels > 0 else None)

        def cap_b(x):
            return x if bwd_cap is None else jnp.minimum(x, bwd_cap)

        unsure_arr = jnp.full((NF,), cfg.levels_unsure, jnp.int32)
        if cfg.adaptive_fwd_px > 0:
            # SHARP lanes (matched last frame within adaptive_fwd_px of
            # the projection prediction) run their first-choice attempt at
            # ONE level both ways; any failure falls through to the same
            # frame's full-budget retry pass
            sharp_ok = ms.feat_sharp & (lvls3 != cfg.levels_unsure)
            lvls_first = jnp.where(sharp_ok, 1, lvls3).astype(jnp.int32)
            bwd_first = cap_b(lvls_first)
        else:
            lvls_first = lvls3
            bwd_first = cap_b(lvls3)

        def make_sweep(start_pred_, use_pred_, due_):
          def sweep(matched, to_px, vi_lane, has, lvls_arr, bwd_arr=None):
            """One fused tracker sweep: per-lane view pick ``vi_lane``,
            eligibility ``has``, per-lane forward level budgets
            ``lvls_arr`` (backward ``bwd_arr``, default capped forward)."""
            from_pt = ms.feat_px[lanes, vi_lane]
            cand = live & due_ & ~matched & has
            start = jnp.where(use_pred_[:, None], start_pred_, from_pt)
            cand = cand & in_image(start, cfg)
            view_levels = _view_pyramid(ms, vi_lane, cfg)  # per-lane offset

            bwd = cap_b(lvls_arr) if bwd_arr is None else bwd_arr

            def run(args):
                from_pt, start, lvls, bwd, cand = args
                S2 = cfg.patch_size * cfg.patch_size
                # each lane's view pick is FIXED within a sweep, so the
                # packed cache is gathered ONCE per sweep ([NF, L, D] rows);
                # every level then reads it with a static slice (full-F
                # bucket) or a C-row gather (compacted buckets). COMMON
                # CASE: every candidate lane picks the SAME view (rank-0
                # after a keyframe stored them all) — then ONE dynamic
                # slice replaces the NF-row gather; only lanes in `cand`
                # are ever read,
                # so non-candidate rows may hold the uniform view's data
                v0 = vi_lane[jnp.argmax(cand)]
                uniform = jnp.all(jnp.where(cand, vi_lane, v0) == v0)
                packed_sel = jax.lax.cond(
                    uniform,
                    lambda: jax.lax.dynamic_index_in_dim(
                        ms.feat_refpack, v0, axis=1, keepdims=False
                    ),
                    lambda: ms.feat_refpack[lanes, vi_lane],
                )
                stats0 = packed_sel[:, 0, 2 * S2:]
                if cfg.bwd_window_cache:
                    # per-lane view-selected window cache rows (flat-table
                    # gather, once per sweep)
                    bwd_wins = (ms.feat_refwin[lanes, vi_lane],
                                ms.feat_reforg[lanes, vi_lane])
                else:
                    bwd_wins = None
                return tracker_fused.track_bidirectional_batch(
                    view_levels, new_pyr, from_pt, start, lvls, weight,
                    cfg.track_threshold, cfg.track_max_iters,
                    iters_coarse=cfg.track_iters_coarse,
                    roundtrip_px=cfg.roundtrip_px, active=cand,
                    p1_packed=packed_sel, p1_stats0=stats0,
                    bwd_lvls=bwd,
                    bwd_ref_from_window=cfg.bwd_ref_from_window,
                    bwd_win_cache=bwd_wins,
                )

            def skip(args):
                from_pt, _, _, _, _ = args
                return from_pt, jnp.zeros((NF,), bool)

            res_px, res_ok = jax.lax.cond(
                jnp.any(cand), run, skip,
                (from_pt, start, lvls_arr, bwd, cand),
            )
            newly = cand & res_ok
            return matched | newly, jnp.where(newly[:, None], res_px, to_px)

          return sweep

        if cfg.retry_mode == "cycle":
            # the walk's attempts AFTER the first, in its order:
            # (rank0,pass1),(rank1,pass0),(rank1,pass1),(rank2,pass0),...
            # A failing lane tries ONE of these per due frame, picked by
            # cycling its fail counter through its own valid attempts —
            # the same attempt set the ladder burns 2V-1 cond-guarded
            # sweeps on every frame, spread over consecutive due frames.
            att_r = jnp.asarray([(j + 1) // 2 for j in range(2 * V - 1)],
                                jnp.int32)
            att_p = jnp.asarray([(j + 1) % 2 for j in range(2 * V - 1)],
                                jnp.int32)
            has_rank = key_sorted >= 0                         # [NF, V]
            retry6 = lvls3 != cfg.levels_unsure
            att_ok = has_rank[:, att_r] & (
                (att_p == 0)[None, :] | retry6[:, None]
            )                                                  # [NF, 2V-1]
            n_att = jnp.sum(att_ok.astype(jnp.int32), axis=1)
            cum_att = jnp.cumsum(att_ok.astype(jnp.int32), axis=1)

            def run_find(matched0, to_px0, start_pred_, use_pred_):
                sweep = make_sweep(start_pred_, use_pred_, due)
                matched, to_px = sweep(
                    matched0, to_px0, lane_order[:, 0], has_rank[:, 0],
                    lvls_first, bwd_first,
                )
                for s in range(cfg.retry_sweeps):
                    cyc = jnp.mod(ms.feat_fail + s, jnp.maximum(n_att, 1))
                    pick = (cum_att == cyc[:, None] + 1) & att_ok
                    j = jnp.argmax(pick, axis=1)   # first valid cyc-th
                    vi = lane_order[lanes, att_r[j]]
                    lvls_arr = jnp.where(
                        att_p[j] == 0, lvls3, jnp.int32(cfg.levels_unsure)
                    ).astype(jnp.int32)
                    matched, to_px = sweep(
                        matched, to_px, vi, n_att > 0, lvls_arr
                    )

                if cfg.retry_escalate_margin >= 0:
                    # decaying frame: the one-retry-per-frame budget is
                    # about to cost a keyframe (the keyframe branch +
                    # view-ring churn) — run the reference's FULL walk instead,
                    # ignoring the straggler backoff (a desperate frame
                    # wants every lane). Steady frames skip the cond.
                    esweep = make_sweep(
                        start_pred_, use_pred_, jnp.ones((NF,), bool)
                    )

                    def escalate(args):
                        def estep(carry, xs):
                            rank, retry_pass = xs
                            has = key_sorted[:, rank] >= 0
                            pass_ok = jnp.where(
                                retry_pass == 0,
                                jnp.ones((NF,), bool),
                                retry6,
                            )
                            lvls_arr = jnp.where(
                                retry_pass == 0, lvls3,
                                jnp.int32(cfg.levels_unsure),
                            ).astype(jnp.int32)
                            m2, px2 = esweep(
                                *carry, lane_order[:, rank],
                                has & pass_ok, lvls_arr,
                            )
                            return (m2, px2), None

                        xs_r = jnp.repeat(jnp.arange(V, dtype=jnp.int32), 2)
                        xs_p = jnp.tile(jnp.arange(2, dtype=jnp.int32), V)
                        out, _ = jax.lax.scan(estep, args, (xs_r, xs_p))
                        return out

                    low = jnp.sum(matched.astype(jnp.int32)) < (
                        cfg.min_matches + cfg.retry_escalate_margin
                    )
                    matched, to_px = jax.lax.cond(
                        low, escalate, lambda a: a, (matched, to_px)
                    )
                return matched, to_px
        else:
            xs_rank = jnp.repeat(jnp.arange(V, dtype=jnp.int32), 2)
            xs_pass = jnp.tile(jnp.arange(2, dtype=jnp.int32), V)

            def run_find(matched0, to_px0, start_pred_, use_pred_):
                sweep = make_sweep(start_pred_, use_pred_, due)

                def find_step(carry, xs):
                    rank, retry_pass = xs
                    has = key_sorted[:, rank] >= 0
                    # any 6-level attempt (retry pass, or an unsure lane's
                    # first pass when it is already failing) follows the
                    # deep cadence
                    pass_ok = jnp.where(
                        retry_pass == 0,
                        jnp.where(lvls3 == cfg.levels_unsure, due_deep,
                                  jnp.ones((NF,), bool)),
                        (lvls3 != cfg.levels_unsure) & due_deep,
                    )
                    # the sharp 1-level shortcut only applies to the very
                    # first attempt; later rungs mean it already failed
                    first = (rank == 0) & (retry_pass == 0)
                    lvls_arr = jnp.where(
                        retry_pass == 0,
                        jnp.where(first, lvls_first, lvls3),
                        unsure_arr,
                    ).astype(jnp.int32)
                    bwd_arr = jnp.where(first, bwd_first, cap_b(lvls_arr))
                    matched, to_px = sweep(
                        *carry, lane_order[:, rank], has & pass_ok,
                        lvls_arr, bwd_arr,
                    )
                    return (matched, to_px), None

                (matched, to_px), _ = jax.lax.scan(
                    find_step, (matched0, to_px0), (xs_rank, xs_pass)
                )
                return matched, to_px
    else:
        # per-lane trackers (lanes/klt): global newest-first view walk
        order = jnp.argsort(-ms.view_frame)  # newest frames first; -1 last

        def make_find_step(start_pred, use_pred):
          def find_step(carry, xs):
            matched, to_px = carry
            vi, retry_pass = xs
            view_ok = ms.view_frame[vi] >= 0
            from_pt = ms.feat_px[:, vi]
            has = ms.feat_valid[:, vi]
            pass_ok = jnp.where(
                retry_pass == 0,
                jnp.ones((NF,), bool),
                lvls3 != cfg.levels_unsure,
            )
            cand = live & due & ~matched & view_ok & has & pass_ok

            start = jnp.where(use_pred[:, None], start_pred, from_pt)
            cand = cand & in_image(start, cfg)
            lvls = jnp.where(
                retry_pass == 0, lvls3, jnp.int32(cfg.levels_unsure)
            ).astype(jnp.int32) * jnp.ones((NF,), jnp.int32)

            view_levels = _view_pyramid(ms, vi, cfg)

            def run(args):
                from_pt, start, lvls, cand = args

                def one(fp, st, lv, act):
                    return tracker.track_bidirectional(
                        view_levels, new_pyr, fp, st, lv, weight,
                        cfg.track_threshold, cfg.track_max_iters,
                        cfg.roundtrip_px, active=act, track_fn=track_fn,
                    )

                return jax.vmap(one)(from_pt, start, lvls, cand)

            def skip(args):
                from_pt, _, _, _ = args
                return from_pt, jnp.zeros((NF,), bool)

            # a step with no candidates (retry pass exhausted, stale view
            # slot) costs one predicate instead of a full tracker sweep
            res_px, res_ok = jax.lax.cond(
                jnp.any(cand), run, skip, (from_pt, start, lvls, cand)
            )
            newly = cand & res_ok
            matched = matched | newly
            to_px = jnp.where(newly[:, None], res_px, to_px)
            return (matched, to_px), None

          return find_step

        xs_rank = jnp.repeat(order, 2)
        # per view: pass 0 (uncertainty-scaled levels), pass 1 (retry at 6)
        xs_pass = jnp.tile(jnp.arange(2, dtype=jnp.int32), V)

        def run_find(matched0, to_px0, start_pred_, use_pred_):
            (matched, to_px), _ = jax.lax.scan(
                make_find_step(start_pred_, use_pred_),
                (matched0, to_px0),
                (xs_rank, xs_pass),
            )
            return matched, to_px

    matched, to_px = run_find(
        jnp.zeros((NF,), bool), jnp.zeros((NF, 2), jnp.float32),
        start_pred, use_pred,
    )

    # optional CleanDuplicates (matcher.cpp:274-288; the reference codes it
    # but comments out the call): features landing in the same half-res
    # pixel get MISMATCHED, keeping the first by slot order
    if cfg.clean_duplicates:
        cell = (to_px / 2.0).astype(jnp.int32)
        same = (
            (cell[:, None, 0] == cell[None, :, 0])
            & (cell[:, None, 1] == cell[None, :, 1])
            & matched[:, None]
            & matched[None, :]
        )
        earlier = jnp.arange(NF)[None, :] < jnp.arange(NF)[:, None]
        dup = jnp.any(same & earlier, axis=1)  # a lower slot owns the cell
        # OOB sentinel (not -1: negative indices wrap, only OOB drops)
        dup_points = jnp.where(dup, pt_idx, map_state.point_flags.shape[0])
        flags = map_state.point_flags.at[dup_points].set(
            map_state.point_flags[dup_points.clip(0)] | lm.MISMATCHED,
            mode="drop",
        )
        map_state = map_state._replace(point_flags=flags)
        matched = matched & ~dup

    # 3. write observations (matcher.cpp:255-257)
    map_state = lm.add_observations(map_state, frame_idx, pt_idx, to_px, matched)
    n_matches = jnp.sum(matched.astype(jnp.int32))

    # optional mid-frame pose re-solve (matcher.cpp:338-346): the reference
    # codes this retry but its Slam::SolveFramePose is dead (unconditional
    # `return false`, slam.cpp:182). Behind cfg.mid_frame_resolve the
    # INTENDED behavior runs: matches < 40 -> re-solve the newest frame's
    # pose from epipolar constraints, re-predict, re-run FindMatches for
    # the still-unmatched lanes, and only then decide on a keyframe.
    resolve_fired = jnp.bool_(False)
    if cfg.mid_frame_resolve:
        from slam_robot_tpu.models import slam as slam_mod

        def resolve_branch(args):
            map_state, matched, to_px = args
            map2, okp = slam_mod.solve_frame_pose_epipolar(map_state, cfg)
            sp2, up2 = predictions(
                map2.frame_quat[frame_idx], map2.frame_trans[frame_idx]
            )
            matched2, to_px2 = run_find(matched, to_px, sp2, up2)
            newly = matched2 & ~matched
            map2 = lm.add_observations(map2, frame_idx, pt_idx, to_px2, newly)
            return map2, matched2, to_px2, okp

        def no_resolve(args):
            map_state, matched, to_px = args
            return map_state, matched, to_px, jnp.bool_(False)

        map_state, matched, to_px, resolve_fired = jax.lax.cond(
            n_matches < cfg.min_matches, resolve_branch, no_resolve,
            (map_state, matched, to_px),
        )
        n_matches = jnp.sum(matched.astype(jnp.int32))

    # consecutive-failure streaks: matched lanes reset; lanes that were due
    # and still failed every attempt increment; backed-off lanes hold
    feat_fail = jnp.where(
        matched, 0, jnp.where(live & due, ms.feat_fail + 1, ms.feat_fail)
    ).astype(jnp.int32)
    feat_point = ms.feat_point
    if cfg.find_fail_give_up > 0:
        # drop lanes whose every stored-view attempt failed give_up
        # consecutive due frames: they have left the view frustum and
        # only bill the retry ladder. The map point survives; a revisit
        # re-seeds a fresh corner.
        gone = feat_point >= 0
        gone = gone & (feat_fail >= cfg.find_fail_give_up)
        feat_point = jnp.where(gone, -1, feat_point)
    if cfg.adaptive_fwd_px > 0:
        inno = jnp.linalg.norm(to_px - start_pred, axis=-1)
        feat_sharp = matched & use_pred & (inno < cfg.adaptive_fwd_px)
    else:
        feat_sharp = jnp.zeros((NF,), bool)
    ms = ms._replace(
        feat_fail=feat_fail, feat_point=feat_point, feat_sharp=feat_sharp
    )

    # 4. keyframe branch (matcher.cpp:353-402). The branch computes ONLY
    # small tensors; the multi-MB cache writes (view_pyr, feat_refpack,
    # feat_refwin, feat_reforg — ~63 MB of MatcherState) happen OUTSIDE the
    # cond via OOB-sentinel scatters that drop on non-keyframes. Carrying
    # them through the cond costs boundary copies of the whole cache every
    # frame.
    is_kf = n_matches < cfg.min_matches
    kneed = min(NF, -(-(cfg.min_matches + cfg.max_corners + 32) // 64) * 64)

    def keyframe_branch(args):
        view_frame0, feat_px0, feat_valid0, feat_point0, feat_fail0, \
            map_state = args
        # ring slot: empty (-1) first, else oldest
        slot = jnp.argmin(view_frame0)
        view_frame = view_frame0.at[slot].set(jnp.int32(frame_idx))
        feat_valid = feat_valid0.at[:, slot].set(matched)
        feat_px = feat_px0.at[:, slot].set(to_px)

        map_state = map_state._replace(
            frame_keyframe=map_state.frame_keyframe.at[frame_idx].set(True)
        )

        # detect new corners on the (blurred) level-0 image
        grey = new_pyr.data[0, PAD:-PAD, PAD:-PAD]
        cpts, cval = corner_ops.detect(
            grey, cfg.max_corners, cfg.corner_quality, cfg.corner_min_dist
        )
        occ = corner_ops.occupancy_grid(
            to_px, matched, cfg.image_width, cfg.image_height, cfg.suppress_grid
        )
        cval = corner_ops.suppress_by_grid(
            cpts, cval, occ, cfg.image_width, cfg.image_height, cfg.suppress_grid
        )

        # seed new points (matcher.cpp:376-385 seeds at a fixed 2000 mm
        # guess). With seed_depth_adaptive the guess is the MEDIAN CAMERA
        # DEPTH of the map's converged points instead: a fixed guess far
        # from the scene's true depth biases every fresh landmark the same
        # way, and because newly-seeded points drag their first frames
        # before BA converges them, the bias leaks into poses that then
        # FREEZE (window exit) — measured as the per-segment scale drift
        # of the trajectory. Only confident points vote (uncertainty gate)
        # so the median can't self-perpetuate the 2000 mm seed value.
        if cfg.seed_depth_adaptive:
            pm = map_state.point_mask & (
                map_state.point_uncertainty <= cfg.uncertainty_confident
            )
            ploc = map_state.point_loc
            w_h = jnp.where(jnp.abs(ploc[:, 3]) > 1e-9, ploc[:, 3], 1e-9)
            xyz = ploc[:, :3] / w_h[:, None]
            zc = jax.vmap(lambda p: quat.rotate(fq, p - ft)[2])(xyz)
            ok_z = pm & (zc > 1.0)
            nv = jnp.sum(ok_z.astype(jnp.int32))
            zs = jnp.sort(jnp.where(ok_z, zc, jnp.inf))
            med = zs[jnp.maximum(nv - 1, 0) // 2]
            seed_depth = jnp.where(
                nv >= 16, jnp.clip(med, 200.0, 50000.0), cfg.seed_depth_mm
            )
        else:
            seed_depth = cfg.seed_depth_mm
        plane = proj.pixel_to_plane(cpts, k)
        locs = jax.vmap(proj.unproject, in_axes=(None, None, 0, None))(
            fq, ft, plane, seed_depth
        )
        # free slots of features with no stored match in any live view:
        # with the oldest view just recycled they can never match again
        # (the reference's features die the same way once every view
        # holding them leaves the <=4-deep deque, matcher.cpp:397-402)
        trackable = jnp.any(feat_valid, axis=1)
        feat_point_live = jnp.where(trackable, feat_point0, -1)
        # assign to free feature slots
        free = feat_point_live < 0
        slot_order = jnp.argsort(~free)  # free slots first (stable)
        n_free = jnp.sum(free.astype(jnp.int32))
        kk = cpts.shape[0]
        dest = slot_order[jnp.arange(kk).clip(0, NF - 1)]
        assign = cval & (jnp.arange(kk) < n_free)

        # capacity-pressure eviction (localmap.evict_points): never evict a
        # point a live lane still tracks
        referenced = jnp.zeros(
            (map_state.point_loc.shape[0],), bool
        ).at[
            jnp.where(feat_point_live >= 0, feat_point_live,
                      map_state.point_loc.shape[0])
        ].set(True, mode="drop")
        map_state, pids = lm.add_points(
            map_state, locs, assign, referenced=referenced,
            evict_retain=cfg.point_evict_retain,
        )
        assign = assign & (pids >= 0)
        map_state = lm.add_observations(map_state, frame_idx, pids, cpts, assign)

        sdest = jnp.where(assign, dest, NF)  # OOB drops
        feat_point = feat_point_live.at[sdest].set(pids, mode="drop")
        feat_px = feat_px.at[sdest, slot].set(cpts, mode="drop")
        feat_valid = feat_valid.at[sdest].set(False, mode="drop")
        feat_valid = feat_valid.at[sdest, slot].set(True, mode="drop")
        feat_fail = feat_fail0.at[sdest].set(0, mode="drop")

        # select the lanes whose caches the view refresh must cover — only
        # lanes stored in this view (matched < min_matches by the keyframe
        # trigger, plus <= max_corners fresh seeds) are ever read from this
        # slot, so extract just those. Patch extraction is a per-row
        # gather, so the uncompacted NF=256 x 6-level refresh bills every
        # lane.
        if kneed < NF:
            need = feat_valid[:, slot]
            ksel = jnp.argsort(~need)[:kneed]     # needed lanes first
            kmask = need[ksel]
            kpts = feat_px[ksel, slot]
            wdest = jnp.where(kmask, ksel, NF)    # OOB drops
            # invariant guard: a lane stored in the view but
            # beyond the kneed cache capacity would track against STALE
            # refpack rows — mark it invalid instead (never fires while
            # sum(need) <= min_matches + max_corners, by the keyframe
            # trigger; this makes the sizing assumption safe, not assumed)
            covered = jnp.zeros((NF,), bool).at[
                jnp.where(kmask, ksel, NF)
            ].set(True, mode="drop")
            feat_valid = feat_valid.at[:, slot].set(need & covered)
        else:
            kmask = jnp.ones((NF,), bool)
            kpts = feat_px[:, slot]
            wdest = jnp.arange(NF)

        # the expensive per-keyframe gathers run HERE (cond-guarded), but
        # return only their compact payloads; the writes into the big
        # cache buffers happen unconditionally outside the cond
        if cfg.bwd_window_cache:
            # gather each needed lane's per-level search windows ONCE; the
            # backward pass reads its windows from this cache on every
            # later frame. The refpack patches are NOT sampled from these
            # windows by banded-matmul interpolation, because that only
            # matches plane extraction to ~1e-5 — and that fp-level
            # difference in the REFERENCE patches forked the keyframe
            # cadence chaotically between cache on/off (15 vs 2 keyframes
            # on the same bench sweep, PERF.md): within-step the cached
            # windows are bit-identical to fresh gathers
            # (tools/diag_wincache.py). Plane-exact refpack keeps cache
            # on/off bit-identical end to end.
            wins, orgs = tracker_fused.get_window_stacks(new_pyr, kpts)
            # refpack support re-read from the windows just gathered at
            # these same kpts: EXACT one-hot selection matmuls + extract's
            # own elementwise bilinear — BIT-IDENTICAL to plane extraction
            # (pinned in tests/test_tracker_fused.py), unlike
            # banded-interpolation sampling whose ~1e-5 forked the
            # keyframe cadence (PERF.md), and without per-lane plane
            # slices.
            stacks = tracker_fused.get_patch_stacks_from_windows(
                new_pyr, kpts, wins, orgs, cfg.patch_size
            )
        else:
            wins = jnp.zeros((kneed, L, tracker_fused.WIN,
                              tracker_fused.WIN), jnp.float32)
            orgs = jnp.zeros((kneed, L, 2), jnp.float32)
            stacks = tracker_fused.get_patch_stacks(new_pyr, kpts,
                                                    cfg.patch_size)
        packed = tracker_fused.pack_stacks(stacks)

        n_added = jnp.sum(assign.astype(jnp.int32))
        return ((view_frame, feat_px, feat_valid, feat_point, feat_fail),
                map_state, n_added, slot, wdest, wins, orgs, packed)

    def plain_branch(args):
        view_frame0, feat_px0, feat_valid0, feat_point0, feat_fail0, \
            map_state = args
        S2 = cfg.patch_size * cfg.patch_size
        return (
            (view_frame0, feat_px0, feat_valid0, feat_point0, feat_fail0),
            map_state, jnp.int32(0), jnp.int32(V),
            jnp.full((kneed,), NF, jnp.int32),
            jnp.zeros((kneed, L, tracker_fused.WIN, tracker_fused.WIN),
                      jnp.float32),
            jnp.zeros((kneed, L, 2), jnp.float32),
            jnp.zeros((kneed, L, 2 * S2 + 2), jnp.float32),
        )

    small, map_state, n_added, kf_slot, wdest, wins, orgs, packed = (
        jax.lax.cond(
            is_kf, keyframe_branch, plain_branch,
            (ms.view_frame, ms.feat_px, ms.feat_valid, ms.feat_point,
             ms.feat_fail, map_state),
        )
    )
    ms = ms._replace(
        view_frame=small[0], feat_px=small[1], feat_valid=small[2],
        feat_point=small[3], feat_fail=small[4],
    )

    # ---- cache writes, OUTSIDE the cond. OOB sentinels (kf_slot = V,
    # wdest = NF) drop everything on non-keyframes, so these are
    # unconditional scatters XLA performs as in-place DUS on the scan
    # carry — instead of the cond-boundary copies that carrying the 63 MB
    # of caches through the keyframe cond would cost every frame.
    upd = dict(
        view_pyr=ms.view_pyr.at[kf_slot].set(new_pyr.data, mode="drop"),
        feat_refpack=ms.feat_refpack.at[wdest, kf_slot].set(
            packed, mode="drop"
        ),
    )
    if cfg.bwd_window_cache:
        upd["feat_refwin"] = ms.feat_refwin.at[wdest, kf_slot].set(
            wins, mode="drop"
        )
        upd["feat_reforg"] = ms.feat_reforg.at[wdest, kf_slot].set(
            orgs, mode="drop"
        )
    ms = ms._replace(**upd)

    metrics = {
        "n_matches": n_matches,
        "n_added": n_added,
        "is_keyframe": is_kf,
        "resolve_fired": resolve_fired,
        # per-lane arrays for host-side observability (patch-history
        # inspector, debug overlays); scalar-only consumers skip ndim>0
        "feat_point": pt_idx,
        "feat_px": to_px,
        "feat_matched": matched,
    }
    return ms, map_state, metrics
