"""Batched coarse-to-fine tracker driving the fused Newton level kernel.

Same semantics as ops/tracker.py's track_feature / track_bidirectional
(hessian.h:243-264 + matcher.cpp:173-206), restructured for batched
fixed-shape execution:

- the pyramid level index is a STATIC Python int (one kernel per level), so
  each level's true extents are compile-time constants
- per level, every lane's 32x32 search window is gathered ONCE (one vmapped
  dynamic_slice), sized to cover the full Newton budget (<= max_iters px of
  motion + 13x13 patch + bilinear support — ops/pallas/newton.MARGIN_PX)
- all Newton iterations for all lanes then run in ONE sweep
  (ops/pallas/newton.py: the Triton kernel on a GPU, the plain XLA form
  elsewhere), replacing per-iteration per-lane gathers
- levels with no active lane are skipped with lax.cond, like the matcher's
  empty find-steps

Numerically this matches the autodiff tracker: the kernel's hand-derived
gradient/Hessian are the exact derivatives of the same photometric score
(tests/test_tracker_fused.py checks both against jax.grad/jacfwd and
against ops/tracker.track_feature lane by lane).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from slam_robot_tpu.ops import patch as patch_ops
from slam_robot_tpu.ops import tracker as tracker_ref
from slam_robot_tpu.ops.pallas.newton import MARGIN_PX, newton_level
from slam_robot_tpu.ops.pyramid import PAD, FlatPyramid, level_dims

WIN = 32  # search window (>= 13 + 1 bilinear + 2 * Newton budget, cap 32)


def default_backend() -> str:
    """The Triton Newton kernel on a GPU, the plain XLA sweep elsewhere."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def _static_dims(pyr: FlatPyramid):
    plane_h, plane_w = pyr.data.shape[-2] - 2 * PAD, pyr.data.shape[-1] - 2 * PAD
    return level_dims(plane_h, plane_w, pyr.depth)


def _gather_windows(pyr: FlatPyramid, level: int, pos, wh: int, ww: int):
    """Per-lane (wh x ww) windows around ``pos`` from one pyramid level.

    Returns (win [F,wh,ww], org [F,2] absolute level coords of win[0,0]).
    Window origins are clamped inside the level's padded extent, so edge
    windows stay flush with the padded border and the kernel's support
    clamp reproduces ops/patch.extract's replicate-edge behavior.
    """
    dims = _static_dims(pyr)
    h, w = dims[level]
    hp, wp = h + 2 * PAD, w + 2 * PAD
    # pyr.offset may be a scalar (one pyramid) or per-lane vector (the
    # matcher's per-lane view pick into the stacked view ring)
    j = jnp.broadcast_to(jnp.asarray(pyr.offset + level), pos.shape[:1])

    p = jnp.clip(jnp.nan_to_num(pos), -1e6, 1e6)
    ox = jnp.clip(
        jnp.floor(p[:, 0]).astype(jnp.int32) - MARGIN_PX + PAD, 0, wp - ww
    )
    oy = jnp.clip(
        jnp.floor(p[:, 1]).astype(jnp.int32) - MARGIN_PX + PAD, 0, hp - wh
    )

    # Row-gather + exact one-hot column select instead of a vmapped
    # dynamic_slice, which XLA lowered to a per-lane
    # slice/dynamic-update-slice while loop. Row gathers from a FLAT
    # [P*Hp, Wp] table are cheap, and the 0/1 one-hot column matmul
    # (HIGHEST precision) is EXACT (one nonzero
    # per output: 1.0*v + 0*finite = v bit-for-bit, the refpack
    # precedent), so this is a pure relayout of the same copy: the
    # returned windows are bit-identical and the goldens don't move.
    P, Hp, Wp = pyr.data.shape
    flat = pyr.data.reshape(P * Hp, Wp)
    rows = (j * Hp + oy)[:, None] + jnp.arange(wh, dtype=jnp.int32)[None, :]
    band = flat[rows]                                      # [F, wh, Wp]
    cols = ox[:, None] + jnp.arange(ww, dtype=jnp.int32)[None, :]
    onehot = (cols[:, :, None]
              == jnp.arange(Wp, dtype=jnp.int32)[None, None, :]
              ).astype(pyr.data.dtype)                     # [F, ww, Wp]
    win = lax.dot_general(
        band, onehot, (((2,), (2,)), ((0,), (0,))),
        precision=lax.Precision.HIGHEST,
    )                                                      # [F, wh, ww]
    org = jnp.stack([ox - PAD, oy - PAD], -1).astype(jnp.float32)
    return win, org


def _extract_refs(ref_pyr: FlatPyramid, level: int, ref_pts, offs, size: int):
    """Per-lane reference patches for one level: extract at ref_pts / 2^level
    from ref_pyr (per-lane plane offs + level)."""
    dims = _static_dims(ref_pyr)
    h, w = dims[level]
    scale = jnp.float32(2.0 ** level)

    def one(pt, j):
        return patch_ops.extract(ref_pyr.data, w, h, pt / scale, size,
                                 index=j + level)

    return jax.vmap(one)(jnp.clip(jnp.nan_to_num(ref_pts), -1e6, 1e6), offs)


def pack_stacks(p: patch_ops.Patch) -> jnp.ndarray:
    """Pack a per-level reference Patch stack [F, L, S, S] into ONE flat
    array [F, L, 2*S*S+2] (data | valid | mean | sumsq). XLA row gathers
    are latency-bound per ROW regardless of row size (PERF.md), so reading
    the cache as one packed gather instead of four separate ones quarters
    the dominant per-level cache cost of a tracker sweep."""
    F, L, S = p.data.shape[0], p.data.shape[1], p.data.shape[2]
    return jnp.concatenate(
        [
            p.data.reshape(F, L, S * S),
            p.valid.astype(jnp.float32).reshape(F, L, S * S),
            p.mean[..., None],
            p.sumsq[..., None],
        ],
        axis=-1,
    )


def _unpack(pk, S: int):
    """Inverse of pack_stacks for one level: pk [C, 2*S*S+2]."""
    C = pk.shape[0]
    refd = pk[:, : S * S].reshape(C, S, S)
    refv = pk[:, S * S: 2 * S * S].reshape(C, S, S)
    return refd, refv, pk[:, 2 * S * S], pk[:, 2 * S * S + 1]


def _sample_from_windows(win, org, pt, w_img: float, h_img: float, size: int):
    """Bilinear 13x13 patch at level coords ``pt`` from per-lane windows.

    Mirrors ops/patch.extract semantics with the WINDOW as the pixel
    source: support clamps to the window extent; validity requires the
    bilinear support inside BOTH the true image and the window. Pure
    vectorized math — no per-lane plane gathers.

    win [F,wh,ww], org [F,2] absolute level coords of win[0,0], pt [F,2].
    Returns (data [F,S,S], valid [F,S,S] f32, mean [F], sumsq [F]).
    """
    F, wh, ww = win.shape
    S = size
    half = (S - 1) // 2
    p = jnp.clip(jnp.nan_to_num(pt), -1e6, 1e6)
    lx = p[:, 0] - org[:, 0]
    ly = p[:, 1] - org[:, 1]
    x0f = jnp.floor(lx)
    y0f = jnp.floor(ly)
    fx = lx - x0f
    fy = ly - y0f
    x0 = x0f.astype(jnp.int32) - half
    y0 = y0f.astype(jnp.int32) - half
    x0c = jnp.clip(x0, 0, ww - (S + 1))
    y0c = jnp.clip(y0, 0, wh - (S + 1))

    def banded(frac, start, length):
        i = lax.broadcasted_iota(jnp.int32, (F, S, length), 1)
        k = lax.broadcasted_iota(jnp.int32, (F, S, length), 2)
        st = start[:, None, None]
        fr = frac[:, None, None]
        return (
            jnp.where(k == i + st, 1.0 - fr, 0.0)
            + jnp.where(k == i + st + 1, fr, 0.0)
        )

    rowm = banded(fy, y0c, wh)                      # [F,S,wh]
    colm = banded(fx, x0c, ww).transpose(0, 2, 1)   # [F,ww,S]
    bd = lambda a, b: lax.dot_general(
        a, b, (((2,), (1,)), ((0,), (0,))), precision=lax.Precision.HIGHEST
    )
    data = bd(bd(rowm, win), colm)                  # [F,S,S]

    gi = lax.broadcasted_iota(jnp.int32, (F, S), 1)
    gx = (x0 + org[:, 0].astype(jnp.int32))[:, None] + gi
    gy = (y0 + org[:, 1].astype(jnp.int32))[:, None] + gi
    vx = (gx >= 0) & (gx.astype(jnp.float32) + 1.0 <= w_img)
    vy = (gy >= 0) & (gy.astype(jnp.float32) + 1.0 <= h_img)
    wx = (x0[:, None] + gi >= 0) & (x0[:, None] + gi + 1 <= ww)
    wyv = (y0[:, None] + gi >= 0) & (y0[:, None] + gi + 1 <= wh)
    valid = (
        (vy & wyv).astype(jnp.float32)[:, :, None]
        * (vx & wx).astype(jnp.float32)[:, None, :]
    )
    mean = jnp.mean(data, axis=(1, 2))
    sumsq = jnp.mean(data * data, axis=(1, 2))
    return data, valid, mean, sumsq


def track_feature_batch(pyr: FlatPyramid, patches: patch_ops.Patch | None,
                        pts, lvls, weight, threshold: float = 0.001,
                        max_iters: int = 10, active=None,
                        iters_coarse: int = 0,
                        backend: str | None = None,
                        ref_pyr: FlatPyramid | None = None, ref_pts=None,
                        packed=None, packed_view_idx=None,
                        return_windows: bool = False,
                        win_cache=None):
    """Batched TrackFeature (hessian.h:243-264): coarse-to-fine cascade with
    per-lane dynamic level counts. pts [F,2].

    Reference patches come one of three ways:
    - ``packed``: pack_stacks output, [F, L, 2S²+2] — or [F, V, L, 2S²+2]
      with ``packed_view_idx`` [F] selecting each lane's view, so the
      matcher's whole per-view cache is passed unsliced and each level
      reads it with ONE row gather (over only the compacted lanes)
    - ``patches``: stacked Patch with leading axes [F, L]
    - ``ref_pyr``/``ref_pts``: extracted per level at ``ref_pts / 2^level``
      — only for levels that actually run, which is what the backward pass
      wants.

    Lane compaction: each level sweep runs at the smallest static lane
    bucket (32 / 128 / F) that holds its active lanes, so a straggler
    retry pass or two far-pyramid lanes don't bill the full feature table.
    Results merge back scatter-free via one-hot matmuls.

    Returns (pos [F,2], ok [F] bool)."""
    backend = backend or default_backend()
    S = int(weight.shape[0])
    if max_iters > MARGIN_PX - (S - 1) // 2:
        raise ValueError(
            f"max_iters={max_iters} exceeds the {WIN}x{WIN} window's Newton "
            f"budget ({MARGIN_PX - (S - 1) // 2}); grow "
            "MARGIN_PX/WIN in ops/pallas/newton.py or lower the budget"
        )
    if (patches is None and packed is None
            and (ref_pyr is None or ref_pts is None)):
        raise ValueError("need packed, patches, or (ref_pyr, ref_pts)")
    dims = _static_dims(pyr)
    L = pyr.depth
    F = pts.shape[0]
    lvls = jnp.asarray(lvls, jnp.int32)
    if active is None:
        active = jnp.ones((F,), bool)
    active = jnp.asarray(active, bool)

    offs = jnp.broadcast_to(jnp.asarray(pyr.offset), (F,))
    roffs = (
        jnp.broadcast_to(jnp.asarray(ref_pyr.offset), (F,))
        if ref_pyr is not None else jnp.zeros((F,), jnp.int32)
    )

    scale0 = (2.0 ** (lvls - 1)).astype(jnp.float32)
    pos = jnp.asarray(pts, jnp.float32) / scale0[:, None]
    status = jnp.zeros((F,), jnp.float32)

    buckets = [c for c in (32, 64, 128) if c < F] + [F]
    lane_ids = jnp.arange(F)
    windows = [None] * L  # per-level (win_full [F,wh,ww], org_full [F,2])

    for k in range(L):
        i = L - 1 - k
        h, w = dims[i]
        wh, ww = min(WIN, h + 2 * PAD), min(WIN, w + 2 * PAD)
        lvl_on = i <= lvls - 1
        take = lvl_on & (status == 0.0) & active
        cnt = jnp.sum(take.astype(jnp.int32))
        bounds_val = jnp.array([float(w), float(h)], jnp.float32)

        def run_at(C, _i=i, _wh=wh, _ww=ww):
            compact = C < F

            def run(args):
                pos, status, take = args
                if compact:
                    sel = jnp.argsort(~take)[:C]  # actives first (stable)
                else:
                    sel = lane_ids
                posC = pos[sel]
                takeC = take[sel]
                if win_cache is not None:
                    # pre-gathered per-lane windows (flat-table reads
                    # instead of per-lane plane slices). NOTE: the caller
                    # gathers the view-selected rows ONCE per sweep —
                    # per-bucket double-fancy indexing into the 5-D cache
                    # measured slower (bit-identical trajectories).
                    cwins, corgs = win_cache
                    if compact:
                        win = cwins[sel, _i, :_wh, :_ww]
                        org = corgs[sel, _i]
                    else:
                        win = cwins[:, _i, :_wh, :_ww]
                        org = corgs[:, _i]
                else:
                    pyrC = FlatPyramid(pyr.data, pyr.heights, pyr.widths,
                                       pyr.depth_, offs[sel])
                    win, org = _gather_windows(pyrC, _i, posC, _wh, _ww)
                if return_windows:
                    # merge this bucket's windows back to full-F rows so
                    # the caller can sample backward reference patches
                    # from them without re-touching the image planes
                    if compact:
                        ohw = ((sel[None, :] == lane_ids[:, None])
                               & takeC[None, :]).astype(jnp.float32)
                        win_full = jnp.matmul(
                            ohw, win.reshape(C, _wh * _ww),
                            precision=lax.Precision.HIGHEST,
                        ).reshape(F, _wh, _ww)
                        org_full = jnp.matmul(
                            ohw, org, precision=lax.Precision.HIGHEST
                        )
                    else:
                        win_full, org_full = win, org
                else:
                    win_full = jnp.zeros((0,), jnp.float32)
                    org_full = jnp.zeros((0,), jnp.float32)
                if packed is not None:
                    if packed_view_idx is not None:
                        pk = packed[sel, packed_view_idx[sel], _i]
                    elif compact:
                        pk = packed[sel, _i]
                    else:
                        pk = packed[:, _i]  # static slice, no gather
                    refd, refv, refm, refs = _unpack(pk, S)
                elif patches is not None:
                    refd = patches.data[sel, _i]
                    refv = patches.valid[sel, _i].astype(jnp.float32)
                    refm = patches.mean[sel, _i]
                    refs = patches.sumsq[sel, _i]
                else:
                    p = _extract_refs(ref_pyr, _i, ref_pts[sel], roffs[sel], S)
                    refd, refv = p.data, p.valid.astype(jnp.float32)
                    refm, refs = p.mean, p.sumsq
                new_posC, stC = newton_level(
                    win, posC, org, refd, refv, refm, refs,
                    takeC.astype(jnp.float32), weight,
                    jnp.broadcast_to(bounds_val, (C, 2)),
                    threshold=float(threshold),
                    # coarse levels only need to land within the next
                    # level's capture basin; level 0 gets the full budget
                    max_iters=int(max_iters if _i == 0 or not iters_coarse
                                  else min(iters_coarse, max_iters)),
                    size=S, backend=backend,
                )
                if compact:
                    # scatter-free merge: one-hot dot. Precision MUST be
                    # pinned: a reduced-precision default (TF32 on the
                    # GPU) would quantize pixel coordinates.
                    oh = ((sel[None, :] == lane_ids[:, None]) & takeC[None, :]
                          ).astype(jnp.float32)
                    row = jnp.sum(oh, axis=1)
                    pos = pos * (1.0 - row)[:, None] + jnp.matmul(
                        oh, new_posC, precision=lax.Precision.HIGHEST
                    )
                    status = status * (1.0 - row) + jnp.matmul(
                        oh, stC, precision=lax.Precision.HIGHEST
                    )
                else:
                    pos = jnp.where(takeC[:, None], new_posC, pos)
                    status = jnp.where(takeC, stC, status)
                return pos, status, win_full, org_full

            return run

        def skip(args, _wh=wh, _ww=ww):
            pos, status, _ = args
            if return_windows:
                return (pos, status, jnp.zeros((F, _wh, _ww), jnp.float32),
                        jnp.zeros((F, 2), jnp.float32))
            z = jnp.zeros((0,), jnp.float32)
            return pos, status, z, z

        branches = [skip] + [run_at(C) for C in buckets]
        idx = sum((cnt > jnp.int32(t)).astype(jnp.int32)
                  for t in [0] + buckets[:-1])
        pos, status, win_full, org_full = lax.switch(
            idx, branches, (pos, status, take)
        )
        if return_windows:
            windows[i] = (win_full, org_full)
        if i > 0:
            pos = jnp.where(lvl_on[:, None], pos * 2.0, pos)

    ok = (status == 0.0) & active
    if return_windows:
        return pos, ok, windows
    return pos, ok


def get_patch_stacks(pyr: FlatPyramid, pts, size: int = 13) -> patch_ops.Patch:
    """Per-lane per-level reference patches: Patch with axes [F, L, ...]."""
    return jax.vmap(lambda p: tracker_ref.get_patch_stack(pyr, p, size))(pts)


def get_patch_stacks_from_windows(pyr: FlatPyramid, pts, wins, orgs,
                                  size: int = 13) -> patch_ops.Patch:
    """BIT-IDENTICAL get_patch_stacks, reading pixel support from the
    per-lane window cache (get_window_stacks at the SAME ``pts``) instead
    of per-(lane, level) plane slices.

    The keyframe branch's refpack extraction was K*L latency-bound
    per-lane dynamic slices. The support windows were ALREADY gathered for the backward-window cache,
    so this re-reads them with exact 0/1 one-hot row/column selection
    matmuls — each output element is 1.0*pixel plus exact zeros, so
    unlike the banded bilinear-interpolation matmuls (which match plane
    extraction only to ~1e-5 and forked the keyframe cadence, PERF.md)
    the support copy is EXACT — followed by ops/patch.extract's
    own elementwise bilinear mix. tests/test_tracker_fused.py pins
    bit-identity against get_patch_stacks.

    Support containment: extract's clamped support start lies within the
    clamped window for every pt (support clamp [0, wp-(S+1)] vs window
    clamp [0, wp-WIN] around the same floor(pt): the offset is 6 + both
    clamps saturate toward the same edges, keeping it in [0, WIN-(S+1)]).
    """
    dims = _static_dims(pyr)
    L = pyr.depth
    K = pts.shape[0]
    S = size
    half = (S - 1) // 2
    sel_dot = lambda a, b: jax.lax.dot_general(
        a, b, (((2,), (1,)), ((0,), (0,))),
        precision=jax.lax.Precision.HIGHEST,
    )

    datas, valids, means, sumsqs = [], [], [], []
    for i in range(L):
        h, w = dims[i]
        wh, ww = min(WIN, h + 2 * PAD), min(WIN, w + 2 * PAD)
        win = wins[:, i, :wh, :ww]
        org = orgs[:, i]
        p = jnp.clip(jnp.nan_to_num(pts / (2.0 ** i)), -1e6, 1e6)
        x, y = p[:, 0], p[:, 1]
        x0 = jnp.floor(x).astype(jnp.int32)
        y0 = jnp.floor(y).astype(jnp.int32)
        fx = (x - x0.astype(jnp.float32))[:, None, None]
        fy = (y - y0.astype(jnp.float32))[:, None, None]

        # extract's support start in PADDED plane coords, then
        # window-local (org is the window start in unpadded coords)
        sy = jnp.clip(y0 - half + PAD, 0, h + 2 * PAD - (S + 1))
        sx = jnp.clip(x0 - half + PAD, 0, w + 2 * PAD - (S + 1))
        ry = sy - (org[:, 1].astype(jnp.int32) + PAD)
        rx = sx - (org[:, 0].astype(jnp.int32) + PAD)

        # exact one-hot selection of the (S+1)^2 support
        ii = jax.lax.broadcasted_iota(jnp.int32, (K, S + 1, wh), 1)
        jj = jax.lax.broadcasted_iota(jnp.int32, (K, S + 1, wh), 2)
        rsel = (jj == ii + ry[:, None, None]).astype(jnp.float32)
        ii = jax.lax.broadcasted_iota(jnp.int32, (K, ww, S + 1), 2)
        jj = jax.lax.broadcasted_iota(jnp.int32, (K, ww, S + 1), 1)
        csel = (jj == ii + rx[:, None, None]).astype(jnp.float32)
        sup = sel_dot(sel_dot(rsel, win), csel)    # [K, S+1, S+1]

        # ops/patch.extract's elementwise bilinear mix, verbatim
        d = (
            (1 - fy) * (1 - fx) * sup[:, :S, :S]
            + (1 - fy) * fx * sup[:, :S, 1:]
            + fy * (1 - fx) * sup[:, 1:, :S]
            + fy * fx * sup[:, 1:, 1:]
        )

        wf = jnp.float32(w)
        hf = jnp.float32(h)
        gi = jnp.arange(S, dtype=jnp.float32)
        gx = x0.astype(jnp.float32)[:, None] + gi - half
        gy = y0.astype(jnp.float32)[:, None] + gi - half
        vx = (gx >= 0) & (gx + 1 <= wf)
        vy = (gy >= 0) & (gy + 1 <= hf)
        valid = vy[:, :, None] & vx[:, None, :]

        n = S * S
        datas.append(d)
        valids.append(valid)
        # axis=(1,2) reduces match vmapped extract's jnp.sum(p) lowering
        # (a different reduction tree would break bit-identity)
        means.append(jnp.sum(d, axis=(1, 2)) / n)
        sumsqs.append(jnp.sum(d * d, axis=(1, 2)) / n)

    return patch_ops.Patch(
        data=jnp.stack(datas, 1),
        valid=jnp.stack(valids, 1),
        mean=jnp.stack(means, 1),
        sumsq=jnp.stack(sumsqs, 1),
    )


def get_window_stacks(pyr: FlatPyramid, pts):
    """Per-lane per-level search windows around ``pts`` (level-0 coords),
    zero-padded to [K, L, WIN, WIN], with origins [K, L, 2].

    The matcher caches these per stored view: a view's match locations
    never change, so the backward-consistency pass's windows are fixed
    the moment the view is stored — caching turns its per-sweep plane
    slices into flat-table reads. Levels whose
    padded extent is below WIN are zero-padded; consumers must slice
    [:wh, :ww] with the level's true static extents.
    """
    dims = _static_dims(pyr)
    L = pyr.depth
    K = pts.shape[0]
    offs = jnp.broadcast_to(jnp.asarray(pyr.offset), (K,))
    wins, orgs = [], []
    for i in range(L):
        h, w = dims[i]
        wh, ww = min(WIN, h + 2 * PAD), min(WIN, w + 2 * PAD)
        pyrL = FlatPyramid(pyr.data, pyr.heights, pyr.widths, pyr.depth_,
                           offs)
        win, org = _gather_windows(pyrL, i, pts / (2.0 ** i), wh, ww)
        if wh < WIN or ww < WIN:
            win = jnp.pad(win, ((0, 0), (0, WIN - wh), (0, WIN - ww)))
        wins.append(win)
        orgs.append(org)
    return jnp.stack(wins, axis=1), jnp.stack(orgs, axis=1)


def track_bidirectional_batch(pyr_from: FlatPyramid, pyr_to: FlatPyramid,
                              from_pt, init_to_pt, lvls, weight,
                              threshold: float = 0.001, max_iters: int = 10,
                              iters_coarse: int = 0,
                              roundtrip_px: float = 0.3,
                              min_variance: float = 1e-5,
                              active=None, backend: str | None = None,
                              p1_packed=None, p1_view_idx=None,
                              p1_stats0=None, bwd_lvls=None,
                              bwd_ref_from_window: bool = False,
                              bwd_win_cache=None):
    """Batched forward/backward consistency tracking (matcher.cpp:173-206)
    with the fused level kernel; mirrors ops/tracker.track_bidirectional.

    ``p1_packed`` optionally supplies precomputed packed reference stacks
    (pack_stacks) at ``from_pt`` in ``pyr_from`` (the matcher caches them
    per view — they never change once a view is stored).

    ``bwd_lvls`` optionally overrides the backward cascade's per-lane level
    counts (cfg.roundtrip_levels: the backward pass starts at the exact
    location a good roundtrip must return to, so its coarse levels only
    serve already-bad tracks); None = the reference's symmetric budget."""
    F = from_pt.shape[0]
    if active is None:
        active = jnp.ones((F,), bool)
    active = jnp.asarray(active, bool)

    S = int(weight.shape[0])
    fwd_windows = None
    if p1_packed is not None:
        fwd = track_feature_batch(
            pyr_to, None, init_to_pt, lvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse,
            active=active, backend=backend, packed=p1_packed,
            packed_view_idx=p1_view_idx,
            return_windows=bwd_ref_from_window,
        )
        if bwd_ref_from_window:
            to_pt, ok1, fwd_windows = fwd
        else:
            to_pt, ok1 = fwd
        if p1_stats0 is not None:
            tex_mean, tex_sumsq = p1_stats0[:, 0], p1_stats0[:, 1]
        elif p1_view_idx is not None:
            lanes = jnp.arange(F)
            stats = p1_packed[lanes, p1_view_idx, 0, 2 * S * S:]
            tex_mean, tex_sumsq = stats[:, 0], stats[:, 1]
        else:
            tex_mean = p1_packed[:, 0, 2 * S * S]
            tex_sumsq = p1_packed[:, 0, 2 * S * S + 1]
    else:
        to_pt, ok1 = track_feature_batch(
            pyr_to, None, init_to_pt, lvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse,
            active=active, backend=backend, ref_pyr=pyr_from,
            ref_pts=from_pt,
        )
        offs = jnp.broadcast_to(jnp.asarray(pyr_from.offset), (F,))
        p0 = _extract_refs(pyr_from, 0, from_pt, offs, S)
        tex_mean, tex_sumsq = p0.mean, p0.sumsq

    # backward: reference patches at the forward result in pyr_to
    if fwd_windows is not None:
        # sample them from the forward pass's own (merged) level windows,
        # which removes every backward per-lane extraction gather.
        # Support that drifted past the window margin is masked
        # invalid (it was headed for a roundtrip reject anyway).
        dims = _static_dims(pyr_to)
        cols = []
        for lv, wo in enumerate(fwd_windows):
            winl, orgl = wo
            h, w = dims[lv]
            d, v, m, sq = _sample_from_windows(
                winl, orgl, to_pt / (2.0 ** lv), float(w), float(h), S
            )
            cols.append(jnp.concatenate(
                [d.reshape(F, S * S), v.reshape(F, S * S),
                 m[:, None], sq[:, None]], axis=-1,
            ))
        packed_bwd = jnp.stack(cols, axis=1)  # [F, L, 2S^2+2]
        back_pt, ok2 = track_feature_batch(
            pyr_from, None, from_pt, lvls if bwd_lvls is None else bwd_lvls,
            weight, threshold, max_iters, iters_coarse=iters_coarse,
            active=ok1, backend=backend, packed=packed_bwd,
            win_cache=bwd_win_cache,
        )
    else:
        back_pt, ok2 = track_feature_batch(
            pyr_from, None, from_pt, lvls if bwd_lvls is None else bwd_lvls,
            weight, threshold, max_iters, iters_coarse=iters_coarse,
            active=ok1, backend=backend, ref_pyr=pyr_to, ref_pts=to_pt,
            win_cache=bwd_win_cache,
        )

    textured = (tex_sumsq - tex_mean ** 2) >= min_variance
    dist = jnp.linalg.norm(from_pt - back_pt, axis=-1)
    ok = ok1 & ok2 & textured & (dist <= roundtrip_px)
    return to_pt, ok
