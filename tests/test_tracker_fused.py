"""Fused Newton tracker: derivative correctness + lane-by-lane parity with
the autodiff tracker (ops/tracker.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from slam_robot_tpu.ops import patch as patch_ops
from slam_robot_tpu.ops import pyramid as pyr
from slam_robot_tpu.ops import tracker, tracker_fused
from slam_robot_tpu.ops.pallas import newton

from test_tracker import make_texture, shift_image

WEIGHT = patch_ops.radial_mask(13)
ITERS = 6


def setup(rng, dx=2.5, dy=-1.5, depth=4):
    img = make_texture(rng)
    img2 = shift_image(img, dx, dy)
    pa = pyr.build_pyramid(jnp.asarray(img), depth=depth)
    pb = pyr.build_pyramid(jnp.asarray(img2), depth=depth)
    return pa, pb


def test_hand_derivatives_match_autodiff(rng):
    """The kernel's closed-form grad/Hessian == jax.grad / jacfwd of the
    same banded-extraction window score (one Newton step comparison)."""
    win = jnp.asarray(rng.uniform(0.2, 0.8, size=(5, 32, 32)).astype(np.float32))
    ref = jnp.asarray(rng.uniform(0.2, 0.8, size=(5, 13, 13)).astype(np.float32))
    pos0 = jnp.asarray(rng.uniform(11.2, 13.7, size=(5, 2)).astype(np.float32))
    org = jnp.zeros((5, 2), jnp.float32)
    rv = jnp.ones((5, 13, 13), jnp.float32)
    rmean = jnp.mean(ref, axis=(1, 2))
    rss = jnp.mean(ref * ref, axis=(1, 2))

    got, _ = newton.newton_level(
        win, pos0, org, ref, rv, rmean, rss, jnp.ones((5,)), WEIGHT,
        jnp.full((5, 2), 32.0), threshold=1e-9, max_iters=1, backend="xla",
    )

    # reference: autodiff of the identical window score
    def score(xy, f):
        fx = xy[0] - jnp.floor(xy[0])
        fy = xy[1] - jnp.floor(xy[1])
        x0 = jnp.floor(xy[0]).astype(jnp.int32) - 6
        y0 = jnp.floor(xy[1]).astype(jnp.int32) - 6
        rows = jnp.arange(13)[:, None] + jnp.arange(32)[None, :] * 0
        k = jnp.arange(32)[None, :]
        rowm = (
            jnp.where(k == rows + y0, 1.0 - fy, 0.0)
            + jnp.where(k == rows + y0 + 1, fy, 0.0)
        )
        colm = (
            jnp.where(k == rows + x0, 1.0 - fx, 0.0)
            + jnp.where(k == rows + x0 + 1, fx, 0.0)
        )
        p2 = rowm @ win[f] @ colm.T
        m2 = jnp.mean(p2)
        ss2 = jnp.mean(p2 * p2)
        alpha = jnp.sqrt(rss[f] / jnp.maximum(ss2, 1e-12))
        beta = rmean[f] - alpha * m2
        d = ref[f] - alpha * p2 - beta
        return jnp.sum(d * d * WEIGHT)

    for f in range(5):
        g = jax.grad(score)(pos0[f], f)
        h = jax.jacfwd(jax.grad(score))(pos0[f], f)
        det = h[0, 0] * h[1, 1] - h[0, 1] * h[1, 0]
        d = -jnp.stack([
            h[1, 1] * g[0] - h[0, 1] * g[1],
            -h[1, 0] * g[0] + h[0, 0] * g[1],
        ]) / det
        n = jnp.linalg.norm(d)
        d = jnp.where(n > 1.0, d / n, d)
        want = pos0[f] + jnp.clip(d, -1, 1)
        np.testing.assert_allclose(np.asarray(got[f]), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_track_feature_parity_with_autodiff_tracker(rng):
    pa, pb = setup(rng)
    pts = jnp.asarray(rng.uniform(30, 90, size=(16, 2)).astype(np.float32))
    lvls = jnp.asarray([3, 4] * 8, jnp.int32)

    patches = tracker_fused.get_patch_stacks(pa, pts)
    got_pos, got_ok = tracker_fused.track_feature_batch(
        pb, patches, pts, lvls, WEIGHT, max_iters=ITERS, backend="xla",
    )

    def one(p, lv):
        stack = tracker.get_patch_stack(pa, p)
        return tracker.track_feature(pb, stack, p, lv, WEIGHT,
                                     max_iters=ITERS)

    want_pos, want_ok = jax.vmap(one)(pts, lvls)

    np.testing.assert_array_equal(np.asarray(got_ok), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    np.testing.assert_allclose(
        np.asarray(got_pos)[ok], np.asarray(want_pos)[ok], atol=2e-3,
    )


def test_bidirectional_parity(rng):
    pa, pb = setup(rng, dx=3.2, dy=2.1)
    pts = jnp.asarray(rng.uniform(35, 85, size=(12, 2)).astype(np.float32))
    lvls = jnp.full((12,), 4, jnp.int32)
    active = jnp.asarray([True] * 10 + [False] * 2)

    got_px, got_ok = tracker_fused.track_bidirectional_batch(
        pa, pb, pts, pts, lvls, WEIGHT, max_iters=ITERS, active=active,
        backend="xla",
    )

    def one(p, act):
        return tracker.track_bidirectional(pa, pb, p, p, 4, WEIGHT,
                                           max_iters=ITERS, active=act)

    want_px, want_ok = jax.vmap(one)(pts, active)
    np.testing.assert_array_equal(np.asarray(got_ok), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    np.testing.assert_allclose(
        np.asarray(got_px)[ok], np.asarray(want_px)[ok], atol=5e-3,
    )
    assert np.asarray(got_ok).sum() > 6  # the scene is trackable


@pytest.mark.parametrize("F", [5, 32, 256])
def test_kernel_interpret_matches_xla(rng, F):
    """The Triton Newton kernel (in the Pallas interpreter) against the
    plain XLA sweep: one program per lane at any lane count, inactive
    lanes untouched, windows offset from the level origin."""
    win = jnp.asarray(rng.uniform(0.1, 0.9, size=(F, 32, 32)).astype(np.float32))
    ref = jnp.asarray(rng.uniform(0.1, 0.9, size=(F, 13, 13)).astype(np.float32))
    pos0 = jnp.asarray(rng.uniform(4.0, 30.0, size=(F, 2)).astype(np.float32))
    org = jnp.asarray(rng.integers(-8, 4, size=(F, 2)).astype(np.float32))
    rv = jnp.asarray(rng.uniform(size=(F, 13, 13)) > 0.1, jnp.float32)
    active = jnp.asarray(rng.uniform(size=F) > 0.2, jnp.float32)
    args = (win, pos0, org, ref, rv, jnp.mean(ref, axis=(1, 2)),
            jnp.mean(ref * ref, axis=(1, 2)), active, WEIGHT,
            jnp.full((F, 2), 30.0))
    kw = dict(max_iters=ITERS)
    px, sx = newton.newton_level(*args, backend="xla", **kw)
    pi, si = newton.newton_level(*args, backend="interpret", **kw)
    np.testing.assert_allclose(np.asarray(px), np.asarray(pi), atol=1e-4)
    np.testing.assert_array_equal(np.asarray(sx), np.asarray(si))
    off = ~np.asarray(active, bool)
    np.testing.assert_array_equal(np.asarray(pi)[off], np.asarray(pos0)[off])


def test_kernel_interpret_matches_xla_on_tracker_windows():
    """Kernel vs XLA sweep on windows and reference patches cut by the
    tracker's own gathers from a textured frame pair, every level."""
    from slam_robot_tpu.utils import kernel_check as kc

    rows = kc.newton_errors("interpret", h=120, w=160, depth=4, lanes=32)
    assert len(rows) == 4
    for lvl, dims, err, n_over, n_status in rows:
        assert n_over == 0 and n_status == 0, (lvl, dims, err)


def test_packed_cache_path_matches_patch_path(rng):
    """pack_stacks + packed gather path == the Patch path bit-for-bit
    (the matcher's per-view packed cache is the same data, one gather)."""
    pa, pb = setup(rng)
    F = 24
    pts = jnp.asarray(rng.uniform(30, 90, size=(F, 2)).astype(np.float32))
    lvls = jnp.asarray(rng.integers(2, 5, size=(F,)), jnp.int32)
    stacks = tracker_fused.get_patch_stacks(pa, pts)
    packed = tracker_fused.pack_stacks(stacks)

    pos_a, ok_a = tracker_fused.track_feature_batch(
        pb, stacks, pts, lvls, WEIGHT, max_iters=ITERS, backend="xla")
    pos_b, ok_b = tracker_fused.track_feature_batch(
        pb, None, pts, lvls, WEIGHT, max_iters=ITERS, backend="xla",
        packed=packed)
    np.testing.assert_array_equal(np.asarray(pos_a), np.asarray(pos_b))
    np.testing.assert_array_equal(np.asarray(ok_a), np.asarray(ok_b))

    # view-indexed form: [F, V, L, D] cache with per-lane view picks
    V = 3
    packed_v = jnp.stack([jnp.roll(packed, s, axis=0) for s in range(V)], 1)
    vidx = jnp.asarray(rng.integers(0, V, size=(F,)), jnp.int32)
    pos_c, ok_c = tracker_fused.track_feature_batch(
        pb, None, pts, lvls, WEIGHT, max_iters=ITERS, backend="xla",
        packed=packed_v, packed_view_idx=vidx)
    # lanes that picked view 0 (unrolled cache) must equal the plain path
    sel = np.asarray(vidx) == 0
    assert sel.any()
    np.testing.assert_array_equal(np.asarray(pos_c)[sel], np.asarray(pos_a)[sel])
    np.testing.assert_array_equal(np.asarray(ok_c)[sel], np.asarray(ok_a)[sel])


def test_bwd_ref_from_window_matches_extraction():
    """Window-sourced backward reference patches reproduce the
    plane-extracted path exactly while the support stays inside the
    forward windows (the common case by construction)."""
    import numpy as np

    from slam_robot_tpu.ops import pyramid as pyr_mod
    from slam_robot_tpu.ops import tracker_fused as tf

    rng = np.random.default_rng(5)
    h0, w0 = 120, 160
    base = rng.random((h0, w0), np.float32)
    # mild shift between "view" and "new" frames
    img1 = np.roll(base, (2, 3), axis=(0, 1))
    p_from = pyr_mod.build_pyramid(jnp.asarray(base), 4, 1.1, 0.8)
    p_to = pyr_mod.build_pyramid(jnp.asarray(img1), 4, 1.1, 0.8)

    F = 24
    pts = jnp.asarray(
        rng.uniform([30, 30], [w0 - 30, h0 - 30], (F, 2)).astype(np.float32)
    )
    lvls = jnp.full((F,), 3, jnp.int32)
    weight = np.asarray(
        __import__("slam_robot_tpu.ops.patch", fromlist=["radial_mask"])
        .radial_mask(13, 15.0)
    )
    weight = jnp.asarray(weight)
    stacks = tf.get_patch_stacks(p_from, pts, 13)
    packed = tf.pack_stacks(stacks)

    start = pts + jnp.asarray([3.0, 2.0])
    kw = dict(threshold=0.001, max_iters=6, roundtrip_px=0.5,
              backend="xla", p1_packed=packed)
    to_a, ok_a = tf.track_bidirectional_batch(
        p_from, p_to, pts, start, lvls, weight,
        bwd_ref_from_window=False, **kw)
    to_b, ok_b = tf.track_bidirectional_batch(
        p_from, p_to, pts, start, lvls, weight,
        bwd_ref_from_window=True, **kw)
    np.testing.assert_array_equal(np.asarray(ok_a), np.asarray(ok_b))
    np.testing.assert_allclose(np.asarray(to_a), np.asarray(to_b),
                               atol=1e-4)


def test_patch_stacks_from_windows_bit_identical():
    """Keyframe refpack via window re-reads must be BIT-identical to plane
    extraction (matcher.py keyframe branch relies on it: any fp-level
    difference in reference patches forks the keyframe cadence chaotically,
    PERF.md finding 15)."""
    import numpy as np

    from slam_robot_tpu.ops import pyramid as pyr_mod
    from slam_robot_tpu.ops import tracker_fused

    rng = np.random.default_rng(3)
    img = jnp.asarray(rng.uniform(0, 1, (120, 160)).astype(np.float32))
    pyr = pyr_mod.build_pyramid(img, depth=4)
    K = 48
    pts = jnp.asarray(np.stack(
        [rng.uniform(-5, 165, K), rng.uniform(-5, 125, K)], -1
    ).astype(np.float32))
    wins, orgs = tracker_fused.get_window_stacks(pyr, pts)
    a = tracker_fused.get_patch_stacks(pyr, pts, 13)
    b = tracker_fused.get_patch_stacks_from_windows(pyr, pts, wins, orgs, 13)
    for f in ("data", "valid", "mean", "sumsq"):
        av, bv = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert np.array_equal(av, bv), f"{f} differs"


def test_gather_windows_bit_identical_to_dynamic_slice():
    """_gather_windows' row-gather + one-hot column select is a pure
    relayout of a vmapped dynamic_slice — it must return bit-identical windows, or the keyframe cadence forks
    chaotically (PERF.md finding 15)."""
    import numpy as np

    from jax import lax
    from slam_robot_tpu.ops import pyramid as pyr_mod
    from slam_robot_tpu.ops import tracker_fused as tf

    rng = np.random.default_rng(7)
    img = jnp.asarray(rng.uniform(0, 1, (120, 160)).astype(np.float32))
    p = pyr_mod.build_pyramid(img, depth=4)
    K = 40
    # include off-image and NaN positions (clamped/zeroed like the matcher)
    pts = np.stack([rng.uniform(-30, 190, K), rng.uniform(-30, 150, K)],
                   -1).astype(np.float32)
    pts[0] = np.nan
    pts[1] = [1e9, -1e9]
    pts = jnp.asarray(pts)
    dims = tf._static_dims(p)
    for lvl in range(p.depth):
        h, w = dims[lvl]
        wh = min(tf.WIN, h + 2 * pyr_mod.PAD)
        ww = min(tf.WIN, w + 2 * pyr_mod.PAD)
        win, org = tf._gather_windows(p, lvl, pts / (2.0 ** lvl), wh, ww)

        # reference: the vmapped per-lane dynamic_slice this replaced
        j = jnp.broadcast_to(jnp.asarray(p.offset + lvl), (K,))
        pc = jnp.clip(jnp.nan_to_num(pts / (2.0 ** lvl)), -1e6, 1e6)
        hp, wp = h + 2 * pyr_mod.PAD, w + 2 * pyr_mod.PAD
        ox = jnp.clip(jnp.floor(pc[:, 0]).astype(jnp.int32)
                      - tf.MARGIN_PX + pyr_mod.PAD, 0, wp - ww)
        oy = jnp.clip(jnp.floor(pc[:, 1]).astype(jnp.int32)
                      - tf.MARGIN_PX + pyr_mod.PAD, 0, hp - wh)
        ref = jax.vmap(
            lambda j1, oy1, ox1: lax.dynamic_slice(
                p.data, (j1, oy1, ox1), (1, wh, ww))[0]
        )(j, oy, ox)
        assert np.array_equal(np.asarray(win), np.asarray(ref)), f"lvl {lvl}"
        np.testing.assert_array_equal(
            np.asarray(org),
            np.stack([np.asarray(ox) - pyr_mod.PAD,
                      np.asarray(oy) - pyr_mod.PAD], -1).astype(np.float32))
