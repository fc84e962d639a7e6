import jax
import jax.numpy as jnp
import numpy as np

from slam_robot_tpu.ops import brute, klt, patch as patch_ops, pyramid as pyr, tracker

from test_tracker import make_texture, shift_image  # reuse fixtures

WEIGHT = patch_ops.radial_mask(13)


def setup(rng, dx=2.5, dy=-1.5):
    img = make_texture(rng)
    img2 = shift_image(img, dx, dy)
    pa = pyr.build_pyramid(jnp.asarray(img), depth=4)
    pb = pyr.build_pyramid(jnp.asarray(img2), depth=4)
    pt = jnp.array([80.0, 60.0])
    patches = tracker.get_patch_stack(pa, pt)
    return pa, pb, pt, patches


def test_klt_tracks_shift(rng):
    pa, pb, pt, patches = setup(rng)
    out, ok = klt.track_feature(pb, patches, pt, 3, WEIGHT)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(out), [82.5, 58.5], atol=0.2)


def test_klt_rejects_oob(rng):
    pa, pb, pt, patches = setup(rng)
    out, ok = klt.track_feature(pb, patches, jnp.array([-40.0, -40.0]), 3, WEIGHT)
    assert not bool(ok)
    assert np.all(np.isfinite(np.asarray(out)))


def test_brute_tracks_shift(rng):
    pa, pb, pt, patches = setup(rng)
    out, ok = brute.track_feature(pb, patches, pt, 3)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(out), [82.5, 58.5], atol=0.2)


def test_brute_rejects_decorrelated(rng):
    pa, _, pt, patches = setup(rng)
    other = make_texture(np.random.default_rng(123))
    pb = pyr.build_pyramid(jnp.asarray(other), depth=4)
    _, ok = brute.track_feature(pb, patches, pt, 3, sad_threshold=2.0)
    assert not bool(ok)


def test_alt_trackers_vmap(rng):
    pa, pb, _, _ = setup(rng)
    pts = jnp.asarray(rng.uniform(40, 80, size=(8, 2)).astype(np.float32))

    def one(p):
        patches = tracker.get_patch_stack(pa, p)
        return klt.track_feature(pb, patches, p, 3, WEIGHT)

    outs, oks = jax.jit(jax.vmap(one))(pts)
    good = np.asarray(oks)
    err = np.linalg.norm(np.asarray(outs) - (np.asarray(pts) + [2.5, -1.5]), axis=1)
    assert good.mean() > 0.7 and np.all(err[good] < 0.3)


def test_matcher_with_klt_tracker(rng):
    import dataclasses

    from slam_robot_tpu.models import localmap as lm, matcher
    from test_matcher import CFG, fresh, texture, shift

    cfg = dataclasses.replace(CFG, tracker_kind="klt")
    ms, s = fresh()
    img0 = texture(0)
    s, f0 = lm.add_frame(s, 0)
    ms, s, m0 = matcher.track(ms, s, jnp.asarray(img0), f0, 0, cfg)
    assert int(m0["n_added"]) > 5
    s, f1 = lm.add_frame(s, 1)
    ms, s, m1 = matcher.track(ms, s, jnp.asarray(shift(img0, 2, 1)), f1, 1, cfg)
    assert int(m1["n_matches"]) >= cfg.min_matches


def test_brute_per_level_refine_cascade(rng):
    """Regression (round-1 verdict): each coarse level must run the
    (window 3, res 1) + (window 1, res 1/3) scan pair of brute.h:147-148
    (the old level step was dead code collapsing to one 1-px scan). A
    displacement with a strong sub-pixel component tracks tightly."""
    pa, pb, pt, patches = setup(rng, dx=6.3, dy=-4.7)
    out, ok = brute.track_feature(pb, patches, pt, 4)
    assert bool(ok)
    np.testing.assert_allclose(np.asarray(out), [86.3, 55.3], atol=0.2)
