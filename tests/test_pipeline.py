import jax.numpy as jnp
import numpy as np

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.io import sources
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.models import pipeline

CFG = SlamConfig(
    image_width=160,
    image_height=120,
    pyramid_depth=4,
    levels_unsure=4,
    max_features=96,
    max_corners=48,
    min_matches=12,
    max_frames=32,
    max_points=384,
    max_obs=8192,
    max_obs_per_point=16,
    ba_max_iters=20,
)


def scaled_intrinsics(cfg):
    # quarter-resolution version of the reference camera
    k = np.array([0, 0, 0, cfg.focal / 4, -cfg.focal / 4, cfg.image_width / 2,
                  cfg.image_height / 2], np.float32)
    return [k, k]


def run_frames(n):
    src = sources.SyntheticSource(CFG, n_frames=n, n_points=400, step_mm=10.0)
    ps = pipeline.init(CFG, scaled_intrinsics(CFG))
    history = []
    for cam, fid, img in sources.prefetch(src):
        ps, m = pipeline.step(ps, jnp.asarray(img), CFG)
        history.append({k: np.asarray(v).item() for k, v in m.items()
                        if np.asarray(v).ndim == 0})
    return ps, history, src


def test_full_loop_runs_and_converges():
    ps, hist, src = run_frames(10)
    assert len(hist) == 10
    # frame 0 keyframes and seeds
    assert hist[0]["is_keyframe"] and hist[0]["n_added"] > 5
    # later frames track
    assert all(h["n_matches"] > 5 for h in hist[1:])
    # BA keeps reprojection error small
    errs = [h["mean_reproj_err"] for h in hist[2:]]
    assert np.median(errs) < 1.0
    # normalize preserved reprojection error every frame (the ref CHECKs
    # this at main.cpp:602-605)
    assert all(h["normalize_err_drift"] < 0.1 for h in hist[1:])
    # BA runs within its iteration budget (ftol 1e-7 usually consumes the
    # whole budget on tiny windows, exactly like Ceres with 1000 iters)
    assert max(h["fast_iters"] for h in hist[2:]) <= CFG.ba_max_iters


def test_trajectory_geometry():
    ps, hist, src = run_frames(10)
    m = ps.map
    n = int(m.n_frames)
    t = np.asarray(m.frame_trans[:n])
    # normalize anchors frame 0 at the origin
    np.testing.assert_allclose(t[0], np.zeros(3), atol=1.0)
    # the stereo pair separation should be near the 150mm baseline prior
    d01 = np.linalg.norm(t[1] - t[0])
    assert 75.0 < d01 < 300.0, f"baseline {d01}"
    # the rig advances in +z over pairs
    assert t[-1][2] > t[0][2]


def test_tracking_only_mode():
    src = sources.SyntheticSource(CFG, n_frames=4, n_points=300)
    ps = pipeline.init(CFG, scaled_intrinsics(CFG))
    for cam, fid, img in sources.prefetch(src):
        ps, m = pipeline.step(ps, jnp.asarray(img), CFG, run_slam=False)
    assert int(ps.map.n_frames) == 4
    assert int(ps.total_ba_iters) == 0


def test_checked_step_flags_nan_input():
    """Numeric guards (SURVEY §5): a NaN-poisoned frame is caught by the
    checkify wrapper; a clean frame passes."""
    import jax

    src = sources.SyntheticSource(CFG, n_frames=2, n_points=300)
    ps = pipeline.init(CFG, scaled_intrinsics(CFG))
    img = jnp.asarray(src.get(0, 0))

    err, (ps2, m) = pipeline.checked_step(ps, img, CFG)
    assert err.get() is None  # clean frame: no numeric error

    bad = img.at[10:20, 10:20].set(jnp.nan)
    err, _ = pipeline.checked_step(ps, bad, CFG)
    assert err.get() is not None and "nan" in err.get().lower()


def test_window_cache_closed_loop_bit_identical():
    """bwd_window_cache must be semantics-NEUTRAL: a
    closed-loop run with the cache on produces the bit-identical trajectory,
    keyframe cadence and match counts as with it off. Round 2 traded ATE
    for the cache because keyframe-time reference patches were sampled from
    the cached windows (~1e-5 off plane extraction), forking the cadence
    chaotically; refpack is now plane-extracted in both modes."""
    import dataclasses

    cfg_on = dataclasses.replace(CFG, bwd_window_cache=True)
    cfg_off = dataclasses.replace(CFG, bwd_window_cache=False)
    assert cfg_on.bwd_ref_from_window == cfg_off.bwd_ref_from_window

    src = sources.SyntheticSource(CFG, n_frames=12, n_points=400, step_mm=10.0)
    states = {}
    for key, cfg in (("on", cfg_on), ("off", cfg_off)):
        ps = pipeline.init(cfg, scaled_intrinsics(cfg))
        kfs, matches = [], []
        for i in range(12):
            ps, m = pipeline.step(ps, jnp.asarray(src.get(i % 2, i)), cfg)
            kfs.append(bool(np.asarray(m["is_keyframe"])))
            matches.append(int(np.asarray(m["n_matches"])))
        states[key] = (ps, kfs, matches)

    (ps_on, kf_on, nm_on), (ps_off, kf_off, nm_off) = states["on"], states["off"]
    assert kf_on == kf_off, f"keyframe cadence diverged: {kf_on} vs {kf_off}"
    assert nm_on == nm_off, f"match counts diverged: {nm_on} vs {nm_off}"
    nf = int(ps_on.map.n_frames)
    np.testing.assert_array_equal(
        np.asarray(ps_on.map.frame_trans[:nf]),
        np.asarray(ps_off.map.frame_trans[:nf]),
        err_msg="trajectories diverged bitwise",
    )


def test_normalize_canary_zero_in_loop_and_detects_corruption():
    """The per-frame normalize canary (main.cpp:602-605 checks invariance
    EVERY frame): ~0 through a healthy closed loop, nonzero the moment
    post-normalize geometry disagrees with the stored error table."""
    ps, hist, src = run_frames(8)
    assert all(h["normalize_canary_px"] < 0.1 for h in hist), (
        [h["normalize_canary_px"] for h in hist]
    )

    # inject a normalize-style corruption: scale all point positions by 2%
    # without touching stored errors (what a buggy similarity transform
    # would do). The canary must see it immediately.
    m = ps.map
    bad = m._replace(point_loc=m.point_loc * jnp.array([1.02, 1.02, 1.02, 1.0]))
    drift = float(lm.normalize_canary(bad, CFG.normalize_canary_rows,
                                      CFG.cheirality_eps))
    assert drift > 0.1, drift


def test_polish_pass_improves_early_trajectory():
    """The one-time early-trajectory polish (cfg.polish_at) re-solves every
    frame but the 0/1 gauge anchor once (the reference's SolveAllFrames,
    slam.cpp:447-480). It must leave the loop healthy and not degrade the
    trajectory vs ground truth."""
    import dataclasses

    n = 14
    src = sources.SyntheticSource(CFG, n_frames=n, n_points=400, step_mm=10.0)

    def run(cfg):
        ps = pipeline.init(cfg, scaled_intrinsics(cfg))
        for i in range(n):
            ps, met = pipeline.step(ps, jnp.asarray(src.get(i % 2, i)), cfg)
        nf = int(ps.map.n_frames)
        est = np.asarray(ps.map.frame_trans[:nf])
        true = np.asarray(src.true_trans[:nf])
        ate = float(np.sqrt(((est - true) ** 2).sum(1)).mean())
        return ps, met, ate

    cfg_p = dataclasses.replace(CFG, polish_at=8)
    ps, met, ate_p = run(cfg_p)
    _, _, ate_base = run(CFG)
    # loop stays healthy through and after the polish frame
    assert float(met["mean_reproj_err"]) < 2.0
    assert int(ps.map.n_frames) == n
    # polish must not make the trajectory meaningfully worse
    assert ate_p <= ate_base * 1.5 + 0.5, (ate_p, ate_base)


def test_step_live_matches_step():
    # the live-loop variant (donated state, one packed f32[LIVE_WIDTH] row)
    # must evolve the same state as the full-metrics step and pack the
    # scalars the robot loop polls in the documented order
    src = sources.SyntheticSource(CFG, n_frames=6, n_points=400, step_mm=10.0)
    frames = [jnp.asarray(src.get(i % 2, i)) for i in range(6)]

    ps_a = pipeline.init(CFG, scaled_intrinsics(CFG))
    mets = []
    for img in frames:
        ps_a, met = pipeline.step(ps_a, img, CFG)
        mets.append(met)

    ps_b = pipeline.init(CFG, scaled_intrinsics(CFG))
    packs = []
    for img in frames:
        ps_b, out = pipeline.step_live(ps_b, img, CFG)
        packs.append(np.asarray(out))

    np.testing.assert_allclose(
        np.asarray(ps_b.map.frame_trans), np.asarray(ps_a.map.frame_trans),
        atol=1e-4,
    )
    assert int(ps_b.map.n_points) == int(ps_a.map.n_points)
    m, p = mets[-1], packs[-1]
    assert p.shape == (pipeline.LIVE_WIDTH,)
    ix = pipeline.LIVE_IDX
    assert int(p[ix["n_matches"]]) == int(m["n_matches"])
    assert int(p[ix["is_keyframe"]]) == int(m["is_keyframe"])
    np.testing.assert_allclose(
        p[ix["mean_reproj_err"]], float(m["mean_reproj_err"]), rtol=1e-5)
    assert int(p[ix["n_points"]]) == int(m["n_points"])
    # the safety counters ride the packed row
    for k in ("fast_obs_dropped", "slow_obs_dropped",
              "reproject_obs_dropped"):
        assert int(p[ix[k]]) == int(m[k])
    np.testing.assert_allclose(
        p[ix["normalize_canary_px"]], float(m["normalize_canary_px"]),
        rtol=1e-5)


def test_step_live_ring_matches_step_live():
    # the ring variant (device-side telemetry batching, fetched every k
    # frames) must evolve the same state as step_live and hold the last 4
    # frames' packed rows in order (row -1 = newest)
    src = sources.SyntheticSource(CFG, n_frames=6, n_points=400, step_mm=10.0)
    frames = [jnp.asarray(src.get(i % 2, i)) for i in range(6)]

    ps_a = pipeline.init(CFG, scaled_intrinsics(CFG))
    packs = []
    for img in frames:
        ps_a, out = pipeline.step_live(ps_a, img, CFG)
        packs.append(np.asarray(out))

    ps_b = pipeline.init(CFG, scaled_intrinsics(CFG))
    ring = jnp.zeros((4, pipeline.LIVE_WIDTH), jnp.float32)
    rings = []
    for img in frames:
        ps_b, ring = pipeline.step_live_ring(ps_b, ring, img, CFG)
        rings.append(np.asarray(ring))

    np.testing.assert_allclose(
        np.asarray(ps_b.map.frame_trans), np.asarray(ps_a.map.frame_trans),
        atol=1e-4,
    )
    assert int(ps_b.map.n_points) == int(ps_a.map.n_points)
    # ring after frame i holds rows for frames i-3..i (zeros pre-history)
    np.testing.assert_allclose(rings[-1], np.stack(packs[-4:]), rtol=1e-5)
    np.testing.assert_allclose(
        rings[1][:2], np.zeros((2, pipeline.LIVE_WIDTH)))
    np.testing.assert_allclose(rings[1][2:], np.stack(packs[:2]), rtol=1e-5)


def test_point_eviction_keeps_matcher_alive_at_capacity():
    """Map saturation collapse (PERF.md finding 41): with a tiny max_points
    the append-only table fills and the matcher starves — no new seeds,
    live lanes decay, every frame keyframes. With capacity-pressure
    eviction (cfg.point_evict_retain) seeding continues past saturation."""
    import dataclasses

    n = 32
    cfg_small = dataclasses.replace(CFG, max_points=64, point_evict_retain=8)
    cfg_off = dataclasses.replace(cfg_small, point_evict_retain=0)
    src = sources.SyntheticSource(CFG, n_frames=n, n_points=400,
                                  step_mm=18.0, yaw_rate=0.06)

    def run(cfg):
        ps = pipeline.init(cfg, scaled_intrinsics(cfg))
        added_after_sat, sat_seen = 0, False
        for i in range(n):
            ps, met = pipeline.step(ps, jnp.asarray(src.get(i % 2, i)), cfg)
            if sat_seen:
                added_after_sat += int(np.asarray(met["n_added"]))
            if int(np.asarray(met["n_points"])) >= cfg.max_points:
                sat_seen = True
        live = int(np.asarray(ps.map.point_mask).sum())
        return ps, sat_seen, added_after_sat, live

    ps_on, sat_on, added_on, live_on = run(cfg_small)
    _, sat_off, added_off, _ = run(cfg_off)
    assert sat_on and sat_off, "scene too small to saturate the tiny map"
    # eviction keeps seeding after saturation; append-only cannot
    assert added_on > added_off, (added_on, added_off)
    assert added_on > 0
    # live count bounded by capacity, and the free-list is consistent
    assert live_on <= cfg_small.max_points
    assert int(ps_on.map.n_points) <= cfg_small.max_points
