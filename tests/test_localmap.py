import jax
import jax.numpy as jnp
import numpy as np

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.ops import projection as proj
from slam_robot_tpu.ops import quaternion as quat
from slam_robot_tpu.utils import synthetic

CFG = SlamConfig(max_frames=16, max_points=64, max_obs=1024, max_obs_per_point=16)


def small_state():
    k = synthetic.reference_intrinsics(CFG)
    s = lm.empty(CFG)
    s = lm.set_camera(s, 0, k)
    s = lm.set_camera(s, 1, k)
    return s


def test_add_frame_point_obs_counters():
    s = small_state()
    s, f0 = lm.add_frame(s, 0)
    s, f1 = lm.add_frame(s, 1, quat.identity(), jnp.array([150.0, 0, 0]))
    assert int(s.n_frames) == 2 and int(f0) == 0 and int(f1) == 1

    locs = jnp.tile(jnp.array([0.0, 0, 2000, 1]), (3, 1))
    s, ids = lm.add_points(s, locs, jnp.array([True, True, False]))
    assert int(s.n_points) == 2
    np.testing.assert_array_equal(np.asarray(ids), [0, 1, -1])
    # new points start NO_OBSERVATIONS|NO_BASELINE (localmap.cpp:106-112)
    assert int(s.point_flags[0]) == lm.NO_OBSERVATIONS | lm.NO_BASELINE
    assert not bool(lm.slam_usable(s.point_flags)[0])

    px = jnp.array([[320.0, 240.0], [100.0, 100.0], [0.0, 0.0]])
    s = lm.add_observations(s, f0, jnp.array([0, 1, -1]), px, jnp.array([True, True, True]))
    assert int(s.n_obs) == 2
    assert int(s.point_obs_total[0]) == 1 and int(s.point_obs_total[1]) == 1
    # ring holds the obs row index
    assert int(s.recent_obs_index(1)[0]) == 0


def test_flags_clear_with_evidence():
    s = small_state()
    s, f0 = lm.add_frame(s, 0, quat.identity(), jnp.zeros(3))
    s, f1 = lm.add_frame(s, 1, quat.identity(), jnp.array([150.0, 0, 0]))
    s, ids = lm.add_points(s, jnp.array([[0.0, 0, 2000, 1]]), jnp.array([True]))
    s = lm.add_observations(s, f0, ids[:1], jnp.array([[320.0, 240]]), jnp.array([True]))
    # one obs: both flags still set
    assert int(s.point_flags[0]) & lm.NO_OBSERVATIONS
    s = lm.add_observations(s, f1, ids[:1], jnp.array([[280.0, 240]]), jnp.array([True]))
    # two enabled obs, frames 150mm apart (>=50mm): both cleared
    # (localmap.cpp:47-83)
    assert not int(s.point_flags[0]) & lm.NO_OBSERVATIONS
    assert not int(s.point_flags[0]) & lm.NO_BASELINE
    assert bool(lm.slam_usable(s.point_flags)[0])


def test_no_baseline_requires_distance():
    s = small_state()
    s, f0 = lm.add_frame(s, 0, quat.identity(), jnp.zeros(3))
    s, f1 = lm.add_frame(s, 1, quat.identity(), jnp.array([10.0, 0, 0]))  # < 50mm
    s, ids = lm.add_points(s, jnp.array([[0.0, 0, 2000, 1]]), jnp.array([True]))
    s = lm.add_observations(s, f0, ids[:1], jnp.array([[320.0, 240]]), jnp.array([True]))
    s = lm.add_observations(s, f1, ids[:1], jnp.array([[318.0, 240]]), jnp.array([True]))
    assert not int(s.point_flags[0]) & lm.NO_OBSERVATIONS  # 2 obs
    assert int(s.point_flags[0]) & lm.NO_BASELINE  # but no baseline


def test_reproject_zero_on_perfect_scene():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=10)
    s, mean = lm.reproject(scene.state)
    assert float(mean) < 1e-2
    errs = np.asarray(s.obs_err)[: int(s.n_obs)]
    assert np.all(np.linalg.norm(errs, axis=1) < 0.1)


def test_reproject_detects_moved_point():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=10)
    s = scene.state
    s = s._replace(point_loc=s.point_loc.at[0, 0].add(500.0))
    s, mean = lm.reproject(s)
    errs = np.linalg.norm(np.asarray(s.obs_err), axis=1)
    obs_of_p0 = np.asarray(s.obs_point)[: int(s.n_obs)] == 0
    assert np.all(errs[: int(s.n_obs)][obs_of_p0] > 1.0)


def test_normalize_preserves_reprojection_error():
    # the reference asserts this every frame (main.cpp:602-605)
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=12)
    s = scene.state
    # shove the whole map into an arbitrary pose so normalize has work to do
    q = quat.from_axis_angle(jnp.array([0.3, 0.5, 0.1]), 0.7)
    t = jnp.array([300.0, -200.0, 100.0])
    new_quat = jax.vmap(lambda fq: quat.normalize(quat.multiply(fq, quat.conjugate(q))))(
        s.frame_quat
    )
    new_trans = jax.vmap(lambda ft: quat.rotate(q, ft) + t)(s.frame_trans)
    xyz = jax.vmap(lambda p: quat.rotate(q, p[:3]) + t * p[3])(s.point_loc)
    new_loc = jnp.concatenate([xyz, s.point_loc[:, 3:]], axis=1)
    s = s._replace(frame_quat=new_quat, frame_trans=new_trans, point_loc=new_loc)

    _, err1 = lm.reproject(s)
    s2 = lm.normalize(s)
    _, err2 = lm.reproject(s2)
    assert abs(float(err1) - float(err2)) < 0.1
    # frame 0 re-anchored at origin/identity
    np.testing.assert_allclose(np.asarray(s2.frame_trans[0]), np.zeros(3), atol=1e-3)
    np.testing.assert_allclose(np.abs(float(s2.frame_quat[0, 3])), 1.0, atol=1e-5)


def test_clean_disables_worst_first_bar():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)
    s, _ = lm.reproject(scene.state)
    # fabricate errors on three obs of different points: 10, 30, 100
    err = s.obs_err
    err = err.at[0].set(jnp.array([10.0, 0.0]))
    err = err.at[7].set(jnp.array([30.0, 0.0]))
    err = err.at[14].set(jnp.array([100.0, 0.0]))
    s = s._replace(obs_err=err)
    s2, all_ok = lm.clean(s, 5.0, CFG)
    assert not bool(all_ok)
    dis = np.asarray(s2.obs_disabled)
    # bar = max(5, 100/4) = 25: disable 30 and 100 but not 10
    # (localmap.cpp:361-387)
    assert not dis[0] and dis[7] and dis[14]
    # their points are MISMATCHED and flagged for evidence re-check
    p7 = int(s.obs_point[7])
    assert int(s2.point_flags[p7]) & lm.MISMATCHED


def test_clean_flags_bad_location():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)
    s, _ = lm.reproject(scene.state)
    # move point 2 to sit on frame 0's camera (z<1 in camera space)
    s = s._replace(point_loc=s.point_loc.at[2].set(jnp.array([0.0, 0.0, 0.5, 1.0])))
    s2, _ = lm.clean(s, 5.0, CFG)
    assert int(s2.point_flags[2]) & lm.BAD_LOCATION
    assert not bool(lm.slam_usable(s2.point_flags)[2])


def test_clean_fixes_negative_w():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)
    s, _ = lm.reproject(scene.state)
    s = s._replace(point_loc=s.point_loc.at[1, 3].set(-1.0))
    s2, _ = lm.clean(s, 5.0, CFG)
    assert float(s2.point_loc[1, 3]) == 1.0


def test_clean_sets_uncertainty_to_avg_err():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)
    s, _ = lm.reproject(scene.state)
    s2, _ = lm.clean(s, 5.0, CFG)
    # perfect scene: avg err ~ 0 => uncertainty ~ 0 for usable points
    u = np.asarray(s2.point_uncertainty)[:6]
    assert np.all(u < 0.1)


def test_pop_frame_and_not_moving():
    scene = synthetic.build_scene(CFG, n_frames=6, n_points=8)
    s = scene.state
    n_obs_before = int(s.n_obs)
    start_last = int(s.frame_obs_start[int(s.n_frames) - 1])
    s2 = lm.pop_frame(s)
    assert int(s2.n_frames) == 5
    assert int(s2.n_obs) == start_last
    # ring totals decremented for points observed by the popped frame
    assert int(s2.point_obs_total[0]) == int(s.point_obs_total[0]) - 1
    assert n_obs_before > start_last

    # check_not_moving: make the last four frames coincident & non-key
    s3 = s._replace(
        frame_trans=s.frame_trans.at[2:6].set(s.frame_trans[2]),
        frame_keyframe=s.frame_keyframe.at[:].set(False),
    )
    s4 = lm.check_not_moving(s3, 5.0)
    assert int(s4.n_frames) == 4
    # moving scene is untouched
    s5 = lm.check_not_moving(s, 5.0)
    assert int(s5.n_frames) == 6


def test_epipolar_constraint_flags_outlier():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=8)
    s = scene.state
    # corrupt the most recent observation of point 3 (in the last frame)
    row = int(s.recent_obs_index(1)[3])
    assert int(s.obs_point[row]) == 3
    s = s._replace(obs_px=s.obs_px.at[row, 1].add(150.0))
    s2 = lm.apply_epipolar_constraint(s, CFG)
    # few observations (<=8): point becomes BAD_FEATURE (localmap.cpp:267-273)
    assert int(s2.point_flags[3]) & lm.BAD_FEATURE
    # clean points untouched
    assert not int(s2.point_flags[1]) & (lm.BAD_FEATURE | lm.MISMATCHED)


def test_epipolar_constraint_mismatch_many_obs():
    cfg = SlamConfig(max_frames=16, max_points=32, max_obs=2048, max_obs_per_point=16)
    scene = synthetic.build_scene(cfg, n_frames=12, n_points=4)
    s = scene.state
    row = int(s.recent_obs_index(1)[0])
    s = s._replace(obs_px=s.obs_px.at[row, 1].add(150.0))
    s2 = lm.apply_epipolar_constraint(s, cfg)
    # many observations (>8): disable the latest obs + MISMATCHED
    assert int(s2.point_flags[0]) & lm.MISMATCHED
    assert bool(s2.obs_disabled[row])
    assert not int(s2.point_flags[0]) & lm.BAD_FEATURE


def test_stats_summary():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)
    d = lm.stats(scene.state)
    assert d["n_frames"] == 4 and d["n_points"] == 6
    assert d["slam_usable"] == 6  # all seen from all frames with baseline


def test_ops_jit_under_scan():
    # the whole maintenance suite must be jittable
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)

    @jax.jit
    def step(s):
        s, _ = lm.reproject(s)
        s, ok = lm.clean(s, 5.0, CFG)
        s = lm.apply_epipolar_constraint(s, CFG)
        s = lm.normalize(s)
        return s, ok

    s, ok = step(scene.state)
    assert bool(ok)


def test_estimate_motion_constant_velocity():
    # same-camera frames advance +30mm in z per stride; prediction continues it
    s = small_state()
    for i in range(5):
        cam = i % 2
        t = jnp.array([150.0 * cam, 0.0, 15.0 * (i // 2 * 2)], jnp.float32)
        s, _ = lm.add_frame(s, cam, quat.identity(), t)
    # frame 5 (camera 1): frames 3 and 1 are its history
    q, t = lm.estimate_motion(s, 5)
    t3 = np.asarray(s.frame_trans[3])
    t1 = np.asarray(s.frame_trans[1])
    np.testing.assert_allclose(np.asarray(t), t3 + (t3 - t1), atol=1e-5)
    # few frames: falls back to copy
    s2 = small_state()
    s2, _ = lm.add_frame(s2, 0, quat.identity(), jnp.zeros(3))
    s2, _ = lm.add_frame(s2, 1, quat.identity(), jnp.array([150.0, 0, 0]))
    s2, _ = lm.add_frame(s2, 0, quat.identity(), jnp.array([0.0, 0, 10]))
    q, t = lm.estimate_motion(s2, 2)
    np.testing.assert_allclose(np.asarray(t), np.zeros(3), atol=1e-5)


def test_pop_frame_clears_wrapped_ring_slot():
    """Regression (round-1 verdict): once a point's obs ring has wrapped
    (total > R), pop_frame must clear the removed obs's ring slot —
    otherwise _ring_gather re-reads the cleared obs row (obs_frame=-1) as
    the point's oldest observation."""
    cfg = SlamConfig(max_frames=16, max_points=64, max_obs=1024,
                     max_obs_per_point=4)
    k = synthetic.reference_intrinsics(cfg)
    s = lm.empty(cfg)
    s = lm.set_camera(s, 0, k)
    s, ids = lm.add_points(s, jnp.array([[0.0, 0, 2000, 1]]),
                           jnp.array([True]))
    for i in range(6):
        s, f = lm.add_frame(s, 0)
        s = lm.add_observations(s, f, ids[:1],
                                jnp.array([[320.0 + i, 240.0]]),
                                jnp.array([True]))
    assert int(s.point_obs_total[0]) == 6  # ring (R=4) has wrapped

    s2 = lm.pop_frame(s)
    assert int(s2.point_obs_total[0]) == 5
    # no ring slot may still reference a removed obs row
    ring = np.asarray(s2.point_obs[0])
    assert not np.any(ring >= int(s2.n_obs)), ring
    # and _ring_gather must not surface the cleared row as valid
    _, ok, idx = lm._ring_gather(s2, s2.obs_frame)
    valid_rows = np.asarray(idx[0])[np.asarray(ok[0])]
    assert valid_rows.size > 0
    assert np.all(valid_rows < int(s2.n_obs)), valid_rows


def test_ring_mirrors_stay_consistent():
    """ring_frame / ring_disabled mirror the obs table through add, clean,
    epipolar, pop: for live slots ring_frame[p,k] == obs_frame[idx] and
    ring_disabled[p,k] == obs_disabled[idx]."""
    import numpy as np

    from slam_robot_tpu.utils import synthetic

    cfg = SlamConfig(max_frames=16, max_points=64, max_obs=1024,
                     max_obs_per_point=8)
    scene = synthetic.build_scene(cfg, n_frames=12, n_points=24,
                                  pixel_noise=2.0)
    s = scene.state

    def check(s, where):
        idx, ok, _age = lm._ring_slots(s)
        idxn = np.asarray(idx)
        okn = np.asarray(ok)
        rf = np.asarray(s.ring_frame)
        rd = np.asarray(s.ring_disabled)
        of = np.asarray(s.obs_frame)
        od = np.asarray(s.obs_disabled)
        p, k = np.nonzero(okn)
        rows = idxn[p, k]
        np.testing.assert_array_equal(rf[p, k], of[rows], err_msg=where)
        np.testing.assert_array_equal(rd[p, k], od[rows], err_msg=where)

    check(s, "after build_scene")
    s, _ = lm.reproject(s)
    s, _ = lm.clean(s, 0.5, cfg)   # low bar: force disables
    check(s, "after clean")
    s = lm.apply_epipolar_constraint(s, cfg)
    check(s, "after epipolar")
    s = lm.pop_frame(s)
    check(s, "after pop_frame")


def test_obs_err_valid_kills_sentinel_aliasing():
    """A stored error exactly equal to its own observed pixel — or exactly
    (0,0) — is a legitimate value and must be COUNTED by mean_obs_error,
    because the explicit obs_err_valid bit (written by reproject) is the
    only exclusion criterion."""
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=10)
    s, _ = lm.reproject(scene.state)
    no = int(s.n_obs)
    assert no > 2
    # every active row passed cheirality on this perfect scene
    assert np.asarray(s.obs_err_valid[:no]).all()

    # adversarial: overwrite row 0's stored error with its own pixel value
    # (the old err==px sentinel) and row 1's with exactly (0,0) (the old
    # "unwritten" sentinel); both rows remain genuinely valid
    err = s.obs_err.at[0].set(s.obs_px[0]).at[1].set(jnp.zeros(2))
    s = s._replace(obs_err=err)

    norms = np.linalg.norm(np.asarray(s.obs_err[:no]), axis=1)
    valid = np.asarray(s.obs_err_valid[:no])
    expected = norms[valid].mean()
    got = float(lm.mean_obs_error(s))
    assert abs(got - expected) < 1e-3
    # row 0 now carries |px| (hundreds of px): an aliasing implementation
    # would have silently excluded it and reported a tiny mean
    assert got > 1.0


def test_obs_err_valid_written_by_reproject():
    """reproject sets the bit for counted rows and clears it for
    cheirality-fail rows; add_observations starts rows invalid."""
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=10)
    s = scene.state
    # a fresh observation (never reprojected) is invalid
    s2 = lm.add_observations(
        s, 0, jnp.array([0]), jnp.array([[11.0, 22.0]]), jnp.array([True])
    )
    assert not bool(s2.obs_err_valid[int(s2.n_obs) - 1])

    # move point 0 far behind every camera: its rows fail cheirality
    s3 = s._replace(
        point_loc=s.point_loc.at[0].set(jnp.array([0.0, 0.0, -5000.0, 1.0]))
    )
    s3, _ = lm.reproject(s3)
    no = int(s3.n_obs)
    rows_p0 = np.asarray(s3.obs_point[:no]) == 0
    valid = np.asarray(s3.obs_err_valid[:no])
    assert rows_p0.any()
    assert not valid[rows_p0].any()
    assert valid[~rows_p0].all()

    # normalize_canary excludes exactly the invalid rows (and doesn't trip
    # on the fresh never-reprojected obs row either)
    c = float(lm.normalize_canary(s3))
    assert c < 0.1


def _saturate(s, n_extra_frames=0):
    """Fill the small map to capacity with synthetic points."""
    P = s.point_loc.shape[0]
    locs = jnp.tile(jnp.array([0.0, 0, 2000, 1]), (P, 1))
    while int(s.n_points) < P:
        k = min(P - int(s.n_points), 32)
        s, _ = lm.add_points(s, locs[:k], jnp.ones(k, bool))
    return s


def test_point_eviction_under_pressure():
    """evict_points via add_points: dead slots reclaimed first, referenced
    slots protected, evicted slots' obs rows retired, ring mirrors stay
    consistent (PERF.md finding 41: the saturation keyframe-storm collapse)."""
    s = small_state()
    s, f0 = lm.add_frame(s, 0)
    s, f1 = lm.add_frame(s, 1, quat.identity(), jnp.array([150.0, 0, 0]))
    P = s.point_loc.shape[0]
    s = _saturate(s)
    assert int(s.n_points) == P

    # give points 0..3 observations so they have retirable rows
    for pid in range(4):
        s = lm.add_observations(
            s, f0, jnp.array([pid]), jnp.array([[100.0 + pid, 50.0]]),
            jnp.array([True]))
    # point 0 and 1: dead (MISMATCHED + BAD_FEATURE -> feature- and
    # slam-dead); point 2: dead but REFERENCED by a lane; point 3: healthy
    flags = s.point_flags
    for pid in (0, 1, 2):
        flags = flags.at[pid].set(lm.MISMATCHED | lm.BAD_FEATURE)
    s = s._replace(point_flags=flags)
    referenced = jnp.zeros(P, bool).at[2].set(True)

    locs = jnp.tile(jnp.array([0.0, 0, 3000, 1]), (2, 1))
    s2, ids = lm.add_points(s, locs, jnp.ones(2, bool),
                            referenced=referenced, evict_retain=100)
    ids = np.asarray(ids)
    # the two new points landed in the two dead unreferenced slots
    assert set(ids.tolist()) == {0, 1}
    # referenced dead slot survived
    assert not bool(s2.point_free[2])
    # new slots are live and reset
    assert bool(s2.point_mask[0]) and bool(s2.point_mask[1])
    assert int(s2.point_obs_total[0]) == 0
    assert int(s2.point_flags[0]) == lm.NO_OBSERVATIONS | lm.NO_BASELINE
    # old rows of the evicted slots are retired
    no = int(s2.n_obs)
    op = np.asarray(s2.obs_point[:no])
    od = np.asarray(s2.obs_disabled[:no])
    ov = np.asarray(s2.obs_err_valid[:no])
    # rows 0 and 1 belonged to points 0 and 1 (retired); 2 and 3 survive
    assert op[0] == -1 and op[1] == -1 and od[0] and od[1]
    assert not ov[0] and not ov[1]
    assert op[2] == 2 and op[3] == 3

    # ring mirror invariant still holds for live slots
    idx, ok, _age = lm._ring_slots(s2)
    idxn, okn = np.asarray(idx), np.asarray(ok)
    of, odn = np.asarray(s2.obs_frame), np.asarray(s2.obs_disabled)
    rf, rd = np.asarray(s2.ring_frame), np.asarray(s2.ring_disabled)
    p, k = np.nonzero(okn & np.asarray(s2.point_mask)[:, None])
    rows = idxn[p, k]
    np.testing.assert_array_equal(rf[p, k], of[rows])
    np.testing.assert_array_equal(rd[p, k], odn[rows])


def test_point_eviction_lru_when_no_dead():
    """With no dead points, pressure falls back to LRU-stale slots (newest
    ring obs older than retain_frames); fresh points are kept."""
    s = small_state()
    for i in range(12):
        s, _ = lm.add_frame(s, i % 2)
    P = s.point_loc.shape[0]
    s = _saturate(s)
    # point 0 observed at frame 0 only (stale); point 1 observed at the
    # newest frame (fresh)
    s = lm.add_observations(s, 0, jnp.array([0]),
                            jnp.array([[100.0, 50.0]]), jnp.array([True]))
    s = lm.add_observations(s, 11, jnp.array([1]),
                            jnp.array([[100.0, 50.0]]), jnp.array([True]))
    locs = jnp.tile(jnp.array([0.0, 0, 3000, 1]), (1, 1))
    s2, ids = lm.add_points(s, locs, jnp.ones(1, bool), evict_retain=4)
    # never-observed points (last_obs -1) are the stalest; the evicted slot
    # must NOT be point 1 (observed at frame 11, within retain=4)
    assert int(ids[0]) != 1
    assert bool(s2.point_mask[1])


def test_add_points_bit_identical_below_capacity():
    """evict_retain > 0 must be a no-op while the table has room: identical
    states with and without it."""
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=10)
    s = scene.state
    locs = jnp.tile(jnp.array([0.0, 0, 2500, 1]), (5, 1))
    valid = jnp.array([True, True, False, True, True])
    a, ida = lm.add_points(s, locs, valid)
    b, idb = lm.add_points(s, locs, valid, evict_retain=40)
    np.testing.assert_array_equal(np.asarray(ida), np.asarray(idb))
    for la, lb in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
