import json
import os

import jax.numpy as jnp
import numpy as np

from slam_robot_tpu.config import SlamConfig
from slam_robot_tpu.io import sources
from slam_robot_tpu.io.recorder import Recorder
from slam_robot_tpu.models import localmap as lm
from slam_robot_tpu.utils import checkpoint, debug_draw, dump, metrics, synthetic
from slam_robot_tpu.utils.histogram import Histogram
from slam_robot_tpu.utils.timer import ScopedTimer

CFG = SlamConfig(max_frames=16, max_points=64, max_obs=1024, max_obs_per_point=16)


def test_histogram_reference_behavior():
    # histogram_test.cpp semantics: clamped bucket counting with scale
    h = Histogram(10)
    for v in (0.5, 1.5, 1.7, 9.0, 99.0, -5.0):
        h.add(v)
    assert h.bucket(0) == 2  # 0.5 and clamped -5.0
    assert h.bucket(1) == 2
    assert h.bucket(9) == 2  # 9.0 and clamped 99.0
    h2 = Histogram(10, 10.0)
    h2.add(35.0)
    assert h2.bucket(3) == 1
    assert "3" in h2.str()


def test_scoped_timer():
    lines = []
    with ScopedTimer("unit", sink=lines.append):
        pass
    assert lines and lines[0].startswith("TIMER: unit:")


def test_metrics_log(tmp_path):
    log = metrics.MetricsLog()
    for i in range(5):
        log.append({"n_matches": jnp.int32(i), "mean_reproj_err": jnp.float32(0.1 * i),
                    "is_keyframe": jnp.bool_(i == 0), "fast_iters": jnp.int32(3),
                    "slow_iters": jnp.int32(0)})
    s = log.summary()
    assert s["frames"] == 5 and s["keyframes"] == 1
    assert abs(s["n_matches"]["mean"] - 2.0) < 1e-6
    p = tmp_path / "m.jsonl"
    log.to_jsonl(str(p))
    rows = [json.loads(l) for l in open(p)]
    assert len(rows) == 5


def test_checkpoint_roundtrip(tmp_path):
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=8)
    path = str(tmp_path / "ck")
    checkpoint.save(scene.state, path)
    restored = checkpoint.restore(lm.empty(CFG), path)
    np.testing.assert_array_equal(
        np.asarray(restored.frame_trans), np.asarray(scene.state.frame_trans)
    )
    assert int(restored.n_obs) == int(scene.state.n_obs)


def test_dump_map_format(tmp_path):
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=8)
    path = str(tmp_path / "z")
    dump.dump_map(scene.state, path)
    text = open(path).read()
    blocks = text.split("\n\n")
    assert len(blocks) >= 3  # even frames, odd frames, points
    first = blocks[0].strip().splitlines()
    assert len(first) == 2  # frames 0, 2
    assert len(first[0].split()) == 3


def test_ate_helper():
    a = np.zeros((5, 3))
    b = np.ones((5, 3))
    assert abs(dump.ate(a, b) - np.sqrt(3)) < 1e-9
    assert dump.ate(a, a) == 0.0


def test_ate_aligned_removes_gauge():
    # a trajectory corrupted by a pure global rotation + scale + shift has
    # large raw ATE but ~zero Umeyama-aligned ATE (PERF.md finding 42: the
    # hard-draw residual is exactly this gauge class)
    rng = np.random.default_rng(0)
    true = np.cumsum(rng.normal(0, 10.0, (40, 3)), axis=0)
    ang = np.radians(4.0)
    rot = np.array([
        [np.cos(ang), 0.0, np.sin(ang)],
        [0.0, 1.0, 0.0],
        [-np.sin(ang), 0.0, np.cos(ang)],
    ])
    est = 1.03 * (true @ rot.T) + np.array([5.0, -3.0, 2.0])
    raw = np.sqrt(((est - true) ** 2).sum(1)).mean()
    assert raw > 1.0  # the gauge error is visible raw
    assert dump.ate_aligned(est, true) < 1e-6
    # SE(3)-only alignment must NOT absorb the scale component
    assert dump.ate_aligned(est, true, with_scale=False) > 0.1
    # round-trip of the fit parameters
    s, rot_f, t = dump.align_umeyama(est, true)
    assert abs(s - 1.0 / 1.03) < 1e-6
    # degenerate inputs fall back to identity
    s2, r2, _ = dump.align_umeyama(est[:2], true[:2])
    assert s2 == 1.0 and np.allclose(r2, np.eye(3))


def test_debug_draw_colors():
    scene = synthetic.build_scene(CFG, n_frames=4, n_points=6)
    img = np.full((480, 640), 0.5, np.float32)
    out = debug_draw.draw_debug(scene.state, img)
    assert out.shape == (480, 640, 3)
    # tracked points draw red crosses
    assert (out == np.array(debug_draw.RED)).all(axis=-1).any()


def test_recorder_file_roundtrip(tmp_path):
    rec = Recorder(str(tmp_path), fmt="npy")
    img = np.random.default_rng(0).uniform(size=(24, 32)).astype(np.float32)
    rec.save(0, img)
    rec.close()
    src = sources.FileSource(str(tmp_path))
    assert src.init()
    out = src.get(0, 0)
    np.testing.assert_allclose(out, img)
    assert src.get(0, 99) is None


def test_recorder_png_roundtrip(tmp_path):
    rec = Recorder(str(tmp_path), fmt="png")
    img = np.random.default_rng(0).uniform(size=(24, 32)).astype(np.float32)
    rec.save(3, img)
    rec.close()
    src = sources.FileSource(str(tmp_path))
    out = src.get(0, 3)
    assert out is not None and out.shape == (24, 32)
    np.testing.assert_allclose(out, img, atol=1 / 255 + 1e-6)


def test_stop_cli():
    from slam_robot_tpu import stop

    assert stop.main() == 0


def test_usb_transport_graceful_without_hardware():
    from slam_robot_tpu.io import usb

    # no Pololu devices in this container: factory must return None, and
    # the raw classes must not crash
    t = usb.pololu_transport()
    assert t is None or callable(t)
    u = usb.Usb()
    dev = usb.UsbDevice(u, 0xDEAD, (0xBEEF,))
    assert dev.handle is None
    assert dev.control_transfer(0x85, 6000, 0) == -1


def test_prefetch_iterator_order(tmp_path):
    import numpy as np

    from slam_robot_tpu.io import sources
    from slam_robot_tpu.io.recorder import Recorder

    rec = Recorder(str(tmp_path), fmt="npy")
    for i in range(5):
        rec.save(i, np.full((4, 4), i, np.float32))
    rec.close()
    src = sources.FileSource(str(tmp_path))
    seen = [(cam, fid, float(img[0, 0])) for cam, fid, img in sources.prefetch(src)]
    assert [s[1] for s in seen] == [0, 1, 2, 3, 4]
    assert [s[2] for s in seen] == [0.0, 1.0, 2.0, 3.0, 4.0]
    # cameras alternate
    assert [s[0] for s in seen] == [1, 0, 1, 0, 1]


def test_patch_history_cache():
    """Last-N patch ring per point id (matcher.cpp:68-74, 260-265)."""
    import numpy as np

    from slam_robot_tpu.utils.patch_history import PatchHistory

    ph = PatchHistory(size=13, depth=3)
    img = np.arange(120 * 160, dtype=np.float32).reshape(120, 160) / (120 * 160)
    ids = np.array([5, 7, -1, 5])
    px = np.array([[40.0, 30.0], [80.5, 60.5], [0, 0], [42.0, 31.0]])
    matched = np.array([True, True, True, True])
    n = ph.update(img, ids, px, matched)
    assert n == 3  # id -1 skipped
    for _ in range(4):
        ph.update(img, ids, px, matched)
    assert len(ph.patches(5)) == 3  # ring depth clamps
    assert ph.patches(7)[0].shape == (13, 13)
    # newest first: sub-pixel extraction around the requested center
    p = ph.patches(7)[0]
    center_val = img[60, 80]
    assert abs(p[6, 6] - center_val) < 0.01
    strip = ph.strip(7, scale=2)
    assert strip.shape == (26, 26 * 3)
    assert ph.top_ids(1) in ([5], [7])


def test_stats_histograms():
    """localmap.stats carries the reference's error histograms
    (localmap.cpp:400-460)."""
    import jax.numpy as jnp

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import localmap as lm
    from slam_robot_tpu.utils import synthetic

    cfg = SlamConfig(max_frames=16, max_points=64, max_obs=1024,
                     max_obs_per_point=16)
    scene = synthetic.build_scene(cfg, n_frames=6, n_points=12,
                                  pixel_noise=0.5)
    s, _ = lm.reproject(scene.state)
    d = lm.stats(s)
    assert "enabled_err_hist" in d and len(d["enabled_err_hist"]) == 10
    assert sum(d["enabled_err_hist"]) + sum(d["disabled_err_hist"]) > 0
    assert "frame_dist" in d and len(d["frame_dist"]) == int(s.n_frames) - 1


def test_liveview_serves_stream_and_status():
    """The --serve live view (the reference GUI loop analog,
    main.cpp:609-638): publish an overlay, then fetch /, /status and one
    MJPEG frame off /stream over real HTTP."""
    import http.client
    import json as _json

    import numpy as np

    from slam_robot_tpu.utils.liveview import LiveView

    view = LiveView(port=0, host="127.0.0.1").start()
    try:
        overlay = np.zeros((24, 32, 3), np.uint8)
        overlay[:, :, 1] = 200
        view.publish(overlay, {"frame": 7, "matches": 42})

        c = http.client.HTTPConnection("127.0.0.1", view.port, timeout=5)
        c.request("GET", "/")
        assert b"slam_robot_tpu" in c.getresponse().read()

        c.request("GET", "/status")
        status = _json.loads(c.getresponse().read())
        assert status == {"frame": 7, "matches": 42}

        c.request("GET", "/stream")
        r = c.getresponse()
        assert r.getheader("Content-Type").startswith(
            "multipart/x-mixed-replace")
        head = r.fp.readline()  # --frame boundary
        assert b"--frame" in head
        ctype = r.fp.readline()
        assert b"image/jpeg" in ctype
        clen = int(r.fp.readline().split(b":")[1])
        r.fp.readline()  # blank
        jpeg = r.fp.read(clen)
        assert jpeg[:2] == b"\xff\xd8"  # JPEG SOI marker
        c.close()
    finally:
        view.stop()


def test_fetchpool_delivers_in_submission_order():
    """FetchPool: every submitted value comes back once, with its meta, in
    submission order, whether collected by drain() or join()."""
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.utils.fetchpool import FetchPool

    pool = FetchPool(workers=2)
    n = 10
    got = []
    for i in range(n):
        pool.submit(jnp.full((8,), float(i)), meta=i)
        if i == 4:
            got.extend(pool.drain())
    got.extend(pool.join())
    pool.close()
    assert [m for m, _ in got] == list(range(n))
    for i, (_, row) in enumerate(got):
        assert np.asarray(row).shape == (8,)
        assert float(np.asarray(row)[0]) == float(i)


def test_liveview_point_inspector_endpoints():
    """The per-point click inspector (/points + /point?id=N): the runtime
    analog of the reference's mouse-hover patch-history inspector
    (main.cpp:158-267, fed by matcher.cpp:260-265)."""
    import http.client
    import json as _json

    import numpy as np

    from slam_robot_tpu.utils.liveview import LiveView
    from slam_robot_tpu.utils.patch_history import PatchHistory

    ph = PatchHistory(size=5)
    img = np.arange(40 * 30, dtype=np.float32).reshape(30, 40) / 1200.0
    ph.update(img, np.array([3, 7, -1]),
              np.array([[10.0, 12.0], [20.0, 8.0], [5.0, 5.0]]),
              np.array([True, True, True]))

    view = LiveView(port=0, host="127.0.0.1").start()
    view.patch_history = ph
    try:
        overlay = np.zeros((24, 32, 3), np.uint8)
        view.publish(overlay, {"frame": 1},
                     points=[(3, 10.0, 12.0), (7, 20.0, 8.0)])

        c = http.client.HTTPConnection("127.0.0.1", view.port, timeout=5)
        c.request("GET", "/points")
        pts = _json.loads(c.getresponse().read())
        assert pts == [[3, 10.0, 12.0], [7, 20.0, 8.0]]

        c.request("GET", "/point?id=3")
        r = c.getresponse()
        body = r.read()
        assert r.status == 200 and body[:2] == b"\xff\xd8"

        # unknown point: 404, not a crash
        c.request("GET", "/point?id=999")
        r = c.getresponse()
        r.read()
        assert r.status == 404
        c.close()
    finally:
        view.stop()
