import numpy as np
import pytest

from slam_robot_tpu.io import native


def ref_yuyv_to_bgr(yuyv):
    """Reference integer math (video.cpp:187-223) in plain Python."""
    out = []
    for i in range(0, len(yuyv), 4):
        y1, u, y2, v = (int(x) for x in yuyv[i : i + 4])
        cb = ((u - 128) * 454) >> 8
        cg = ((u - 128) * 88 + (v - 128) * 183) >> 8
        cr = ((v - 128) * 359) >> 8
        for y in (y1, y2):
            out.extend(
                [
                    min(max(y + cb, 0), 255),
                    min(max(y - cg, 0), 255),
                    min(max(y + cr, 0), 255),
                ]
            )
    return np.array(out, np.uint8)


def test_yuyv_to_bgr_matches_reference_math(rng):
    yuyv = rng.integers(0, 256, size=2 * 16, dtype=np.uint8)  # 16 px, 2 B/px
    out = native.yuyv_to_bgr(yuyv, width=16, height=1)
    np.testing.assert_array_equal(out.reshape(-1), ref_yuyv_to_bgr(yuyv))


def test_yuyv_to_grey(rng):
    yuyv = rng.integers(0, 256, size=4 * 8, dtype=np.uint8)
    g = native.yuyv_to_grey(yuyv, width=16, height=1)
    expect = yuyv.reshape(-1, 2)[:, 0].astype(np.float32) / 255.0
    np.testing.assert_allclose(g.reshape(-1), expect)


def test_grey_conversion_full_frame(rng):
    yuyv = rng.integers(0, 256, size=640 * 480 * 2, dtype=np.uint8)
    g = native.yuyv_to_grey(yuyv, 640, 480)
    assert g.shape == (480, 640)
    assert 0.0 <= g.min() and g.max() <= 1.0


@pytest.fixture
def native_lib():
    """The built native library (built from source at first use); skips
    when no compiler could build it."""
    if not native.available():
        pytest.skip("native lib not built (make -C native)")
    return native.load()


def test_frame_ring_prefetch(rng, native_lib):
    frames = [rng.uniform(size=(8, 10)).astype(np.float32) for _ in range(5)]
    it = iter(frames)

    def fill():
        return next(it, None)

    ring = native.FrameRing((8, 10), capacity=2, fill=fill)
    got = []
    while True:
        frame, fid = ring.next()
        if frame is None:
            break
        got.append((fid, frame))
    ring.close()
    assert [fid for fid, _ in got] == [0, 1, 2, 3, 4]
    for (fid, frame), expect in zip(got, frames):
        np.testing.assert_array_equal(frame, expect)


def test_native_lib_loaded(native_lib):
    assert native_lib is not None
