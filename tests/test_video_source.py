"""VideoSource (ImageSourceMono analog, video.h:41-62): decode video files,
pair two as the fake stereo rig, drive the replay CLI end-to-end."""

import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")


def write_videos(tmp_path, w=160, h=120, n_pairs=4):
    """Two MJPG files: camera-0 frames and camera-1 frames of a synthetic
    sweep (the reference replays two recorded files the same way,
    main.cpp:456-460)."""
    import jax.numpy as jnp

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.io import sources

    cfg = SlamConfig(image_width=w, image_height=h, pyramid_depth=4)
    src = sources.SyntheticSource(cfg, n_frames=2 * n_pairs, n_points=400,
                                  step_mm=10.0)
    paths = [str(tmp_path / "cam0.avi"), str(tmp_path / "cam1.avi")]
    writers = [
        cv2.VideoWriter(p, cv2.VideoWriter_fourcc(*"MJPG"), 10, (w, h))
        for p in paths
    ]
    for i in range(2 * n_pairs):
        img = np.asarray(src.get(i % 2, i))
        u8 = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        writers[i % 2].write(np.repeat(u8[:, :, None], 3, axis=2))
    for wr in writers:
        wr.release()
    return paths


def test_video_source_reads_frames(tmp_path):
    from slam_robot_tpu.io import sources

    paths = write_videos(tmp_path)
    vs = sources.VideoSource(paths[0])
    assert vs.init()
    f0 = vs.get(0, 0)
    f1 = vs.get(0, 1)
    assert f0 is not None and f0.shape == (120, 160)
    assert f0.dtype == np.float32 and 0.0 <= f0.min() and f0.max() <= 1.0
    assert not np.allclose(f0, f1)  # the stream advances
    for _ in range(2):
        vs.get(0, 0)
    assert vs.get(0, 0) is None  # end of stream


def test_duo_video_replay_cli(tmp_path):
    """run_replay --video a b works end-to-end."""
    paths = write_videos(tmp_path, n_pairs=3)
    out = subprocess.run(
        [sys.executable, "-m", "slam_robot_tpu.run_replay",
         "--video", *paths, "--platform", "cpu",
         "--width", "160", "--height", "120", "--quiet"],
        capture_output=True, text=True, timeout=560,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    import json

    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["frames"] == 6
    assert summary["n_points"] > 5  # it actually tracked and seeded
