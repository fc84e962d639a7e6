"""Silent-truncation guard on the headline-bench workload: the fixed obs
windows (window_obs_fast / window_obs / reproject_window, config.py) must
hold EVERY participating observation row — the reference includes all
enabled obs of presented frames (slam.cpp:279-299). The counters exist and
are unit-tested; this test makes a window-sizing regression FAIL CI on the
actual bench scene instead of printing a counter nobody reads.

Runs the bench sweep's exploration phase (the keyframe-densest, highest
obs-pressure regime) at full production size: 64 eager warm frames + a
24-frame scan continuation, asserting zero drops on every frame. bench.py
itself surfaces obs_dropped_total over the full 64-frame continuation in
its detail line.
"""

import jax
import jax.numpy as jnp
import numpy as np


def test_bench_workload_has_zero_silent_drops():
    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import benchscene

    cfg = SlamConfig()  # the bench's production config, full 640x480
    n_warm, n_scan = 64, 24
    frames = benchscene.make_frames(cfg, n_warm + n_scan)

    keys = ("fast_obs_dropped", "slow_obs_dropped", "reproject_obs_dropped")
    ps = pipeline.init(cfg)
    for i in range(n_warm):
        ps, met = pipeline.step(ps, frames[i], cfg)
        drops = {k: int(met[k]) for k in keys}
        assert all(v == 0 for v in drops.values()), (
            f"frame {i}: silent obs drops {drops} — grow the obs windows "
            f"(config.py window_obs_fast/window_obs/reproject_window)")

    @jax.jit
    def run_scan(ps, imgs):
        def body(ps, img):
            ps, met = pipeline.step(ps, img, cfg)
            return ps, jnp.stack([met[k] for k in keys])

        return jax.lax.scan(body, ps, imgs)

    ps2, drops = run_scan(ps, jnp.stack(frames[n_warm:]))
    drops = np.asarray(drops)
    assert drops.sum() == 0, (
        f"scan continuation dropped rows per frame:\n{drops}")
