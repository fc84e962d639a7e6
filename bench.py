"""Headline benchmark: full SLAM step rate (track + match + BA) at 640x480
with a 1k-landmark map on one GPU.

The reference publishes no numbers (BASELINE.md); the north star in
BASELINE.json asks for the loop deployed as "a single jitted lax.scan"
over frames. Accordingly the primary measurement scans device-resident
frames inside one program (production shape, no per-frame host dispatch);
the eager per-call rate and the live per-frame loop are reported in
detail. Prints ONE JSON line:
{"metric": ..., "value": fps, "unit": "fps", "detail": {...}}.

Fails (non-zero exit, no JSON) when JAX finds no GPU: a CPU timing is not
a device number.

    python bench.py
"""

from __future__ import annotations

import json
import subprocess
import time

METRIC = "SLAM fps (track+match+BA) 640x480, 1k-landmark map, 1 card"


def card_info() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 and \
        r.stdout.strip() else f"nvidia-smi failed (rc {r.returncode})"


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev.platform!r}; this "
                         "measurement needs the card")
    return dev


def device_record() -> dict:
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card_info()}


def _ate(est_t, true_t):
    """(raw ATE mm, raw % of path, Sim(3)-aligned % of path)."""
    import numpy as np

    from slam_robot_tpu.utils.dump import ate_aligned

    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = max(float(np.linalg.norm(true_t[-1] - true_t[0])), 1e-9)
    return ate, 100.0 * ate / path, 100.0 * ate_aligned(est_t, true_t) / path


def run(seeds=(0, 1, 2), n_warm: int = 96, n_timed: int = 64) -> dict:
    """Bootstrap the bench sweep eagerly, then time the scanned
    continuation and the live loop. Returns the detail dict; seed 0 is
    timed, further seeds reuse the compiled programs for accuracy only."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.models.localmap import slam_usable
    from slam_robot_tpu.utils.benchscene import make_frames, sweep_pose
    from slam_robot_tpu.utils.fetchpool import FetchPool

    cfg = SlamConfig()  # 640x480, max_points=1024 (the 1k-landmark config)
    compile_s = {}

    # pre-render an alternating-stereo panoramic sweep wide enough that
    # keyframes keep seeding until the map actually HOLDS ~1k live
    # landmarks. The warm phase yaws briskly to populate the map and the
    # timed continuation runs at the reference's slow-robot motion
    # (utils/benchscene).
    frames = make_frames(cfg, n_warm + n_timed)
    ps = pipeline.init(cfg)

    t = time.time()
    step_exe = pipeline.step.lower(ps, frames[0], cfg).compile()
    compile_s["step"] = time.time() - t
    mem = step_exe.memory_analysis()

    # eager bootstrap: drive the first part of the sweep so the map is
    # populated (also measures the per-call rate)
    t = time.time()
    for i in range(n_warm - 8):
        ps, _ = step_exe(ps, frames[i])
        ps = pipeline.maybe_polish(ps, i, cfg)
    jax.block_until_ready(ps)
    bootstrap_s = time.time() - t
    t0 = time.perf_counter()
    for i in range(n_warm - 8, n_warm):
        ps, _ = step_exe(ps, frames[i])
    jax.block_until_ready(ps)
    eager_ms = (time.perf_counter() - t0) / 8 * 1000

    # production shape: scan the sweep's continuation inside one program.
    # Each rep replays the same continuation from the same mid-sweep state
    # (deterministic, identical work), so the timing is of live
    # exploration — tracking, keyframing, seeding, window BA.
    @jax.jit
    def run_scan(ps, imgs):
        def body(ps, img):
            ps, met = pipeline.step(ps, img, cfg)
            drops = (met["fast_obs_dropped"] + met["slow_obs_dropped"]
                     + met["reproject_obs_dropped"])
            return ps, (met["mean_reproj_err"], drops,
                        met["normalize_canary_px"])

        return jax.lax.scan(body, ps, imgs)

    imgs = jnp.stack(frames[n_warm:])
    t = time.time()
    scan_exe = run_scan.lower(ps, imgs).compile()
    compile_s["scan"] = time.time() - t
    ps2, (errs, drops, canary) = scan_exe(ps, imgs)
    jax.block_until_ready(errs)
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        ps2, (errs, drops, canary) = scan_exe(ps, imgs)
    jax.block_until_ready(errs)
    scan_ms = (time.perf_counter() - t0) / (reps * n_timed) * 1000
    obs_dropped_total = int(np.asarray(drops).sum())
    canary_max = float(np.asarray(canary).max())

    # live robot loop: frames arrive one at a time as on a real robot
    # (main.cpp:503-645). step_live_ring donates the state and carries a
    # f32[8,LIVE_WIDTH] telemetry ring (pipeline.LIVE_SCALARS: loop
    # scalars + the safety counters) fetched once per 8 frames on a pool
    # thread. Frames come from the pre-split host list. run_replay --live
    # is this loop.
    live_frames = frames[n_warm:]
    ring = jnp.zeros((8, pipeline.LIVE_WIDTH), jnp.float32)
    t = time.time()
    # the live step donates the state: ps is not used after this
    ps_l, ring = pipeline.step_live_ring(ps, ring, live_frames[0], cfg)
    jax.block_until_ready(ring)
    compile_s["live"] = time.time() - t
    n_live = n_timed - 1
    pool = FetchPool(workers=2)
    fetched = []
    group = []
    t0 = time.perf_counter()
    for i in range(1, 1 + n_live):
        ps_l, ring = pipeline.step_live_ring(ps_l, ring, live_frames[i], cfg)
        group.append(i)
        if len(group) == 8:
            pool.submit(ring, group)
            group = []
        for metas, rows in pool.drain():
            fetched.extend(zip(metas, rows[-len(metas):]))
    if group:
        pool.submit(ring, group)
    for metas, rows in pool.join():
        fetched.extend(zip(metas, rows[-len(metas):]))
    live_ms = (time.perf_counter() - t0) / n_live * 1000
    pool.close()
    assert len(fetched) == n_live  # every frame's telemetry arrived
    ix = pipeline.LIVE_IDX
    live_drops = int(sum(
        row[ix["fast_obs_dropped"]] + row[ix["slow_obs_dropped"]]
        + row[ix["reproject_obs_dropped"]] for _, row in fetched))
    live_canary_max = float(max(
        row[ix["normalize_canary_px"]] for _, row in fetched))
    stats = jax.devices()[0].memory_stats() or {}
    peak_bytes = stats.get("peak_bytes_in_use")

    # accuracy: the reference-parity mean includes disabled outliers BY
    # DESIGN (slam.cpp:523-548); report the robust median over enabled obs,
    # the split, and the trajectory ATE vs the known sweep
    m2 = ps2.map
    n_obs_final = int(m2.n_obs)
    errn = np.linalg.norm(np.asarray(m2.obs_err[:n_obs_final]), axis=1)
    dis = np.asarray(m2.obs_disabled[:n_obs_final])
    q = lambda a, p: float(np.quantile(a, p)) if a.size else 0.0
    # "enabled" still counts obs of points the flag machine retired from
    # SLAM; the solver's true input is enabled obs of slam-USABLE points
    pu = np.asarray(slam_usable(m2.point_flags) & m2.point_mask)
    usable = (~dis) & pu[np.asarray(m2.obs_point[:n_obs_final]).clip(0)]
    err_split = {
        "pct_disabled": 100.0 * float(dis.mean()),
        "enabled_quantiles_px": {p: q(errn[~dis], v) for p, v in
                                 (("p50", .5), ("p90", .9), ("p99", .99))},
        "n_enabled_usable": int(usable.sum()),
        "usable_quantiles_px": {p: q(errn[usable], v) for p, v in
                                (("p50", .5), ("p90", .9), ("p99", .99))},
    }

    def traj(m):
        nf = int(m.n_frames)
        est = np.asarray(m.frame_trans[:nf])
        true = np.stack([sweep_pose(i)[1] for i in range(nf)])
        return est, true

    est_t, true_t = traj(m2)
    ate_mm, ate_pct, ate_al_pct = _ate(est_t, true_t)
    seed_pcts = {0: ate_pct}
    seed_al_pcts = {0: ate_al_pct}
    # multi-seed accuracy: single-draw ATE is cadence-chaotic (PERF.md),
    # so the headline carries the median over seeds. Extra seeds reuse the
    # compiled step/scan: one render + one bootstrap + one scan each.
    for sd in seeds:
        if sd == 0:
            continue
        fr = make_frames(cfg, n_warm + n_timed, seed=sd)
        ps_s = pipeline.init(cfg)
        for i in range(n_warm):
            ps_s, _ = step_exe(ps_s, fr[i])
            ps_s = pipeline.maybe_polish(ps_s, i, cfg)
        ps_s2, (_e, drops_s, canary_s) = scan_exe(ps_s, jnp.stack(fr[n_warm:]))
        _, seed_pcts[sd], seed_al_pcts[sd] = _ate(*traj(ps_s2.map))
        obs_dropped_total += int(np.asarray(drops_s).sum())
        canary_max = max(canary_max, float(np.asarray(canary_s).max()))

    return {
        "scan_step_ms": scan_ms,
        "fps": 1000.0 / scan_ms,
        "eager_step_ms": eager_ms,
        "live_step_ms": live_ms,
        "live_fps": 1000.0 / live_ms,
        "compile_s": compile_s,
        "bootstrap_s": bootstrap_s,
        "step_memory": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "code_bytes": mem.generated_code_size_in_bytes,
        },
        "peak_bytes_in_use": peak_bytes,
        "mean_reproj_err_px": float(np.asarray(errs)[-1]),
        "median_enabled_err_px": q(errn[~dis], 0.5),
        "err_split": err_split,
        "poses_finite": bool(np.isfinite(est_t).all()),
        "ate_mm": ate_mm,
        "ate_pct_of_path": ate_pct,
        "ate_pct_per_seed": seed_pcts,
        "ate_pct_median": float(np.median(list(seed_pcts.values()))),
        "ate_pct_aligned_per_seed": seed_al_pcts,
        "ate_pct_aligned_median": float(np.median(list(seed_al_pcts.values()))),
        "obs_dropped_total": obs_dropped_total,
        "canary_max_px": canary_max,
        "live_obs_dropped": live_drops,
        "live_canary_max_px": live_canary_max,
        "n_points": int(m2.n_points),
        "n_obs": n_obs_final,
    }


def main() -> None:
    require_gpu()
    from slam_robot_tpu.utils import cachedir

    cachedir.configure()
    detail = run()
    detail["device"] = device_record()
    print(json.dumps({"metric": METRIC, "value": detail["fps"],
                      "unit": "fps", "detail": detail}))


if __name__ == "__main__":
    main()
