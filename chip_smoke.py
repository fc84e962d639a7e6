#!/usr/bin/env python3
"""Smoke test of the whole system on one GPU: the quickest proof that the
main path still starts, runs and is right on the card.

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # only the sharded large-map CG solve
                                       # over 4 cards, against one card

Phases (one card), each in a child process so that exactly one JAX
process holds the card at a time (this parent never imports JAX):

1. device: JAX must report a GPU; prints its kind and count.
2. parity: the Triton Newton sweep against the plain XLA sweep at F=256
   lanes on every level of the 640x480 pyramid, and build_pyramid against
   a numpy reflect-101 reference, each error beside its tolerance.
3. cli: ``python -m slam_robot_tpu.run_replay --synthetic 30 --dump F``,
   then the same with ``--live``; each must exit 0 and write its dump.
4. step: the headline bench sweep at SlamConfig() (bench.run, seed 0):
   eager bootstrap, one scanned continuation, the live ring loop; gates on
   finite poses, zero dropped obs rows, the normalize canary and the
   aligned ATE.
5. tests: ``pytest -m gpu`` on the card; every collected test must pass.

Exits non-zero on the first failed phase (and prints no result line).
The last line of a pass is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, ".smoke")   # listed in .gitignore

# gates of phase 4: the reference CHECKs the normalize invariance to
# +-0.1 px every frame (main.cpp:602-605); 2.8 % of path is the per-seed
# ATE cap of tools/parity.py's production gate
CANARY_PX = 0.1
ATE_ALIGNED_PCT = 2.8


class PhaseFailed(Exception):
    pass


def card_info() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        raise PhaseFailed(f"nvidia-smi failed (rc {r.returncode})")
    return r.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseFailed(what)


# ---------------------------------------------------------------- children

def _device() -> dict:
    import jax

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu", f"JAX found no GPU (platform {d.platform!r})")
    info = {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}
    print(f"device: {d.platform} {d.device_kind} x{len(devs)}")
    print("DEVICE " + json.dumps(info))
    return info


def phase_parity() -> None:
    from slam_robot_tpu.utils import cachedir, kernel_check as kc

    _device()
    cachedir.configure()
    for lvl, (h, w), err, n_over, n_status in kc.newton_errors("triton"):
        print(f"newton level {lvl} {w}x{h} F=256: max |dpos| {err:.3e} px "
              f"(tol {kc.NEWTON_TOL_PX:g}), lanes over tol {n_over}, "
              f"status mismatches {n_status}")
        check(n_over == 0 and n_status == 0,
              f"Newton kernel disagrees with XLA at level {lvl}")
    err = kc.pyramid_error(480, 640, 6)
    print(f"build_pyramid 480x640: max err {err:.3e} (tol {kc.PYRAMID_TOL:g})")
    check(err < kc.PYRAMID_TOL, "build_pyramid disagrees with numpy")


def phase_step() -> None:
    import bench
    from slam_robot_tpu.utils import cachedir

    _device()
    cachedir.configure()
    card = card_info()
    r = bench.run(seeds=(0,))
    for name, s in r["compile_s"].items():
        print(f"set-up: compile {name} {s:.2f} s")
    print(f"set-up: eager bootstrap {r['bootstrap_s']:.2f} s")
    print(f"pipeline.step memory_analysis: {json.dumps(r['step_memory'])}")
    print(f"peak_bytes_in_use {r['peak_bytes_in_use']}")
    print(f"scan {r['scan_step_ms']:.4f} ms/frame, live "
          f"{r['live_step_ms']:.4f} ms/frame, eager "
          f"{r['eager_step_ms']:.4f} ms/frame | {card}")
    print(f"ATE raw {r['ate_mm']:.3f} mm = {r['ate_pct_of_path']:.3f} % of "
          f"path, Sim(3)-aligned {r['ate_pct_aligned_per_seed'][0]:.3f} % "
          f"(cap {ATE_ALIGNED_PCT}); points {r['n_points']} obs {r['n_obs']}")
    print(f"obs_dropped_total {r['obs_dropped_total']} live_obs_dropped "
          f"{r['live_obs_dropped']} canary max scan "
          f"{r['canary_max_px']:.3e} live {r['live_canary_max_px']:.3e} px")
    check(r["poses_finite"], "non-finite poses")
    check(r["obs_dropped_total"] == 0, "scan dropped obs rows")
    check(r["live_obs_dropped"] == 0, "live loop dropped obs rows")
    check(max(r["canary_max_px"], r["live_canary_max_px"]) < CANARY_PX,
          "normalize canary over 0.1 px")
    check(r["ate_pct_aligned_per_seed"][0] <= ATE_ALIGNED_PCT,
          "aligned ATE over its cap")


def phase_four_cards(nf: int = 10_000, npts: int = 500_000) -> dict:
    """ba_cg.solve_sharded over a ('model', 4) mesh against ba_cg.solve on
    one card, at the large-map size of BASELINE config 5 (10k keyframes,
    500k landmarks, 1M observations); tolerances of the CPU test
    tests/test_parallel.py::test_sharded_cg_matches_single_device."""
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from slam_robot_tpu.ops import ba_cg
    from slam_robot_tpu.parallel import mesh as mesh_lib
    from slam_robot_tpu.utils import cachedir, synthetic

    info = _device()
    check(info["count"] == 4, f"needs 4 GPUs, JAX sees {info['count']}")
    cachedir.configure()
    mesh = mesh_lib.make_mesh({"model": 4})
    prob = synthetic.build_large_problem(nf, npts, obs_per_frame=100)
    cfg = ba_cg.CGConfig(max_free_frames=nf, gn_iters=5, cg_iters=20,
                         precond="diag")
    keys = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc",
            "point_uncertainty", "obs_frame", "obs_point", "obs_px",
            "obs_ok", "present", "free_frame")
    args = [prob[k] for k in keys]
    n_obs = int(args[6].shape[0])
    check(n_obs % 4 == 0, f"{n_obs} obs rows do not split over 4 cards")
    obs_sharding = NamedSharding(mesh, PartitionSpec("model"))
    for i in range(6, 10):
        args[i] = jax.device_put(args[i], obs_sharding)
    shard_devs = {s.device for s in args[6].addressable_shards}
    print(f"obs table shards on {len(shard_devs)} distinct devices: "
          f"{sorted(str(d) for d in shard_devs)}")
    check(len(shard_devs) == 4, "obs shards are not on 4 distinct devices")

    def timed(fn):
        jax.block_until_ready(fn().cost)      # compile + first run
        t = time.perf_counter()
        res = fn()
        jax.block_until_ready(res.cost)
        return res, time.perf_counter() - t

    single = [jax.device_put(a, jax.devices()[0]) for a in args]
    ref, t_one = timed(lambda: ba_cg.solve(*single, cfg))
    shd, t_shd = timed(lambda: ba_cg.solve_sharded(mesh, *args, cfg=cfg))
    cost_rel = abs(float(shd.cost) - float(ref.cost)) / abs(float(ref.cost))
    d_trans = float(np.abs(np.asarray(shd.frame_trans)
                           - np.asarray(ref.frame_trans)).max())
    d_pts = float(np.abs(np.asarray(shd.point_loc)
                         - np.asarray(ref.point_loc)).max())
    print(f"large CG {nf} frames / {npts} points / {n_obs} obs, "
          f"{cfg.gn_iters} GN x {cfg.cg_iters} CG: one card {t_one:.4f} s "
          f"({cfg.gn_iters / t_one:.4f} GN iters/s), 4 cards {t_shd:.4f} s "
          f"({cfg.gn_iters / t_shd:.4f} GN iters/s)")
    print(f"sharded vs one card: cost {float(shd.cost):.6g} vs "
          f"{float(ref.cost):.6g} (rel {cost_rel:.2e}, tol 1e-4), max "
          f"|d frame_trans| {d_trans:.3e} mm (tol 0.5), max |d point_loc| "
          f"{d_pts:.3e} mm (tol 1.0)")
    check(bool(ref.ok) and bool(shd.ok), "a solve reported not ok")
    check(cost_rel <= 1e-4 and d_trans <= 0.5 and d_pts <= 1.0,
          "sharded solve disagrees with the one-card solve")
    return info


CHILDREN = {"parity": phase_parity, "step": phase_step}


# ------------------------------------------------------------------ parent

def run_child(argv: list[str], what: str, env=None, timeout=900) -> str:
    t = time.time()
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=timeout, env=env)
    sys.stdout.write(r.stdout)
    if r.returncode != 0:
        sys.stdout.write(r.stderr[-4000:])
        raise PhaseFailed(f"{what} exited {r.returncode}")
    print(f"[{what}: ok in {time.time() - t:.1f} s]", flush=True)
    return r.stdout


def one_card() -> dict:
    py = sys.executable
    me = os.path.abspath(__file__)
    out = run_child([py, me, "--phase", "parity"], "phase 1-2 device+parity")
    m = re.search(r"^DEVICE (\{.*\})$", out, re.M)
    check(m is not None, "device phase printed no device")
    device = json.loads(m.group(1))

    os.makedirs(OUT, exist_ok=True)
    for extra in ([], ["--live"]):
        dump = os.path.join(OUT, "replay_live.txt" if extra else "replay.txt")
        if os.path.exists(dump):
            os.remove(dump)
        out = run_child([py, "-m", "slam_robot_tpu.run_replay",
                         "--synthetic", "30", "--quiet", "--dump", dump]
                        + extra, "phase 3 run_replay " + " ".join(extra))
        check(os.path.getsize(dump) > 0, f"{dump} is empty")
        print(f"  wrote {dump} ({os.path.getsize(dump)} bytes)")

    run_child([py, me, "--phase", "step"], "phase 4 full step")

    env = dict(os.environ, JAX_PLATFORMS="cuda")
    out = run_child([py, "-m", "pytest", "-m", "gpu", "-p", "no:cacheprovider",
                     "-n", "0", "-q", "tests/"], "phase 5 pytest -m gpu",
                    env=env)
    passed = re.search(r"(\d+) passed", out)
    n_pass = int(passed.group(1)) if passed else 0
    bad = re.search(r"(\d+) (failed|skipped|error)", out)
    check(n_pass > 0 and bad is None,
          f"pytest -m gpu: {n_pass} passed, and {bad.group(0) if bad else ''}")
    return device


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded CG solve over 4 cards")
    ap.add_argument("--phase", choices=sorted(CHILDREN), help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    try:
        if args.phase:
            CHILDREN[args.phase]()
            return 0
        device = phase_four_cards() if args.four_cards else one_card()
        print(card_info())
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
