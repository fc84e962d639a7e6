"""Reference-parity trajectory harness.

The north star is "trajectory ATE within 1% of the C++ reference on
recorded sequences" (BASELINE.md). The reference's own integration method
is record/replay (main.cpp:371-398 + video.h:24-38): record a sequence,
replay it deterministically, compare trajectories.

**Why the C++ side is not run here:** the reference needs Ceres 1.8 (it
vendors only the include path, Makefile:7-8), Eigen, glog, gflags, CHOLMOD
and OpenCV 2-era APIs. This container has OpenCV 4 only — no Ceres, no
Eigen headers, no glog/gflags/cholmod (verified: `ldconfig -p | grep
ceres` empty, `/usr/include/eigen3` absent) — and package installation is
unavailable (zero egress). The harness therefore gates on **pinned golden
trajectories**: frozen deterministic sequences (fixed seed, fixed config)
replayed through the full pipeline, compared against committed fixtures in
tests/fixtures/. Any change that moves a trajectory beyond its gate shows
up as ATE drift; when a built reference becomes available, point --golden
at a dump of its /tmp/z trajectory instead (utils/dump.py reads/writes
that format).

Sequences:
  forward_yaw          24f 320x240, gentle forward+yaw (the original golden)
  rotation_heavy       40f 640x480 (production res), 5x yaw rate: stored
                       views age fast, retry ladder and keyframe cadence
                       dominate
  long_forward         100f 320x240: long-horizon windowed-BA drift
  production_defaults  the rotation_heavy sequence under the config users
                       actually run (production deviations ON) — the
                       shipped defaults get their own accuracy gate

Gates scale with path length: max(1.5 mm, 1% of path) per sequence, so a
short path cannot hide a >1% regression behind an absolute gate.

Usage:
    python tools/parity.py                  # replay all + compare, JSON
    python tools/parity.py --seq rotation_heavy
    python tools/parity.py --regen          # regenerate golden fixtures
    python tools/parity.py --out PARITY.json

CI gate: tests/test_parity.py runs the same comparisons.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

FIXTURES = os.path.join(os.path.dirname(__file__), "..", "tests", "fixtures")

# reference-exact semantics come from the SINGLE shared pin list
# (config.REFERENCE_EXACT_KW) so production deviations and the goldens'
# pins cannot drift apart; only capacities/resolution are set per sequence
from slam_robot_tpu.config import REFERENCE_EXACT_KW  # noqa: E402

_SMALL = dict(
    image_width=320, image_height=240, pyramid_depth=5, levels_unsure=5,
    max_features=192, max_corners=96, min_matches=20,
    max_points=512, max_obs=8192, max_obs_per_point=16,
)

SEQUENCES = {
    "forward_yaw": dict(
        seq=dict(n_frames=24, seed=7, n_points=700, step_mm=15.0,
                 yaw_rate=0.004),
        cfg=dict(_SMALL, max_frames=32, **REFERENCE_EXACT_KW),
        golden="golden_trajectory.json",
        truth_pct=1.0,
    ),
    "rotation_heavy": dict(
        # production resolution; ~0.57 deg/frame-pair yaw — stored views
        # age out of appearance fast, exercising the retry ladder, the
        # backward caches' margins and the keyframe cadence
        seq=dict(n_frames=40, seed=11, n_points=1400, step_mm=4.0,
                 yaw_rate=0.02),
        cfg=dict(max_frames=64, **REFERENCE_EXACT_KW),
        golden="golden_rotation.json",
        # rotation-dominant motion is low-parallax (weak triangulation);
        # the windowed solver genuinely drifts more here (measured 1.7%)
        truth_pct=2.5,
    ),
    "long_forward": dict(
        # 100 frames: long-horizon windowed-BA drift accumulation
        seq=dict(n_frames=100, seed=3, n_points=900, step_mm=12.0,
                 yaw_rate=0.006),
        cfg=dict(_SMALL, max_frames=128, **REFERENCE_EXACT_KW),
        golden="golden_long.json",
        truth_pct=1.0,
    ),
    "production_defaults": dict(
        # SAME rendered scene family as rotation_heavy under the SHIPPED
        # defaults (backoff, give-up, window caches, LM policy all ON):
        # the config users run is CI-guarded, not just the
        # reference-exact one. MULTI-SEED: closed-loop ATE on one texture
        # draw is cadence-chaotic (PERF.md findings 32/38 — seed 11 swung
        # 1.35 <-> 2.69% across solver policies that are equivalent on
        # 3-seed medians), so this gate replays three draws and binds the
        # MEDIAN truth ATE, with a per-seed blowup cap and per-seed drift
        # gates vs the committed golden trajectories.
        seq=dict(n_frames=40, seed=11, n_points=1400, step_mm=4.0,
                 yaw_rate=0.02),
        seeds=[11, 12, 13],
        cfg=dict(max_frames=64),
        golden="golden_production.json",
        truth_pct=2.8,         # per-seed cap (worst measured 2.69 + margin)
        truth_pct_median=1.6,  # 3-seed median bar (measured 1.49). Round 5
                               # re-examined tightening to 1.0: the only
                               # knobs that reach it on the bench family
                               # (min_matches 56, max_corners 200) regress
                               # THIS fast-yaw family 2-8x or sign-flip
                               # other seeds — PERF.md findings 43/44. The
                               # bar states what the shipped config
                               # measures, not what a per-regime knob
                               # could cherry-pick.
    ),
}

# legacy single-sequence aliases (tests/test_parity.py pre-r3 API)
SEQ = SEQUENCES["forward_yaw"]["seq"]
CFG_KW = SEQUENCES["forward_yaw"]["cfg"]
GOLDEN = os.path.join(FIXTURES, SEQUENCES["forward_yaw"]["golden"])


def run_sequence(name: str = "forward_yaw", seed: int | None = None):
    # EXACTLY the test env (tests/conftest.py): the 8-virtual-device flag
    # changes XLA:CPU compilation enough that a trajectory replayed with it
    # drifts ~2 mm from one generated without it on the cadence-chaotic
    # rotation sequence (each env is internally deterministic). Goldens
    # must be generated under the env that replays them.
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from slam_robot_tpu.utils import cachedir

    cachedir.configure("cpu", 5.0)

    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.io import sources
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import dump as dump_util

    spec = SEQUENCES[name]
    seq_kw = dict(spec["seq"])
    if seed is not None:
        seq_kw["seed"] = seed
    cfg = SlamConfig(**spec["cfg"])
    src = sources.SyntheticSource(cfg, **seq_kw)
    ps = pipeline.init(cfg, [jnp.asarray(src.k)] * 2)
    for i in range(seq_kw["n_frames"]):
        ps, _ = pipeline.step(ps, jnp.asarray(src.get(i % 2, i)), cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
    est = dump_util.trajectory(ps.map)
    true = np.asarray(src.true_trans[: seq_kw["n_frames"]])

    # match-quality stat alongside the trajectory: a run can stay inside
    # the ATE gate while its matches degrade — the
    # enabled-obs median reprojection error catches that axis
    m = ps.map
    no = int(m.n_obs)
    errn = np.linalg.norm(np.asarray(m.obs_err[:no]), axis=1)
    dis = np.asarray(m.obs_disabled[:no])
    stats = {
        "median_enabled_err_px": (
            round(float(np.median(errn[~dis])), 4) if (~dis).any() else 0.0),
        "n_obs": no,
        "n_points": int(m.n_points),
    }
    return est, true, stats


def gate_mm(path_mm: float) -> float:
    """Drift gate: 1% of path, floored at 1.5 mm for very short paths."""
    return max(1.5, 0.01 * path_mm)


def compare(name: str, est, true, stats=None):
    import numpy as np

    from slam_robot_tpu.utils import dump as dump_util

    spec = SEQUENCES[name]
    with open(os.path.join(FIXTURES, spec["golden"])) as f:
        golden = json.load(f)
    assert golden["sequence"] == spec["seq"], f"{name}: fixture mismatch"
    gold = np.asarray(golden["trajectory"], np.float32)

    ate_golden = dump_util.ate(est, gold)
    ate_true = dump_util.ate(est, true)
    path = float(np.linalg.norm(true[-1] - true[0]))
    g = gate_mm(path)
    rep = {
        "sequence": name,
        "ate_vs_golden_mm": round(ate_golden, 3),
        "ate_vs_ground_truth_mm": round(ate_true, 3),
        "ate_pct_of_path": round(100.0 * ate_true / path, 3),
        "path_mm": round(path, 1),
        "gate_mm": round(g, 2),
        "truth_gate_pct": spec.get("truth_pct", 1.0),
        "golden_commit": golden.get("commit", "unrecorded"),
        "ok": bool(ate_golden <= g),
    }
    # match-quality gate: median enabled reprojection error must not
    # degrade past the fixture's recorded value + 0.1 px (a trajectory
    # can sit inside the ATE gate while its matches rot)
    gm = golden.get("median_enabled_err_px")
    if stats is not None and gm is not None:
        rep["median_enabled_err_px"] = stats["median_enabled_err_px"]
        rep["golden_median_px"] = gm
        rep["median_ok"] = bool(
            stats["median_enabled_err_px"] <= gm + 0.1)
        rep["ok"] = rep["ok"] and rep["median_ok"]
    return rep


def evaluate(name: str):
    """Replay + gate one sequence; handles single- and multi-seed specs.

    Multi-seed (``spec["seeds"]``): each draw is gated on drift vs its own
    golden trajectory and a per-seed truth-ATE cap (``truth_pct``), and the
    MEDIAN truth ATE across draws is gated at ``truth_pct_median`` — a
    single texture draw's cadence chaos (PERF.md findings 32/38) can no
    longer pass/fail the production config by luck.
    """
    import numpy as np

    from slam_robot_tpu.utils import dump as dump_util

    spec = SEQUENCES[name]
    seeds = spec.get("seeds")
    if not seeds:
        est, true, stats = run_sequence(name)
        return compare(name, est, true, stats)

    with open(os.path.join(FIXTURES, spec["golden"])) as f:
        golden = json.load(f)
    assert golden["sequence"] == spec["seq"], f"{name}: fixture mismatch"
    assert golden.get("seeds") == seeds, f"{name}: fixture seed-set mismatch"
    per = []
    for sd in seeds:
        est, true, stats = run_sequence(name, seed=sd)
        g = golden["per_seed"][str(sd)]
        gold = np.asarray(g["trajectory"], np.float32)
        path = float(np.linalg.norm(true[-1] - true[0]))
        ate_g = dump_util.ate(est, gold)
        ate_t = dump_util.ate(est, true)
        gmm = gate_mm(path)
        gm = g.get("median_enabled_err_px")
        r = {
            "seed": sd,
            "ate_vs_golden_mm": round(ate_g, 3),
            "ate_vs_ground_truth_mm": round(ate_t, 3),
            "ate_pct_of_path": round(100.0 * ate_t / path, 3),
            "gate_mm": round(gmm, 2),
            "median_enabled_err_px": stats["median_enabled_err_px"],
            "golden_median_px": gm,
            "drift_ok": bool(ate_g <= gmm),
            "cap_ok": bool(100.0 * ate_t / path <= spec["truth_pct"]),
            "median_ok": bool(gm is None
                              or stats["median_enabled_err_px"] <= gm + 0.1),
        }
        r["ok"] = r["drift_ok"] and r["cap_ok"] and r["median_ok"]
        per.append(r)
    med = float(np.median([r["ate_pct_of_path"] for r in per]))
    return {
        "sequence": name,
        "seeds": seeds,
        "per_seed": per,
        "median_truth_pct": round(med, 3),
        "median_gate_pct": spec["truth_pct_median"],
        "per_seed_cap_pct": spec["truth_pct"],
        "golden_commit": golden.get("commit", "unrecorded"),
        "ok": bool(all(r["ok"] for r in per)
                   and med <= spec["truth_pct_median"]),
    }


def _git_commit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(__file__),
        ).stdout.strip()
    except Exception:  # noqa: BLE001
        return "unknown"


def regen(name: str) -> bool:
    """Regenerate one golden fixture; refuses if the generating build fails
    its own truth gate (de-circularization) — every
    committed golden is evidence the generating build met the bar."""
    import numpy as np

    from slam_robot_tpu.utils import dump as dump_util

    spec = SEQUENCES[name]
    path = os.path.join(FIXTURES, spec["golden"])
    os.makedirs(FIXTURES, exist_ok=True)
    seeds = spec.get("seeds")
    if not seeds:
        est, true, stats = run_sequence(name)
        p = float(np.linalg.norm(true[-1] - true[0]))
        truth_ate = dump_util.ate(est, true)
        truth_pct = 100.0 * truth_ate / p
        bar = spec.get("truth_pct", 1.0)
        if truth_pct > bar:
            print(f"REFUSED {name}: ATE vs truth {truth_ate:.2f} mm = "
                  f"{truth_pct:.2f}% of path > {bar}% gate — fix "
                  f"accuracy before regenerating this fixture", flush=True)
            return False
        commit = _git_commit()
        with open(path, "w") as f:
            json.dump(
                {"sequence": spec["seq"], "config": spec["cfg"],
                 "commit": commit,
                 "ate_vs_truth_mm": round(truth_ate, 3),
                 "median_enabled_err_px": stats["median_enabled_err_px"],
                 "trajectory": est.tolist()}, f, indent=1,
            )
        print(f"golden written: {path} ({len(est)} poses, "
              f"path {p:.0f} mm, ATE vs truth {truth_ate:.2f} mm = "
              f"{truth_pct:.2f}%, median "
              f"{stats['median_enabled_err_px']:.3f} px, @{commit[:9]})",
              flush=True)
        return True

    per_seed, pcts = {}, []
    for sd in seeds:
        est, true, stats = run_sequence(name, seed=sd)
        p = float(np.linalg.norm(true[-1] - true[0]))
        truth_ate = dump_util.ate(est, true)
        pct = 100.0 * truth_ate / p
        pcts.append(pct)
        if pct > spec["truth_pct"]:
            print(f"REFUSED {name}: seed {sd} ATE {pct:.2f}% of path > "
                  f"{spec['truth_pct']}% per-seed cap", flush=True)
            return False
        per_seed[str(sd)] = {
            "trajectory": est.tolist(),
            "ate_vs_truth_mm": round(truth_ate, 3),
            "ate_pct_of_path": round(pct, 3),
            "median_enabled_err_px": stats["median_enabled_err_px"],
        }
    med = float(np.median(pcts))
    if med > spec["truth_pct_median"]:
        print(f"REFUSED {name}: median ATE {med:.2f}% of path > "
              f"{spec['truth_pct_median']}% median gate", flush=True)
        return False
    commit = _git_commit()
    with open(path, "w") as f:
        json.dump({"sequence": spec["seq"], "seeds": seeds,
                   "config": spec["cfg"], "commit": commit,
                   "median_truth_pct": round(med, 3),
                   "per_seed": per_seed}, f, indent=1)
    print(f"golden written: {path} (seeds {seeds}, median ATE "
          f"{med:.2f}% of path, @{commit[:9]})", flush=True)
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--regen", action="store_true",
                    help="regenerate the golden fixtures from this build")
    ap.add_argument("--seq", default="",
                    help="comma-separated sequence names (default: all)")
    ap.add_argument("--out", default="", help="write the JSON ATE artifact")
    args = ap.parse_args(argv)

    names = args.seq.split(",") if args.seq else list(SEQUENCES)
    reports = []
    for name in names:
        if args.regen:
            regen(name)
            continue
        rep = evaluate(name)
        reports.append(rep)
        print(json.dumps(rep), flush=True)

    if args.regen:
        return 0
    report = {
        "sequences": reports,
        "ok": all(r["ok"] for r in reports),
        "reference_cpp": "unbuildable here: no ceres/eigen/glog/gflags/"
                         "cholmod and zero egress; golden fixtures gate "
                         "drift instead (see module docstring)",
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
