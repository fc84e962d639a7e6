"""Sweep config overrides on the parity harness's production_defaults
sequence (the 40-frame rotation-heavy scene under shipped defaults) and
print truth-ATE per variant — the fast inner loop for making the
production config pass the 1% parity gate without losing the bench sweep.

    python tools/probe_prodseq.py --variants "lm_lambda_min=1e-05,lm_lambda_min=0.0001"

Variant syntax matches profile_scan's set: fields (";"-joined overrides);
"default" = shipped defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default="default")
    ap.add_argument("--seq", default="production_defaults")
    ap.add_argument("--seed", type=int, default=-1,
                    help="override the sequence's texture-draw seed "
                         "(finding 32: ATE is draw-dominated — decide "
                         "config changes on multi-seed medians)")
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
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
    from tools import parity

    spec = parity.SEQUENCES[args.seq]
    seq_kw = dict(spec["seq"])
    if args.seed >= 0:
        seq_kw["seed"] = args.seed

    for name in args.variants.split(","):
        kw = dict(spec["cfg"])
        if name != "default":
            for pair in name.split(";"):
                k, v = pair.split("=")
                ftype = type(getattr(SlamConfig(), k))
                if ftype is bool:
                    kw[k] = v == "True"
                elif ftype is tuple:
                    kw[k] = tuple(int(t) for t in v.split("x"))
                else:
                    kw[k] = ftype(v)
        cfg = SlamConfig(**kw)
        src = sources.SyntheticSource(cfg, **seq_kw)
        ps = pipeline.init(cfg, [jnp.asarray(src.k)] * 2)
        for i in range(seq_kw["n_frames"]):
            ps, _ = pipeline.step(ps, jnp.asarray(src.get(i % 2, i)), cfg)
            ps = pipeline.maybe_polish(ps, i, cfg)
        est = dump_util.trajectory(ps.map)
        true = np.asarray(src.true_trans[: seq_kw["n_frames"]])
        ate = dump_util.ate(est, true)
        path = float(np.linalg.norm(true[-1] - true[0]))
        m = ps.map
        no = int(m.n_obs)
        errn = np.linalg.norm(np.asarray(m.obs_err[:no]), axis=1)
        dis = np.asarray(m.obs_disabled[:no])
        print(json.dumps({
            "variant": name,
            "ate_mm": round(ate, 2),
            "ate_pct": round(100.0 * ate / path, 2),
            "median_px": round(float(np.median(errn[~dis])), 3)
            if (~dis).any() else 0.0,
            "n_points": int(m.n_points),
        }), flush=True)


if __name__ == "__main__":
    main()
