"""Diagnose the bwd_window_cache keyframe-cadence shift.

Round-2 controlled measurement: cache off = 15 keyframes / ATE 1.01%,
cache on = 2 keyframes / 1.29% on the same 64-frame bench continuation.
Median error is unchanged, so the divergence must live in MARGINAL lanes
whose match outcome flips with the cache. This tool isolates semantics
from closed-loop divergence by running matcher.track twice ON THE SAME
STATE (cache on / cache off) for each continuation frame and diffing the
per-lane `matched` masks.

    python tools/diag_wincache.py [--frames 24] [--res 640x480]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--warm", type=int, default=96)
    ap.add_argument("--drill", type=int, default=-1,
                    help="frame index (within the continuation) to drill "
                         "into lane level; -1 = first diverging frame")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from slam_robot_tpu.utils import cachedir

    cachedir.configure("cpu")
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import benchscene

    cfg_on = SlamConfig()
    assert cfg_on.bwd_window_cache
    cfg_off = dataclasses.replace(cfg_on, bwd_window_cache=False)

    frames = benchscene.make_frames(cfg_on, args.warm + args.frames)
    print("frames rendered", flush=True)

    ps = pipeline.init(cfg_on)
    t0 = time.time()
    for i in range(args.warm):
        ps, _ = pipeline.step(ps, frames[i], cfg_on, run_slam=True)
        if i % 16 == 15:
            print(f"warm {i+1}/{args.warm} ({time.time()-t0:.0f}s)",
                  flush=True)

    # continuation: per frame, same-state on/off diff, then advance with ON
    drill_frame = None
    drill_state = None
    for j in range(args.frames):
        img = frames[args.warm + j]
        # same pre-step state, both configs: the only difference inside is
        # the matcher's backward-window source
        ps_on, met_on = pipeline.step(ps, img, cfg_on, run_slam=True)
        ps_off, met_off = pipeline.step(ps, img, cfg_off, run_slam=True)
        m_on = np.asarray(met_on["feat_matched"])
        m_off = np.asarray(met_off["feat_matched"])
        on_only = m_on & ~m_off
        off_only = m_off & ~m_on
        both = m_on & m_off
        px_on = np.asarray(met_on["feat_px"])[both]
        px_off = np.asarray(met_off["feat_px"])[both]
        rec = {
            "frame": j,
            "n_on": int(m_on.sum()),
            "n_off": int(m_off.sum()),
            "on_only": int(on_only.sum()),
            "off_only": int(off_only.sum()),
            "kf_on": bool(np.asarray(met_on["is_keyframe"])),
            "kf_off": bool(np.asarray(met_off["is_keyframe"])),
            # bitwise position agreement on co-matched lanes: nonzero =
            # fp-level divergence that will fork the closed loop chaotically
            "px_bitdiff": int((px_on != px_off).any(axis=1).sum()),
            "px_maxdiff": float(np.abs(px_on - px_off).max()) if both.any() else 0.0,
        }
        print(json.dumps(rec), flush=True)
        if drill_frame is None and (rec["on_only"] or rec["off_only"]):
            drill_frame = j
            drill_state = ps
            np.save("/tmp/diag_onlane.npy", on_only)
            np.save("/tmp/diag_offlane.npy", off_only)
        ps = ps_on  # advance with production (cache on)

    if drill_frame is None:
        print("no divergence found", flush=True)
        return

    print(f"\nfirst divergence at continuation frame {drill_frame}; "
          f"drilling lanes...", flush=True)
    _drill(drill_state, frames[args.warm + drill_frame], cfg_on, cfg_off)


def _drill(ps, img, cfg_on, cfg_off):
    """Re-run both modes eagerly with the tracker instrumented: for each
    bidirectional sweep, record per-lane forward result, backward result,
    roundtrip distance, and ok1/ok2 — then print the diverging lanes."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.ops import tracker_fused as tf

    on_only = np.load("/tmp/diag_onlane.npy")
    off_only = np.load("/tmp/diag_offlane.npy")
    lanes = np.nonzero(on_only | off_only)[0]
    print(f"diverging lanes: {lanes.tolist()}"
          f" (on_only={np.nonzero(on_only)[0].tolist()},"
          f" off_only={np.nonzero(off_only)[0].tolist()})", flush=True)

    orig = tf.track_bidirectional_batch
    records = {"on": [], "off": []}
    mode = ["on"]

    def spy(pyr_from, pyr_to, from_pt, init_to_pt, lvls, weight,
            threshold=0.001, max_iters=10, iters_coarse=0,
            roundtrip_px=0.3, min_variance=1e-5, active=None,
            backend=None, p1_packed=None, p1_view_idx=None,
            p1_stats0=None, bwd_lvls=None, bwd_ref_from_window=False,
            bwd_win_cache=None):
        to_pt, ok = orig(
            pyr_from, pyr_to, from_pt, init_to_pt, lvls, weight,
            threshold, max_iters, iters_coarse, roundtrip_px,
            min_variance, active, backend, p1_packed, p1_view_idx,
            p1_stats0, bwd_lvls, bwd_ref_from_window, bwd_win_cache,
        )
        # decompose: forward, then backward both ways for comparison
        fwd = tf.track_feature_batch(
            pyr_to, None, init_to_pt, lvls, weight, threshold, max_iters,
            iters_coarse=iters_coarse, active=active, backend=backend,
            packed=p1_packed, packed_view_idx=p1_view_idx,
            return_windows=bwd_ref_from_window,
        )
        if bwd_ref_from_window:
            to2, ok1, fwd_windows = fwd
            dims = tf._static_dims(pyr_to)
            S = int(weight.shape[0])
            F = from_pt.shape[0]
            cols = []
            for lv, wo in enumerate(fwd_windows):
                winl, orgl = wo
                h, w = dims[lv]
                d, v, m, sq = tf._sample_from_windows(
                    winl, orgl, to2 / (2.0 ** lv), float(w), float(h), S)
                cols.append(jnp.concatenate(
                    [d.reshape(F, S * S), v.reshape(F, S * S),
                     m[:, None], sq[:, None]], axis=-1))
            packed_bwd = jnp.stack(cols, axis=1)
            bl = lvls if bwd_lvls is None else bwd_lvls
            back_c, ok2_c = tf.track_feature_batch(
                pyr_from, None, from_pt, bl, weight, threshold, max_iters,
                iters_coarse=iters_coarse, active=ok1, backend=backend,
                packed=packed_bwd, win_cache=bwd_win_cache)
            back_f, ok2_f = tf.track_feature_batch(
                pyr_from, None, from_pt, bl, weight, threshold, max_iters,
                iters_coarse=iters_coarse, active=ok1, backend=backend,
                packed=packed_bwd, win_cache=None)
            records[mode[0]].append(dict(
                from_pt=np.asarray(from_pt), to_pt=np.asarray(to2),
                ok1=np.asarray(ok1),
                back_cached=np.asarray(back_c), ok2_cached=np.asarray(ok2_c),
                back_fresh=np.asarray(back_f), ok2_fresh=np.asarray(ok2_f),
                active=np.asarray(active),
            ))
        return to_pt, ok

    tf.track_bidirectional_batch = spy
    try:
        with jax.disable_jit():
            mode[0] = "on"
            pipeline.step(ps, img, cfg_on, run_slam=False)
    finally:
        tf.track_bidirectional_batch = orig

    print(f"\nsweeps recorded: {len(records['on'])}", flush=True)
    for si, r in enumerate(records["on"]):
        for ln in lanes:
            if not r["active"][ln]:
                continue
            d_c = np.linalg.norm(r["from_pt"][ln] - r["back_cached"][ln])
            d_f = np.linalg.norm(r["from_pt"][ln] - r["back_fresh"][ln])
            print(
                f"sweep {si} lane {ln}: ok1={bool(r['ok1'][ln])} "
                f"cached: ok2={bool(r['ok2_cached'][ln])} d={d_c:.3f} "
                f"fresh: ok2={bool(r['ok2_fresh'][ln])} d={d_f:.3f} "
                f"from={r['from_pt'][ln].round(2).tolist()} "
                f"to={r['to_pt'][ln].round(2).tolist()}",
                flush=True,
            )


if __name__ == "__main__":
    main()
