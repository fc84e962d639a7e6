"""End-to-end replay driver: the reference's main() as a host loop around
one jitted step (main.cpp:421-664 rebuilt, flags included).

Usage:
    python -m slam_robot_tpu.run_replay --load DIR        # PNG/npy replay
    python -m slam_robot_tpu.run_replay --synthetic 60    # rendered world
    python -m slam_robot_tpu.run_replay --save DIR ...    # record frames
    ... --dump /tmp/z                                     # gnuplot map dump
    ... --no-slam                                         # tracking only

Prints one status line per frame (the reference's frame banner + TIMER
lines) and a JSON summary at exit (cumulative BA iterations + final error,
main.cpp:654-656).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _live_loop(args, cfg, src, ps, run_slam, rec, view=None) -> int:
    """The live robot loop (main.cpp:503-645 cadence): pipeline.step_live
    donates the ~70 MB state in place and the jitted step itself carries a
    f32[8,LIVE_WIDTH] telemetry ring (pipeline.step_live_ring), fetched
    ONCE per 8 frames on a pool thread, so the loop dispatches without
    waiting on per-frame fetches. The frame lines print up to ~8 frames
    late; the slow-BA-failure stop and the SAFETY guards below land the
    same few frames late: bounded, and the price of not blocking the
    dispatch loop on the host.

    Safety guards acted on per frame: nonzero
    fast/slow/reproject_obs_dropped (obs-window truncation: the solver
    silently lost participating rows) and normalize_canary_px > 0.1 (the
    reference's every-frame Normalize invariance CHECK, main.cpp:602-605)
    both stop the loop."""
    import json as _json

    import jax.numpy as jnp

    from slam_robot_tpu.io import sources
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import dump as dump_util
    from slam_robot_tpu.utils.fetchpool import FetchPool

    t_start = time.time()
    n_done = 0
    stop = False
    pool = FetchPool(workers=2)
    ring = jnp.zeros((8, pipeline.LIVE_WIDTH), jnp.float32)
    metas = []
    last_t0 = None
    last_status = {}
    ix = pipeline.LIVE_IDX

    def report(meta, v):
        nonlocal stop
        fid, cam, dt = meta
        if run_slam and v[ix["slow_ok"]] < 0.5:
            print("slow BA window failed; stopping (main.cpp:591-594)")
            stop = True
        drops = (int(v[ix["fast_obs_dropped"]])
                 + int(v[ix["slow_obs_dropped"]])
                 + int(v[ix["reproject_obs_dropped"]]))
        canary = float(v[ix["normalize_canary_px"]])
        if run_slam and drops > 0:
            print(f"frame {fid}: obs-window truncation dropped {drops} "
                  f"participating rows; stopping (silent-drop guard)")
            stop = True
        if run_slam and canary > 0.1:
            print(f"frame {fid}: normalize invariance canary "
                  f"{canary:.3f}px > 0.1; stopping (main.cpp:602-605)")
            stop = True
        last_status.update(
            frame=fid, cam=cam, matches=int(v[ix["n_matches"]]),
            keyframe=bool(v[ix["is_keyframe"]] > 0.5),
            points=int(v[ix["n_points"]]),
            err=round(float(v[ix["mean_reproj_err"]]), 3),
            ba_iters=f"{int(v[ix['fast_iters']])}+{int(v[ix['slow_iters']])}",
            obs_dropped=drops, canary_px=round(canary, 4),
        )
        if not args.quiet:
            print(
                f"frame {fid:4d} cam {cam}: "
                f"matches {int(v[ix['n_matches']]):3d} "
                f"{'KF' if v[ix['is_keyframe']] > 0.5 else '  '} "
                f"added {int(v[ix['n_added']]):3d} "
                f"pts {int(v[ix['n_points']]):4d} "
                f"err {float(v[ix['mean_reproj_err']]):6.3f} "
                f"ba {int(v[ix['fast_iters']])}+{int(v[ix['slow_iters']])} "
                f"TIMER: {dt:.3f}s"
            )

    for cam, fid, img in sources.prefetch(src):
        if (args.max_frames and fid >= args.max_frames) or stop:
            break
        t0 = time.time()
        if rec is not None:
            rec.save(fid, img)
        ps, ring = pipeline.step_live_ring(ps, ring, jnp.asarray(img), cfg,
                                           run_slam)
        ps = pipeline.maybe_polish(ps, fid, cfg, run_slam)
        n_done += 1
        dt = 0.0 if last_t0 is None else t0 - last_t0
        last_t0 = t0
        metas.append((fid, cam, dt))
        if len(metas) == 8:
            pool.submit(ring, metas)
            metas = []
        if (args.view_dir or view) and fid % max(args.view_every, 1) == 0:
            from slam_robot_tpu.utils.debug_draw import draw_debug

            # ps.map here is the NEW state — its buffers stay alive until
            # donated to the next dispatch; drawing fetches them to the
            # host, so it runs at --view-every cadence only
            overlay = draw_debug(ps.map, img)
            if args.view_dir:
                from PIL import Image

                Image.fromarray(overlay).save(
                    os.path.join(args.view_dir, f"frame_{fid:05d}.png")
                )
            if view:
                view.publish(overlay, last_status)
        for batch_meta, rows in pool.drain():
            for meta, v in zip(batch_meta, rows[-len(batch_meta):]):
                report(meta, v)
    if metas:
        pool.submit(ring, metas)  # tail group: last len(metas) ring rows
    for batch_meta, rows in pool.join():
        for meta, v in zip(batch_meta, rows[-len(batch_meta):]):
            report(meta, v)
    pool.close()

    wall = time.time() - t_start
    if rec is not None:
        rec.close()
    if args.dump:
        dump_util.dump_map(ps.map, args.dump)
    summary = {
        "frames": n_done,
        "wall_s": round(wall, 3),
        "fps": round(n_done / max(wall, 1e-9), 2),
        "iterations": int(ps.total_ba_iters),
        "error": float(ps.last_error),
        "n_points": int(ps.map.n_points),
        "n_obs": int(ps.map.n_obs),
    }
    print(_json.dumps(summary))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--load", default="", help="replay frames from directory")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="run N synthetic rendered frames")
    ap.add_argument("--video", nargs="+", default=None, metavar="FILE",
                    help="replay video file(s); two files form the fake "
                         "alternating-stereo rig (main.cpp:456-460)")
    ap.add_argument("--save", default="", help="record frames to directory")
    ap.add_argument("--dump", default="", help="write /tmp/z-style map dump")
    ap.add_argument("--no-slam", action="store_true", help="tracking only")
    ap.add_argument("--final-ba", action="store_true",
                    help="run one full bundle adjustment over all frames at "
                         "the end (collapses windowed-BA drift; measured "
                         "13.6mm -> 0.6mm ATE on the synthetic bench)")
    ap.add_argument("--platform", default="", help="force jax platform (cpu)")
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--live", action="store_true",
                    help="live robot loop mode: donated state buffers + "
                         "an in-step telemetry ring fetched every 8 "
                         "frames off the dispatch loop. Prints a reduced "
                         "frame line (up to 8 frames late); incompatible "
                         "with --debug-numerics / --patch-history")
    ap.add_argument("--debug-numerics", action="store_true",
                    help="run under checkify float guards (NaN/Inf/OOB; "
                         "the SURVEY §5 sanitizer analog) and fail fast")
    ap.add_argument("--patch-history", default="", metavar="DIR",
                    help="accumulate per-point patch histories (the "
                         "reference's hover inspector data, matcher.cpp:"
                         "260-265) and write strips for the most-tracked "
                         "points to DIR")
    ap.add_argument("--view-dir", default="", metavar="DIR",
                    help="write the DrawDebug overlay (main.cpp:609-638) to "
                         "DIR/frame_%%05d.png every --view-every frames — "
                         "the live-GUI observability analog")
    ap.add_argument("--view-every", type=int, default=5,
                    help="overlay dump cadence for --view-dir (default 5)")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="serve the DrawDebug overlay live at "
                         "http://HOST:PORT/ (MJPEG stream + status line) — "
                         "the reference's interactive GUI loop analog "
                         "(main.cpp:609-638) for a headless host; "
                         "works with and without --live")
    args = ap.parse_args(argv)

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import jax

    from slam_robot_tpu.utils import cachedir

    cachedir.configure(args.platform)
    dev = jax.devices()[0]
    print(f"running on {dev.platform} {dev.device_kind} "
          f"x{len(jax.devices())}", flush=True)
    import jax.numpy as jnp
    import numpy as np

    from slam_robot_tpu.config import SlamConfig
    from slam_robot_tpu.io import sources
    from slam_robot_tpu.io.recorder import Recorder
    from slam_robot_tpu.models import pipeline
    from slam_robot_tpu.utils import dump as dump_util

    cfg = SlamConfig(image_width=args.width, image_height=args.height)

    if args.load:
        src = sources.FileSource(args.load)
    elif args.video and len(args.video) >= 2:
        src = sources.DuoSource(sources.VideoSource(args.video[0]),
                                sources.VideoSource(args.video[1]))
    elif args.video:
        src = sources.VideoSource(args.video[0])
    elif args.synthetic:
        src = sources.SyntheticSource(cfg, n_frames=args.synthetic)
    else:
        print("need --load DIR, --video FILE [FILE] or --synthetic N",
              file=sys.stderr)
        return 1
    if not src.init():
        print(f"source init failed", file=sys.stderr)
        return 1

    rec = Recorder(args.save) if args.save else None
    phist = None
    if args.patch_history:
        from slam_robot_tpu.utils.patch_history import PatchHistory

        phist = PatchHistory(size=cfg.patch_size)

    ps = pipeline.init(cfg)
    run_slam = not args.no_slam

    if args.view_dir:
        os.makedirs(args.view_dir, exist_ok=True)

    view = None
    if args.serve:
        from slam_robot_tpu.utils.liveview import LiveView

        view = LiveView(port=args.serve).start()
        # per-point click inspector (main.cpp:158-267): needs the per-frame
        # match arrays, which only the full-metrics path fetches — under
        # --live the view streams overlay+status without it
        if not args.live:
            if phist is None:
                from slam_robot_tpu.utils.patch_history import PatchHistory

                phist = PatchHistory(size=cfg.patch_size)
            view.patch_history = phist
        print(f"live view: http://0.0.0.0:{view.port}/")

    # BA termination-reason short names (ops/ba.TERM_*), the per-solve
    # Ceres BriefReport analog (slam.cpp:510-518)
    term_names = {0: "-", 1: "ftol", 2: "xtol", 3: "stall", 4: "cap"}

    if args.live:
        if args.debug_numerics or args.patch_history:
            print("--live is incompatible with --debug-numerics/"
                  "--patch-history", file=sys.stderr)
            return 1
        return _live_loop(args, cfg, src, ps, run_slam, rec, view)

    t_start = time.time()
    n_done = 0
    for cam, fid, img in sources.prefetch(src):
        if args.max_frames and fid >= args.max_frames:
            break
        t0 = time.time()
        if rec is not None:
            rec.save(fid, img)
        if args.debug_numerics:
            err_chk, (ps, metrics) = pipeline.checked_step(
                ps, jnp.asarray(img), cfg, run_slam
            )
            err_chk.throw()
        else:
            ps, metrics = pipeline.step(ps, jnp.asarray(img), cfg, run_slam)
        ps = pipeline.maybe_polish(ps, fid, cfg, run_slam)
        live_points = None
        if phist is not None:
            phist.update(img, metrics["feat_point"], metrics["feat_px"],
                         metrics["feat_matched"])
            if view is not None:
                ids = np.asarray(metrics["feat_point"])
                pxs = np.asarray(metrics["feat_px"])
                sel = np.asarray(metrics["feat_matched"]) & (ids >= 0)
                live_points = list(zip(
                    ids[sel].tolist(),
                    pxs[sel, 0].tolist(), pxs[sel, 1].tolist(),
                ))
        metrics = {k: np.asarray(v).item() for k, v in metrics.items()
                   if np.asarray(v).ndim == 0}
        if (args.view_dir or view) and fid % max(args.view_every, 1) == 0:
            from slam_robot_tpu.utils.debug_draw import draw_debug

            overlay = draw_debug(ps.map, img)
            if args.view_dir:
                from PIL import Image

                Image.fromarray(overlay).save(
                    os.path.join(args.view_dir, f"frame_{fid:05d}.png")
                )
            if view:
                view.publish(overlay, {
                    "frame": fid, "cam": cam,
                    "matches": metrics["n_matches"],
                    "keyframe": bool(metrics["is_keyframe"]),
                    "points": metrics["n_points"],
                    "err": round(metrics["mean_reproj_err"], 3),
                }, points=live_points)
        dt = time.time() - t0
        n_done += 1
        if not args.quiet:
            # per-solve BriefReport analog: cost-before->after (reason)
            if run_slam:
                ba_rep = (
                    f"ba {metrics['fast_iters']}"
                    f"({term_names.get(metrics['fast_term'], '?')} "
                    f"{metrics['fast_cost0']:.1f}->{metrics['ba_cost']:.1f})"
                    f"+{metrics['slow_iters']}"
                    f"({term_names.get(metrics['slow_term'], '?')})"
                )
            else:
                ba_rep = "ba -"
            print(
                f"frame {fid:4d} cam {cam}: matches {metrics['n_matches']:3d} "
                f"{'KF' if metrics['is_keyframe'] else '  '} "
                f"added {metrics['n_added']:3d} pts {metrics['n_points']:4d} "
                f"err {metrics['mean_reproj_err']:6.3f} "
                f"{ba_rep} "
                f"drift {metrics['normalize_err_drift']:.4f} "
                f"TIMER: {dt:.3f}s"
            )
        if run_slam and not metrics["slow_ok"]:
            print("slow BA window failed; stopping (main.cpp:591-594)")
            break

    wall = time.time() - t_start
    if rec is not None:
        rec.close()

    if args.final_ba and run_slam:
        from slam_robot_tpu.models import localmap as lm
        from slam_robot_tpu.models import slam as slam_mod

        m, res = slam_mod.solve_all_frames(ps.map, cfg.ba_range, cfg=cfg)
        m = lm.normalize(m)
        m, final_err = lm.reproject(m)
        ps = ps._replace(map=m)
        print(f"final full BA: {int(res.iters)} iters, "
              f"mean reproj err {float(final_err):.3f}px")

    if args.dump:
        dump_util.dump_map(ps.map, args.dump)

    if phist is not None and args.patch_history:
        os.makedirs(args.patch_history, exist_ok=True)
        from PIL import Image

        for pid in phist.top_ids(8):
            strip = phist.strip(pid)
            if strip is None:
                continue
            u8 = np.clip(strip * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(u8).save(
                os.path.join(args.patch_history, f"point_{pid:04d}.png")
            )
        print(f"patch histories: {len(phist.hist)} points -> "
              f"{args.patch_history}")

    summary = {
        "frames": n_done,
        "wall_s": round(wall, 3),
        "fps": round(n_done / max(wall, 1e-9), 2),
        "iterations": int(ps.total_ba_iters),
        "error": float(ps.last_error),
        "n_points": int(ps.map.n_points),
        "n_obs": int(ps.map.n_obs),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
