"""Re-parse an existing /tmp/jaxtrace xplane into detailed op rows
(occurrences, op text, source info) without touching the device.

    python tools/trace_detail.py [--match fusion.7] [--top 30]
"""

from __future__ import annotations

import argparse
import glob
import json
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--match", default="")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--frames", type=int, default=64)
    args = ap.parse_args()

    planes = glob.glob("/tmp/jaxtrace/**/*.xplane.pb", recursive=True)
    if not planes:
        sys.exit("no xplane found")

    from xprof.convert import raw_to_tool_data as rtd

    params = {"tqx": "out:json;", "use_saved_result": False}
    data, _ = rtd.xspace_to_tool_data(planes, "hlo_stats", params)
    if isinstance(data, bytes):
        data = data.decode()
    obj = json.loads(data)
    cols = [c["label"] for c in obj["cols"]]
    rows = [[c["v"] if c else None for c in r["c"]] for r in obj["rows"]]

    def col(label):
        for i, c in enumerate(cols):
            if label.lower() == c.lower():
                return i
        for i, c in enumerate(cols):
            if label.lower() in c.lower():
                return i
        return None

    i_cat = col("HLO op category")
    i_name = col("HLO op name")
    i_text = col("HLO op text")
    i_occ = col("#Occurrences")
    i_self = col("Total self time (us)")
    i_src = col("Source Info")
    i_bound = col("Bound by")

    rows.sort(key=lambda r: -(r[i_self] or 0.0))
    n = 0
    for r in rows:
        if args.match and args.match not in str(r[i_name]):
            continue
        n += 1
        if n > args.top:
            break
        us = r[i_self] or 0.0
        occ = r[i_occ]
        print(f"== {r[i_name]}  [{r[i_cat]}]  {us/args.frames:.1f} us/frame  "
              f"occ={occ}  bound={r[i_bound] if i_bound else '?'}")
        txt = str(r[i_text])
        print("   ", txt[:600].replace("\n", "\n    "))
        if i_src is not None and r[i_src]:
            print("    src:", str(r[i_src])[:300])
        print()


if __name__ == "__main__":
    main()
