#!/usr/bin/env python
"""Aggregate a jax.profiler chrome trace (trace.json.gz) into per-op totals.

Usage: python tools/parse_trace.py /tmp/mpctrace [--top 40] [--by op|category]

Finds the newest plugins/profile/*/ run directory, loads the trace, keeps
device-track complete events, and prints total/self time per op name so the
hot ops of the controller step are obvious.
"""

import argparse
import collections
import glob
import gzip
import json
import os
import re
import sys


def find_trace(root):
    cands = sorted(
        glob.glob(os.path.join(root, "plugins", "profile", "*", "*.trace.json.gz"))
        + glob.glob(os.path.join(root, "*.trace.json.gz")),
        key=os.path.getmtime,
    )
    if not cands:
        sys.exit(f"no trace.json.gz under {root}")
    return cands[-1]


def base_name(name):
    """Strip SSA suffixes: 'fusion.123' -> 'fusion', 'while.body/...' kept."""
    return re.sub(r"\.\d+$", "", name)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--raw", action="store_true", help="don't strip numeric suffixes")
    ap.add_argument(
        "--self",
        dest="self_time",
        action="store_true",
        help="nest-aware SELF time: per device track, subtract each event's "
        "enclosed children so containers (while/body/vmap wrappers) stop "
        "double-counting their contents",
    )
    args = ap.parse_args()

    path = find_trace(args.root)
    print(f"trace: {path}", file=sys.stderr)
    with gzip.open(path, "rt") as f:
        data = json.load(f)

    events = data["traceEvents"]
    # Identify device pids (process names naming a device or XLA)
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    device_pids = {p for p, n in pid_names.items() if re.search(r"GPU|/device|XLA", n, re.I)}
    if not device_pids:
        device_pids = set(pid_names)  # fall back to everything

    tot = collections.Counter()
    cnt = collections.Counter()
    wall = 0.0
    if args.self_time:
        # Group complete events per (pid, tid) track; a chrome trace nests
        # strictly within a track, so sorting by (start asc, dur desc) and
        # keeping an enclosing-interval stack yields each event's direct
        # parent. Self time = dur - sum(direct children durs).
        tracks = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or e.get("pid") not in device_pids:
                continue
            tracks[(e["pid"], e.get("tid"))].append(e)
        for evs in tracks.values():
            evs.sort(key=lambda e: (e.get("ts", 0), -e.get("dur", 0)))
            stack = []  # (end_ts, event, child_total)
            for e in evs:
                ts, dur = e.get("ts", 0), e.get("dur", 0)
                while stack and ts >= stack[-1][0] - 1e-9:
                    end, ev, child = stack.pop()
                    name = ev.get("name", "?")
                    if not args.raw:
                        name = base_name(name)
                    self_us = max(ev.get("dur", 0) - child, 0)
                    tot[name] += self_us
                    cnt[name] += 1
                    wall += self_us
                    if stack:
                        stack[-1][2] += ev.get("dur", 0)
                stack.append([ts + dur, e, 0.0])
            while stack:
                end, ev, child = stack.pop()
                name = ev.get("name", "?")
                if not args.raw:
                    name = base_name(name)
                self_us = max(ev.get("dur", 0) - child, 0)
                tot[name] += self_us
                cnt[name] += 1
                wall += self_us
                if stack:
                    stack[-1][2] += ev.get("dur", 0)
    else:
        for e in events:
            if e.get("ph") != "X" or e.get("pid") not in device_pids:
                continue
            name = e.get("name", "?")
            if not args.raw:
                name = base_name(name)
            dur = e.get("dur", 0)
            tot[name] += dur
            cnt[name] += 1
            wall += dur

    print(f"{'total_ms':>10} {'%':>6} {'count':>8}  op")
    for name, t in tot.most_common(args.top):
        print(f"{t/1e3:10.2f} {100.0*t/max(wall,1):6.2f} {cnt[name]:8d}  {name[:110]}")
    print(f"{wall/1e3:10.2f} {'100.0':>6}           TOTAL (sum of device events)")


if __name__ == "__main__":
    main()
