#!/usr/bin/env python
"""Capture a jax.profiler trace of ONE WARM full-pipeline compress pass.

Usage: python tools/profile_pipeline.py <fastq> [out_dir]
Runs two un-traced warm-up passes (compiles), then traces the third and
prints total device time vs wall plus the top device ops — the
device-vs-host split the stage marks can't show.
"""
import glob
import gzip
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    fq = sys.argv[1]
    out = sys.argv[2] if len(sys.argv) > 2 else "/tmp/stpu_pipe_profile"
    import jax
    from spring_tpu import api
    opts = api.CompressOptions(num_threads=os.cpu_count() or 8,
                               verbose=False)
    arc = fq + ".prof.stpu"
    for i in range(2):
        t0 = time.time()
        api.compress([fq], arc, opts)
        print(f"warm pass {i}: {time.time() - t0:.2f}s", flush=True)
    t0 = time.time()
    with jax.profiler.trace(out, create_perfetto_trace=True):
        api.compress([fq], arc, opts)
    wall = time.time() - t0
    print(f"traced pass: {wall:.2f}s", flush=True)
    os.unlink(arc)

    traces = glob.glob(os.path.join(out, "**", "perfetto_trace.json.gz"),
                       recursive=True)
    if not traces:
        print("no trace file found")
        return
    tf = max(traces, key=os.path.getmtime)
    with gzip.open(tf, "rt") as f:
        data = json.load(f)
    # split events by process name: device planes ("/device:GPU:0", ...)
    # vs host threads ("/host:CPU")
    pids = {}
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            pids[ev["pid"]] = ev.get("args", {}).get("name", "?")
    tot = {}
    dev_total = 0.0
    spans = []
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev:
            pname = pids.get(ev.get("pid", 0), "?")
            if pname.lower().startswith("/device:"):
                name = ev.get("name", "?")
                tot[name] = tot.get(name, 0) + ev["dur"]
                spans.append((ev["ts"], ev["dur"]))
    # device busy time = union of spans (ops can nest/overlap)
    spans.sort()
    busy = 0.0
    end = -1
    for ts, dur in spans:
        s, e = ts, ts + dur
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    print(f"--- device busy {busy / 1e6:.2f}s of {wall:.2f}s wall "
          f"({100 * busy / 1e6 / wall:.0f}%) [{tf}]")
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:30]
    for name, dur in top:
        print(f"{dur / 1e3:10.1f} ms  {name[:110]}")


if __name__ == "__main__":
    main()
