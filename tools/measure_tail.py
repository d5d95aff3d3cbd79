#!/usr/bin/env python
"""One traced 10M compress pass: stage walls + engine stats, for
codec-tail overlap measurements. Reuses the bench
dataset if present; prints one JSON line with the stage dict."""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("MALLOC_MMAP_THRESHOLD_") is None and os.name == "posix":
    os.environ["MALLOC_MMAP_THRESHOLD_"] = str(1 << 30)
    os.environ["MALLOC_TRIM_THRESHOLD_"] = str(1 << 30)
    os.execv(sys.executable, [sys.executable] + sys.argv)

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
PASSES = int(sys.argv[2]) if len(sys.argv) > 2 else 2


def main():
    from spring_tpu import api
    from spring_tpu.pipeline import short_mode
    from spring_tpu.reorder import engine as eng
    from spring_tpu.utils import synth

    fq = f"/tmp/bench_{N}.fastq"
    if not os.path.exists(fq):
        synth.make_se(fq, N, read_len=100,
                      genome_size=max(2_000_000, N * 100 // 50), seed=42)
    arc = fq + ".stpu"
    opts = api.CompressOptions(num_threads=os.cpu_count() or 8,
                               verbose=False)
    best, stages, engines = float("inf"), {}, {}
    for i in range(PASSES):
        t0 = time.time()
        api.compress([fq], arc, opts)
        t = time.time() - t0
        print(f"pass {i}: {t:.2f}s", file=sys.stderr, flush=True)
        if t < best:
            best = t
            stages = dict(short_mode.LAST_STAGE_SECONDS)
            engines = dict(eng.LAST_RUN_STATS)
    print(json.dumps({"n": N, "best_s": round(best, 2),
                      "reads_per_s": round(N / best, 1),
                      "stage_s": stages, "engine": engines}))


main()
