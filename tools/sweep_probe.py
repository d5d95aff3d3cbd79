#!/usr/bin/env python
"""On-device probe-config sweep at the 10M bench shape.

Usage: python tools/sweep_probe.py <fastq> [config ...]
Configs are NAME=ENV:VAL[,ENV:VAL...] pairs, e.g.
  base=  fardict=SPRING_TPU_FARDICT:4  sc8=SPRING_TPU_SC:8
Each config: best-of-2 warm compress walls + archive bytes + engine
stats; one JSON line per config on stdout, logs on stderr.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    fq = sys.argv[1]
    configs = []
    for spec in sys.argv[2:]:
        name, _, envs = spec.partition("=")
        env = {}
        if envs:
            for kv in envs.split(","):
                k, _, v = kv.partition(":")
                env[k] = v
        configs.append((name, env))
    from spring_tpu import api
    from spring_tpu.pipeline import short_mode
    from spring_tpu.reorder import engine as eng

    KEYS = ("SPRING_TPU_FARDICT", "SPRING_TPU_SC", "SPRING_TPU_SLOTS",
            "SPRING_TPU_WALKERS")
    opts = api.CompressOptions(num_threads=os.cpu_count() or 8,
                               verbose=False)
    arc = fq + ".sweep.stpu"
    for name, env in configs:
        for k in KEYS:
            os.environ.pop(k, None)
        os.environ.update(env)
        best, stages, engs = float("inf"), {}, {}
        for i in range(3):
            t0 = time.time()
            api.compress([fq], arc, opts)
            dt = time.time() - t0
            log(f"[{name}] pass {i}: {dt:.2f}s")
            if i and dt < best:       # pass 0 pays compiles
                best = dt
                stages = dict(short_mode.LAST_STAGE_SECONDS)
                engs = dict(eng.LAST_RUN_STATS)
        print(json.dumps({"config": name, "env": env,
                          "best_s": round(best, 2),
                          "archive_bytes": os.path.getsize(arc),
                          "engine": engs, "stage_s": stages}), flush=True)
    os.unlink(arc)


if __name__ == "__main__":
    main()
