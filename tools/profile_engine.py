#!/usr/bin/env python
"""Capture a jax.profiler device trace of reorder flushes on the device.

Usage: python tools/profile_engine.py [n_reads] [out_dir]
Prints the top ops by self time from the captured trace.
"""
import glob
import gzip
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    out = sys.argv[2] if len(sys.argv) > 2 else "/tmp/stpu_profile"
    from spring_tpu.utils import synth
    import tempfile
    import jax

    from spring_tpu.io import fastq_native
    from spring_tpu.reorder import engine as eng

    fq = os.path.join(tempfile.mkdtemp(), "p.fastq")
    synth.make_se(fq, n)
    arrs = fastq_native.load_file(fq, want_quals=False)
    codes = arrs.codes
    lengths = arrs.lengths
    packed = fastq_native.pack_2bit(codes, 4)
    t0 = time.time()
    e = eng.ReorderEngine(packed, lengths,
                          eng.ReorderConfig(max_readlen=100), codes=codes)
    print(f"engine built {time.time() - t0:.1f}s; B={e.B} Np={e.Np}")

    state = e._init_state()
    rows_tab = state.pop("rows")
    dkeys = eng.jnp.concatenate([d.btab for d in e.dicts], axis=0)
    drids = eng.dct.pairs_from_rids_stacked(
        eng.jnp.concatenate([d.rids for d in e.dicts]), len(e.dicts))
    stride = max(e.N // e.B, 1)
    idx = np.arange(e.N, dtype=np.int32)
    so = np.concatenate([idx[r::stride] for r in range(stride)])
    so = np.concatenate([so, np.full(e.Np - len(so), e.Np - 1, np.int32)])
    import jax.numpy as jnp
    seed_order = jnp.asarray(so.astype(np.int32))
    args = (e.lengths, dkeys, drids, seed_order,
            jnp.asarray(e.N, jnp.int32),
            jnp.asarray(e.cfg.max_shift, jnp.int32), rows_tab)

    t0 = time.time()
    state, dense, cnt, stats = e._round_fn(state, *args)   # compile + run
    jax.block_until_ready(dense)
    print(f"first flush (incl compile) {time.time() - t0:.1f}s")
    t0 = time.time()
    with jax.profiler.trace(out):
        state, dense, cnt, stats = e._round_fn(state, *args)
        jax.block_until_ready(dense)
    dt = time.time() - t0
    print(f"profiled flush {dt:.2f}s ({1000 * dt / eng.FLUSH_ROUNDS:.1f} ms/round)")

    traces = glob.glob(os.path.join(out, "**", "*.trace.json.gz"),
                       recursive=True)
    if not traces:
        print("no trace file found")
        return
    tf = max(traces, key=os.path.getmtime)
    with gzip.open(tf, "rt") as f:
        data = json.load(f)
    tot = {}
    for ev in data.get("traceEvents", []):
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "?")
            pid = ev.get("pid", 0)
            tot[name] = tot.get(name, 0) + ev["dur"]
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:40]
    print(f"--- top ops by total duration ({tf}) ---")
    for name, dur in top:
        print(f"{dur / 1e3:10.1f} ms  {name[:120]}")


if __name__ == "__main__":
    main()
