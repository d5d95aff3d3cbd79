#!/usr/bin/env python
"""A/B benchmark: spring_tpu vs the reference SPRING binary on identical input.

Builds the reference out-of-source via tools/refbuild (boost shimmed with
std::filesystem + zlib), generates synthetic SE and PE datasets, runs both
tools in the same modes, and writes a comparison report (AB_REPORT.md):
wall times, total archive size, and per-stream (reads/quality/id) sizes.

Usage: python bench_ab.py [--reads N] [--modes se,pe,se-r,pe-r] [--quick]
"""
import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REF_BIN = os.environ.get("SPRING_REF_BIN", "/tmp/spring_ref_build/spring")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def ensure_ref_binary() -> str:
    if not os.path.exists(REF_BIN):
        log("building reference binary ...")
        subprocess.run(["make", "-j16", f"BUILD={os.path.dirname(REF_BIN)}"],
                       cwd=os.path.join(REPO, "tools", "refbuild"), check=True,
                       capture_output=True)
    return REF_BIN


def run_reference(infiles, outfile, workdir, reorder=False, threads=8,
                  long_mode=False):
    cmd = [ensure_ref_binary(), "-c", "-i", *infiles, "-o", outfile,
           "-w", workdir, "-t", str(threads)]
    if reorder:
        cmd.append("-r")
    if long_mode:
        cmd.append("-l")
    t0 = time.time()
    p = subprocess.run(cmd, capture_output=True, text=True, check=True)
    dt = time.time() - t0
    streams = {}
    for name, pat in [("reads", r"Reads:\s+(\d+) bytes"),
                      ("quality", r"Quality:\s+(\d+) bytes"),
                      ("id", r"ID:\s+(\d+) bytes")]:
        m = re.search(pat, p.stdout)
        streams[name] = int(m.group(1)) if m else 0
    # decompress timing + verification
    outs = [os.path.join(workdir, f"ref_out_{i}.fastq")
            for i in range(len(infiles))]
    t1 = time.time()
    subprocess.run([REF_BIN, "-d", "-i", outfile, "-o", *outs, "-w", workdir,
                    "-t", str(threads)], capture_output=True, check=True)
    ddt = time.time() - t1
    ok = verify(infiles, outs, order_insensitive=reorder)
    return {"time_c": dt, "time_d": ddt, "size": os.path.getsize(outfile),
            "streams": streams, "roundtrip_ok": ok}


def run_ours(infiles, outfile, reorder=False, threads=8,
             long_mode=False, warm=True):
    from spring_tpu import api
    from spring_tpu.io.container import ArchiveReader
    opts = api.CompressOptions(num_threads=threads, verbose=False,
                               reorder=reorder, long_mode=long_mode)
    if warm:
        # warm-up (compile) pass, then the timed pass
        api.compress(list(infiles), outfile, opts)
    t0 = time.time()
    api.compress(list(infiles), outfile, opts)
    dt = time.time() - t0
    with ArchiveReader(outfile) as r:
        sizes = r.size_by_prefix()
    streams = {
        "reads": sum(v for k, v in sizes.items()
                     if k in ("pos", "seq", "npos", "literal", "nn", "nchar",
                              "rc", "flag", "rlen", "order", "pair",
                              "read1", "read2", "rlen1", "rlen2")),
        "quality": sum(v for k, v in sizes.items()
                       if k.startswith("quality")),
        "id": sum(v for k, v in sizes.items() if k.startswith("id")),
    }
    outs = [outfile + f".out_{i}.fastq" for i in range(len(infiles))]
    t1 = time.time()
    api.decompress(outfile, outs, verbose=False, num_threads=threads)
    ddt = time.time() - t1
    ok = verify(infiles, outs, order_insensitive=reorder)
    return {"time_c": dt, "time_d": ddt, "size": os.path.getsize(outfile),
            "streams": streams, "roundtrip_ok": ok, "all_streams": sizes}


def verify(orig, outs, order_insensitive=False):
    import filecmp
    if not order_insensitive:
        return all(filecmp.cmp(a, b, shallow=False)
                   for a, b in zip(orig, outs))
    # multiset equality of complete records
    def recset(paths):
        recs = []
        for p in paths:
            with open(p, "rb") as f:
                lines = f.read().split(b"\n")
            recs += [tuple(lines[i:i + 4])
                     for i in range(0, len(lines) - 3, 4)]
        return sorted(recs)
    return recset(orig) == recset(outs)


# Robustness grid (VERDICT r2 #4): one-factor-at-a-time from the base
# profile plus a combined stress cell — the available substitute for the
# reference's human-scale variable-profile benchmark data (no network).
# Each profile is (name, n_reads, synth kwargs, modes).
GRID_PROFILES = [
    ("cov5", 100_000, {}, "se,pe,se-r,pe-r"),
    ("cov50", 1_000_000, {}, "se,pe,se-r,pe-r"),
    ("genome100M", 2_000_000, {"genome_size": 100_000_000}, "se,se-r"),
    ("varlen", 500_000, {"len_range": (36, 151)}, "se,pe,se-r,pe-r"),
    ("qual40", 500_000, {"qual_levels": 40}, "se,pe,se-r,pe-r"),
    ("n0.1%", 500_000, {"n_rate": 0.001}, "se,pe,se-r,pe-r"),
    ("sra_perm", 500_000, {"id_style": "sra_perm"}, "se,pe,se-r,pe-r"),
    ("stress", 250_000, {"len_range": (36, 151), "qual_levels": 40,
                         "n_rate": 0.001, "id_style": "sra_perm",
                         "genome_size": 10_000_000}, "se,pe,se-r,pe-r"),
]


def run_grid(threads: int, report: str, only: str | None = None) -> None:
    from spring_tpu.utils import synth
    rows = []
    for name, n, kw, modes in GRID_PROFILES:
        if only and name not in only.split(","):
            continue
        tmp = tempfile.mkdtemp(prefix=f"spring_grid_{name.replace('%','')}_")
        modes = modes.split(",")
        datasets = {}
        if any(m.startswith("se") for m in modes):
            se = os.path.join(tmp, "se.fastq")
            log(f"[{name}] generating SE ({n} reads) ...")
            synth.make_se(se, n, **kw)
            datasets["se"] = [se]
        if any(m.startswith("pe") for m in modes):
            p1 = os.path.join(tmp, "pe_1.fastq")
            p2 = os.path.join(tmp, "pe_2.fastq")
            log(f"[{name}] generating PE ({n // 2} pairs) ...")
            synth.make_pe(p1, p2, n // 2, **kw)
            datasets["pe"] = [p1, p2]
        for mode in modes:
            base = mode.split("-")[0]
            reorder = mode.endswith("-r")
            infiles = datasets[base]
            wd = os.path.join(tmp, f"ref_{mode}")
            os.makedirs(wd, exist_ok=True)
            try:
                ref = run_reference(infiles, os.path.join(wd, "a.spring"),
                                    wd, reorder=reorder, threads=threads)
            except subprocess.CalledProcessError as e:
                log(f"[{name}/{mode}] reference FAILED: "
                    f"{(e.stderr or '')[-200:]}")
                ref = None
            try:
                # warm=True: the first pass pays per-shape XLA compiles;
                # the timed pass is what a warmed process measures (cold
                # cells would fold warm-up into the grid's time columns).
                ours = run_ours(infiles, os.path.join(tmp, f"o_{mode}.stpu"),
                                reorder=reorder, threads=threads, warm=True)
            except Exception as e:
                log(f"[{name}/{mode}] OURS FAILED: {type(e).__name__}: "
                    f"{str(e)[:300]}")
                ours = None
            cell = {"profile": name, "mode": mode, "n": n,
                    "ref": ref, "ours": ours}
            rows.append(cell)
            if ours:
                r = (f"{ours['size'] / ref['size']:.3f}x" if ref
                     else "ref-fail")
                log(f"[{name}/{mode}] size ratio ours/ref: {r} "
                    f"(ok={ours['roundtrip_ok']}"
                    + (f", ref_ok={ref['roundtrip_ok']})" if ref else ")"))
            # free the per-mode outputs early; keep datasets for other modes
            for f in os.listdir(tmp):
                if f.startswith(("o_", "ref_")) and f.endswith(".fastq"):
                    os.unlink(os.path.join(tmp, f))
        shutil.rmtree(tmp, ignore_errors=True)
        _write_grid_report(rows, report)   # incremental: crash loses nothing
    bad = [c for c in rows
           if not c["ours"] or not c["ours"]["roundtrip_ok"]]
    print(json.dumps({"grid_cells": len(rows), "roundtrip_failures":
                      [f"{c['profile']}/{c['mode']}" for c in bad]}))


def _write_grid_report(rows, report: str) -> None:
    lines = ["", "## Robustness grid (synthetic profile matrix)", "",
             "One-factor-at-a-time from the base profile (2 Mbp genome, "
             "fixed 100 bp, 8-level qualities, 0 N, affine ids) plus a "
             "combined stress cell. Size = total archive bytes, "
             "ratio = ours/reference on identical input; both tools "
             "round-trip verified per cell.", "",
             "Time columns are warmed (compile paid in an untimed "
             "pass); ref times on the same shared host.", "",
             "| profile | mode | reads | ref B | ours B | size ratio | "
             "quality ratio | id ratio | ours c/d (s) | ref c/d (s) | "
             "round-trip |",
             "|---|---|---|---|---|---|---|---|---|---|---|"]
    for c in rows:
        o, r = c["ours"], c["ref"]
        if not o:
            lines.append(f"| {c['profile']} | {c['mode']} | {c['n']} "
                         f"| {r['size'] if r else 'ref FAIL'} | OURS FAIL "
                         f"| — | — | — | — | — | FAIL |")
            continue
        ok = "ok" if o["roundtrip_ok"] and (not r or r["roundtrip_ok"]) \
            else "FAIL"
        if r:
            qr = o["streams"]["quality"] / max(r["streams"]["quality"], 1)
            ir = o["streams"]["id"] / max(r["streams"]["id"], 1)
            lines.append(
                f"| {c['profile']} | {c['mode']} | {c['n']} | {r['size']} "
                f"| {o['size']} | {o['size'] / r['size']:.3f}x "
                f"| {qr:.3f}x | {ir:.3f}x "
                f"| {o['time_c']:.1f}/{o['time_d']:.1f} "
                f"| {r['time_c']:.1f}/{r['time_d']:.1f} | {ok} |")
        else:
            lines.append(
                f"| {c['profile']} | {c['mode']} | {c['n']} | ref FAIL "
                f"| {o['size']} | — | — | — "
                f"| {o['time_c']:.1f}/{o['time_d']:.1f} | — | {ok} |")
    grid_md = "\n".join(lines) + "\n"
    txt = ""
    if os.path.exists(report):
        txt = open(report).read()
        if "## Robustness grid" in txt:
            txt = txt[:txt.index("## Robustness grid")].rstrip() + "\n"
    with open(report, "w") as f:
        f.write(txt + grid_md)
    log(f"grid -> {report}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int,
                    default=int(os.environ.get("AB_READS", 1_000_000)))
    ap.add_argument("--modes", default="se,pe,se-r,pe-r")
    ap.add_argument("--threads", type=int, default=os.cpu_count() or 8)
    ap.add_argument("--report", default=os.path.join(REPO, "AB_REPORT.md"))
    ap.add_argument("--grid", action="store_true",
                    help="run the robustness profile matrix instead")
    ap.add_argument("--profiles", default=None,
                    help="comma-separated grid profile names to run")
    args = ap.parse_args()
    if args.grid:
        run_grid(args.threads, args.report, args.profiles)
        return

    from spring_tpu.utils import synth
    tmp = tempfile.mkdtemp(prefix="spring_ab_")
    n = args.reads
    rows = []
    datasets = {}
    if any(m.startswith("se") for m in args.modes.split(",")):
        se = os.path.join(tmp, "se.fastq")
        log(f"generating SE dataset ({n} reads) ...")
        synth.make_se(se, n)
        datasets["se"] = [se]
    if any(m.startswith("pe") for m in args.modes.split(",")):
        pe1, pe2 = os.path.join(tmp, "pe_1.fastq"), os.path.join(tmp, "pe_2.fastq")
        log(f"generating PE dataset ({n // 2} pairs) ...")
        synth.make_pe(pe1, pe2, n // 2)
        datasets["pe"] = [pe1, pe2]

    for mode in args.modes.split(","):
        base = mode.split("-")[0]
        reorder = mode.endswith("-r")
        long_mode = mode.endswith("-l")
        infiles = datasets[base]
        nbases = n * 100
        log(f"--- mode {mode}: reference ---")
        wd = os.path.join(tmp, f"ref_{mode}")
        os.makedirs(wd, exist_ok=True)
        ref = run_reference(infiles, os.path.join(wd, "a.spring"), wd,
                            reorder=reorder, threads=args.threads,
                            long_mode=long_mode)
        log(f"    ref: {ref['time_c']:.1f}s c / {ref['time_d']:.1f}s d, "
            f"{ref['size']} B, ok={ref['roundtrip_ok']}")
        log(f"--- mode {mode}: spring_tpu ---")
        ours = run_ours(infiles, os.path.join(tmp, f"ours_{mode}.stpu"),
                        reorder=reorder, threads=args.threads,
                        long_mode=long_mode)
        log(f"    ours: {ours['time_c']:.1f}s c / {ours['time_d']:.1f}s d, "
            f"{ours['size']} B, ok={ours['roundtrip_ok']}")
        rows.append((mode, ref, ours, nbases))

    lines = ["# A/B report: spring_tpu vs reference SPRING",
             "",
             f"Synthetic data ({n} reads x 100 bp, 2 Mbp genome, 1% err, "
             f"{args.threads} threads). Reference built from /root/reference "
             "via tools/refbuild.", "",
             "| mode | tool | c time (s) | d time (s) | total B | reads B | "
             "quality B | id B | reads bits/base | round-trip |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for mode, ref, ours, nbases in rows:
        for tool, r in (("reference", ref), ("spring_tpu", ours)):
            s = r["streams"]
            lines.append(
                f"| {mode} | {tool} | {r['time_c']:.1f} | {r['time_d']:.1f} "
                f"| {r['size']} | {s['reads']} | {s['quality']} | {s['id']} "
                f"| {s['reads'] * 8 / nbases:.3f} "
                f"| {'ok' if r['roundtrip_ok'] else 'FAIL'} |")
        ref_t, our_t = ref["time_c"], ours["time_c"]
        lines.append(
            f"| {mode} | *ratio ours/ref* | {our_t / ref_t:.2f}x | "
            f"{ours['time_d'] / max(ref['time_d'], 1e-9):.2f}x | "
            f"{ours['size'] / ref['size']:.3f}x | "
            f"{ours['streams']['reads'] / max(ref['streams']['reads'], 1):.3f}x | "
            f"{ours['streams']['quality'] / max(ref['streams']['quality'], 1):.3f}x "
            f"| | | |")
    with open(args.report, "w") as f:
        f.write("\n".join(lines) + "\n")
    log(f"report -> {args.report}")
    print(json.dumps({"modes": [r[0] for r in rows]}))


if __name__ == "__main__":
    main()
