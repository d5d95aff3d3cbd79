#!/usr/bin/env python3
"""GPU smoke run: compress and decompress end to end on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py                 # phases main, modes, parity
    python3 chip_smoke.py --four-cards    # sharded engine on a 4-GPU mesh

Phases (every check is exact; any failure exits non-zero):

  main    SRR554369-shaped paired-end input (2 x 1,657,871 reads of 100 bp,
          ~50x coverage) through api.compress twice (cold, then warm): both
          archives identical, decompressed files equal the inputs; then -r,
          where the pair multiset must survive; then --decompress-range on
          mid-archive blocks of both files.
  modes   every other user path through the device on 100,000 seeded reads
          with N bases: SE lossless and -r, the three lossy quality modes
          against their tables, --no-ids --no-quality, FASTA, gzip in and
          out, long mode, SE range decode of a mid-archive block, and the
          sharded engine (SPRING_TPU_DIST=1) on a one-card mesh.
  parity  the archives of two pinned seeded inputs must hash to the same
          SHA-256 as on the CPU (spring_tpu/utils/parity.py): the device
          path is integer-only, so any difference is a bug.

--four-cards runs only the sharded engine over four GPUs on the main input
and compares it with the default engine on card 0.

One process drives every card it uses and starts no other JAX process.
The card's name and power limit are printed first; the last line is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import filecmp
import gzip
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

MAIN_PAIRS = 1_657_871          # SRR554369: 3,315,742 reads (BASELINE.md)
MAIN_SEED = 554369
MODES_READS = 100_000
RANGE_SE_READS = 600_000        # > 2 blocks of 256k reads: a middle block


def log(*a) -> None:
    print(*a, flush=True)


class CheckFailed(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)
    log(f"  ok: {what}")


# ---------------- device ----------------

def require_gpu(n_cards: int):
    """Fail unless JAX's default backend is CUDA with >= n_cards devices.
    Returns the devices; prints the card line, device kind and JAX
    version before any work."""
    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"chip_smoke: JAX found no GPU (default backend is "
                         f"{backend!r}); this run needs a CUDA device")
    try:
        devs = jax.devices("cuda")
    except RuntimeError as e:
        raise SystemExit(f"chip_smoke: the GPU backend is not CUDA ({e})")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: needs {n_cards} CUDA devices, JAX "
                         f"sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip() or smi.stderr.strip()}")
    log(f"device_kind: {devs[0].device_kind}  devices: {len(devs)}  "
        f"jax {jax.__version__}")
    return devs


def peak_bytes(dev) -> int | None:
    stats = dev.memory_stats()
    return None if stats is None else int(stats.get("peak_bytes_in_use", 0))


# ---------------- file helpers ----------------

def records(path: str, n_lines: int = 4) -> list[bytes]:
    """The records of a FASTQ (or n_lines=2: FASTA) file, each as the
    joined bytes of its lines."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    if lines and lines[-1] == b"":
        lines.pop()
    return [b"\n".join(lines[i:i + n_lines])
            for i in range(0, len(lines), n_lines)]


def fields(path: str) -> tuple[list[bytes], list[bytes], list[bytes]]:
    """(ids, reads, qualities) of a FASTQ file."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return lines[0::4][:len(lines) // 4], lines[1::4][:len(lines) // 4], \
        lines[3::4][:len(lines) // 4]


def fastq_to_fasta(src: str, dst: str) -> None:
    ids, reads, _ = fields(src)
    with open(dst, "wb") as f:
        f.write(b"".join(b">" + i[1:] + b"\n" + r + b"\n"
                         for i, r in zip(ids, reads)))


def same_file(a: str, b: str) -> bool:
    return filecmp.cmp(a, b, shallow=False)


# ---------------- runs ----------------

def compress(files, arc, label: str, **opt) -> dict:
    """api.compress with the per-run findings printed (wall, stage and
    engine stats, archive bytes, peak device memory so far)."""
    import jax

    from spring_tpu import api
    from spring_tpu.pipeline import short_mode
    from spring_tpu.reorder import engine as eng
    opts = api.CompressOptions(num_threads=os.cpu_count() or 8,
                               verbose=False, **opt)
    t0 = time.time()
    api.compress(files, arc, opts)
    wall = time.time() - t0
    out = {"wall_s": wall, "bytes": os.path.getsize(arc),
           "stage_s": dict(short_mode.LAST_STAGE_SECONDS),
           "engine": dict(eng.LAST_RUN_STATS),
           "peak_bytes_in_use": peak_bytes(jax.devices()[0])}
    log(f"[{label}] compress {json.dumps(out)}")
    return out


def decompress(arc, outs, label: str, **kw) -> float:
    from spring_tpu import api
    t0 = time.time()
    api.decompress(arc, outs, verbose=False,
                   num_threads=os.cpu_count() or 8, **kw)
    wall = time.time() - t0
    log(f"[{label}] decompress wall_s={wall}")
    return wall


def cli(*argv) -> None:
    from spring_tpu import cli as spring_cli
    rc = spring_cli.main([str(a) for a in argv] + ["--quiet"])
    if rc != 0:
        raise CheckFailed(f"cli {' '.join(map(str, argv))} exited {rc}")


def check_range(arc: str, recs: list[bytes], lo: int, hi: int,
                tmp: str, label: str) -> None:
    """--decompress-range lo+1..hi (CLI, 1-based inclusive) must give
    records [lo, hi) of the global index space."""
    out = os.path.join(tmp, "range.fastq")
    cli("-d", "-i", arc, "-o", out, "--decompress-range", lo + 1, hi)
    with open(out, "rb") as f:
        got = f.read()
    check(got == b"\n".join(recs[lo:hi]) + b"\n",
          f"{label}: --decompress-range {lo + 1} {hi} equals input slice")
    os.unlink(out)


# ---------------- phases ----------------

def make_main_input(tmp: str, n_pairs: int) -> tuple[str, str]:
    """The SRR554369-shaped PE input: 100 bp mates at ~50x coverage."""
    from spring_tpu.utils import synth
    f1, f2 = os.path.join(tmp, "main_1.fastq"), os.path.join(tmp, "main_2.fastq")
    t0 = time.time()
    synth.make_pe(f1, f2, n_pairs, read_len=100,
                  genome_size=max(2 * n_pairs * 100 // 50, 10_000),
                  seed=MAIN_SEED)
    log(f"[main] generated input in {time.time() - t0:.1f}s "
        f"({os.path.getsize(f1) + os.path.getsize(f2)} bytes)")
    return f1, f2


def phase_main(tmp: str, n_pairs: int = MAIN_PAIRS) -> None:
    log(f"== main: {n_pairs} pairs x 100 bp, paired-end")
    f1, f2 = make_main_input(tmp, n_pairs)
    a1, a2 = os.path.join(tmp, "main1.stpu"), os.path.join(tmp, "main2.stpu")
    compress([f1, f2], a1, "main cold")
    compress([f1, f2], a2, "main warm")
    check(same_file(a1, a2), "main: two compressions give identical archives")
    os.unlink(a2)
    o1, o2 = os.path.join(tmp, "o_1.fastq"), os.path.join(tmp, "o_2.fastq")
    decompress(a1, [o1, o2], "main")
    check(same_file(f1, o1) and same_file(f2, o2),
          "main: decompressed files equal both inputs")
    os.unlink(o1)
    os.unlink(o2)

    # --decompress-range on mid-archive blocks of file 1 and file 2
    recs = records(f1) + records(f2)
    block = 256_000
    for lo in (2 * block + 1000, n_pairs + 3 * block + 17):
        if lo + 2000 <= len(recs):
            check_range(a1, recs, lo, lo + 2000, tmp, "main PE")
    os.unlink(a1)
    del recs

    ar = os.path.join(tmp, "main_r.stpu")
    compress([f1, f2], ar, "main -r", reorder=True)
    decompress(ar, [o1, o2], "main -r")
    want = sorted(zip(records(f1), records(f2)))
    got = sorted(zip(records(o1), records(o2)))
    check(want == got, "main -r: the pair multiset survives (pe_encode)")
    for p in (ar, o1, o2, f1, f2):
        os.unlink(p)


def phase_modes(tmp: str, n_reads: int = MODES_READS,
                n_range: int = RANGE_SE_READS) -> None:
    from spring_tpu.pipeline import quality, qvz
    from spring_tpu.utils import synth
    log(f"== modes: {n_reads} single-end reads x 100 bp with N bases")
    fq = os.path.join(tmp, "modes.fastq")
    synth.make_se(fq, n_reads, read_len=100, genome_size=max(n_reads * 2, 10_000),
                  seed=100_000, n_rate=0.002, qual_levels=40)
    ids, reads, quals = fields(fq)
    check(sum(b"N" in r for r in reads) > 0, "modes: input carries N bases")
    arc = os.path.join(tmp, "m.stpu")
    out = os.path.join(tmp, "m.out")

    compress([fq], arc, "SE lossless")
    decompress(arc, [out], "SE lossless")
    check(same_file(fq, out), "SE lossless: byte-exact")

    compress([fq], arc, "SE -r", reorder=True)
    decompress(arc, [out], "SE -r")
    check(sorted(records(fq)) == sorted(records(out)),
          "SE -r: record multiset equal")

    # lossy quality modes through the CLI: ids and reads exact, every
    # quality value the mode's quantizer gives for the input value
    lut = {"ill_bin": quality.illumina_binning_table(),
           "binary": quality.binary_binning_table(20, 40, 10)}
    qvz_want = qvz.quantize_block(quals, 8.0)
    for qopt in (["ill_bin"], ["binary", "20", "40", "10"], ["qvz", "8"]):
        name = qopt[0]
        cli("-c", "-i", fq, "-o", arc, "-q", *qopt)
        cli("-d", "-i", arc, "-o", out)
        gi, gr, gq = fields(out)
        check(gi == ids and gr == reads, f"-q {' '.join(qopt)}: ids and "
              "reads byte-exact")
        if name == "qvz":
            want = qvz_want
        else:
            want = [lut[name][np.frombuffer(q, np.uint8)].tobytes()
                    for q in quals]
        check(gq == want, f"-q {' '.join(qopt)}: every quality equals the "
              "mode's quantizer output")

    cli("-c", "-i", fq, "-o", arc, "--no-ids", "--no-quality")
    cli("-d", "-i", arc, "-o", out)
    with open(out, "rb") as f:
        lines = f.read().split(b"\n")
    check(lines[1::2][:len(reads)] == reads and len(lines) // 2 == len(reads),
          "--no-ids --no-quality: reads byte-exact")

    fa = os.path.join(tmp, "modes.fasta")
    fastq_to_fasta(fq, fa)
    compress([fa], arc, "FASTA", fasta_input=True)
    decompress(arc, [out], "FASTA")
    check(same_file(fa, out), "FASTA input: byte-exact")
    os.unlink(fa)

    gz = fq + ".gz"
    with open(fq, "rb") as f, open(gz, "wb") as g:
        g.write(gzip.compress(f.read(), mtime=0))
    compress([gz], arc, "gzip")
    decompress(arc, [out + ".gz"], "gzip", gzipped=True)
    with gzip.open(out + ".gz", "rb") as g, open(fq, "rb") as f:
        check(g.read() == f.read(), "gzip in and out: byte-exact after "
              "gunzip")
    os.unlink(gz)
    os.unlink(out + ".gz")

    cli("-c", "-i", fq, "-o", arc, "-l")
    cli("-d", "-i", arc, "-o", out)
    check(same_file(fq, out), "-l long mode: byte-exact")

    os.environ["SPRING_TPU_DIST"] = "1"
    try:
        compress([fq], arc, "SPRING_TPU_DIST=1 one card")
    finally:
        del os.environ["SPRING_TPU_DIST"]
    decompress(arc, [out], "SPRING_TPU_DIST=1 one card")
    check(same_file(fq, out), "SPRING_TPU_DIST=1 on a one-card mesh: "
          "byte-exact")

    # SE range decode needs an archive of >= 3 blocks (256k reads each)
    big = os.path.join(tmp, "range_se.fastq")
    synth.make_se(big, n_range, read_len=100,
                  genome_size=max(n_range * 2, 10_000), seed=600_000,
                  n_rate=0.002)
    compress([big], arc, "SE range input")
    recs = records(big)
    lo = min(256_000 + 4321, max(len(recs) - 2000, 0))
    check_range(arc, recs, lo, min(lo + 2000, len(recs)), tmp, "SE")
    for p in (big, fq, arc, out):
        os.unlink(p)


def phase_parity(tmp: str) -> None:
    from spring_tpu.utils import parity
    log("== parity: pinned CPU archive digests")
    for case in parity.CASES:
        d = tempfile.mkdtemp(dir=tmp)
        t0 = time.time()
        seen = parity.run_case(case, d)
        log(f"[parity {case}] wall_s={time.time() - t0} "
            f"archive sha256 {seen['archive']}")
        bad = parity.mismatches(case, seen)
        check(not bad, f"parity {case}: input and archive digests equal the "
              f"pinned CPU digests{'; ' + '; '.join(bad) if bad else ''}")
        shutil.rmtree(d)


def phase_four_cards(tmp: str, devs, n_pairs: int = MAIN_PAIRS) -> None:
    """The main input through SPRING_TPU_DIST=1 over every card, then
    through the default engine on card 0. Both round trips byte-exact,
    archives within 0.5%, and every card holding a share of the sharded
    engine's tables (peak memory at the end of its run)."""
    log(f"== four cards: {n_pairs} pairs over {len(devs)} devices")
    f1, f2 = make_main_input(tmp, n_pairs)
    o1, o2 = os.path.join(tmp, "o_1.fastq"), os.path.join(tmp, "o_2.fastq")
    ad, a0 = os.path.join(tmp, "dist.stpu"), os.path.join(tmp, "one.stpu")
    os.environ["SPRING_TPU_DIST"] = "1"
    try:
        dist = compress([f1, f2], ad, "dist 4 cards")
    finally:
        del os.environ["SPRING_TPU_DIST"]
    peaks = dist["engine"].get("device_peak_bytes") or []
    log(f"[dist 4 cards] per-device peak_bytes_in_use at end of the "
        f"sharded run: {peaks}")
    check(len(peaks) == len(devs) and all(p and p > 0 for p in peaks),
          "dist: every card holds device memory")
    check(max(peaks) <= 2 * min(peaks),
          "dist: no card holds more than twice another's share")
    decompress(ad, [o1, o2], "dist 4 cards")
    check(same_file(f1, o1) and same_file(f2, o2),
          "dist 4 cards: byte-exact round trip")
    one = compress([f1, f2], a0, "default engine card 0")
    decompress(a0, [o1, o2], "default engine card 0")
    check(same_file(f1, o1) and same_file(f2, o2),
          "default engine card 0: byte-exact round trip")
    rel = abs(dist["bytes"] - one["bytes"]) / one["bytes"]
    log(f"[four cards] dist wall_s={dist['wall_s']} bytes={dist['bytes']}  "
        f"default wall_s={one['wall_s']} bytes={one['bytes']}  "
        f"size delta {100 * rel:.4f}%")
    check(rel <= 0.005, "dist archive within 0.5% of the one-card archive")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded engine over four GPUs and "
                         "its one-card comparison")
    args = ap.parse_args(argv)
    devs = require_gpu(4 if args.four_cards else 1)
    if args.four_cards:
        devs = devs[:4]

    import spring_tpu  # noqa: F401  (fails here outside a checkout)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    t0 = time.time()
    try:
        if args.four_cards:
            phase_four_cards(tmp, devs)
        else:
            for phase in (phase_main, phase_modes, phase_parity):
                t = time.time()
                phase(tmp)
                log(f"== {phase.__name__} passed in {time.time() - t:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"all checks passed in {time.time() - t0:.1f}s")
    import jax
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devs) if args.four_cards else len(jax.devices())}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
