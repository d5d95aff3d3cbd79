"""Peak-RSS check for the compression pipeline at scale.

Reference behavior for comparison: SPRING compresses NA12878 (560M reads)
at 32.6 GB peak (logs/8_29_18/NA12878-Rep-1_S1_L001.log:203) by streaming
blocks (src/preprocess.cpp:141-285). Our memory plan: packed 2-bit rows
stay resident (n x W uint32); the quality matrix never exists — qualities
spill to an unlinked disk spool during parse and are gathered per output
bin of ~n/8 rows (pipeline/qualstream.py).

Usage: python tools/rss_check.py [n_reads] [read_len] [limit_gb]
Runs compress in a child under resource tracking, prints one JSON line.
"""
import json
import os
import resource
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = int(sys.argv[1]) if len(sys.argv) > 1 else 10_000_000
L = int(sys.argv[2]) if len(sys.argv) > 2 else 100
LIMIT_GB = int(sys.argv[3]) if len(sys.argv) > 3 else 8

CHILD = r"""
import sys, time
sys.path.insert(0, %(repo)r)
from spring_tpu import api
t0 = time.time()
api.compress([%(fq)r], %(out)r)
print(f"compress {time.time() - t0:.1f}s", flush=True)
with open("/proc/self/status") as f:          # pipeline process's own peak
    for line in f:
        if line.startswith("VmHWM"):
            open(%(hwm)r, "w").write(line.split()[1])
"""


def main():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    tmpd = tempfile.mkdtemp(prefix="rss_check_")
    # deterministic cached input: a 100M-read file takes ~25 min to
    # synthesize — keep it for re-runs (delete by hand to reclaim disk)
    cache = os.environ.get("SPRING_TPU_RSS_DATA", "/tmp/rss_check_data")
    os.makedirs(cache, exist_ok=True)
    fq = os.path.join(cache, f"in_{N}_{L}.fastq")
    out = os.path.join(tmpd, "out.stpu")
    if not os.path.exists(fq):
        print(f"generating {N} x {L}bp synthetic reads ...", flush=True)
        from spring_tpu.utils import synth
        # scale the genome so coverage stays ~50x (SRR554369-like) at any N
        genome = max(2_000_000, N * L // 50)
        tmp_fq = fq + ".tmp"
        synth.make_se(tmp_fq, N, read_len=L, genome_size=genome, seed=5)
        os.replace(tmp_fq, fq)
    sz = os.path.getsize(fq)
    print(f"input {sz / 1e9:.2f} GB; compressing ...", flush=True)
    hwm_file = os.path.join(tmpd, "hwm")
    rc = subprocess.run(
        [sys.executable, "-c", CHILD % {"repo": repo, "fq": fq, "out": out,
                                        "hwm": hwm_file}],
        cwd=repo)
    # ru_maxrss folds in every child process the pipeline may start; the
    # pipeline process's own VmHWM is the design-relevant number. The
    # parent imports spring_tpu (and so jax) but initializes no backend,
    # so the child is the only process on the device
    peak_kb = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss
    pipe_kb = 0
    if os.path.exists(hwm_file):
        pipe_kb = int(open(hwm_file).read().strip() or 0)
        os.unlink(hwm_file)
    ok = rc.returncode == 0 and (pipe_kb or peak_kb) * 1024 < LIMIT_GB << 30
    print(json.dumps({
        "n_reads": N, "read_len": L, "input_bytes": sz,
        "archive_bytes": os.path.getsize(out) if rc.returncode == 0 else -1,
        "peak_rss_gb": round(peak_kb / 1e6, 3),
        "pipeline_hwm_gb": round(pipe_kb / 1e6, 3),
        "limit_gb": LIMIT_GB, "ok": ok}))
    if os.path.exists(out):
        os.unlink(out)
    os.rmdir(tmpd)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
