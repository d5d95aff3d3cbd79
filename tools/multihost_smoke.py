"""Two-process jax.distributed smoke test for the sharded reorder.

parallel/multihost.py is otherwise never executed with
process_count > 1. This driver spawns TWO local CPU processes, forms a
2-device mesh spanning both (1 CPU device per process), runs the FULL
distributed reorder on identical synthetic input in each, and checks
that the emissions match a single-process 2-device run bit for bit —
exercising jax.distributed.initialize, cross-process put_sharded /
put_replicated, the all_to_all/all_gather collectives over the
coordination service, and process_allgather in to_host.

Usage:
    python tools/multihost_smoke.py            # parent: orchestrates
    (children are spawned internally with SPRING_TPU_COORD/NPROCS/PROC)

Prints one JSON line {"ok": true, ...} and exits 0 on success.
"""
import json
import os
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS, L, SEED = 512, 64, 7

CHILD = r"""
import os, sys
sys.path.insert(0, os.environ["SMOKE_REPO"])
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
# distributed init must precede ANY backend use; importing the engine
# builds jnp constants, so initialize through multihost alone first
from spring_tpu.parallel import multihost as mh
ok = mh.maybe_initialize()
import __graft_entry__ as g
from spring_tpu.parallel import dist

assert ok and jax.process_count() == 2, (ok, jax.process_count())
mesh = dist.make_mesh()
assert mesh.devices.size == 2
packed, lengths = g._synthetic(int(os.environ["SMOKE_N"]),
                               int(os.environ["SMOKE_L"]),
                               seed=int(os.environ["SMOKE_SEED"]))
e = dist.DistReorderEngine(packed, lengths,
                           dist.DistConfig(max_readlen=int(
                               os.environ["SMOKE_L"])), mesh=mesh)
em = e.run()
np.save(os.environ["SMOKE_OUT"] + f".p{jax.process_index()}.npy", em)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(timeout: float = 600.0) -> dict:
    import numpy as np
    port = _free_port()
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "em")
        procs = []
        logs = []
        for pid in range(2):
            env = dict(os.environ)
            env.pop("XLA_FLAGS", None)         # 1 CPU device per process
            env.update(
                JAX_PLATFORMS="cpu",
                SPRING_TPU_COORD=f"127.0.0.1:{port}",
                SPRING_TPU_NPROCS="2",
                SPRING_TPU_PROC=str(pid),
                SMOKE_REPO=REPO, SMOKE_OUT=out,
                SMOKE_N=str(N_READS), SMOKE_L=str(L),
                SMOKE_SEED=str(SEED),
            )
            lf = open(os.path.join(td, f"log{pid}"), "w+")
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", CHILD], env=env,
                stdout=lf, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=timeout) for p in procs]
        tails = []
        for lf in logs:
            lf.seek(0)
            tails.append(lf.read()[-2000:])
            lf.close()
        if any(rcs):
            return {"ok": False, "rcs": rcs, "logs": tails}
        em0 = np.load(out + ".p0.npy")
        em1 = np.load(out + ".p1.npy")
        # reference: single-process run over a 2-device CPU mesh
        env = dict(os.environ)
        env.update(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                   JAX_PLATFORMS="cpu",
                   SMOKE_REPO=REPO, SMOKE_OUT=out + ".ref",
                   SMOKE_N=str(N_READS), SMOKE_L=str(L),
                   SMOKE_SEED=str(SEED))
        for k in ("SPRING_TPU_COORD", "SPRING_TPU_NPROCS",
                  "SPRING_TPU_PROC"):
            env.pop(k, None)
        rc = subprocess.run([sys.executable, "-c", CHILD.replace(
            'assert ok and jax.process_count() == 2, (ok, jax.process_count())',
            'assert not ok')],
            env=env, capture_output=True, timeout=timeout)
        if rc.returncode:
            return {"ok": False, "ref_log": rc.stdout.decode()[-2000:]
                    + rc.stderr.decode()[-2000:]}
        ref = np.load(out + ".ref.p0.npy")
        same_procs = bool(np.array_equal(em0, em1))
        same_ref = bool(np.array_equal(em0, ref))
        return {"ok": same_procs and same_ref,
                "emissions": int(len(em0)),
                "procs_match": same_procs, "ref_match": same_ref}


if __name__ == "__main__":
    res = run()
    print(json.dumps(res))
    sys.exit(0 if res.get("ok") else 1)
