"""Pinned digests of two seeded round trips, one per backend-parity case.

The device path (reorder engine, dictionary build, second-chance placer)
computes on integers only and every sort in it is stable, so the archive
of a given input is the same bytes on every backend: a CPU test
(tests/test_parity.py) and the GPU smoke run (chip_smoke.py) both compress
these inputs and must reproduce the pinned SHA-256 of each archive. The
inputs' own digests are pinned beside them, so a change in data generation
is told apart from a change in compression.
"""
from __future__ import annotations

import hashlib
import os

# fixed thread count: archives are thread-count independent by design,
# but the pinned runs should not depend on that claim
NUM_THREADS = 4

CASES = {
    # 20,000 single-end reads, order kept, lossless
    "se_lossless": {
        "inputs": {
            "se.fastq":
            "626d2a942804e4d62a46c1262d0489ac79e8540337e72ea0a5d648b7e13ef203",
        },
        "archive":
        "04a814aaf857079333e5a6acf372a13c0d43ca1646d14e231e6bc8ef79d68a85",
    },
    # 20,000 read pairs, -r (order not kept, pairing kept)
    "pe_reorder": {
        "inputs": {
            "pe_1.fastq":
            "4de40f7159e185dd2af90f773932af817a92b516b3f3a67c9a3520630d95c8b5",
            "pe_2.fastq":
            "ace0be24dc8abbb66c2ed61e9c81f57c50dc76cba908b9f2b8c786fd705d00e7",
        },
        "archive":
        "598a1211d2981b2dc5158850a4a5ba2843e731e166b84afdce07b1fe4de25147",
    },
}


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def make_inputs(case: str, tmp: str) -> list[str]:
    """Write the seeded input FASTQ file(s) of ``case`` under ``tmp``."""
    from . import synth
    paths = [os.path.join(tmp, name) for name in CASES[case]["inputs"]]
    if case == "se_lossless":
        synth.make_se(paths[0], 20_000, read_len=100, genome_size=100_000,
                      seed=1234, n_rate=0.002)
    elif case == "pe_reorder":
        synth.make_pe(paths[0], paths[1], 20_000, read_len=100,
                      genome_size=200_000, seed=4321, n_rate=0.002)
    else:
        raise KeyError(case)
    return paths


def run_case(case: str, tmp: str) -> dict:
    """Generate ``case``'s inputs, compress them through api.compress and
    return the digests actually seen: {"inputs": {name: sha}, "archive":
    sha, "archive_path": path}."""
    from .. import api
    paths = make_inputs(case, tmp)
    arc = os.path.join(tmp, case + ".stpu")
    api.compress(paths, arc, api.CompressOptions(
        reorder=case == "pe_reorder", num_threads=NUM_THREADS,
        verbose=False))
    return {"inputs": {os.path.basename(p): sha256_file(p) for p in paths},
            "archive": sha256_file(arc), "archive_path": arc}


def mismatches(case: str, seen: dict) -> list[str]:
    """Human-readable differences between ``seen`` and the pinned digests
    (empty when they agree)."""
    want = CASES[case]
    out = [f"{case}: input {k} sha256 {seen['inputs'].get(k)} != pinned {v}"
           for k, v in want["inputs"].items() if seen["inputs"].get(k) != v]
    if seen["archive"] != want["archive"]:
        out.append(f"{case}: archive sha256 {seen['archive']} != pinned "
                   f"{want['archive']}")
    return out
