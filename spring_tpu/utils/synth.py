"""Synthetic FASTQ dataset generator for benchmarks and A/B tests.

Models an SRR554369-class dataset (the reference's baseline log
logs/8_29_18/SRR554369.log): a small genome sampled at
high coverage, 1% substitution noise, both strands, Illumina-like
position-correlated quality values. Supports single-end and paired-end
(two files, mates drawn from the same fragment with a normal insert
size, mate 2 reverse-complemented, as real Illumina PE data is).

Robustness-grid axes — the reference's benchmark
datasets are human-scale and variable-profile; with no network access
the grid must be synthesized. Beyond the base profile the generator can
vary: read length (uniform in [lo, hi], exercising variable-length
paths), quality alphabet (8-level Illumina bins or 40-level raw Phred
with error-correlated dips), N bases (rate of ambiguous calls, quality
forced to '#'), and id style ("affine" = strictly incrementing
SRA-style, "sra_perm" = SRA tokens with a permuted, non-monotonic read
index, "illumina" = tile/x/y coordinate ids).
"""
from __future__ import annotations

import numpy as np

QLEVELS = b"#,7<BFIJ"  # Illumina 8-level-like bins


def _quals(rng: np.random.Generator, n: int, read_len: int,
           levels: int = 8, err_mask: np.ndarray | None = None) -> np.ndarray:
    if levels <= 8:
        qlevels = np.frombuffer(QLEVELS, dtype=np.uint8)
        qidx = np.clip(
            rng.normal(6.0 - np.arange(read_len) / 40.0, 1.2,
                       size=(n, read_len)).astype(np.int32), 0, 7)
        q = qlevels[qidx]
    else:
        # 40-level raw Phred ('!'..'I'): high plateau decaying along the
        # read with noise, the shape real unbinned Illumina data has
        qidx = np.clip(
            rng.normal(38.0 - np.arange(read_len) / 8.0, 3.0,
                       size=(n, read_len)).astype(np.int32), 2, 40)
        q = (qidx + 33).astype(np.uint8)
    if err_mask is not None:
        # sequencing errors carry depressed quality (correlated streams)
        q[err_mask] = np.minimum(
            q[err_mask],
            (rng.integers(2, 12, size=int(err_mask.sum())) + 33
             ).astype(np.uint8))
    return q


def _ids(rng: np.random.Generator, n: int, read_len: int,
         style: str = "affine", mate: int = 0,
         base: int = 0) -> "list[str]":
    suffix = f"/{mate}" if mate else ""
    if style == "affine":
        if mate:
            return [f"@SYN.{base + i + 1}{suffix}" for i in range(n)]
        return [f"@SYN.{base + i + 1} {base + i + 1} length={read_len}"
                for i in range(n)]
    if style == "sra_perm":
        # SRA accession with a permuted spot index: breaks every
        # delta/affine assumption an id model might lean on
        perm = rng.permutation(n) + 1
        return [f"@SRR9876543.{perm[i]} {perm[i]} length={read_len}{suffix}"
                for i in range(n)]
    if style == "illumina":
        tile = rng.integers(1101, 2316, size=n)
        x = rng.integers(1000, 30000, size=n)
        y = rng.integers(1000, 30000, size=n)
        return [f"@M00321:42:000000000-A1B2C:1:{tile[i]}:{x[i]}:{y[i]}"
                f"{suffix}" for i in range(n)]
    raise ValueError(f"unknown id style {style!r}")


def _write_fastq(path: str, chars: np.ndarray, quals: np.ndarray,
                 ids: "list[str]", lens: np.ndarray | None = None,
                 mode: str = "wb") -> None:
    n = chars.shape[0]
    with open(path, mode) as f:
        block = 100_000
        for s in range(0, n, block):
            e = min(s + block, n)
            body = bytearray()
            for i in range(s, e):
                L = int(lens[i]) if lens is not None else chars.shape[1]
                body += ids[i].encode() + b"\n"
                body += chars[i, :L].tobytes() + b"\n+\n"
                body += quals[i, :L].tobytes() + b"\n"
            f.write(bytes(body))


def _apply_n(rng: np.random.Generator, chars: np.ndarray,
             quals: np.ndarray, n_rate: float) -> None:
    """Overwrite ~n_rate of all bases with 'N' (quality dropped to '#',
    as real basecallers emit for no-calls)."""
    if n_rate <= 0:
        return
    k = int(n_rate * chars.size)
    if k == 0:
        return
    r = rng.integers(0, chars.shape[0], size=k)
    c = rng.integers(0, chars.shape[1], size=k)
    chars[r, c] = ord("N")
    quals[r, c] = ord("#")


def make_se(path: str, n_reads: int, read_len: int = 100,
            genome_size: int = 2_000_000, err_rate: float = 0.01,
            seed: int = 42, len_range: "tuple[int, int] | None" = None,
            qual_levels: int = 8, n_rate: float = 0.0,
            id_style: str = "affine") -> None:
    """Single-end dataset: n_reads reads over a random genome.

    len_range=(lo, hi) draws per-read lengths uniformly (reads truncate
    from read_len = hi); qual_levels selects the 8-level bins or 40-level
    raw Phred; n_rate injects ambiguous bases; id_style picks the header
    scheme (see _ids).
    """
    rng = np.random.default_rng(seed)
    if len_range is not None:
        read_len = int(len_range[1])
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    # permuted-id styles draw the id list whole (needs a global
    # permutation); sequential styles stream it per chunk
    ids_all = (_ids(rng, n_reads, read_len, id_style)
               if id_style != "affine" else None)
    # chunked generation: the float64 normals behind the quality model
    # are 8 bytes/base — one whole-dataset draw at 100M x 100 bp is
    # ~80 GB of transient; 2M-read chunks keep it ~1.6 GB
    chunk = 2_000_000
    mode = "wb"
    for c0 in range(0, n_reads, chunk):
        nc = min(chunk, n_reads - c0)
        starts = rng.integers(0, genome_size - read_len, size=nc)
        reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
        nerr = int(err_rate * nc * read_len)
        er = rng.integers(0, nc, size=nerr)
        ec = rng.integers(0, read_len, size=nerr)
        reads[er, ec] = (reads[er, ec] + rng.integers(1, 4, size=nerr)) % 4
        rc = rng.random(nc) < 0.5
        reads[rc] = 3 - reads[rc][:, ::-1]
        chars = np.frombuffer(b"ACGT", dtype=np.uint8)[reads]
        err_mask = None
        if qual_levels > 8:
            err_mask = np.zeros(reads.shape, bool)
            err_mask[er, ec] = True
            # reflect strand flips so depressed quality stays on the error
            err_mask[rc] = err_mask[rc][:, ::-1]
        quals = _quals(rng, nc, read_len, qual_levels, err_mask)
        _apply_n(rng, chars, quals, n_rate)
        lens = (rng.integers(len_range[0], len_range[1] + 1, size=nc)
                .astype(np.int32) if len_range is not None else None)
        ids = (ids_all[c0:c0 + nc] if ids_all is not None else
               _ids(rng, nc, read_len, id_style, base=c0))
        _write_fastq(path, chars, quals, ids, lens, mode=mode)
        mode = "ab"


def make_pe(path1: str, path2: str, n_pairs: int, read_len: int = 100,
            genome_size: int = 2_000_000, err_rate: float = 0.01,
            insert_mean: float = 300.0, insert_sd: float = 30.0,
            seed: int = 42, len_range: "tuple[int, int] | None" = None,
            qual_levels: int = 8, n_rate: float = 0.0,
            id_style: str = "affine") -> None:
    """Paired-end dataset: mate 1 forward, mate 2 reverse-complemented from
    the far end of the same fragment (standard Illumina FR orientation).
    Grid axes as in make_se; per-mate lengths are drawn independently."""
    rng = np.random.default_rng(seed)
    if len_range is not None:
        read_len = int(len_range[1])
    genome = rng.integers(0, 4, size=genome_size, dtype=np.int8)
    insert = np.clip(rng.normal(insert_mean, insert_sd, size=n_pairs),
                     read_len + 10, genome_size - 1).astype(np.int64)
    starts = rng.integers(0, genome_size - insert.max() - 1, size=n_pairs)
    r1 = genome[starts[:, None] + np.arange(read_len)[None, :]]
    s2 = starts + insert - read_len
    r2 = genome[s2[:, None] + np.arange(read_len)[None, :]]
    r2 = 3 - r2[:, ::-1]  # mate 2 is on the reverse strand
    err_masks = []
    for reads in (r1, r2):
        nerr = int(err_rate * n_pairs * read_len)
        er = rng.integers(0, n_pairs, size=nerr)
        ec = rng.integers(0, read_len, size=nerr)
        reads[er, ec] = (reads[er, ec] + rng.integers(1, 4, size=nerr)) % 4
        m = np.zeros(reads.shape, bool)
        m[er, ec] = True
        err_masks.append(m)
    # half the pairs flipped to the other strand (swap + RC both mates)
    flip = rng.random(n_pairs) < 0.5
    r1f = r1.copy()
    r1[flip] = 3 - r2[flip][:, ::-1]
    r2[flip] = 3 - r1f[flip][:, ::-1]
    m1f = err_masks[0].copy()
    err_masks[0][flip] = err_masks[1][flip][:, ::-1]
    err_masks[1][flip] = m1f[flip][:, ::-1]
    base = np.frombuffer(b"ACGT", dtype=np.uint8)
    ids1 = _ids(rng, n_pairs, read_len, id_style, mate=1)
    ids2 = _ids(rng, n_pairs, read_len, id_style, mate=2)
    if id_style != "affine":
        # mates must share the token body for PE id-pattern detection
        ids2 = [i[:-2] + "/2" for i in ids1]
    for pth, reads, ids, m in ((path1, r1, ids1, err_masks[0]),
                               (path2, r2, ids2, err_masks[1])):
        chars = base[reads]
        quals = _quals(rng, n_pairs, read_len,
                       qual_levels, m if qual_levels > 8 else None)
        _apply_n(rng, chars, quals, n_rate)
        lens = (rng.integers(len_range[0], len_range[1] + 1, size=n_pairs)
                .astype(np.int32) if len_range is not None else None)
        _write_fastq(pth, chars, quals, ids, lens)
