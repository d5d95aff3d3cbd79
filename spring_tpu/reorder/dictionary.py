"""Read k-mer dictionaries: host-side construction, device-side probing.

Reference analog: ``bbhashdict`` — a BooPHF minimal perfect hash over 64-bit
keys plus a CSR (startpos / read_id) bin layout with lock-striped deletion
(src/bitset_util.h:74-221, src/bitset_util.cpp:20-63). SPRING builds
NUM_DICTS=2 dictionaries over fixed base windows around the read midpoint
(src/reorder.h:752-759) and deletes reads from the bins as they are claimed.

Accelerator-first redesign: pointer-chasing MPHF lookups don't map to
batched vector code, so a dictionary here is a bucketed open hash probed
with contiguous row gathers (see the section comment below); the CSR rid
bins stay sorted by
key. Deletion is replaced by a global ``claimed`` bitmap checked after
the gather plus periodic in-bin compaction — no mutation inside compiled
programs, no locks, race-free by construction.

Key width is 16 bases = 32 bits (exact, no hashing): keys stay uint32 end to
end so no x64 mode is needed; rare 16-mer collisions only add candidates that
Hamming verification rejects.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

KEY_BASES = 16  # bases per dictionary key (uint32, 2 bits/base)


@dataclass
class DictSpec:
    """Base window [start, start+KEY_BASES) indexed by one dictionary."""
    start: int

    @property
    def end(self) -> int:
        return self.start + KEY_BASES


def default_windows(max_len: int) -> list[DictSpec]:
    """Two windows flanking the read midpoint (reference src/reorder.h:752-759
    places its dictionaries around maxlen/2 so both survive left/right shifts).
    For short reads fall back to the front of the read."""
    mid = max_len // 2
    if max_len >= 2 * KEY_BASES:
        lo = min(mid - KEY_BASES, max_len - 2 * KEY_BASES)
        return [DictSpec(lo), DictSpec(min(mid, max_len - KEY_BASES))]
    if max_len >= KEY_BASES:
        return [DictSpec(0)]
    return []


def _window_keys_np(codes: np.ndarray, start: int) -> np.ndarray:
    window = codes[:, start:start + KEY_BASES].astype(np.uint32)
    shifts = (2 * np.arange(KEY_BASES, dtype=np.uint32))[None, :]
    return np.bitwise_or.reduce(window << shifts, axis=1)


def _window_keys_packed(packed: np.ndarray, start: int) -> np.ndarray:
    """16-base (= one uint32) window keys straight from packed 2-bit rows —
    no unpacked (n, L) codes matrix needed (the packed rows are the
    pipeline's canonical read representation)."""
    w0, b = divmod(start, 16)
    lo = packed[:, w0] >> np.uint32(2 * b)
    if b:
        lo = lo | (packed[:, w0 + 1] << np.uint32(32 - 2 * b))
    return lo.astype(np.uint32)


# ---------------- bucketed hash dictionary (single-device fast path) ------
#
# The binary-search probe costs log2(n) sequential scattered gathers; a
# bucketed open hash answers in contiguous row gathers. Each bucket holds
# SLOTS entries — wide enough (8) that a SINGLE home-bucket attempt
# suffices; keys that overflow their bucket are dropped (load factor
# <= 0.25 keeps this ~1e-4 — those reads just stay singletons, matching is
# a heuristic). Scattered row gathers were BYTE-bound on the previous
# accelerator, so the probe row is kept small: the compact layout stores
# 16-bit key tags + (start | count) packed words, 48 B per bucket.
# Reference analog: the BooPHF mphf + CSR bins (src/bitset_util.h:74-221),
# redesigned for vector probing.

SLOTS = 8
_HASH_MULT = np.uint32(0x9E3779B1)
_HASH_MULT_INV = np.uint32(0x0E8B2F51)   # modular inverse mod 2^32
_TAG_MULT = np.uint32(0x85EBCA6B)
# compact btab row: SLOTS/2 words of packed 16-bit key tags + SLOTS words of
# (start << SC_SHIFT | min(count, SC_CMASK)). Byte-bound probe gathers make
# the row width their cost, so halving the row halves it; a 16-bit tag
# false-positive (~2^-16/slot) only adds candidates that Hamming verification
# rejects. start fits 27 bits in the packed word (count saturates at 31 —
# only the min(count, C<=8) candidate fetch reads it); tables past 2^27
# entries switch to the WIDE row automatically: full 32-bit starts + a
# plane of 8-bit counts (56 B/bucket vs 48), addressing the int32 rid
# space (reference: BooPHF + CSR index every read, src/BooPHF.h:754,
# src/bitset_util.h:167-216).
COMPACT_WORDS = SLOTS // 2 + SLOTS
WIDE_WORDS = SLOTS // 2 + SLOTS + SLOTS // 4
SC_SHIFT = 5
SC_CMASK = (1 << SC_SHIFT) - 1
MAX_COMPACT_ENTRIES = 1 << (32 - SC_SHIFT)
# tests flip this to exercise the wide format small; the env var lets
# at-scale runs cross into the wide row without 135M+ reads
FORCE_WIDE = bool(__import__("os").environ.get("SPRING_TPU_FORCE_WIDE"))


def _use_wide(n_entries: int) -> bool:
    return FORCE_WIDE or n_entries > MAX_COMPACT_ENTRIES


def table_buckets(n_keys: int) -> int:
    """Bucket count for n_keys (pow2, ~2 slots per key: bucket-overflow
    drop rate ~1e-4 at SLOTS=8). Capped at 2^25 buckets so the tables of
    a 100M+-read build still fit a 16 GB device beside the row table. At
    the cap (100M synthetic reads) ~0.04% of keys dropped per dict and
    the unmatched-read fraction stayed at 0.04% — dropped keys leave
    their reads to the other dict window or the second-chance pass."""
    b = max(1 << int(max(4 * n_keys // SLOTS, 1) - 1).bit_length(), 64)
    return min(b, 1 << 25)


@functools.partial(jax.jit, static_argnums=(1,))
def pairs_from_rids_stacked(rids_all: jnp.ndarray, D: int) -> jnp.ndarray:
    """pairs_from_rids for D dictionaries stacked flat in ``rids_all``
    (dict d's rids at [d*n, (d+1)*n)): returns the (D*n/8, 16) stacked
    pair rows in ONE jitted gather. Dict boundaries behave like each
    dict's own tail (positions past its n fill with -1). The eager
    per-dict pairs + eager concatenate this replaces let the concat
    pick a T(8,128)-tiled output layout — 8x padding (layout workaround
    from the previous accelerator, kept until measured on the H100,
    ROADMAP 3.3)."""
    n = rids_all.shape[0] // D
    rows_per = n // 8
    i = jnp.arange(D * rows_per, dtype=jnp.int32)[:, None]
    d = i // rows_per
    li = (i % rows_per) * 8 + jnp.arange(16, dtype=jnp.int32)[None, :]
    gi = d * n + li
    out = rids_all[jnp.minimum(gi, D * n - 1)]
    return jnp.where(li >= n, jnp.asarray(-1, rids_all.dtype), out)


@jax.jit
def pairs_from_rids(rids: jnp.ndarray) -> jnp.ndarray:
    """(n,) rids -> (n/8, 16) overlapping pair rows: row i holds
    rids[8i : 8i+16] (positions past n filled with -1). Duplicates
    memory 2x so a probe's up-to-8 candidates at any bin offset land in
    ONE gathered row. Built as ONE jitted gather from the flat array:
    the eager reshape(-1, 8) + concat form materialized a T(8,128)-
    tiled intermediate that pads the 8-wide minor dim 16x (layout
    workaround from the previous accelerator, kept until measured on
    the H100, ROADMAP 3.3)."""
    n = rids.shape[0]
    idx = (jnp.arange(n // 8, dtype=jnp.int32)[:, None] * 8
           + jnp.arange(16, dtype=jnp.int32)[None, :])
    out = rids[jnp.minimum(idx, n - 1)]
    return jnp.where(idx >= n, jnp.asarray(-1, rids.dtype), out)


@dataclass
class HashDict:
    btab: jnp.ndarray      # (S, COMPACT_WORDS) uint32 compact rows (or
                           # classic (S, 3*SLOTS) [keys|starts|counts])
    rids: jnp.ndarray      # (n,) int32 CSR payload, bins sorted by
                           # h = key * _HASH_MULT (bucket ids monotonic)
    start: int             # window start
    keys_sorted: object = None   # host np: ORIGINAL keys in bin order

    @property
    def nbuckets(self) -> int:
        return int(self.btab.shape[0])


def build_hash_dicts(codes: np.ndarray, lengths: np.ndarray,
                     windows: list[DictSpec] | None = None,
                     pad_to_pow2: bool = True,
                     compact: bool = True) -> list[HashDict]:
    if windows is None:
        windows = default_windows(codes.shape[1])
    return _build_hash_dicts(
        lambda ok, start: _window_keys_np(codes[ok], start),
        lengths, windows, pad_to_pow2, compact)


def build_hash_dicts_packed(packed: np.ndarray, lengths: np.ndarray,
                            windows: list[DictSpec],
                            pad_to_pow2: bool = True,
                            compact: bool = True) -> list[HashDict]:
    """build_hash_dicts from packed 2-bit rows (no codes matrix)."""
    return _build_hash_dicts(
        lambda ok, start: _window_keys_packed(packed[ok], start),
        lengths, windows, pad_to_pow2, compact)


def _build_hash_dicts(keyfn, lengths: np.ndarray, windows: list[DictSpec],
                      pad_to_pow2: bool = True,
                      compact: bool = True) -> list[HashDict]:
    out = []
    for spec in windows:
        ok = lengths >= spec.end
        rids = np.nonzero(ok)[0].astype(np.int32)
        keys = keyfn(ok, spec.start)
        # rows sort by h = key * MULT (bijection: equal keys still bin
        # together) so bucket ids h >> shift come out MONOTONIC — same
        # single-sort layout as the device build
        h = (keys * _HASH_MULT).astype(np.uint32)
        order = np.argsort(h, kind="stable")
        keys, rids, h = keys[order], rids[order], h[order]
        if pad_to_pow2:
            n = max(1 << max(len(keys) - 1, 1).bit_length(), 64)
            keys = np.concatenate(
                [keys, np.full(n - len(keys), 0xFFFFFFFF, np.uint32)])
            rids = np.concatenate(
                [rids, np.full(n - len(rids), -1, np.int32)])
            h = np.concatenate(
                [h, np.full(n - len(h), 0xFFFFFFFF, np.uint32)])
        uh, starts, counts = np.unique(h, return_index=True,
                                       return_counts=True)
        ukeys = keys[starts]
        # drop the sentinel bin (rid -1 padding)
        if len(uh) and uh[-1] == 0xFFFFFFFF and rids[starts[-1]] == -1:
            uh, starts, counts = uh[:-1], starts[:-1], counts[:-1]
            ukeys = ukeys[:-1]
        S = table_buckets(len(uh))
        shift = 32 - int(np.log2(S))
        bkey = np.zeros((S, SLOTS), np.uint32)
        bstart = np.zeros((S, SLOTS), np.int32)
        bcount = np.zeros((S, SLOTS), np.int32)
        # buckets are sorted; rank = index - first index of the bucket
        b = (uh >> np.uint32(shift)).astype(np.int64)
        first = np.concatenate([[True], b[1:] != b[:-1]])
        grp = np.cumsum(first) - 1
        first_idx = np.nonzero(first)[0]
        rank = np.arange(len(b)) - first_idx[grp]
        fits = rank < SLOTS
        bi, si = b[fits], rank[fits]
        bkey[bi, si] = ukeys[fits]
        bstart[bi, si] = starts[fits]
        bcount[bi, si] = counts[fits]
        dropped = int((~fits).sum())
        if compact:
            t8 = ((bkey * _TAG_MULT) >> np.uint32(16)) & np.uint32(0xFFFF)
            tagw = t8[:, 0::2] | (t8[:, 1::2] << np.uint32(16))
            if _use_wide(len(keys)):
                c8 = np.minimum(bcount, 255).astype(np.uint32)
                countw = (c8[:, 0::4] | (c8[:, 1::4] << np.uint32(8))
                          | (c8[:, 2::4] << np.uint32(16))
                          | (c8[:, 3::4] << np.uint32(24)))
                btab = np.concatenate(
                    [tagw, bstart.astype(np.uint32), countw], axis=1)
            else:
                scw = (bstart.astype(np.uint32) << np.uint32(SC_SHIFT)) \
                    | np.minimum(bcount, SC_CMASK).astype(np.uint32)
                btab = np.concatenate([tagw, scw], axis=1)
            out.append(HashDict(
                btab=jnp.asarray(btab), rids=jnp.asarray(rids),
                start=spec.start, keys_sorted=keys))
            continue
        if dropped:
            import sys
            print(f"[dict] {dropped}/{len(uh)} keys overflowed the hash "
                  "table and were dropped", file=sys.stderr)
        btab = np.concatenate([bkey, bstart.view(np.uint32),
                               bcount.view(np.uint32)], axis=1)
        out.append(HashDict(
            btab=jnp.asarray(btab), rids=jnp.asarray(rids),
            start=spec.start, keys_sorted=keys))
    return out


def probe_meta(btab, queries: jnp.ndarray
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hash-probe a batch of uint32 keys for bin metadata only.

    Returns (start, count) per query, both int32 with count 0 on miss.
    Accepts the btab layouts: classic (S, 3*SLOTS) full-key rows,
    compact (S, COMPACT_WORDS) or wide (S, WIDE_WORDS) tag rows."""
    S = btab.shape[0]
    shift = 32 - int(np.log2(S))
    flat = queries.reshape(-1)
    b = (flat * jnp.uint32(_HASH_MULT)) >> shift
    row = btab[b]                       # one row gather
    if btab.shape[1] == COMPACT_WORDS:
        tagw = row[:, :SLOTS // 2]
        scw = row[:, SLOTS // 2:]
        tags = jnp.stack([tagw & jnp.uint32(0xFFFF), tagw >> 16],
                         axis=2).reshape(-1, SLOTS)
        qtag = ((flat * jnp.uint32(_TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
        hit = (tags == qtag[:, None]) & ((scw & jnp.uint32(SC_CMASK)) > 0)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        sc = jnp.sum(jnp.where(first_hit, scw, 0), axis=1)
        start = (sc >> SC_SHIFT).astype(jnp.int32)
        count = (sc & jnp.uint32(SC_CMASK)).astype(jnp.int32)
    elif btab.shape[1] == WIDE_WORDS:
        tagw = row[:, :SLOTS // 2]
        srow = row[:, SLOTS // 2: SLOTS // 2 + SLOTS]
        cw = row[:, SLOTS // 2 + SLOTS:]
        tags = jnp.stack([tagw & jnp.uint32(0xFFFF), tagw >> 16],
                         axis=2).reshape(-1, SLOTS)
        cnts = jnp.stack([cw & jnp.uint32(0xFF),
                          (cw >> 8) & jnp.uint32(0xFF),
                          (cw >> 16) & jnp.uint32(0xFF),
                          cw >> 24], axis=2).reshape(-1, SLOTS)
        qtag = ((flat * jnp.uint32(_TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
        hit = (tags == qtag[:, None]) & (cnts > 0)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        start = jnp.sum(jnp.where(first_hit, srow, 0),
                        axis=1).astype(jnp.int32)
        count = jnp.sum(jnp.where(first_hit, cnts, 0),
                        axis=1).astype(jnp.int32)
    else:
        krow = row[:, :SLOTS]
        srow = row[:, SLOTS:2 * SLOTS].astype(jnp.int32)
        crow = row[:, 2 * SLOTS:].astype(jnp.int32)
        hit = (krow == flat[:, None]) & (crow > 0)
        # masked sums, not take_along_axis: per-element gathers along a
        # narrow minor axis ran far below memory speed on the previous
        # accelerator (kept until measured on the H100, ROADMAP 3.3)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        start = jnp.sum(jnp.where(first_hit, srow, 0), axis=1)
        count = jnp.sum(jnp.where(first_hit, crow, 0), axis=1)
    return start.reshape(queries.shape), count.reshape(queries.shape)


def probe_meta_split_stacked(btab_all, S: int, queries
                             ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Metadata probe of D compact/wide tables stacked along axis 0
    (dict d's buckets at rows [d*S, (d+1)*S)). queries: (D, ...) uint32
    keys. Returns (start, count) int32 planes with queries' shape (count
    0 on miss) — ONE btab row gather serves every dictionary; the format
    is chosen by the stacked table's row width."""
    D = queries.shape[0]
    flat = queries.reshape(D, -1)
    shift = 32 - int(np.log2(S))
    b = (flat * jnp.uint32(_HASH_MULT)) >> shift
    b = b.astype(jnp.int32) + (jnp.arange(D, dtype=jnp.int32) * S)[:, None]
    row = btab_all[b.reshape(-1)]
    tagw = row[:, :SLOTS // 2]
    tags = jnp.stack([tagw & jnp.uint32(0xFFFF), tagw >> 16],
                     axis=2).reshape(-1, SLOTS)
    qtag = ((flat.reshape(-1) * jnp.uint32(_TAG_MULT)) >> 16) \
        & jnp.uint32(0xFFFF)
    if btab_all.shape[1] == COMPACT_WORDS:
        scw = row[:, SLOTS // 2:]
        hit = (tags == qtag[:, None]) & ((scw & jnp.uint32(SC_CMASK)) > 0)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        sc = jnp.sum(jnp.where(first_hit, scw, 0), axis=1)
        start = (sc >> SC_SHIFT).astype(jnp.int32)
        count = (sc & jnp.uint32(SC_CMASK)).astype(jnp.int32)
    else:
        srow = row[:, SLOTS // 2: SLOTS // 2 + SLOTS]
        cw = row[:, SLOTS // 2 + SLOTS:]
        cnts = jnp.stack([cw & jnp.uint32(0xFF),
                          (cw >> 8) & jnp.uint32(0xFF),
                          (cw >> 16) & jnp.uint32(0xFF),
                          cw >> 24], axis=2).reshape(-1, SLOTS)
        hit = (tags == qtag[:, None]) & (cnts > 0)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        start = jnp.sum(jnp.where(first_hit, srow, 0),
                        axis=1).astype(jnp.int32)
        count = jnp.sum(jnp.where(first_hit, cnts, 0),
                        axis=1).astype(jnp.int32)
    return start.reshape(queries.shape), count.reshape(queries.shape)


def probe_meta_groups(btab_all, S: int, queries: jnp.ndarray,
                      dict_of_g: np.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Metadata probe of D stacked compact/wide tables for a STATIC group
    list: queries (B, G) uint32 keys, dict_of_g (G,) host constant of the
    dictionary each group probes. Generalizes probe_meta_split_stacked to
    group lists that don't probe every (shift, orient, dict) combination
    (the far-shift dict-thinning probe) — still ONE btab row gather."""
    B, G = queries.shape
    flat = queries.reshape(-1)
    shift = 32 - int(np.log2(S))
    b = (flat * jnp.uint32(_HASH_MULT)) >> shift
    off = jnp.asarray(dict_of_g.astype(np.int32) * S)[None, :]
    b = (b.astype(jnp.int32).reshape(B, G) + off).reshape(-1)
    row = btab_all[b]
    tagw = row[:, :SLOTS // 2]
    tags = jnp.stack([tagw & jnp.uint32(0xFFFF), tagw >> 16],
                     axis=2).reshape(-1, SLOTS)
    qtag = ((flat * jnp.uint32(_TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
    if btab_all.shape[1] == COMPACT_WORDS:
        scw = row[:, SLOTS // 2:]
        hit = (tags == qtag[:, None]) & ((scw & jnp.uint32(SC_CMASK)) > 0)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        sc = jnp.sum(jnp.where(first_hit, scw, 0), axis=1)
        start = (sc >> SC_SHIFT).astype(jnp.int32)
        count = (sc & jnp.uint32(SC_CMASK)).astype(jnp.int32)
    else:
        srow = row[:, SLOTS // 2: SLOTS // 2 + SLOTS]
        cw = row[:, SLOTS // 2 + SLOTS:]
        cnts = jnp.stack([cw & jnp.uint32(0xFF),
                          (cw >> 8) & jnp.uint32(0xFF),
                          (cw >> 16) & jnp.uint32(0xFF),
                          cw >> 24], axis=2).reshape(-1, SLOTS)
        hit = (tags == qtag[:, None]) & (cnts > 0)
        first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
        start = jnp.sum(jnp.where(first_hit, srow, 0),
                        axis=1).astype(jnp.int32)
        count = jnp.sum(jnp.where(first_hit, cnts, 0),
                        axis=1).astype(jnp.int32)
    return start.reshape(B, G), count.reshape(B, G)


def probe_hash(btab, rids, queries: jnp.ndarray,
               max_candidates: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Hash-probe a batch of uint32 keys. Same contract as ``probe``.

    ``rids`` may be the flat (n,) CSR payload or the (n/8, 16) overlapping
    pair rows from ``pairs_from_rids`` — the pair layout answers each probe
    with ONE row gather (candidates <= 8 only)."""
    start, count = probe_meta(btab, queries)
    start = start.reshape(-1)
    count = count.reshape(-1)
    offs = jnp.arange(max_candidates, dtype=jnp.int32)
    valid = offs[None, :] < jnp.minimum(count, max_candidates)[:, None]
    if rids.ndim == 2:
        # overlapping pair rows: one gather covers [start & ~7, +16)
        assert max_candidates <= 8
        nrows = rids.shape[0]
        both = rids[jnp.clip(start >> 3, 0, nrows - 1)]      # (Q, 16)
        off = start & 7
        cand = both[:, :max_candidates]
        for o in range(1, 8):
            cand = jnp.where((off == o)[:, None],
                             both[:, o:o + max_candidates], cand)
    elif max_candidates <= 8 and rids.shape[0] % 8 == 0:
        # two contiguous 8-wide row gathers + an offset select chain
        r2d = rids.reshape(-1, 8)
        nrows = r2d.shape[0]
        b0 = jnp.clip(start >> 3, 0, nrows - 1)
        both = jnp.concatenate(
            [r2d[b0], r2d[jnp.minimum(b0 + 1, nrows - 1)]], axis=-1)
        off = start & 7
        cand = both[:, :max_candidates]
        for o in range(1, 8):
            cand = jnp.where((off == o)[:, None],
                             both[:, o:o + max_candidates], cand)
    else:
        n = rids.shape[0]
        idx = start[:, None] + offs[None, :]
        cand = jnp.take(rids, jnp.minimum(idx, n - 1), axis=0)
    shape = (*queries.shape, max_candidates)
    return cand.reshape(shape), valid.reshape(shape)


# ---------------- device-side build & compaction --------------------------
#
# The host build costs seconds of numpy sorting at 1M+ reads and the tables
# then need a host->device copy. The packed rows are already on device for
# the reorder engine, so building the dictionary there — one big lax.sort
# + segment scans + placement scatters — removes both.
# The placement order matches _build_hash_dicts exactly (keys processed in
# ascending order per target bucket), so btab/rids come out bit-identical.

@dataclass
class DeviceDict:
    """Device arrays of one hash dictionary (same probe contract as
    HashDict, plus the key-sorted array for on-device bin compaction)."""
    btab: jnp.ndarray      # (S, 3*SLOTS) uint32
    rids: jnp.ndarray      # (Np,) int32, key-sorted bins
    keys_dev: jnp.ndarray  # (Np,) uint32, sorted (compaction key)
    start: int
    dropped: jnp.ndarray   # () int32 — overflowed unique keys


@functools.partial(jax.jit, static_argnums=(3, 4))
def _build_hash_dict_dev(rows, n_real, start, S: int, wide: bool = False):
    """Build one bucketed hash dict from packed rows living on device.

    rows: (Np, W+1) uint32 — packed reads + length word (engine layout).
    ``start`` is a TRACED scalar so one compiled program serves every
    dictionary window (fewer programs to compile per run).
    Returns (btab, keys_sorted, rids_sorted, dropped); btab is COMPACT."""
    Np, Wp1 = rows.shape
    W = Wp1 - 1
    lengths = (rows[:, W] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    start = jnp.asarray(start, jnp.int32)
    w0 = start // 16
    b2 = (2 * (start % 16)).astype(jnp.uint32)
    two = jax.lax.dynamic_slice_in_dim(rows, w0, 2, axis=1)
    lo = two[:, 0] >> b2
    lo = jnp.where(b2 > 0, lo | (two[:, 1] << (32 - b2)), lo)
    rid = jnp.arange(Np, dtype=jnp.int32)
    ok = (rid < n_real) & (lengths >= start + KEY_BASES)
    return _hash_build_core(lo.astype(jnp.uint32), ok, S, compact=True,
                            wide=wide)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def build_hash_dict_seq_seg(seq_words, total, base, word_offset: int,
                            nw_seg: int, S: int):
    """Segmented variant of build_hash_dict_seq_dev: keys for the
    (nw_seg - 2) * 16 positions starting at flat-sequence base ``base``
    (a multiple of 16), payload = GLOBAL position. Bounds the build's
    table + sort memory by the segment size regardless of consensus
    length — a 100 Mbp consensus needs a ~19 GB build program whole,
    which did not fit a 16 GB device; segments of 2^24 positions do."""
    w0 = word_offset + (base >> 4)
    seg = jax.lax.dynamic_slice(seq_words, (w0,), (nw_seg,))
    npos = (nw_seg - 2) * 16
    p = jnp.arange(npos, dtype=jnp.int32)
    wi = p >> 4
    r2 = (2 * (p & 15)).astype(jnp.uint32)
    lo = seg[jnp.clip(wi, 0, nw_seg - 1)]
    hi = seg[jnp.clip(wi + 1, 0, nw_seg - 1)]
    keys = jnp.where(r2 > 0, (lo >> r2) | (hi << (32 - r2)), lo)
    gp = p + base
    ok = gp <= total - KEY_BASES
    return _hash_build_core(keys, ok, S, rids=gp)


@functools.partial(jax.jit, static_argnums=(2, 3))
def build_hash_dict_seq_dev(seq_words, total, word_offset: int, S: int):
    """Sliding-window hash dict over a packed flat sequence (device):
    key[p] = the 16-mer starting at base p, value = p. ``seq_words`` may
    carry ``word_offset`` leading padding words (second_chance layout).
    Returns (btab, keys_sorted, pos_sorted, dropped) — probe with
    probe_hash; candidates are base positions."""
    nw = seq_words.shape[0]
    npos = (nw - word_offset) * 16
    p = jnp.arange(npos, dtype=jnp.int32)
    wi = (p >> 4) + word_offset
    r2 = (2 * (p & 15)).astype(jnp.uint32)
    lo = seq_words[jnp.clip(wi, 0, nw - 1)]
    hi = seq_words[jnp.clip(wi + 1, 0, nw - 1)]
    keys = jnp.where(r2 > 0, (lo >> r2) | (hi << (32 - r2)), lo)
    ok = p <= total - KEY_BASES
    return _hash_build_core(keys, ok, S)


def _hash_build_core(keys_raw, ok, S: int, compact: bool = False,
                     rids=None, wide: bool = False):
    """Shared device build, ONE sort total.

    Rows are sorted by h = key * _HASH_MULT — a bijection of the key, so
    equal keys still group into bins, and the bucket id b = h >> shift is
    MONOTONIC along the sorted order. Bin segmentation, per-bucket slot
    ranks, and placement all follow from neighbor compares and cumulative
    ops — the two extra placement sorts of the previous form tripled the
    compiled program size (and its compile time).

    The sort carries exactly TWO operands: h and a rid key that encodes
    padding as INT32_MAX (so padding sorts after real rids within a bin).
    The original key is recovered from h by the modular inverse of the
    odd multiplier; a 4-operand sort (separate padding key + carried
    original keys) moves twice the bytes of this one.

    ``rids`` carries explicit payload ids (the sharded build routes
    (key, global rid) pairs between devices); default is the position."""
    Np = keys_raw.shape[0]
    rid = (jnp.arange(Np, dtype=jnp.int32) if rids is None
           else rids.astype(jnp.int32))
    h = jnp.where(ok, keys_raw * jnp.uint32(_HASH_MULT),
                  jnp.uint32(0xFFFFFFFF))
    ridkey = jnp.where(ok, rid, jnp.int32(2**31 - 1))
    h_s, rk_s = jax.lax.sort((h, ridkey), num_keys=2)
    rids_s = jnp.where(rk_s == jnp.int32(2**31 - 1), -1, rk_s)
    keys_s = h_s * jnp.uint32(_HASH_MULT_INV)    # original window keys

    pos = jnp.arange(Np, dtype=jnp.int32)
    first = jnp.concatenate(
        [jnp.ones(1, bool), h_s[1:] != h_s[:-1]])
    # segment end of the bin starting at i = next 'first' position after i
    marks = jnp.where(first, pos, Np)
    nxt = jax.lax.cummin(
        jnp.concatenate([marks[1:], jnp.full(1, Np, jnp.int32)]),
        reverse=True)
    ucount = nxt - pos                       # valid where first
    # drop the all-padding sentinel bin (host build does the same; a real
    # bin whose h collides with the sentinel keeps its leading real rids)
    entry = first & ~((h_s == jnp.uint32(0xFFFFFFFF)) & (rids_s == -1))

    shift = 32 - int(np.log2(S))
    b = (h_s >> shift).astype(jnp.int32)     # monotonic buckets

    # rank of each ENTRY (bin head) within its bucket: entries before it
    # in the same bucket, via cumsum of entries minus the bucket's base
    bfirst = jnp.concatenate([jnp.ones(1, bool), b[1:] != b[:-1]])
    ecum0 = jnp.cumsum(entry.astype(jnp.int32)) - entry.astype(jnp.int32)
    base = jax.lax.cummax(jnp.where(bfirst, ecum0, 0))
    rank = ecum0 - base
    fits = entry & (rank < SLOTS)
    flat = jnp.where(fits, b * SLOTS + rank, S * SLOTS)
    dropped = jnp.sum(entry & ~fits).astype(jnp.int32)

    if compact and not wide:
        # scatter the pre-packed slot values DIRECTLY into the 2-D
        # (S+1, 12) btab: tag halves via scatter-add (slots 2j/2j+1 own
        # disjoint 16-bit halves of tag word j), sc words at their
        # column, row S the sink. Building per-slot (S, SLOTS) planes
        # and reshaping/concatenating them — or reshaping a flat image
        # to (S, 12) ANYWHERE, in- or out-of-jit — made XLA materialize
        # a T(8,128)-tiled relayout that pads the minor dim to 128 on the
        # previous accelerator, the whole out-of-memory of the 100M-read
        # build. A 2-D zeros + 2-D scatter keeps the benign pad-to-16
        # layout end to end (layout workaround kept until measured on
        # the H100, ROADMAP 3.3).
        t16 = ((keys_s * jnp.uint32(_TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
        scv = (pos.astype(jnp.uint32) << SC_SHIFT) \
            | jnp.minimum(ucount, SC_CMASK).astype(jnp.uint32)
        rowi = jnp.where(fits, b, S)
        col_tag = jnp.clip(rank >> 1, 0, SLOTS // 2 - 1)
        val_tag = jnp.where(
            fits, t16 << (16 * (rank & 1)).astype(jnp.uint32), 0)
        col_sc = jnp.clip(SLOTS // 2 + rank, 0, COMPACT_WORDS - 1)
        val_sc = jnp.where(fits, scv, 0)
        btab = jnp.zeros((S + 1, COMPACT_WORDS), jnp.uint32)
        btab = btab.at[jnp.concatenate([rowi, rowi]),
                       jnp.concatenate([col_tag, col_sc])].add(
            jnp.concatenate([val_tag, val_sc]))
        return btab[:S], h_s, rids_s, dropped

    if compact and wide:
        # wide row via the SAME direct 2-D scatter as the compact branch:
        # the flat-image + reshape form below materialized T(8,128)-tiled
        # relayout temps at S=2^25 on the previous accelerator. Layout:
        # 4 tag words | 8 start words | 2 count words (byte s%4 of word
        # s//4).
        t16 = ((keys_s * jnp.uint32(_TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
        rowi = jnp.where(fits, b, S)
        col_tag = jnp.clip(rank >> 1, 0, SLOTS // 2 - 1)
        val_tag = jnp.where(
            fits, t16 << (16 * (rank & 1)).astype(jnp.uint32), 0)
        col_st = jnp.clip(SLOTS // 2 + rank, 0, SLOTS // 2 + SLOTS - 1)
        val_st = jnp.where(fits, pos.astype(jnp.uint32), 0)
        col_cn = jnp.clip(SLOTS // 2 + SLOTS + (rank >> 2),
                          0, WIDE_WORDS - 1)
        val_cn = jnp.where(
            fits,
            jnp.minimum(ucount, 255).astype(jnp.uint32)
            << (8 * (rank & 3)).astype(jnp.uint32), 0)
        btab = jnp.zeros((S + 1, WIDE_WORDS), jnp.uint32)
        btab = btab.at[jnp.concatenate([rowi, rowi, rowi]),
                       jnp.concatenate([col_tag, col_st, col_cn])].add(
            jnp.concatenate([val_tag, val_st, val_cn]))
        return btab[:S], h_s, rids_s, dropped

    fkey = jnp.zeros(S * SLOTS + 1, jnp.uint32)
    fstart = jnp.zeros(S * SLOTS + 1, jnp.uint32)
    fcount = jnp.zeros(S * SLOTS + 1, jnp.uint32)
    fkey = fkey.at[flat].set(jnp.where(fits, keys_s, 0))
    fstart = fstart.at[flat].set(jnp.where(fits, pos, 0).astype(jnp.uint32))
    fcount = fcount.at[flat].set(
        jnp.where(fits, ucount, 0).astype(jnp.uint32))

    k8 = fkey[: S * SLOTS].reshape(S, SLOTS)
    s8 = fstart[: S * SLOTS].reshape(S, SLOTS)
    c8 = fcount[: S * SLOTS].reshape(S, SLOTS)
    if compact:
        t8 = ((k8 * jnp.uint32(_TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
        tagw = t8[:, 0::2] | (t8[:, 1::2] << 16)
        cb = jnp.minimum(c8, jnp.uint32(255))
        countw = (cb[:, 0::4] | (cb[:, 1::4] << 8)
                  | (cb[:, 2::4] << 16) | (cb[:, 3::4] << 24))
        btab = jnp.concatenate([tagw, s8, countw], axis=1)
    else:
        btab = jnp.concatenate([k8, s8, c8], axis=1)
    return btab, h_s, rids_s, dropped


def build_hash_dicts_device(rows, n_real: int,
                            windows: list[DictSpec]) -> list[DeviceDict]:
    """Build all dictionaries on device from engine-layout packed rows."""
    Np = int(rows.shape[0])
    S = table_buckets(Np)
    nr = jnp.asarray(n_real, jnp.int32)
    out = []
    for spec in windows:
        btab, keys_s, rids_s, dropped = _build_hash_dict_dev(
            rows, nr, spec.start, S, _use_wide(Np))
        if Np > (1 << 26):
            # serialize big builds: two dispatched together keep both
            # builds' temps live at once, which ran the 100M build out of
            # a 16 GB device's memory (kept until measured on the H100)
            jax.block_until_ready(btab)
        out.append(DeviceDict(btab=btab, rids=rids_s, keys_dev=keys_s,
                              start=spec.start, dropped=dropped))
    return out


@jax.jit
def compact_bins_dev(keys_s, rids_s, claimed):
    """Device-side in-bin compaction: live entries to each bin's front
    (same contract as compact_bins; claimed is the engine's bitmap).

    TWO sort operands: the dead flag rides bit 31 of the rid word, so
    within a bin live entries order by ascending rid — exactly the
    canonical in-bin order the build produces (rids are the secondary
    build sort key), making this equivalent to the 4-operand
    (keys, dead, pos, rids) sort it replaces at half the cost (the
    compaction ran ~2.5 s per call at 16M rows)."""
    safe = jnp.clip(rids_s, 0, claimed.shape[0] * 32 - 1)
    bit = (claimed[safe >> 5] >> (safe & 31).astype(jnp.uint32)) & 1
    dead = (rids_s < 0) | (bit == 1)
    key2 = jnp.where(dead, jnp.uint32(1 << 31), jnp.uint32(0)) \
        | jnp.where(rids_s < 0, jnp.uint32(0),
                    rids_s.astype(jnp.uint32))
    _, key2_s = jax.lax.sort((keys_s, key2), num_keys=2)
    return jnp.where((key2_s >> 31) == 1, -1,
                     key2_s.astype(jnp.int32))


def compact_bins(rids_np, keys_np, claimed_np):
    """In-bin compaction: move live entries to each bin's front without
    changing bin starts/counts (stable sort by (key, dead))."""
    dead = (rids_np < 0) | claimed_np[np.clip(rids_np, 0, len(claimed_np) - 1)]
    order = np.lexsort((dead, keys_np))
    new_rids = rids_np[order].copy()
    new_rids[dead[order]] = -1
    return new_rids
