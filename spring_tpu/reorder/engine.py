"""Batched read-reordering engine (the algorithmic heart #1).

Reference analog: the greedy consensus-following contig walk of
src/reorder.h — per-thread sequential loop (src/reorder.h:432-616) with
search_match (src/reorder.h:246-318: dictionary probe + shifted Hamming
verify), updaterefcount consensus update (src/reorder.h:110-220), and
lock-striped claim/delete of reads (src/reorder.h:440-475).

Accelerator-first redesign — breadth-first instead of thread-serial:
  * B independent contig *walkers* advance in lock-step rounds. Each round a
    walker probes a chunk of SHIFT_CHUNK shifts x 2 dictionaries x
    {forward, reverse-complement} against the sorted-key dictionaries, then
    verifies all gathered candidates at once with a packed XOR+popcount
    Hamming kernel. Everything is one fixed-shape jitted program — no locks,
    no data-dependent shapes.
  * Claim conflicts between walkers are resolved with a sort (stable argsort
    by candidate rid; first walker wins) instead of omp_test_lock.
  * Dictionary deletion is replaced by a `claimed` bitmap filter plus a
    periodic host-side compaction of the sorted arrays (shape-preserving:
    freed slots get rid -1), mirroring the reference's bin deletion without
    any mutation inside the compiled program.
  * Match semantics follow the reference: forward match at shift s compares
    read[p] == ref[s+p] over the overlap with Hamming <= THRESH_REORDER;
    reverse match compares read[p] == revcomp(ref)[p-s] over [s, ...). The
    consensus window is pinned to the newest read's start (forward-case
    updaterefcount semantics applied to both orientations).

The round is decomposed into module-level pure functions so the multi-chip
round (parallel/dist.py) composes the same math with collectives.

Emissions are (rid, flag, pos_delta, rc) per walker per round, buffered on
device and flushed every FLUSH_ROUNDS rounds so the host loop syncs rarely.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P
from ..ops import bits
from . import dictionary as dct

import os as _os

SHIFT_CHUNK = 4        # shifts probed per round
# rounds between host syncs. 64 was tried pre-pipelining: seed-queue
# compaction and the endgame exit only happen between flushes, and the
# extra tail rounds cost more than the amortization saved
FLUSH_ROUNDS = int(_os.environ.get("SPRING_TPU_FLUSH_ROUNDS", "32"))
# compact dicts when claimed grew by this fraction since the last compact.
# DISABLED by default (fraction > 1 never triggers): ablations gave
# BYTE-IDENTICAL archives and the same unmatched rate with compaction off
# on synthetic profiles from 100k to 100M reads — the 2-dict x 16-shift
# probe redundancy absorbs stale bin entries — while each compaction
# event stalled the flush loop. Re-enable with e.g.
# SPRING_TPU_REBUILD_FRACTION=0.22 if a profile ever shows bin staleness
# (high-dup data with shallow probes).
REBUILD_FRACTION = float(_os.environ.get("SPRING_TPU_REBUILD_FRACTION",
                                         "10"))

# stats of the most recent run() — bench.py reports them next to the
# headline (rounds, flush wall, emission bytes fetched to the host)
LAST_RUN_STATS: dict = {}


def padded_n(n: int) -> int:
    """Engine read-count padding: pow2 so datasets of similar size share
    one compiled program (padding reads are pre-claimed, never touched).
    Past 2^26 reads, pow2 padding can waste up to 2x in EVERY device
    table (rows/dicts/pairs — 100M reads padded to 134M); 1/8-octave
    granules bound the waste at ONE granule — ~12.5% of n mid-octave, up
    to 25% for n just past a power of two (the granule then comes from
    the next octave: 2^26+1 pads to 5*2^24) — for at most 8 compiled
    shapes per octave, amortized by runs that big. Size device-memory
    headroom from the 25% worst case. (Sized for a 16 GB device; kept
    until measured on the H100, ROADMAP 3.3.)
    Always a multiple of 64 (bitmap words, pairs rows)."""
    np_pow2 = max(1 << max(n - 1, 1).bit_length(), 64)
    if n <= (1 << 26):
        return np_pow2
    gran = 1 << (max(n - 1, 1).bit_length() - 3)
    return min(-(-n // gran) * gran, np_pow2)

_ODD = jnp.uint32(0x55555555)
_ONES = jnp.uint32(0xFFFFFFFF)
_BIG = jnp.iinfo(jnp.int32).max


@dataclass
class ReorderConfig:
    max_readlen: int
    num_walkers: int = P.REORDER_BATCH
    candidates: int = P.DICT_PROBE_CANDIDATES
    thresh: int = P.THRESH_REORDER
    # reference rg.maxshift is maxlen/2, sensible for 8 sequential walkers;
    # with thousands of walkers, contig-death shift scans dominate round
    # count, so cap the scan (shifts beyond it are rare at real coverage)
    max_shift: int = 0   # 0 -> min(max_readlen // 2, MAX_SHIFT_CAP)
    # batch-accept: shifts scanned per round (wide chunks amortize fixed
    # round cost) and accepted-candidate slots per walker per round (the
    # reference accepts one read then re-probes, src/reorder.h:432-616;
    # accepting every verified candidate of a round is the same objective
    # optimized breadth-first and cuts round count by ~coverage)
    shift_chunk: int = 16
    accept_slots: int = 16
    # probe thinning: shifts >= far_near probe ONE dictionary (d = s % D)
    # instead of both — the probe gather's cost is its row count, and
    # far-shift probes are the long tail of that count while accepts
    # concentrate at near shifts. A read findable
    # only via the skipped dict at a far shift is retried at nearer
    # shifts as the contig approaches, or lands in second chance.
    # 0 disables (reference semantics: both dicts at every shift,
    # src/reorder.h:479-557).
    far_near: int = 0

    def __post_init__(self):
        if self.max_shift == 0:
            self.max_shift = max(min(self.max_readlen // 2,
                                     P.MAX_SHIFT_CAP), 1)


# --------------- small vector helpers ---------------

def _prefix_mask_words(nbases: jnp.ndarray, W: int) -> jnp.ndarray:
    """Word masks covering base positions [0, nbases) of a packed read.

    Equivalent of the reference's precomputed shifted-compare masks
    (src/bitset_util.h:223-236), computed on the fly.
    """
    k = jnp.clip(nbases[..., None] - 16 * jnp.arange(W), 0, 16)
    full = _ONES >> (32 - 2 * jnp.clip(k, 1, 16)).astype(jnp.uint32)
    return jnp.where(k > 0, full, jnp.uint32(0))


def _range_mask_words(lo: jnp.ndarray, hi: jnp.ndarray, W: int) -> jnp.ndarray:
    return _prefix_mask_words(hi, W) & ~_prefix_mask_words(lo, W)


def _masked_hamming(a: jnp.ndarray, b: jnp.ndarray, lo: jnp.ndarray,
                    hi: jnp.ndarray) -> jnp.ndarray:
    """Base mismatches between packed reads over base range [lo, hi)."""
    W = a.shape[-1]
    d = a ^ b
    m = (d | (d >> 1)) & _ODD
    m = m & _range_mask_words(lo, hi, W)
    return jnp.sum(jax.lax.population_count(m), axis=-1).astype(jnp.int32)


def _onehot_read(codes: jnp.ndarray, rlen: jnp.ndarray) -> jnp.ndarray:
    """(Bw, Lb) codes -> (Bw, 4, Lb) one-hot masked by read length."""
    Lb = codes.shape[-1]
    oh = (codes[:, None, :] == jnp.arange(4)[None, :, None])
    valid = (jnp.arange(Lb)[None, None, :] < rlen[:, None, None])
    return (oh & valid).astype(jnp.int32)


# --------------- packed consensus counts (engine-internal) ---------------
#
# The single-chip round keeps its per-position base counts as FOUR u8
# lanes of one uint32 (c0 | c1<<8 | c2<<16 | c3<<24) instead of a
# (B, 4, Lb) int32 tensor: the roll/select chains and one-hot updates
# move 4x fewer bytes. Lanes saturate at 127 (the add invariant: counts
# <= 127 and a round adds <= M <= 16 per lane, so lane sums stay < 256 —
# carry-free — before re-saturating). Majority votes beyond 127x
# coverage freeze, which only affects consensus quality, never
# losslessness. dist.py keeps the plane layout and the helpers above.

_LANE1 = jnp.uint32(0x01010101)


def _counts_argmax_packed(c8):
    """(…, Lb) packed lanes -> argmax plane index (first max wins,
    matching jnp.argmax over the plane axis)."""
    c0 = c8 & jnp.uint32(0xFF)
    c1 = (c8 >> 8) & jnp.uint32(0xFF)
    c2 = (c8 >> 16) & jnp.uint32(0xFF)
    c3 = c8 >> 24
    m = jnp.maximum(jnp.maximum(c0, c1), jnp.maximum(c2, c3))
    return jnp.where(c0 == m, 0,
                     jnp.where(c1 == m, 1,
                               jnp.where(c2 == m, 2, 3))).astype(jnp.int32)


def _roll_words(x, t):
    """Dynamic per-row left roll of (…, Lb) along positions via two
    static select chains (t = 8q + r) — gather-free."""
    Lb = x.shape[-1]
    q, r = t // 8, t % 8
    out = x
    for qq in range(1, Lb // 8 + 1):
        out = jnp.where((q == qq)[..., None],
                        _shift_last_static(x, 8 * qq), out)
    base = out
    for rr in range(1, 8):
        out = jnp.where((r == rr)[..., None],
                        _shift_last_static(base, rr), out)
    return out


def _lane_inc(codes, rlen):
    """(…, Lb) codes -> packed one-hot lane increments masked by rlen."""
    Lb = codes.shape[-1]
    valid = jnp.arange(Lb) < rlen[..., None]
    return jnp.where(valid, jnp.uint32(1) << (8 * codes).astype(jnp.uint32),
                     jnp.uint32(0))


def _sat_add(c8, inc):
    """Lane-wise saturating add (inputs carry-free per the invariant)."""
    sm = c8 + inc
    ov = (sm >> 7) & _LANE1
    return (sm & ~(ov * jnp.uint32(0xFF))) | (ov * jnp.uint32(0x7F))


def walker_frames_packed(c8, ref_len, shift_base, sc: int = SHIFT_CHUNK):
    """walker_frames over packed lane counts: (Bw, Lb) uint32 in."""
    Lb = c8.shape[-1]
    refc = _counts_argmax_packed(c8)
    refc = jnp.where(jnp.arange(Lb) < ref_len[:, None], refc, 0)
    ref_pk = bits.pack(refc)
    rev_pk = bits.revcomp_packed(ref_pk, ref_len)
    base_ref = bits.shift_bases_left(ref_pk, shift_base, Lb)
    base_rev = bits.shift_bases_right(rev_pk, shift_base, Lb)
    ref_i = [bits.shift_bases_left_static(base_ref, i) for i in range(sc)]
    rev_i = [bits.shift_bases_right_static(base_rev, i) for i in range(sc)]
    frames = jnp.stack([jnp.stack(ref_i, axis=1),
                        jnp.stack(rev_i, axis=1)], axis=2)
    s_tot = shift_base[:, None] + jnp.arange(sc)
    return frames, s_tot


# --------------- round stages (pure, walker-batched) ---------------
#
# Layout rule applied throughout: keep the LARGE axis (walkers x probe
# slots) in the minor-most dimension and loop over the 7-word packed axis in
# Python — a 7-wide minor dim wastes most of a 128-lane tile. Layout
# workaround from the previous accelerator, kept until measured on the
# H100 (ROADMAP 3.3).


class ProbeLayout:
    """Static decomposition of the flattened probe axis K = SC*D*2*C.

    k = ((s * D + d) * 2 + o) * C + c. All index arrays are host numpy,
    baked into the program as constants.
    """

    def __init__(self, D: int, C: int, sc: int = SHIFT_CHUNK):
        self.D, self.C, self.SC = D, C, sc
        self.K = sc * D * 2 * C
        k = np.arange(self.K)
        # layout k = ((s*2 + o)*D + d)*C + c: slot index IS the priority
        # (shift > orientation > dict > bin slot — the reference search
        # order, src/reorder.h:479-557)
        self.k_c = k % C
        self.k_d = (k // C) % D
        self.k_o = (k // (C * D)) % 2
        self.k_s = k // (C * D * 2)
        self.k_frame = self.k_s * 2 + self.k_o      # index into SC*2 frames
        self.pr_static = k.astype(np.int32)


def walker_frames(counts, ref_len, shift_base, sc: int = SHIFT_CHUNK):
    """Consensus comparison frames, computed entirely in the packed bit
    domain (funnel shifts, no gathers — take_along_axis-style shifts
    lowered to scattered loads on the previous accelerator; layout
    workaround kept until measured on the H100, ROADMAP 3.3).

    counts: (Bw, 4, Lb). Returns (frames, s_tot):
      frames: (Bw, sc, 2, W) packed consensus windows — orientation axis is
              {forward shifted left by s, revcomp shifted right by s}
      s_tot:  (Bw, sc) absolute shift of each probe
    """
    Lb = counts.shape[2]
    refc = jnp.argmax(counts, axis=1).astype(jnp.int32)
    refc = jnp.where(jnp.arange(Lb) < ref_len[:, None], refc, 0)
    ref_pk = bits.pack(refc)                         # (Bw, W)
    rev_pk = bits.revcomp_packed(ref_pk, ref_len)
    base_ref = bits.shift_bases_left(ref_pk, shift_base, Lb)
    base_rev = bits.shift_bases_right(rev_pk, shift_base, Lb)
    ref_i = [bits.shift_bases_left_static(base_ref, i)
             for i in range(sc)]
    rev_i = [bits.shift_bases_right_static(base_rev, i)
             for i in range(sc)]
    frames = jnp.stack([jnp.stack(ref_i, axis=1),
                        jnp.stack(rev_i, axis=1)], axis=2)
    s_tot = shift_base[:, None] + jnp.arange(sc)
    return frames, s_tot


def walker_queries(frames, s_tot, ref_len, starts):
    """Dictionary queries from the packed frames. Returns (q, v):
    (Bw, SC, D, 2)."""
    qs, vs = [], []
    for st in starts:
        k = bits.extract_key_packed(frames, st)      # (Bw, SC, 2)
        v_fwd = (s_tot + st + dct.KEY_BASES) <= ref_len[:, None]
        v_rev = (s_tot <= st) & ((st + dct.KEY_BASES - s_tot)
                                 <= ref_len[:, None])
        qs.append(k)
        vs.append(jnp.stack([v_fwd, v_rev], axis=2))
    return jnp.stack(qs, axis=2), jnp.stack(vs, axis=2)


def _prefix_word(nb: jnp.ndarray) -> jnp.ndarray:
    """uint32 mask covering the first nb (clipped 0..16) 2-bit lanes."""
    full = _ONES >> (32 - 2 * jnp.clip(nb, 1, 16)).astype(jnp.uint32)
    return jnp.where(nb > 0, full, jnp.uint32(0))


def resolve_conflicts(matched, rid_sel):
    """First claimant (lowest original index) wins each rid; others lose.

    Two multi-operand lax.sorts (forward by rid, back by original index)
    instead of argsort + gather + scatter: per-element gathers/scatters
    ran far below memory speed on the previous accelerator, sorts did
    not. Kept until measured on the H100 (ROADMAP 3.3).
    """
    n = rid_sel.shape[0]
    key = jnp.where(matched, rid_sel, _BIG)
    idx = jnp.arange(n, dtype=jnp.int32)
    ks, orig = jax.lax.sort((key, idx), num_keys=2)
    first = jnp.concatenate([jnp.array([True]), ks[1:] != ks[:-1]])
    win_sorted = first & (ks != _BIG)
    # the flag rides the back-permutation as int32: XLA's GPU compiler
    # rewrites a sort keyed by a permutation into a scatter, and for a
    # bool operand that scatter fails its HLO verifier (jax 0.9.0)
    _, win = jax.lax.sort((orig, win_sorted.astype(jnp.int32)), num_keys=1)
    return win.astype(bool)


def _shift_last_static(x, s: int):
    """x[..., p] = x[..., p + s], zero fill (static s)."""
    if s == 0:
        return x
    z = jnp.zeros((*x.shape[:-1], s), x.dtype)
    return jnp.concatenate([x[..., s:], z], axis=-1)


def _roll_counts(x, t):
    """Dynamic per-row left roll of (Bw, 4, Lb) along positions via two
    static select chains (t = 8q + r) — gather-free."""
    Lb = x.shape[-1]
    q, r = t // 8, t % 8
    out = x
    for qq in range(1, Lb // 8 + 1):
        out = jnp.where((q == qq)[:, None, None],
                        _shift_last_static(x, 8 * qq), out)
    base = out
    for rr in range(1, 8):
        out = jnp.where((r == rr)[:, None, None],
                        _shift_last_static(base, rr), out)
    return out


def apply_matches(counts, ref_len, matched, rid_sel, t_sel, rc_sel,
                  packed, lengths):
    """Consensus update (updaterefcount semantics, src/reorder.h:110-220):
    roll the count window to the new read's start, add its one-hot.

    counts layout (Bw, 4, Lb) — base plane as the middle axis keeps the
    112-wide position axis minor for full vector tiles. The roll and the
    reverse complement are select chains / packed funnels: no gathers
    except the Bw-row fetch of the matched reads.
    """
    Lb = counts.shape[2]
    Np = packed.shape[0]
    W = packed.shape[1] - 1
    t_upd = jnp.where(matched, t_sel, 0)
    live = jnp.arange(Lb)[None, None, :] < ref_len[:, None, None]
    rolled = _roll_counts(counts * live, t_upd)
    rows = packed[jnp.clip(rid_sel, 0, Np - 1)]              # (Bw, W+1)
    cur_len = (rows[:, W] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    pk = rows[:, :W]
    pk = jnp.where(rc_sel[:, None] == 1,
                   bits.revcomp_packed(pk, cur_len), pk)
    cur = bits.unpack(pk, Lb)
    new_counts = rolled + _onehot_read(cur, cur_len)
    counts = jnp.where(matched[:, None, None], new_counts, counts)
    ref_len = jnp.where(matched, jnp.maximum(ref_len - t_upd, cur_len),
                        ref_len)
    return counts, ref_len


def seed_counts_for(packed, lengths, seed_rid, Lb):
    seed_codes = bits.unpack(packed[seed_rid], Lb)
    return _onehot_read(seed_codes, lengths[seed_rid])


@jax.jit
def _assemble_rows(full, sel, lengths_p):
    """Gather full[sel] and append the length word (claimed bit 31 set
    where sel < 0, i.e. padding rows)."""
    n_all = full.shape[0]
    rows = full[jnp.clip(sel, 0, n_all - 1)]
    lw = lengths_p.astype(jnp.uint32)
    lw = jnp.where(sel >= 0, lw, lw | jnp.uint32(1 << 31))
    return jnp.concatenate([rows, lw[:, None]], axis=1)


@functools.partial(jax.jit, donate_argnums=0)
def _dus_rows(buf, seg, r0):
    return jax.lax.dynamic_update_slice(buf, seg, (r0, 0))


class DeviceRowStager:
    """Overlap the packed-rows host->device transfer with the parse.

    ``feed(r0, rows)`` ships each parsed segment (~14 MB) into a
    device-resident table while the next segment parses, so the engine
    starts from device rows instead of paying the whole transfer (plus
    its client-side staging spike) after the parse. Built for a slow
    host-device link; kept until measured on the H100 (ROADMAP 3.2). The
    table is sized at 1/8-octave granularity (multiple of the feed
    segment) so the update program and downstream gathers stay
    shape-bucketed."""

    def __init__(self, n: int, W: int, seg: int):
        gran = max(1 << max(int(max(n, 1) - 1).bit_length() - 3, 6), seg)
        self.cap = -(-max(n, 1) // gran) * gran
        self.W = W
        self.seg = seg
        self._buf = None
        self._released = False

    def feed(self, r0: int, rows: np.ndarray) -> None:
        if self._buf is None:
            self._buf = jnp.zeros((self.cap, self.W), jnp.uint32)
        if rows.shape[0] != self.seg:          # tail segment: pad to shape
            pad = np.zeros((self.seg, self.W), np.uint32)
            pad[: rows.shape[0]] = rows
            rows = pad
        self._buf = _dus_rows(self._buf, jax.device_put(rows),
                              jnp.asarray(r0, jnp.int32))

    def rows(self):
        """The (cap, W) device table (zeros if nothing was fed)."""
        if self._released:
            raise RuntimeError("DeviceRowStager used after release()")
        if self._buf is None:
            self._buf = jnp.zeros((self.cap, self.W), jnp.uint32)
        return self._buf

    def release(self) -> None:
        """Drop the device table and mark the stager unusable — rows()
        after release raises instead of silently recreating zeros."""
        self._buf = None
        self._released = True


# --------------- single-device engine ---------------

class ReorderEngine:
    """Runs the batched reorder on one device.

    Inputs are host numpy: packed (N, W) uint32 reads and lengths (N,).
    Output: emissions array (M, 4) int32 of (rid, flag, pos_delta, rc) in
    walker-timeline order; see ``assemble_contigs``.
    """

    ordered_emissions = True   # run() returns filtered walker-major rows

    def __init__(self, packed: np.ndarray, lengths: np.ndarray,
                 cfg: ReorderConfig, codes: np.ndarray | None = None,
                 select: np.ndarray | None = None, rows_dev=None):
        """packed: (n, W) uint32 packed rows; lengths: matching lengths.
        With ``select``, packed covers the FULL read set and the engine
        operates on packed[select] (the row gather happens ON DEVICE — a
        host-side fancy-index of 32 MB costs ~1 s on this host's lazily
        faulted memory, and the rows transfer anyway). ``rows_dev`` is an
        already-device-resident (>= max rid + 1, W) row table (from
        DeviceRowStager) — the h2d transfer was overlapped with parse."""
        self.cfg = cfg
        self._rows_dev = rows_dev
        if select is None:
            select = np.arange(packed.shape[0], dtype=np.int32)
            lengths_sel = lengths
        else:
            select = np.ascontiguousarray(select, np.int32)
            lengths_sel = lengths[select]
        self._full = packed
        self._sel = select
        self.N = len(select)              # real read count
        self.W = packed.shape[1]
        self.Lb = self.W * bits.BASES_PER_WORD
        self.Np = padded_n(self.N)
        # enough walkers to keep the device busy, but few enough that seeds
        # don't fragment the contig space: ~256 reads per walker (fewer,
        # longer contigs also shrink the seq stream; the ratio comes from
        # a sweep on the previous accelerator — re-sweep on the H100,
        # ROADMAP 1.1a). An explicit
        # num_walkers below the REORDER_BATCH cap is honored as-is (up to
        # Np/8) so the knob can push B both ways.
        auto = max(8, self.Np // 256)
        self.B = int(min(cfg.num_walkers, auto)
                     if cfg.num_walkers >= P.REORDER_BATCH
                     else min(cfg.num_walkers, max(8, self.Np // 8)))
        self.windows = dct.default_windows(cfg.max_readlen)
        # dictionaries are built ON DEVICE from the packed rows at run()
        # (one lax.sort + placement scatters): the host build cost seconds
        # of numpy sorting plus a host->device copy of its tables
        self._dicts = None
        lengths_p = np.zeros(self.Np, np.int32)
        lengths_p[: self.N] = lengths_sel
        self.lengths = jnp.asarray(lengths_p)
        # the flush program is cached at module level by its static shape
        # signature: a per-engine jax.jit would re-trace the (large) round
        # scan on every compress call (~3 s of pure Python tracing)
        self._round_impl, self._round_fn, self.emit_cap = _flush_program(
            self.Np, cfg.candidates, cfg.shift_chunk, cfg.accept_slots,
            tuple(w.start for w in self.windows), cfg.thresh,
            cfg.far_near,
            int(_os.environ.get("SPRING_TPU_CAP_PER_ROUND", "3")))

    @property
    def dicts(self) -> list[dct.DeviceDict]:
        """Device dictionaries (built lazily from a fresh rows copy when
        accessed outside run() — run() builds from its own state rows)."""
        if getattr(self, "_released", False):
            raise RuntimeError("ReorderEngine used after release()")
        if self._dicts is None:
            self._build_dicts(self._device_rows())
        return self._dicts

    def release(self) -> None:
        """Drop the engine's device residency (dict tables, row table,
        lengths) and mark it unusable: device
        accessors raise after release instead of silently rebuilding from
        nulled state."""
        self._dicts = None
        self._rows_dev = None
        self.lengths = None
        self._full = None
        self._released = True

    def _device_rows(self):
        """Assemble the engine's (Np, W+1) padded row array on device:
        gather packed[select], append the length word with the claimed flag
        (bit 31) pre-set on padding rows (one row gather in the round
        fetches data + length + claimed state).

        Only the rows the select actually reaches are copied to the
        device — the caller's pow2-padded buffer holds up to 2x the real
        bytes (never-written np.empty padding). The slice length is
        rounded up to 1/8-of-octave granules so _assemble_rows keeps a
        few compiled shapes per size bucket, not one per dataset."""
        if getattr(self, "_released", False):
            raise RuntimeError("ReorderEngine used after release()")
        sel_p = np.full(self.Np, -1, np.int32)
        sel_p[: self.N] = self._sel
        if self._rows_dev is not None:
            return _assemble_rows(self._rows_dev, jnp.asarray(sel_p),
                                  self.lengths)
        n_full = self._full.shape[0]
        n_used = int(self._sel.max()) + 1 if self.N else 1
        gran = max(1 << max(int(n_used - 1).bit_length() - 3, 6), 64)
        n_used = min(-(-n_used // gran) * gran, n_full)
        return _assemble_rows(jnp.asarray(self._full[:n_used]),
                              jnp.asarray(sel_p), self.lengths)

    def _build_dicts(self, rows) -> None:
        self._dicts = dct.build_hash_dicts_device(rows, self.N, self.windows)
        for d in self._dicts:
            nd = int(d.dropped)
            if nd:
                import sys
                print(f"[dict] {nd} keys overflowed the hash table and "
                      "were dropped", file=sys.stderr)

    # ---------------- state ----------------

    def _init_state(self):
        B, Lb, Np = self.B, self.Lb, self.Np
        # claimed set as a bitmap: gathers hit a table 32x smaller (cache-
        # resident), scatters become distinct-bit adds. Last word is a
        # scatter dump for inactive lanes.
        nwords = Np // 32 + 2
        claimed = np.zeros(nwords, np.uint32)
        pad = np.zeros(Np, bool)
        pad[self.N:] = True                   # padding reads are never live
        claimed[: Np // 32] = np.packbits(
            pad, bitorder="little").view(np.uint32)
        return dict(
            counts=jnp.zeros((B, Lb), jnp.uint32),
            ref_len=jnp.zeros((B,), jnp.int32),
            active=jnp.zeros((B,), bool),
            shift_base=jnp.zeros((B,), jnp.int32),
            first_rid=jnp.zeros((B,), jnp.int32),
            left_phase=jnp.zeros((B,), bool),
            grew=jnp.zeros((B,), bool),
            claimed=jnp.asarray(claimed),
            queue_pos=jnp.zeros((), jnp.int32),
            rows=self._device_rows(),          # fresh device copy per run
        )

    # ---------------- dictionary compaction ----------------

    def _compact_dicts(self, drids, claimed_dev):
        """Move live entries to the front of every bin (bin starts/counts
        unchanged). Equivalent of the reference's in-bin deletion
        (src/bitset_util.cpp:38-63) — runs entirely on device, with no
        host round-trip of the rids."""
        return [dct.compact_bins_dev(d.keys_dev, r, claimed_dev)
                for d, r in zip(self._dicts, drids)]


# ---------------- the jitted round (module-level, shape-keyed cache) ------

@functools.lru_cache(maxsize=None)
def _flush_program(Np: int, C: int, SC: int, accept_slots: int,
                   starts: tuple, thresh: int, far_near: int = 0,
                   cap_per_round: int = 3):
    """Build (round_impl, jitted flush, emit_cap) for one static shape
    signature. Cached at MODULE level: a per-engine jax.jit would re-trace
    the (large) scanned round on every compress call — ~3 s of pure Python
    tracing per run."""
    D = len(starts)
    # static probe-group list in priority order (shift > orientation >
    # dict — the reference search order, src/reorder.h:479-557). With
    # far_near > 0, shifts past it probe one dictionary (d = s % D): the
    # probe gather's row count is its cost and far-shift probes are its
    # long tail.
    thin = bool(far_near) and far_near < SC and D > 1
    groups = [(s, o, d) for s in range(SC) for o in range(2)
              for d in range(D)
              if not thin or s < far_near or d == s % D]
    G = len(groups)                    # probe groups: (shift, orient, dict)
    g_srel_c = np.array([s for s, o, d in groups], np.int32)
    g_o_c = np.array([o for s, o, d in groups], np.int32)
    g_d_c = np.array([d for s, o, d in groups], np.int32)
    # flat index of group (s, o, d) in the (B, SC, D, 2) query tensor
    g_flat_c = np.array([(s * D + d) * 2 + o for s, o, d in groups],
                        np.int32)
    GSEL = max(1, min(accept_slots, G * C) // C)
    M = GSEL * C

    def round_fn(state, lengths, dkeys, pairs_all, seed_order,
                 n_real, maxshift, rows_tab=None, room=None):
        counts = state["counts"]
        ref_len = state["ref_len"]
        active = state["active"]
        shift_base = state["shift_base"]
        claimed = state["claimed"]
        packed = rows_tab
        if room is None:
            room = jnp.ones(active.shape, bool)
        # a walker whose flush emission buffer is nearly full stalls:
        # it neither searches nor seeds this round (no state advances)
        searching = active & room
        B = counts.shape[0]
        Lb = counts.shape[1]
        Wl = packed.shape[1] - 1
        nwords = Np // 32 + 2
        lp0 = state["left_phase"]

        def claimed_bit(idx):
            w = claimed[idx >> 5]
            return ((w >> (idx & 31).astype(jnp.uint32)) & 1) == 1

        def claim(cond, idx):
            # bitmap only: the packed rows are READ-ONLY (they used to
            # carry a bit-31 claim flag, but the two row scatters + the
            # scan-carry copies of the whole array dominated; verification
            # gathers the cache-resident bitmap instead)
            word = jnp.where(cond, idx >> 5, nwords - 1)
            bit = jnp.where(
                cond, jnp.uint32(1) << (idx & 31).astype(jnp.uint32),
                jnp.uint32(0))
            return claimed.at[word].add(bit)

        frames, s_tot = walker_frames_packed(counts, ref_len,
                                             shift_base, SC)
        q, v = walker_queries(frames, s_tot, ref_len, starts)

        # ---- metadata-only probe: one packed (start|count) sc word per
        # STATIC probe group from ONE stacked-table gather; NO candidate
        # rids are fetched yet: fetching C rids for all G groups eagerly
        # cost more than the whole rest of the round on the previous
        # accelerator, where probe gathers were byte-bound. The group list's order IS the
        # priority (shift > orientation > dict) ----
        Sdict = dkeys.shape[0] // D
        qf = q.reshape(B, SC * D * 2)
        vf = v.reshape(B, SC * D * 2)
        gsel_idx = jnp.asarray(g_flat_c)
        q_g = jnp.take(qf, gsel_idx, axis=1)        # (B, G)
        v_g = jnp.take(vf, gsel_idx, axis=1)
        st_g, ct_g = dct.probe_meta_groups(dkeys, Sdict, q_g, g_d_c)
        ct_g = jnp.where(v_g, ct_g, 0)
        hit_g = (ct_g > 0) & searching[:, None]

        # ---- pick the GSEL best-priority hitting groups; only those
        # fetch candidate rows (one pairs-row gather each) ----
        negp = jnp.where(hit_g, -jnp.arange(G, dtype=jnp.int32)[None, :],
                         -_BIG)
        negg, _ = jax.lax.top_k(negp, GSEL)        # (B, GSEL)
        gok = negg != -_BIG
        g_id = jnp.where(gok, -negg, 0)
        st_sel = jnp.take_along_axis(st_g, g_id, axis=1)
        ct_sel = jnp.where(gok, jnp.take_along_axis(ct_g, g_id, axis=1), 0)
        # per-group fields from tiny static tables (the group list may be
        # thinned, so arithmetic decode no longer applies)
        d_sel = jnp.asarray(g_d_c)[g_id]
        o_sel = jnp.asarray(g_o_c)[g_id]
        srel = jnp.asarray(g_srel_c)[g_id]
        nprow = Np // 8
        rowid = d_sel * nprow + (st_sel >> 3)
        both = pairs_all[jnp.clip(rowid, 0, D * nprow - 1).reshape(-1)]
        both = both.reshape(B, GSEL, 16)
        off = st_sel & 7
        candg = both[:, :, :C]
        for o in range(1, 8):
            candg = jnp.where((off == o)[:, :, None],
                              both[:, :, o:o + C], candg)
        vcand = (jnp.arange(C, dtype=jnp.int32)[None, None, :]
                 < jnp.minimum(ct_sel, C)[:, :, None]) & gok[:, :, None]
        cand_m = candg.reshape(B, M)
        valid_m = (vcand & (candg >= 0)).reshape(B, M)
        # per-slot fields are pure arithmetic on the group id — no
        # per-element table gathers
        co = jnp.arange(C, dtype=jnp.int32)[None, None, :]
        k_o_m = jnp.broadcast_to(
            o_sel[:, :, None], (B, GSEL, C)).reshape(B, M)
        k_frame_m = jnp.broadcast_to(
            (srel * 2 + o_sel)[:, :, None], (B, GSEL, C)).reshape(B, M)
        s_m = shift_base[:, None] + jnp.broadcast_to(
            srel[:, :, None], (B, GSEL, C)).reshape(B, M)
        pr_m = (g_id[:, :, None] * C + co).reshape(B, M)

        # ---- verify: ONE (B, M) row gather + masked popcounts ----
        safe = jnp.clip(cand_m, 0, Np - 1)
        rows = packed[safe]                        # (B, M, W+1)
        lw = rows[..., Wl]
        claimed_row = claimed_bit(safe)
        clen = (lw & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        rl = ref_len[:, None]
        lo = jnp.where(k_o_m == 0, 0, s_m)
        hi = jnp.where(k_o_m == 0, jnp.minimum(rl - s_m, clen),
                       jnp.minimum(rl + s_m, clen))
        t = jnp.where(k_o_m == 0, s_m, rl + s_m - clen)
        fr2 = frames.reshape(B, 2 * SC, -1)
        frow = jnp.take_along_axis(fr2, k_frame_m[:, :, None], axis=1)
        ham = jnp.zeros((B, M), jnp.int32)
        for w in range(Wl):
            d = frow[..., w] ^ rows[..., w]
            mm = (d | (d >> 1)) & _ODD
            mw = _prefix_word(jnp.clip(hi - 16 * w, 0, 16)) \
                & ~_prefix_word(jnp.clip(lo - 16 * w, 0, 16))
            ham = ham + jax.lax.population_count(mm & mw).astype(
                jnp.int32)
        ok = valid_m & ~claimed_row & (ham <= thresh) \
            & (t >= 0) & (hi > lo)

        # ---- batch accept: dedup rids within the walker (a read found
        # via both dicts appears twice), then order accepts by t so the
        # per-round emission deltas chain like sequential accepts.
        # Multi-operand lexicographic lax.sorts carry every per-slot
        # field through the permutation — no take_along_axis gathers ----
        rid_eff = jnp.where(ok, cand_m, _BIG)
        slot_i = jnp.broadcast_to(
            jnp.arange(M, dtype=jnp.int32)[None, :], (B, M))
        rid_s, _, t_s, ko_s, clen_s, slot_s = jax.lax.sort(
            (rid_eff, pr_m, t, k_o_m, clen, slot_i),
            dimension=1, num_keys=2)
        firsts = jnp.concatenate(
            [jnp.ones((B, 1), bool), rid_s[:, 1:] != rid_s[:, :-1]],
            axis=1)
        keep_s = (rid_s != _BIG) & firsts
        tkey = jnp.where(keep_s, t_s, _BIG)
        (_, _, keep_f, rid_f, t_f, ko_f, clen_f, slot_f) = jax.lax.sort(
            (tkey, rid_s, keep_s, rid_s, t_s, ko_s, clen_s, slot_s),
            dimension=1, num_keys=2)
        rows_f = jnp.take_along_axis(rows, slot_f[:, :, None], axis=1)

        # ---- cross-walker conflicts: first walker per rid wins ----
        win = resolve_conflicts(keep_f.reshape(-1),
                                rid_f.reshape(-1)).reshape(B, M)
        matched_any = win.any(axis=1)
        t_roll = jnp.max(jnp.where(win, t_f, 0), axis=1)

        # ---- batched consensus update (updaterefcount semantics,
        # src/reorder.h:110-220, applied to the whole accepted set:
        # roll to the last accepted read's start, add each accepted
        # read's one-hot at its relative offset) ----
        left_phase = lp0
        first_rid = state["first_rid"]
        live = jnp.arange(Lb)[None, :] < ref_len[:, None]
        rolled0 = _roll_words(jnp.where(live, counts, jnp.uint32(0)),
                              t_roll)
        len0 = jnp.maximum(ref_len - t_roll, 0)

        # all M slots at once (a fori_loop here paid per-op overhead on
        # every slot; the batched form is a handful of (B, M, ·) fusions
        # XLA reduces over M in place)
        pk_all = rows_f[..., :Wl]                        # (B, M, W)
        pk_all = jnp.where((ko_f == 1)[:, :, None],
                           bits.revcomp_packed(pk_all, clen_f), pk_all)
        d_all = jnp.where(win, t_roll[:, None] - t_f, 0)  # (B, M)
        pk_all = bits.shift_bases_left(pk_all, d_all, Lb)
        codes_all = bits.unpack(pk_all, Lb)               # (B, M, Lb)
        len_all = jnp.where(win, clen_f - d_all, 0)
        inc = _lane_inc(codes_all, len_all).sum(axis=1)   # (B, Lb) u32
        rolled = _sat_add(rolled0, inc)
        new_len = jnp.maximum(len0, len_all.max(axis=1))
        counts = jnp.where(matched_any[:, None], rolled, counts)
        ref_len = jnp.where(matched_any, new_len, ref_len)
        claimed = claim(win.reshape(-1),
                        jnp.clip(rid_f, 0, Np - 1).reshape(-1))
        shift_base = jnp.where(matched_any, 0, shift_base)

        # walkers that found nothing advance their shift window; an
        # exhausted forward walker whose contig GREW restarts leftward
        # from the contig's first read, reverse-complemented (reference
        # left search, src/reorder.h:562-571); an exhausted left walker
        # dies. A walker still alone on its seed skips the left phase
        # entirely — re-scanning the RC'd seed rarely finds what the
        # forward scan's rc-orient probes missed, and singleton deaths
        # dominate the endgame rounds (~1/3 of all rounds at 10M); a
        # missed left-pair costs only a stitchable contig split.
        grew = state["grew"] | matched_any
        missed = searching & ~matched_any
        shift_base = jnp.where(missed, shift_base + SC, shift_base)
        death = missed & (shift_base > maxshift)
        start_left = death & ~left_phase & grew
        active = active & ~(death & (left_phase | ~grew))
        left_phase = left_phase | start_left
        shift_base = jnp.where(start_left, 0, shift_base)
        fr_rows = packed[jnp.clip(first_rid, 0, Np - 1)]
        fr_len = (fr_rows[:, Wl] & jnp.uint32(0x7FFFFFFF)
                  ).astype(jnp.int32)
        fr_rc = bits.revcomp_packed(fr_rows[:, :Wl], fr_len)
        fr_counts = _lane_inc(bits.unpack(fr_rc, Lb), fr_len)
        counts = jnp.where(start_left[:, None], fr_counts, counts)
        ref_len = jnp.where(start_left, fr_len, ref_len)

        # seeding: inactive walkers take the next unclaimed queue reads
        # (reference picks from remainingreads, src/reorder.h:570-592)
        inactive = ~active & room
        rank = jnp.cumsum(inactive) - 1
        qidx = state["queue_pos"] + rank
        in_range = inactive & (qidx < n_real)
        seed_rid = seed_order[jnp.clip(qidx, 0, Np - 1)]
        ok_seed = in_range & ~claimed_bit(seed_rid)
        claimed = claim(ok_seed, seed_rid)
        seed_cnt = _lane_inc(bits.unpack(packed[seed_rid], Lb),
                             lengths[seed_rid])
        counts = jnp.where(ok_seed[:, None], seed_cnt, counts)
        ref_len = jnp.where(ok_seed, lengths[seed_rid], ref_len)
        shift_base = jnp.where(ok_seed, 0, shift_base)
        active = active | ok_seed
        left_phase = jnp.where(ok_seed, False, left_phase)
        grew = jnp.where(ok_seed, False, grew)
        first_rid = jnp.where(ok_seed, seed_rid, first_rid)
        queue_pos = state["queue_pos"] + jnp.sum(in_range)

        # emissions: (B, M+1, 2) int32 — slot 0 seeds (flag 0), slots
        # 1..M the t-ordered accepted reads with within-round position
        # deltas. Packed to 8 B/slot (word0 rid, word1 delta|flag|rc)
        # to halve the device->host transfer (built for a slow link; kept
        # until measured on the H100, ROADMAP 3.2)
        tw = jnp.where(win, t_f, 0)
        cm = jax.lax.cummax(tw, axis=1)
        prev = jnp.concatenate(
            [jnp.zeros((B, 1), tw.dtype), cm[:, :-1]], axis=1)
        delta = tw - prev
        flagv = jnp.where(lp0[:, None], 2, 1)
        meta = jnp.where(win, delta + (flagv << 16) + (ko_f << 24), 0)
        emit_m = jnp.stack([jnp.where(win, rid_f, -1), meta], axis=-1)
        zero = jnp.zeros((B,), jnp.int32)
        emit_seed = jnp.stack(
            [jnp.where(ok_seed, seed_rid, -1), zero],
            axis=-1)[:, None, :]
        emit = jnp.concatenate([emit_seed, emit_m], axis=1)

        new_state = dict(counts=counts, ref_len=ref_len, active=active,
                         shift_base=shift_base, first_rid=first_rid,
                         left_phase=left_phase, grew=grew,
                         claimed=claimed, queue_pos=queue_pos)
        return new_state, emit.astype(jnp.int32)

    S = M + 1
    # buffer slots per walker per flush: accepts/round scale with the
    # probed shift span (~3 per 16 shifts at 20-50x coverage); an
    # undersized CAP silently stalls every walker for the tail of each
    # flush (measured: SC=32 with the SC=16 CAP gained nothing).
    # SPRING_TPU_CAP_PER_ROUND raises the budget — bursty walkers (high
    # local coverage) otherwise stall out the flush tail.
    CAP = FLUSH_ROUNDS * max(cap_per_round, cap_per_round * SC // 16) + S

    def flush_fn(state, lengths, dkeys, pairs_all, seed_order,
                 n_real, maxshift, rows_tab):
        # FLUSH_ROUNDS rounds in ONE dispatch — per-call dispatch latency
        # would otherwise dominate.
        # Per-round emissions are stacked by the scan (a cheap contiguous
        # dynamic-update-slice), compacted per walker with a stable sort
        # that pushes empty slots to the back, then ONE scatter packs the
        # walker regions into a dense global prefix so the host fetches
        # only ~emitted rows instead of CAP slots per walker. (A per-round
        # scatter into a carried buffer was slower on the previous
        # accelerator, whose scatter lowering the sort avoids; emission compaction is kept
        # until measured on the H100, ROADMAP 3.2/3.3.) A walker whose
        # buffer is nearly full stalls until the next flush.
        B = state["counts"].shape[0]
        cnt0 = jnp.zeros((B,), jnp.int32)

        def body(carry, _):
            st, cnt = carry
            room = cnt < CAP - S
            st2, emit = round_fn(st, lengths, dkeys, pairs_all,
                                 seed_order, n_real, maxshift, rows_tab,
                                 room)
            cnt = cnt + jnp.sum(emit[:, :, 0] >= 0, axis=1)
            return (st2, cnt), emit

        (state, cnt), ys = jax.lax.scan(
            body, (state, cnt0), None, length=FLUSH_ROUNDS)
        em = jnp.moveaxis(ys, 0, 1).reshape(B, FLUSH_ROUNDS * S, 2)
        empty = (em[:, :, 0] < 0).astype(jnp.int32)
        _, w0, w1 = jax.lax.sort(
            (empty, em[:, :, 0], em[:, :, 1]), dimension=1, num_keys=1)
        # dense prefix: walker w's first cnt[w] compacted slots move to
        # [base[w], base[w]+cnt[w]) — walker-major, slot order kept
        base = jnp.cumsum(cnt) - cnt
        s_idx = jnp.arange(CAP, dtype=jnp.int32)[None, :]
        fill2 = s_idx < cnt[:, None]
        dst2 = jnp.where(fill2, base[:, None] + s_idx, B * CAP).reshape(-1)
        dense = jnp.full((B * CAP + 1, 2), -1, jnp.int32)
        dense = dense.at[dst2].set(
            jnp.stack([w0[:, :CAP].reshape(-1),
                       w1[:, :CAP].reshape(-1)], axis=-1))
        # per-flush stats as ONE tiny transfer instead of pulling the
        # claimed bitmap every flush (bitmap cadence kept until measured on
        # the H100, ROADMAP 3.2)
        stats = jnp.stack([
            jnp.sum(jax.lax.population_count(
                state["claimed"][: Np // 32])).astype(jnp.int32),
            state["queue_pos"],
            jnp.sum(state["active"]).astype(jnp.int32),
            jnp.sum(cnt)])
        return state, dense, cnt, stats

    return round_fn, jax.jit(flush_fn, donate_argnums=(0,)), CAP


@functools.partial(jax.jit, donate_argnums=(0,))
def _dus_pairs(out, seg, row0):
    return jax.lax.dynamic_update_slice(out, seg, (row0, 0))


_PAIRS_SEG_ROWS = 1 << 21


@functools.partial(jax.jit, static_argnums=(2,))
def _pairs_seg(rids, row0, rows: int):
    """Pair rows [row0, row0+rows) of one dict's bin array: row i holds
    rids[8i : 8i+16] (-1 past the end). Segmented because the whole-dict
    program's internal (n/8, 16) temps got T(8,128)-tiled layouts on the
    previous accelerator — 8x padding; 2M-row segments bound that. Layout
    workaround kept until measured on the H100 (ROADMAP 3.3)."""
    idx = ((row0 + jnp.arange(rows, dtype=jnp.int32))[:, None] * 8
           + jnp.arange(16, dtype=jnp.int32)[None, :])
    n = rids.shape[0]
    out = rids[jnp.minimum(idx, n - 1)]
    return jnp.where(idx >= n, jnp.asarray(-1, rids.dtype), out)


@functools.lru_cache(maxsize=None)
def _take_prefix_fn(k: int):
    """Jitted static-size prefix slice (pow2-bucketed so a run compiles a
    handful of variants): fetch only the filled rows of a flush's dense
    emission buffer."""
    return jax.jit(
        lambda a: jax.lax.dynamic_slice_in_dim(a, 0, k, axis=0))


def _engine_run(self, progress=None) -> np.ndarray:
        """Returns emissions (n_emitted, 4) int32 rows of
        (rid, flag, pos_delta, rc), WALKER-MAJOR (each walker's timeline is
        contiguous, flushes concatenated in time order), empty slots already
        filtered out."""
        import os
        import time
        trace = os.environ.get("SPRING_TPU_TRACE")
        _t0 = time.time()
        state = self._init_state()
        # the packed rows are READ-ONLY in the round: they ride every
        # flush as a non-donated argument instead of a scan carry
        rows_tab = state.pop("rows")
        jax.block_until_ready(rows_tab)
        # the staged pre-gather row table (rows_dev) is folded into
        # rows_tab now — drop the reference so it frees before the
        # dictionary builds run their temps
        self._rows_dev = None
        _t1 = time.time()
        self._build_dicts(rows_tab)
        # both dicts' compact tables stacked: ONE probe gather per round.
        # The stacked copy is the only one the round reads — drop the
        # per-dict tables. PJRT allocates an execution's outputs at
        # ENQUEUE time, so past 2^26 reads each step blocks before the
        # next dispatch: without the barriers the concat/pairs outputs
        # were co-resident with every input and ran a 16 GB device out
        # of memory at 100M reads (kept until measured on the H100,
        # ROADMAP 3.3).
        big = self.Np > (1 << 26)
        dkeys = jnp.concatenate([d.btab for d in self._dicts], axis=0)
        if big:
            jax.block_until_ready(dkeys)
        for d in self._dicts:
            d.btab = None
        drids1 = [d.rids for d in self._dicts]

        # stacked overlapping pair rows (dict d at row offset d*Np/8):
        # the round's bin fetch is ONE row gather across both dicts.
        # Built per dict into a donated preallocated output — one fused
        # all-dict gather program's temps did not fit beside the 100M
        # tables on a 16 GB device (and eager 2-D concats picked tiled
        # layouts that pad the 16-wide minor dim 8x there)
        def build_pairs(drids):
            nprow = self.Np // 8
            out = jnp.zeros((len(drids) * nprow, 16), jnp.int32)
            SEG = _PAIRS_SEG_ROWS
            for di, r in enumerate(drids):
                starts = (list(range(0, nprow - SEG, SEG))
                          + [max(nprow - SEG, 0)]) if nprow > SEG else [0]
                for s0 in starts:
                    rows_n = min(SEG, nprow)
                    p = _pairs_seg(r, jnp.asarray(s0, jnp.int32), rows_n)
                    out = _dus_pairs(
                        out, p, jnp.asarray(di * nprow + s0, jnp.int32))
                    if big:
                        # enqueue-time allocation: unsynced segments
                        # would co-resident their temps
                        jax.block_until_ready(out)
            return out

        pairs_all = build_pairs(drids1)
        if trace:
            print(f"[trace] reorder init: state {_t1 - _t0:.3f}s dicts "
                  f"{time.time() - _t1:.3f}s", flush=True)
        lengths = self.lengths
        # strided seed order: the first B seeds land evenly spread over the
        # input so concurrent walkers claim distinct regions even when the
        # input happens to be genome-ordered
        stride = max(self.N // self.B, 1)
        idx = np.arange(self.N, dtype=np.int32)
        so = (np.concatenate([idx[r::stride] for r in range(stride)])
              if self.N else idx)
        so = np.concatenate(
            [so, np.full(self.Np - len(so), self.Np - 1, np.int32)])
        queue = so[: self.N].astype(np.int32)   # real rids only, no padding
        n_real = jnp.asarray(len(queue), jnp.int32)
        seed_order = jnp.asarray(so.astype(np.int32))
        maxshift = jnp.asarray(self.cfg.max_shift, jnp.int32)
        chunks = []
        last_claimed = 0
        rounds = accepts = seeds = 0
        LAST_RUN_STATS.clear()
        t_start = time.time()

        def dispatch():
            nonlocal state
            state, dense, cnt, stats = self._round_fn(
                state, lengths, dkeys, pairs_all, seed_order, n_real,
                maxshift, rows_tab)
            for a in (cnt, stats):
                try:
                    a.copy_to_host_async()
                except Exception:
                    pass
            return dense, cnt, stats

        cap_rows = self.B * self.emit_cap

        def fetch(dense_k, cnt_k, emitted):
            """Enqueue the device slice + async d2h of flush k's filled
            emission rows (pow2-bucketed size: a handful of compiled
            slice variants per run, ~emitted rows on the wire instead of
            the whole B*CAP buffer)."""
            p2 = min(max(64, 1 << max(emitted - 1, 1).bit_length()),
                     cap_rows)
            em_dev = _take_prefix_fn(p2)(dense_k)
            try:
                em_dev.copy_to_host_async()
            except Exception:
                pass
            LAST_RUN_STATS["emit_mb"] = round(
                LAST_RUN_STATS.get("emit_mb", 0.0) + p2 * 8 / 1e6, 1)
            return em_dev, np.asarray(cnt_k), emitted

        def harvest(em_dev, cnt_np, emitted):
            """(walker, rid, word) triples for one flush — walker column
            reconstructed from the per-walker counts (the dense prefix is
            walker-major with slot order preserved)."""
            em = np.asarray(em_dev)[:emitted]
            out = np.empty((emitted, 3), np.int32)
            out[:, 0] = np.repeat(
                np.arange(len(cnt_np), dtype=np.int32), cnt_np)
            out[:, 1:] = em
            return out

        # pipelined loop: flush k+1 is DISPATCHED before flush k's stats
        # are read, so the device runs flushes back to back while the host
        # processes results one flush behind; emission prefixes are
        # harvested one MORE flush behind so their d2h overlaps compute.
        # The one speculative flush after the exit condition runs on a
        # finished state (no live walkers, queue drained) and emits
        # nothing. Compaction decisions lag one flush — harmless, claims
        # are monotone.
        inflight = dispatch()
        fetch_q = []
        while True:
            t0 = time.time()
            nxt = dispatch()
            dense_k, cnt_k, stats_k = inflight
            inflight = nxt
            # ONE small transfer syncs flush k (k+1 is already running);
            # the claimed bitmap is pulled only when seed-queue
            # compaction triggers
            stats_np = np.asarray(stats_k)
            if int(stats_np[3]):
                fetch_q.append(fetch(dense_k, cnt_k, int(stats_np[3])))
            while len(fetch_q) > 1:
                chunks.append(harvest(*fetch_q.pop(0)))
            n_claimed = int(stats_np[0]) - (self.Np - self.N)
            queue_pos = int(stats_np[1])
            any_active = stats_np[2] > 0
            emitted = int(stats_np[3])
            rounds += FLUSH_ROUNDS
            if trace:
                from ..pipeline.short_mode import _vm
                rss, hwm = _vm()
                print(f"[trace] reorder flush r={rounds} "
                      f"{time.time() - t0:.3f}s claimed={n_claimed} "
                      f"emitted={emitted} q={queue_pos}/{int(n_real)} "
                      f"rss={rss:.2f}G hwm={hwm:.2f}G", flush=True)
            if progress is not None:
                progress(n_claimed, self.N)
            if (queue_pos >= int(n_real) and not any_active
                    and (emitted == 0 or n_claimed >= self.N)):
                break
            if n_claimed - last_claimed > REBUILD_FRACTION * max(self.N, 1):
                tc = time.time()
                drids1 = self._compact_dicts(drids1, state["claimed"])
                # drop this loop's ref to the old pairs before building
                # the new ones (the in-flight flush may still pin them,
                # but one less reference frees them the moment it lands)
                pairs_all = None
                pairs_all = build_pairs(drids1)
                last_claimed = n_claimed
                if trace:
                    jax.block_until_ready(pairs_all)
                    print(f"[trace] reorder dict-compact "
                          f"{time.time() - tc:.3f}s", flush=True)
            # compact the seed queue: drop already-claimed reads so the
            # endgame doesn't burn rounds skipping them one walker-batch
            # at a time (95% of reads are claimed within a few flushes).
            # The queue always holds every unclaimed read, so the trigger
            # (live queue half-consumed) needs no bitmap transfer.
            if (queue_pos > 0 and n_claimed < self.N
                    and self.N - n_claimed < 0.5 * int(n_real)):
                tq = time.time()
                claimed_np = np.unpackbits(
                    np.asarray(state["claimed"])[: self.Np // 32]
                    .view(np.uint8), bitorder="little")[: self.N]
                remaining = queue[~claimed_np[queue].astype(bool)]
                if not len(remaining):
                    # stats lag one flush: every queued read is already
                    # claimed — skip the pointless seed-order re-upload
                    queue = remaining
                    continue
                queue = remaining
                seed_order = jnp.asarray(np.concatenate([
                    remaining,
                    np.full(self.Np - len(remaining), self.Np - 1,
                            np.int32)]).astype(np.int32))
                n_real = jnp.asarray(len(remaining), jnp.int32)
                state["queue_pos"] = jnp.zeros((), jnp.int32)
                if trace:
                    print(f"[trace] reorder queue-compact "
                          f"{time.time() - tq:.3f}s "
                          f"({len(remaining)} left)", flush=True)
        _t2 = time.time()
        # drain the speculative in-flight flush (its rounds found nothing
        # but its buffer must be harvested for ordering consistency) and
        # any emission prefixes still in the fetch queue
        dense_k, cnt_k, stats_k = inflight
        emitted_tail = int(np.asarray(stats_k)[3])
        if emitted_tail:
            fetch_q.append(fetch(dense_k, cnt_k, emitted_tail))
        for f in fetch_q:
            chunks.append(harvest(*f))
        del fetch_q[:]
        _t3 = time.time()
        dt = time.time() - t_start
        out = _emissions_from_chunks(chunks)
        LAST_RUN_STATS.update(
            rounds=rounds, flush_wall_s=round(dt, 3),
            ms_per_round=round(1000 * dt / max(rounds, 1), 2),
            emitted=int(len(out)), walkers=self.B)
        if trace:
            print(f"[trace] reorder tail: last-buf {_t3 - _t2:.3f}s "
                  f"assemble {time.time() - _t3:.3f}s", flush=True)
        if trace:
            accepts = int((out[:, 1] > 0).sum())
            seeds = int((out[:, 1] == 0).sum())
            print(f"[trace] reorder done: {rounds} rounds {dt:.2f}s "
                  f"({1000 * dt / max(rounds, 1):.1f} ms/round) "
                  f"accepts={accepts} seeds={seeds}", flush=True)
        return out


ReorderEngine.run = _engine_run


def _compact_emit(buf: np.ndarray) -> np.ndarray:
    """One flush's (B, CAP, 2) emit buffer -> (k, 3) int32 rows of
    (walker, rid, word), slot order preserved per walker. Keeping flushes
    compacted bounds run() host memory by total accepts, not
    flushes x buffer size (52 MB/flush at B=64k)."""
    w, s = np.nonzero(buf[:, :, 0] >= 0)
    out = np.empty((len(w), 3), np.int32)
    out[:, 0] = w
    out[:, 1] = buf[w, s, 0]
    out[:, 2] = buf[w, s, 1]
    return out


def _emissions_from_chunks(chunks: list[np.ndarray]) -> np.ndarray:
    """Compacted per-flush triples -> filtered walker-major (k, 4) rows of
    (rid, flag, pos_delta, rc).

    Each chunk is already walker-sorted (np.nonzero is row-major), so the
    walker-major timeline is an O(n) stable MERGE of sorted runs — a
    stable argsort over all rows cost ~19 s at 10M reads on this host."""
    chunks = [c for c in chunks if len(c)]
    if not chunks:
        return np.empty((0, 4), np.int32)
    B = int(max(c[:, 0].max() for c in chunks)) + 1
    counts = [np.bincount(c[:, 0], minlength=B) for c in chunks]
    total = np.sum(counts, axis=0)
    starts = np.zeros(B, np.int64)
    np.cumsum(total[:-1], out=starts[1:])
    n = int(total.sum())
    em3 = np.empty((n, 3), np.int32)
    prior = np.zeros(B, np.int64)
    for c, cnt in zip(chunks, counts):
        w = c[:, 0]
        cstart = np.zeros(B, np.int64)
        np.cumsum(cnt[:-1], out=cstart[1:])
        within = np.arange(len(w), dtype=np.int64) - cstart[w]
        em3[starts[w] + prior[w] + within] = c
        prior += cnt
    # unpack word = delta | flag<<16 | rc<<24
    out = np.empty((n, 4), np.int32)
    out[:, 0] = em3[:, 1]
    out[:, 1] = (em3[:, 2] >> 16) & 0xFF
    out[:, 2] = em3[:, 2] & 0xFFFF
    out[:, 3] = (em3[:, 2] >> 24) & 0xFF
    return out


def assemble_contigs(emissions: np.ndarray, num_walkers: int = 0,
                     lengths: np.ndarray | None = None,
                     slots: int = 1,
                     ordered: bool = False) -> list[dict[str, np.ndarray]]:
    """Group round-major emissions into per-contig read lists.

    Returns a list of contigs, each a dict with:
      rids: (k,) int32 read ids in contig order (position-sorted)
      pos:  (k,) int64 read start offsets within the contig (min = 0)
      rc:   (k,) uint8 orientation flags
    Contig order is walker-major then time (the reference concatenates
    per-thread shards the same way, src/reorder.h:703-728). Left-phase
    emissions (flag 2) are reads matched against the reverse complement of
    the contig's first read — their coordinates fold back as
    o = len(first) - q - len(read) with orientation flipped.
    """
    if ordered:
        # already a filtered walker-major stream: every walker timeline
        # starts with its seed (flag 0), so contig segmentation alone works
        cols = [emissions] if len(emissions) else []
    else:
        R = emissions.shape[0] // (num_walkers * slots)
        em = emissions.reshape(R, num_walkers, slots, 4)
        cols = []
        for w in range(num_walkers):
            col = em[:, w].reshape(-1, 4)
            col = col[col[:, 0] >= 0]
            if len(col):
                cols.append(col)
    contigs = []
    for col in cols:
        starts = np.nonzero(col[:, 1] == 0)[0]
        bounds = np.append(starts, len(col))
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = col[a:b]
            right = seg[seg[:, 1] != 2]
            left = seg[seg[:, 1] == 2]
            pos = np.cumsum(right[:, 2].astype(np.int64))
            pos -= pos[0]
            rids = right[:, 0].astype(np.int32)
            rcs = right[:, 3].astype(np.uint8)
            if len(left):
                if lengths is None:
                    raise ValueError("left-phase emissions need lengths")
                l0 = int(lengths[rids[0]])
                q = np.cumsum(left[:, 2].astype(np.int64))
                lr = left[:, 0].astype(np.int32)
                o = l0 - q - lengths[lr].astype(np.int64)
                rids = np.concatenate([rids, lr])
                pos = np.concatenate([pos, o])
                rcs = np.concatenate([rcs,
                                      (1 - left[:, 3]).astype(np.uint8)])
            pos = pos - pos.min()
            order = np.argsort(pos, kind="stable")
            contigs.append(dict(rids=rids[order], pos=pos[order],
                                rc=rcs[order]))
    return contigs
