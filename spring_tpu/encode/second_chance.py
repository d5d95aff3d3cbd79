"""Second-chance alignment: place leftover reads against the consensus.

Reference analog: the encoder's singleton re-alignment — dictionaries are
built over the unplaced reads (singletons + N-containing reads, 3-bit
bitsets so N never matches) and every contig position probes them, accepting
Hamming <= THRESH_ENCODER=24 (src/encoder.h:242-351, dicts at
src/encoder.h:610-624).

Accelerator-first design: the roles are flipped relative to the reference —
ONE sliding-window hash dict is built (on device) over every consensus 16-mer,
and each oriented leftover read probes it at its 16-aligned windows (an
error in one window still matches via another), verifying candidates with
N-masked packed popcounts. Work scales with the leftover-read count, not
the consensus length. N bases ride along as a second 2-bit plane that
forces a mismatch. Ambiguity resolves by a per-read min over candidates
(lowest position, forward preferred). No iteration, no locks.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import params as P
from ..io import packing
from ..ops import bits
from ..reorder import dictionary as dct

_ODD = jnp.uint32(0x55555555)
_BIG = jnp.iinfo(jnp.int32).max
CANDS = 8
WINDOWS = (0, 16)    # minimum window set (reads >= 32 bases)


def windows_for(max_len: int) -> tuple[int, ...]:
    """Read-local key windows, 16-base aligned (the verify funnel shifts
    are word-aligned), spread across the read so a read stays placeable
    unless EVERY window carries an error. The reference uses two 21-base
    windows at 0-20/21-41 (src/encoder.h:610-620); at 1% error four
    16-mers miss ~0.05% of reads vs ~3.6% for the reference pair."""
    ws = [0, 16]
    for st in (32, 48):
        if max_len >= st + 16:
            ws.append(st)
    return tuple(ws)




_PAD = 16        # leading pad bases so window word -1 is addressable


@jax.jit
def _assemble_sc_rows(pk, nm_f, nm_r, lens):
    """Device assembly of the (2*k2, 2W+1) oriented verify rows from packed
    forward rows + N-mask planes: rc rows via packed revcomp, masks via the
    host-reversed plane (revcomp would complement mask lanes)."""
    rcpk = bits.revcomp_packed(pk, lens)
    lw = lens.astype(jnp.uint32)[:, None]
    fwd = jnp.concatenate([pk, nm_f, lw], axis=1)
    rcr = jnp.concatenate([rcpk, nm_r, lw], axis=1)
    return jnp.concatenate([fwd, rcr], axis=0)


@functools.partial(jax.jit, static_argnums=(5, 6, 7))
def _match_reads(seq_j, btab, rids, rows_j, total_j, W: int,
                 thresh: int, windows: tuple = WINDOWS,
                 exclude=None, rcbit=None):
    """Each oriented leftover read probes the consensus sliding-window
    dict at its 16-aligned windows and Hamming-verifies the candidate
    placements in place. ONE dispatch, no scatter, and work scales with
    the number of LEFTOVER reads (~1e5), not consensus positions (~1e7) —
    the previous positions-probe-read-dicts orientation gathered candidate
    rows for every consensus position at a ~1% hit rate (gather-bound).

    Returns (nr,) per-row best = min(pos<<1 | rc) or _BIG (the caller
    min-folds the rc half onto the forward half; ``rcbit`` marks rc rows
    so row chunks can be dispatched separately — the whole-set program's
    candidate-row intermediates exhausted a 16 GB device at 10M
    reads)."""
    nr = rows_j.shape[0]
    nwords = seq_j.shape[0]
    clen = rows_j[:, 2 * W].astype(jnp.int32)
    if rcbit is None:
        rcbit = (jnp.arange(nr, dtype=jnp.int32)
                 >= nr // 2).astype(jnp.int32)
    best = jnp.full((nr,), _BIG, jnp.int32)
    for st in windows:
        key = rows_j[:, st // 16]            # windows are 16-aligned
        cand, hit = dct.probe_hash(btab, rids, key, CANDS)  # (nr, C) pos
        q = cand - st                        # candidate read start in seq
        okc = (hit & (q >= 0) & ((q + clen[:, None]) <= total_j)
               & ((st + dct.KEY_BASES) <= clen)[:, None])
        if exclude is not None:
            # self-placement veto (contig stitching probes its own head)
            okc &= q != exclude[:, None]
        wi = (q >> 4) + (_PAD // 16)
        r2 = (2 * (q & 15)).astype(jnp.uint32)
        # fetch the W+1 consensus words per candidate as K 8-wide row
        # gathers + an offset select chain (the per-word single-element
        # gathers this replaces paid per element, ~2x the whole match).
        # K covers offset 7 + W+1 words: two rows suffice only for
        # W <= 8 (reads <= 128 bases); longer reads need a third.
        k8 = -(-(W + 8) // 8)
        s8 = seq_j.reshape(-1, 8)
        nrows8 = s8.shape[0]
        b0 = jnp.clip(wi >> 3, 0, nrows8 - k8)
        both = jnp.concatenate(
            [s8[b0.reshape(-1) + i] for i in range(k8)],
            axis=-1).reshape(*wi.shape, 8 * k8)
        woff = wi & 7
        wrows = both[..., : W + 1]
        for o in range(1, 8):
            wrows = jnp.where((woff == o)[..., None],
                              both[..., o: o + W + 1], wrows)
        ham = jnp.zeros(cand.shape, jnp.int32)
        for w in range(W):
            lo = wrows[..., w]
            hi = wrows[..., w + 1]
            fw = jnp.where(r2 > 0, (lo >> r2) | (hi << (32 - r2)), lo)
            dd = fw ^ rows_j[:, w][:, None]
            m = ((dd | (dd >> 1)) | rows_j[:, W + w][:, None]) & _ODD
            k = jnp.clip(clen[:, None] - 16 * w, 0, 16)
            full = jnp.uint32(0xFFFFFFFF) >> (
                32 - 2 * jnp.clip(k, 1, 16)).astype(jnp.uint32)
            mw = jnp.where(k > 0, full, jnp.uint32(0))
            ham = ham + jax.lax.population_count(m & mw).astype(jnp.int32)
        okc &= ham <= thresh
        val = jnp.where(okc, (q << 1) | rcbit[:, None], _BIG)
        best = jnp.minimum(best, jnp.min(val, axis=1))
    return best


def align_leftovers_packed(seq_codes: np.ndarray, pk: np.ndarray,
                           nm_f: np.ndarray, nm_r: np.ndarray,
                           lengths: np.ndarray,
                           thresh: int = P.THRESH_ENCODER,
                           exclude: np.ndarray | None = None
                           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Try to place each read on the consensus, packed-domain input.

    pk: (n, W) packed 2-bit rows (N packed as A); nm_f/nm_r: packed N-mask
    planes, forward and length-reversed (NOverlay.nmask_planes). Returns
    (gpos, rc, placed) per input read; gpos is the start of the oriented
    read in seq coordinates, -1 if unplaced.
    """
    import os
    import time
    trace = os.environ.get("SPRING_TPU_TRACE")
    _t = time.time()

    def mark(stage):
        nonlocal _t
        if trace:
            now = time.time()
            print(f"[trace] sc.{stage}: {now - _t:.2f}s", flush=True)
            _t = now

    n = len(pk)
    out_pos = np.full(n, -1, np.int64)
    out_rc = np.zeros(n, np.uint8)
    total = len(seq_codes)
    if n == 0 or total < dct.KEY_BASES:
        return out_pos, out_rc, out_pos >= 0

    windows = windows_for(int(lengths.max()) if n else 32)
    W = pk.shape[1]
    # pow2-pad; the oriented rows (fwd half [0, k2), rc half [k2, 2*k2))
    # are assembled ON DEVICE — the old byte-codes path unpacked, host-
    # revcomp'd and repacked every leftover read (~20 s at 10M reads)
    k2 = max(1 << max(n - 1, 1).bit_length(), 64)

    def pad(a, dtype=np.uint32):
        out = np.zeros((k2, a.shape[1]), dtype)
        out[: len(a)] = a
        return out

    lens_p = np.zeros(k2, np.int32)
    lens_p[:n] = lengths
    rows_j = _assemble_sc_rows(jnp.asarray(pad(pk)), jnp.asarray(pad(nm_f)),
                               jnp.asarray(pad(nm_r)), jnp.asarray(lens_p))

    # dict-build segmentation: one whole-consensus dict up to 2^25
    # positions; beyond that the build's table + sort footprint outgrew a
    # 16 GB device (~19 GB at a 100 Mbp consensus), so build per-2^24-base
    # segment dicts with
    # GLOBAL positions as payload and min-fold the matches. Verification
    # always reads the full packed consensus (67 MB at 1 Gbp — cheap).
    seg_bases = 1 << 24
    single_max = 1 << 25
    nseg = max(1, -(-total // seg_bases)) if total > single_max else 1

    seq_pk = packing.pack_codes(np.concatenate(
        [np.zeros(_PAD, np.uint8), seq_codes,
         np.zeros((W + 2) * 16, np.uint8)])[None, :])[0]
    need = max(len(seq_pk),
               _PAD // 16 + nseg * (seg_bases // 16) + 2)
    # 1/8-octave padding, not pow2: the dict build sorts every padded
    # position, and pow2 padding made that sort up to 2x the real size
    # (shape-bucket count stays bounded at 8 per octave)
    gran = max(1 << max(int(need - 1).bit_length() - 3, 6), 64)
    nw = -(-need // gran) * gran
    seq_p = np.zeros(nw, np.uint32)
    seq_p[: len(seq_pk)] = seq_pk
    seq_j = jnp.asarray(seq_p)
    mark("pack+h2d")

    total_j = jnp.asarray(total, jnp.int32)
    ex_j = None
    if exclude is not None:
        ex_p = np.full(k2, -2, np.int32)
        ex_p[:n] = exclude
        ex_j = jnp.asarray(np.concatenate([ex_p, ex_p]))  # both orient rows
    rc_j = jnp.concatenate([jnp.zeros(k2, jnp.int32),
                            jnp.ones(k2, jnp.int32)])

    # row-chunked dispatch: the match's candidate-row intermediates are
    # O(rows x CANDS x 16 words); the whole oriented set in one program
    # outgrew a 16 GB device at 10M reads (~1M oriented rows on top of the
    # resident consensus/dict tables). 2^17-row chunks bound it at ~1 GB;
    # at the sizes the chunking targets they share one compiled program
    # (pow2 padding bounds the variant count for smaller leftover sets).
    # ALL chunks are dispatched before any is read back, so chunk k+1's
    # compute overlaps chunk k's d2h (a per-chunk np.asarray serialized
    # them).
    CH = min(2 * k2, 1 << 17)

    def match_fold(btab, pos_bins, best):
        outs = []
        for c0 in range(0, 2 * k2, CH):
            b = _match_reads(
                seq_j, btab, pos_bins, rows_j[c0:c0 + CH], total_j, W,
                thresh, windows,
                None if ex_j is None else ex_j[c0:c0 + CH],
                rc_j[c0:c0 + CH])
            try:
                b.copy_to_host_async()
            except Exception:
                pass
            outs.append((c0, b))
        for c0, b in outs:
            np.minimum(best[c0:c0 + CH], np.asarray(b),
                       out=best[c0:c0 + CH])
        return best

    best2 = np.full(2 * k2, _BIG, np.int32)
    if nseg == 1:
        # ONE sliding-window dict over the consensus, built on device; the
        # oriented reads probe it (work scales with reads, not positions).
        # Half the read-dict bucket budget (load ~0.5): overflow-dropped
        # positions only cost a read its match if ALL its probe windows
        # land on dropped 16-mers (~(0.03)^4 — negligible), and the
        # bucket table + its placement scatters halve.
        npos = (nw - _PAD // 16) * 16
        S = max(dct.table_buckets(npos) // 2, 64)
        btab, _keys, pos_bins, dropped = dct.build_hash_dict_seq_dev(
            seq_j, total_j, _PAD // 16, S)
        mark("dicts")
        best2 = match_fold(btab, pos_bins, best2)
    else:
        S = dct.table_buckets(seg_bases)
        nw_seg = seg_bases // 16 + 2
        for k in range(nseg):
            btab, _keys, pos_bins, _ = dct.build_hash_dict_seq_seg(
                seq_j, total_j, jnp.asarray(k * seg_bases, jnp.int32),
                _PAD // 16, nw_seg, S)
            best2 = match_fold(btab, pos_bins, best2)
        mark(f"dicts+match x{nseg}")
    best = np.minimum(best2[:k2], best2[k2:])[:n]
    mark("match")
    placed = best != _BIG
    out_pos[placed] = (best[placed] >> 1).astype(np.int64)
    out_rc[placed] = (best[placed] & 1).astype(np.uint8)
    return out_pos, out_rc, out_pos >= 0


def align_leftovers(seq_codes: np.ndarray, codes: np.ndarray,
                    lengths: np.ndarray, thresh: int = P.THRESH_ENCODER
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Byte-codes convenience wrapper over align_leftovers_packed."""
    lengths = np.asarray(lengths, np.int32)
    pk = packing.pack_codes(codes)
    ind = (codes == packing.N).astype(np.uint8)
    nm_f = packing.pack_codes(ind)
    L = codes.shape[1] if codes.ndim == 2 and codes.shape[1] else 1
    src = lengths[:, None].astype(np.int64) - 1 - np.arange(L)
    ind_r = np.where(
        src >= 0,
        np.take_along_axis(ind, np.clip(src, 0, L - 1), axis=1),
        0).astype(np.uint8)
    nm_r = packing.pack_codes(ind_r)
    return align_leftovers_packed(seq_codes, pk, nm_f, nm_r, lengths, thresh)
