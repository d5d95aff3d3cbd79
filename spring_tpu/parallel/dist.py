"""Multi-device reorder: shard_map over a device mesh, O(B/n) per device.

Reference analog: none — the reference is a single-process OpenMP tool
(SURVEY.md §2.3). This module is the scale-out design. It runs
the SAME round as the single-device batch-accept engine (reorder/engine.py)
— packed u8x4 lane consensus counts, metadata-only probe with group top-k
before any candidate fetch, batched consensus update, scan-stacked
emissions, read-only rows with bitmap claims — with every heavy data
structure sharded:

  * walkers are data-parallel over the mesh axis ("shard"): each device
    owns B/n contig walkers, their consensus lanes, frames and batch
    accepts — all O(B/n) compute;
  * the k-mer dictionaries are key-sharded: device d holds ONE merged
    bucketed hash table over the (salted) keys of ALL dictionary windows
    whose owner hash routes to d, plus the matching rid bins and
    overlapping pair rows. The per-dict key salt is a bijective XOR, so a
    cross-dict collision only merges two bins' candidates — Hamming
    verification rejects them. The table is BUILT on device too: each
    device extracts keys from its row shard and routes (key, global rid)
    pairs to their owners with one all_to_all;
  * the probe is METADATA-ONLY and capacity-limited (the MoE dispatch
    pattern: sort by owner, rank within group, drop overflow): keys ship
    to their owner, one packed (start | count) sc word returns. Each
    walker then top-k selects the GSEL best-priority hitting groups and
    only THOSE ship a candidate-fetch request (one pairs-row gather at
    the owner, C rids back) — the eager all-K fetch this replaces was the
    round-1 engine shape, and removing it was the single-device engine's
    largest cut in round time;
  * packed read rows are range-sharded by rid and READ-ONLY: verification
    fetches candidate rows from their owners through a third exchange.
    Claim state lives in the replicated bitmap only (claimed candidates
    are filtered before dispatch; unfetched slots come back marked
    claimed), so the row table rides the flush as a non-donated argument
    instead of a scan carry;
  * cross-device claim conflicts are resolved REPLICATED from one small
    all_gather of per-device claim proposals; every device applies
    identical updates to the replicated claimed bitmap (Np/8 bytes);
  * each device drains its own strided slice of the seed queue. Seed
    rows ride the row-fetch exchange, so seeding decisions use the
    walker state carried from the previous round (a walker that dies in
    round r reseeds in round r+1 — one-round lag vs single-chip).

Slot validity across an exchange is tracked ONLY by the dispatch's
per-query slot map (_collect gathers replies back by slot): payloads are
raw 32-bit patterns and must never be sign-tested on the receiving side
(a uint32 key with the top bit set is a legitimate value, not an empty
slot). Dispatch tables and collects are sort+gather end to end — no
scatters (scatter-built tables dominated a 10M-read run on one device of
the previous accelerator; kept until measured on the H100, ROADMAP 3.3).

Per-round collectives: 2 all_to_alls (probe keys + meta words),
2 (candidate requests + rids), 2 (row requests + rows), 1 all_gather
(claim proposals). All O(B/n) sized except the proposal gather (O(B)).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as Pspec

from .. import params as P
from ..ops import bits
from ..reorder import dictionary as dct
from ..reorder import engine as eng
from . import multihost as mh

# decorrelated from BOTH table hashes (_HASH_MULT picks buckets,
# _TAG_MULT makes the 16-bit tags): sharing _TAG_MULT here would fix the
# tag's top lg(n) bits per device and shrink effective tag entropy
_OWNER_MULT = jnp.uint32(0xC2B2AE35)
_BIG = eng._BIG
# per-dict bijective XOR salts so D windows share one merged table/device
_SALTS = (0, 0x3C6EF372, 0x61C88647, 0x9E3779B9)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    # multi-process: start jax.distributed first so jax.devices() spans
    # every process's devices (see parallel/multihost.py)
    mh.maybe_initialize()
    devices = devices if devices is not None else jax.devices()
    n = n_devices or len(devices)
    return Mesh(np.array(devices[:n]), axis_names=("shard",))


@dataclass
class DistConfig:
    max_readlen: int
    num_walkers: int = P.REORDER_BATCH  # global walkers (divisible by mesh)
    candidates: int = P.DICT_PROBE_CANDIDATES
    thresh: int = P.THRESH_REORDER
    max_shift: int = 0
    shift_chunk: int = 16
    accept_slots: int = 16
    capacity_factor: float = 2.0   # all_to_all slack over the uniform load

    def __post_init__(self):
        # same cap as ReorderConfig: an uncapped shift scan both dominates
        # round count and can exceed _roll_words' select-chain coverage
        if self.max_shift == 0:
            self.max_shift = max(min(self.max_readlen // 2,
                                     P.MAX_SHIFT_CAP), 1)


def _owner_of_key(key: jnp.ndarray, n: int) -> jnp.ndarray:
    if n == 1:
        return jnp.zeros(key.shape, jnp.int32)
    lg = int(np.log2(n))
    return ((key * _OWNER_MULT) >> jnp.uint32(32 - lg)).astype(jnp.int32)


def _dispatch(payloads: tuple, owner: jnp.ndarray, valid: jnp.ndarray,
              n: int, cap: int):
    """MoE-style capacity-limited dispatch table, built SORT-FIRST.

    payloads: tuple of (Q,) int32 arrays routed together. Returns
      sends: list of (n*cap,) int32 per-destination tables (-1 fill)
      slot:  (Q,) int32 table slot of each query (n*cap if dropped)
    Overflow beyond `cap` per destination is dropped. A dropped probe or
    candidate only loses match opportunities (the read stays a singleton
    or seeds later) — never correctness.

    The tables are GATHERED from the sorted order (slot j of the table
    reads sorted entry starts[j//cap] + j%cap) and the per-query slot map
    comes from one inverse-permutation sort. The previous form scattered
    payloads + a source map into the n*cap tables; at big per-device
    shapes (Bl*G ~ 0.5M probe queries at 10M reads on one device) those
    scatters dominated the round on the previous accelerator, whose
    scatter lowering ran far below sort+gather speed (kept until measured
    on the H100, ROADMAP 3.3)."""
    Q = owner.shape[0]
    key = jnp.where(valid, owner, n)            # invalid to the end
    idx = jnp.arange(Q, dtype=jnp.int32)
    out = jax.lax.sort((key, idx) + tuple(payloads), num_keys=1)
    ko, io = out[0], out[1]
    firsts = jnp.concatenate([jnp.array([True]), ko[1:] != ko[:-1]])
    grp_start = jax.lax.cummax(jnp.where(firsts, idx, 0))
    rank = idx - grp_start
    ok = (ko < n) & (rank < cap)
    # per-destination entry counts/starts in the sorted order (n is tiny:
    # one broadcast compare beats segment bookkeeping)
    cnt = jnp.sum(ko[None, :] == jnp.arange(n, dtype=jnp.int32)[:, None],
                  axis=1).astype(jnp.int32)
    starts = jnp.cumsum(cnt) - cnt
    j = jnp.arange(n * cap, dtype=jnp.int32)
    d, r = j // cap, j % cap
    src_idx = jnp.clip(starts[d] + r, 0, Q - 1)
    slot_ok = r < jnp.minimum(cnt[d], cap)
    sends = [jnp.where(slot_ok, po[src_idx], -1) for po in out[2:]]
    # per-query slot: invert the sort permutation with one 2-operand sort
    slot_sorted = jnp.where(ok, ko * cap + rank, n * cap)
    _, slot_q = jax.lax.sort((io, slot_sorted), num_keys=1)
    return sends, slot_q


def _collect(replies: jnp.ndarray, slot_q: jnp.ndarray) -> jnp.ndarray:
    """Gather exchange replies back to their source queries.

    replies: (n*cap, ...) aligned with the dispatch table; slot_q as
    returned by _dispatch ((Q,), n*cap where nothing was sent). Returns
    (Q, ...) with zeros where nothing returned — one row gather, no
    scatter."""
    T = replies.shape[0]
    out = replies[jnp.clip(slot_q, 0, T - 1)]
    good = slot_q < T
    if replies.ndim > 1:
        good = good.reshape(good.shape + (1,) * (replies.ndim - 1))
    return jnp.where(good, out, jnp.zeros((), replies.dtype))


def _probe_meta_sc(btab: jnp.ndarray, keys: jnp.ndarray) -> jnp.ndarray:
    """Compact-table metadata probe: packed (start | count) sc words,
    0 on miss (same math as dct.probe_meta's compact branch)."""
    S = btab.shape[0]
    shift = 32 - int(np.log2(S))
    b = (keys * jnp.uint32(dct._HASH_MULT)) >> shift
    row = btab[b]
    tagw = row[:, : dct.SLOTS // 2]
    scw = row[:, dct.SLOTS // 2:]
    tags = jnp.stack([tagw & jnp.uint32(0xFFFF), tagw >> 16],
                     axis=2).reshape(-1, dct.SLOTS)
    qtag = ((keys * jnp.uint32(dct._TAG_MULT)) >> 16) & jnp.uint32(0xFFFF)
    hit = (tags == qtag[:, None]) & ((scw & jnp.uint32(dct.SC_CMASK)) > 0)
    first_hit = hit & (jnp.cumsum(hit, axis=1) == 1)
    return jnp.sum(jnp.where(first_hit, scw, 0), axis=1)


@functools.lru_cache(maxsize=None)
def _dist_programs(mesh: Mesh, Np: int, W: int, B: int, C: int, SC: int,
                   accept_slots: int, starts: tuple, thresh: int,
                   capf: float):
    """Compile the sharded build / flush / compact programs for one static
    shape signature. Cached at module level like the single-chip
    _flush_program — per-engine jits would re-trace per compress call."""
    n = int(mesh.devices.size)
    assert n & (n - 1) == 0, "mesh size must be a power of two"
    D = len(starts)
    assert 1 <= D <= len(_SALTS)
    Bl = B // n
    Npl = Np // n
    lg_npl = int(np.log2(Npl))
    Lb = W * 16
    G = SC * 2 * D
    GSEL = max(1, min(accept_slots, G * C) // C)
    M = GSEL * C
    S_EMIT = M + 1
    CAP = eng.FLUSH_ROUNDS * max(3, 3 * SC // 16) + S_EMIT
    nwords = Np // 32 + 2
    # exchange capacities (per destination, per device), never above the
    # query count itself (at n<=2 the slack factor would size the tables
    # past what a destination can possibly receive)
    capk = max(-(-min(int(np.ceil(capf * D * Npl / n)), D * Npl)
                 // 8) * 8, 8)
    capq = max(min(int(np.ceil(capf * (Bl * G) / n)), Bl * G), 1)
    capc = max(min(int(np.ceil(capf * (Bl * GSEL) / n)), Bl * GSEL), 1)
    capr = max(min(int(np.ceil(capf * (Bl * (M + 2)) / n)),
                   Bl * (M + 2)), 1)
    R = n * capk                    # per-device dictionary entries
    if R > dct.MAX_COMPACT_ENTRIES:
        raise ValueError(
            f"per-device dictionary of {R} entries exceeds the compact "
            f"table's {dct.MAX_COMPACT_ENTRIES} (packed 27-bit starts); "
            "add mesh devices to shrink the per-device shard (the wide "
            "format used by the single-chip engine past 2^27 entries is "
            "not wired into the dist probe exchange yet)")
    S = dct.table_buckets(max(D * Np // n, 64))
    salt = jnp.asarray(np.array(_SALTS[:D], np.uint32))

    def a2a(x):
        if n == 1:
            return x
        return jax.lax.all_to_all(x, "shard", split_axis=0, concat_axis=0,
                                  tiled=True)

    # ---------------- sharded dictionary build ----------------

    def build_fn(rows_local):
        me = jax.lax.axis_index("shard")
        lengths = (rows_local[:, W] & jnp.uint32(0x7FFFFFFF)
                   ).astype(jnp.int32)
        rid0 = me * Npl + jnp.arange(Npl, dtype=jnp.int32)
        ks, rs, vs = [], [], []
        for d, st in enumerate(starts):
            w0, b = divmod(st, 16)
            lo = rows_local[:, w0] >> jnp.uint32(2 * b)
            if b:
                lo = lo | (rows_local[:, w0 + 1] << jnp.uint32(32 - 2 * b))
            ks.append(lo ^ jnp.uint32(_SALTS[d]))
            rs.append(rid0)
            # padding rows carry length 0, so the window check excludes
            # them along with genuinely short reads
            vs.append(lengths >= st + dct.KEY_BASES)
        keys = jnp.concatenate(ks)
        rids = jnp.concatenate(rs)
        valid = jnp.concatenate(vs)
        sends, _ = _dispatch((keys.astype(jnp.int32), rids),
                             _owner_of_key(keys, n), valid, n, capk)
        rk = a2a(sends[0]).astype(jnp.uint32)
        rr = a2a(sends[1])
        btab, h_s, rids_s, dropped = dct._hash_build_core(
            rk, rr >= 0, S, compact=True, rids=rr)
        pairs = dct.pairs_from_rids(rids_s)
        return btab, h_s, rids_s, pairs, dropped.reshape(1)

    sh = Pspec("shard")
    rep = Pspec()
    build = jax.jit(jax.shard_map(
        build_fn, mesh=mesh, in_specs=(sh,),
        out_specs=(sh, sh, sh, sh, sh), check_vma=False))

    # ---------------- dictionary compaction ----------------

    def compact_fn(keys_l, rids_l, claimed):
        rids2 = dct.compact_bins_dev(keys_l, rids_l, claimed)
        return rids2, dct.pairs_from_rids(rids2)

    compact = jax.jit(jax.shard_map(
        compact_fn, mesh=mesh, in_specs=(sh, sh, rep),
        out_specs=(sh, sh), check_vma=False))

    # ---------------- the sharded round ----------------

    def round_fn(state, btab, pairs, rows_local, seed_slice, maxshift,
                 room):
        counts = state["counts"]          # (Bl, Lb) packed u8x4 lanes
        ref_len = state["ref_len"]
        active = state["active"]
        shift_base = state["shift_base"]
        first_rid = state["first_rid"]
        lp0 = state["left_phase"]
        claimed = state["claimed"]        # replicated bitmap
        qpos = state["queue_pos"]         # (1,) this device's queue cursor
        nq = state["n_queue"]             # (1,) live entries in my slice
        me = jax.lax.axis_index("shard")
        searching = active & room

        def claimed_bit(idx):
            w = claimed[idx >> 5]
            return ((w >> (idx & 31).astype(jnp.uint32)) & 1) == 1

        # ---- seed draw (from the previous round's walker state) ----
        inactive = ~active & room
        rank = jnp.cumsum(inactive) - 1
        qidx = qpos[0] + rank
        in_range = inactive & (qidx < nq[0])
        seed_rid = seed_slice[jnp.clip(qidx, 0, Npl - 1)]
        seed_try = in_range & ~claimed_bit(seed_rid)
        qpos = qpos + jnp.sum(in_range)

        # ---- frames + salted queries ----
        frames, s_tot = eng.walker_frames_packed(counts, ref_len,
                                                 shift_base, SC)
        q, v = eng.walker_queries(frames, s_tot, ref_len, starts)
        # (Bl, SC, D, 2) -> (Bl, SC, 2, D): group id g = ((s*2+o)*D + d),
        # slot order IS the priority (shift > orientation > dict — the
        # reference search order, src/reorder.h:479-557)
        keys_bg = (jnp.moveaxis(q, 2, 3).astype(jnp.uint32) ^ salt
                   ).reshape(Bl, G)
        v_g = (jnp.moveaxis(v, 2, 3)
               & searching[:, None, None, None]).reshape(Bl * G)

        # ---- metadata-only probe exchange ----
        keys_g = keys_bg.reshape(-1)
        sends_q, slot_q = _dispatch((keys_g.astype(jnp.int32),),
                                    _owner_of_key(keys_g, n), v_g, n, capq)
        recv_k = a2a(sends_q[0]).astype(jnp.uint32)
        sc_back = a2a(_probe_meta_sc(btab, recv_k))
        sc_g = _collect(sc_back, slot_q).reshape(Bl, G)
        hit_g = ((sc_g & jnp.uint32(dct.SC_CMASK)) > 0) & searching[:, None]

        # ---- pick the GSEL best-priority hitting groups ----
        negp = jnp.where(hit_g, -jnp.arange(G, dtype=jnp.int32)[None, :],
                         -_BIG)
        negg, _ = jax.lax.top_k(negp, GSEL)        # (Bl, GSEL)
        gok = negg != -_BIG
        g_id = jnp.where(gok, -negg, 0)
        sc_sel = jnp.take_along_axis(sc_g, g_id, axis=1)
        st_sel = (sc_sel >> dct.SC_SHIFT).astype(jnp.int32)
        ct_sel = jnp.where(gok,
                           (sc_sel & jnp.uint32(dct.SC_CMASK)).astype(jnp.int32), 0)
        key_sel = jnp.take_along_axis(keys_bg, g_id, axis=1)
        o_sel = (g_id // D) % 2
        srel = g_id // (2 * D)

        # ---- candidate fetch exchange: only GSEL starts per walker ----
        sends_c, slot_c = _dispatch((st_sel.reshape(-1),),
                                    _owner_of_key(key_sel.reshape(-1), n),
                                    gok.reshape(-1), n, capc)
        recv_st = a2a(sends_c[0])
        prow = pairs[jnp.clip(recv_st >> 3, 0, pairs.shape[0] - 1)]
        offc = recv_st & 7
        cr = prow[:, :C]
        for o in range(1, 8):
            cr = jnp.where((offc == o)[:, None], prow[:, o:o + C], cr)
        back_c = a2a(cr)
        fetched_c = slot_c < n * capc
        cand_sel = jnp.where(fetched_c[:, None],
                             _collect(back_c, slot_c),
                             -1).reshape(Bl, GSEL, C)
        offs = jnp.arange(C, dtype=jnp.int32)
        vcand = (offs[None, None, :]
                 < jnp.minimum(ct_sel, C)[:, :, None]) & gok[:, :, None]
        cand_m = cand_sel.reshape(Bl, M)
        valid_m = (vcand & (cand_sel >= 0)).reshape(Bl, M)
        # per-slot fields are pure arithmetic on the group id
        co = jnp.arange(C, dtype=jnp.int32)[None, None, :]
        k_o_m = jnp.broadcast_to(
            o_sel[:, :, None], (Bl, GSEL, C)).reshape(Bl, M)
        k_frame_m = jnp.broadcast_to(
            (srel * 2 + o_sel)[:, :, None], (Bl, GSEL, C)).reshape(Bl, M)
        s_m = shift_base[:, None] + jnp.broadcast_to(
            srel[:, :, None], (Bl, GSEL, C)).reshape(Bl, M)

        # ---- row fetch exchange: M candidates + first_rid + seed ----
        # claimed candidates are filtered before dispatch (the bitmap is
        # replicated and fresh as of last round — the same staleness as
        # the single-chip verify-time check); unfetched slots come back
        # with the claimed marker so they are never accepted
        req = jnp.concatenate([cand_m.reshape(-1), first_rid, seed_rid])
        req_valid = jnp.concatenate([
            (valid_m & ~claimed_bit(jnp.clip(cand_m, 0, Np - 1))
             ).reshape(-1),
            jnp.ones((Bl,), bool), seed_try])
        owner_r = (jnp.clip(req, 0, Np - 1) >> lg_npl).astype(jnp.int32)
        sends_r, slot_r = _dispatch((req,), owner_r, req_valid, n, capr)
        recv_r = a2a(sends_r[0])
        rows_srv = rows_local[jnp.clip(recv_r, 0, Np - 1) & (Npl - 1)]
        rows_back = a2a(rows_srv)
        rows_all = _collect(rows_back, slot_r)
        fetched = slot_r < n * capr
        rows_all = jnp.where(fetched[:, None], rows_all,
                             jnp.uint32(1 << 31))
        rows = rows_all[: Bl * M].reshape(Bl, M, W + 1)
        fr_rows = rows_all[Bl * M: Bl * M + Bl]
        seed_rows = rows_all[Bl * M + Bl:]

        # ---- verify: masked popcounts over the fetched rows ----
        lw = rows[..., W]
        claimed_row = (lw >> 31) == 1
        clen = (lw & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        rl = ref_len[:, None]
        lo = jnp.where(k_o_m == 0, 0, s_m)
        hi = jnp.where(k_o_m == 0, jnp.minimum(rl - s_m, clen),
                       jnp.minimum(rl + s_m, clen))
        t = jnp.where(k_o_m == 0, s_m, rl + s_m - clen)
        fr2 = frames.reshape(Bl, 2 * SC, -1)
        frow = jnp.take_along_axis(fr2, k_frame_m[:, :, None], axis=1)
        ham = jnp.zeros((Bl, M), jnp.int32)
        for w in range(W):
            d = frow[..., w] ^ rows[..., w]
            mm = (d | (d >> 1)) & eng._ODD
            mw = eng._prefix_word(jnp.clip(hi - 16 * w, 0, 16)) \
                & ~eng._prefix_word(jnp.clip(lo - 16 * w, 0, 16))
            ham = ham + jax.lax.population_count(mm & mw).astype(jnp.int32)
        ok = valid_m & ~claimed_row & (ham <= thresh) \
            & (t >= 0) & (hi > lo)

        # ---- dedup rids within the walker, then order accepts by t ----
        pr_m = (g_id[:, :, None] * C + co).reshape(Bl, M)
        rid_eff = jnp.where(ok, cand_m, _BIG)
        slot_i = jnp.broadcast_to(
            jnp.arange(M, dtype=jnp.int32)[None, :], (Bl, M))
        rid_s, _, t_s, ko_s, clen_s, slot_s = jax.lax.sort(
            (rid_eff, pr_m, t, k_o_m, clen, slot_i),
            dimension=1, num_keys=2)
        firsts = jnp.concatenate(
            [jnp.ones((Bl, 1), bool), rid_s[:, 1:] != rid_s[:, :-1]],
            axis=1)
        keep_s = (rid_s != _BIG) & firsts
        tkey = jnp.where(keep_s, t_s, _BIG)
        (_, _, keep_f, rid_f, t_f, ko_f, clen_f, slot_f) = jax.lax.sort(
            (tkey, rid_s, keep_s, rid_s, t_s, ko_s, clen_s, slot_s),
            dimension=1, num_keys=2)
        rows_f = jnp.take_along_axis(rows, slot_f[:, :, None], axis=1)

        # ---- global claim resolution: one all_gather of proposals ----
        # priority classes: matches (first) beat seeds on the same rid,
        # matching the single-chip order of operations
        prop_rid = jnp.concatenate(
            [jnp.where(keep_f, rid_f, _BIG).reshape(-1),
             jnp.where(seed_try, seed_rid, _BIG)])
        Ppd = prop_rid.shape[0]
        props = (jax.lax.all_gather(prop_rid, "shard", axis=0, tiled=True)
                 if n > 1 else prop_rid)
        Pn = props.shape[0]
        cls = jnp.tile(jnp.concatenate(
            [jnp.zeros((Bl * M,), jnp.int32), jnp.ones((Bl,), jnp.int32)]),
            n)
        gidx = jnp.arange(Pn, dtype=jnp.int32)
        ks, cs, gs = jax.lax.sort((props, cls, gidx), num_keys=3)
        firstp = jnp.concatenate([jnp.array([True]), ks[1:] != ks[:-1]])
        win_sorted = firstp & (ks != _BIG)
        # int32, not bool: see engine.resolve_conflicts (GPU sort-to-
        # scatter rewrite of a permutation-keyed sort)
        _, win_all = jax.lax.sort((gs, win_sorted.astype(jnp.int32)),
                                  num_keys=1)
        win_all = win_all.astype(bool)

        # replicated claimed-bitmap update for every winner (winner bits
        # are previously 0 — proposals were filtered by the bitmap and
        # the resolution dedups within the round — so .add is exact)
        win_rid = jnp.where(win_all, props, Np - 1)
        word = jnp.where(win_all, win_rid >> 5, nwords - 1)
        bit = jnp.where(win_all,
                        jnp.uint32(1) << (win_rid & 31).astype(jnp.uint32),
                        jnp.uint32(0))
        claimed = claimed.at[word].add(bit)

        # my verdict slices
        my0 = me * Ppd
        win_me = jax.lax.dynamic_slice_in_dim(win_all, my0, Ppd, 0)
        win = win_me[: Bl * M].reshape(Bl, M) & keep_f
        ok_seed = win_me[Bl * M:] & seed_try

        matched_any = win.any(axis=1)
        t_roll = jnp.max(jnp.where(win, t_f, 0), axis=1)

        # ---- batched consensus update over packed lanes (O(Bl)) ----
        live = jnp.arange(Lb)[None, :] < ref_len[:, None]
        rolled0 = eng._roll_words(jnp.where(live, counts, jnp.uint32(0)),
                                  t_roll)
        len0 = jnp.maximum(ref_len - t_roll, 0)
        pk_all = rows_f[..., :W]                          # (Bl, M, W)
        pk_all = jnp.where((ko_f == 1)[:, :, None],
                           bits.revcomp_packed(pk_all, clen_f), pk_all)
        d_all = jnp.where(win, t_roll[:, None] - t_f, 0)
        pk_all = bits.shift_bases_left(pk_all, d_all, Lb)
        codes_all = bits.unpack(pk_all, Lb)               # (Bl, M, Lb)
        len_all = jnp.where(win, clen_f - d_all, 0)
        inc = eng._lane_inc(codes_all, len_all).sum(axis=1)
        rolled = eng._sat_add(rolled0, inc)
        new_len = jnp.maximum(len0, len_all.max(axis=1))
        counts = jnp.where(matched_any[:, None], rolled, counts)
        ref_len = jnp.where(matched_any, new_len, ref_len)
        shift_base = jnp.where(matched_any, 0, shift_base)

        # ---- death / left phase ----
        left_phase = lp0
        missed = searching & ~matched_any
        shift_base = jnp.where(missed, shift_base + SC, shift_base)
        death = missed & (shift_base > maxshift)
        start_left = death & ~left_phase
        active = active & ~(death & left_phase)
        left_phase = left_phase | start_left
        shift_base = jnp.where(start_left, 0, shift_base)
        fr_len = (fr_rows[:, W] & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
        fr_rc = bits.revcomp_packed(fr_rows[:, :W], fr_len)
        fr_counts = eng._lane_inc(bits.unpack(fr_rc, Lb), fr_len)
        counts = jnp.where(start_left[:, None], fr_counts, counts)
        ref_len = jnp.where(start_left, fr_len, ref_len)

        # ---- apply seeds ----
        seed_len = (seed_rows[:, W] & jnp.uint32(0x7FFFFFFF)
                    ).astype(jnp.int32)
        seed_cnt = eng._lane_inc(bits.unpack(seed_rows[:, :W], Lb),
                                 seed_len)
        counts = jnp.where(ok_seed[:, None], seed_cnt, counts)
        ref_len = jnp.where(ok_seed, seed_len, ref_len)
        shift_base = jnp.where(ok_seed, 0, shift_base)
        active = active | ok_seed
        left_phase = jnp.where(ok_seed, False, left_phase)
        first_rid = jnp.where(ok_seed, seed_rid, first_rid)

        # ---- emissions (packed like the single-chip round) ----
        tw = jnp.where(win, t_f, 0)
        cm = jax.lax.cummax(tw, axis=1)
        prev = jnp.concatenate([jnp.zeros((Bl, 1), tw.dtype), cm[:, :-1]],
                               axis=1)
        delta = tw - prev
        flagv = jnp.where(lp0[:, None], 2, 1)
        meta = jnp.where(win, delta + (flagv << 16) + (ko_f << 24), 0)
        emit_m = jnp.stack([jnp.where(win, rid_f, -1), meta], axis=-1)
        zero = jnp.zeros((Bl,), jnp.int32)
        emit_seed = jnp.stack(
            [jnp.where(ok_seed, seed_rid, -1), zero], axis=-1)[:, None, :]
        emit = jnp.concatenate([emit_seed, emit_m], axis=1)

        new_state = dict(counts=counts, ref_len=ref_len, active=active,
                         shift_base=shift_base, first_rid=first_rid,
                         left_phase=left_phase, claimed=claimed,
                         queue_pos=qpos, n_queue=nq)
        return new_state, emit.astype(jnp.int32)

    # ---------------- the flush (FLUSH_ROUNDS in one dispatch) ----------

    def flush_fn(state, btab, pairs, rows_local, seed_slice, maxshift):
        # per-round emissions are stacked by the scan and compacted ONCE
        # per flush with a stable sort (the per-round positional scatter
        # this replaces was a large share of the single-device round)
        cnt0 = jnp.zeros((Bl,), jnp.int32)

        def body(carry, _):
            st, cnt = carry
            room = cnt < CAP - S_EMIT
            st2, emit = round_fn(st, btab, pairs, rows_local, seed_slice,
                                 maxshift, room)
            cnt = cnt + jnp.sum(emit[:, :, 0] >= 0, axis=1)
            return (st2, cnt), emit

        (state, cnt), ys = jax.lax.scan(
            body, (state, cnt0), None, length=eng.FLUSH_ROUNDS)
        em = jnp.moveaxis(ys, 0, 1).reshape(
            Bl, eng.FLUSH_ROUNDS * S_EMIT, 2)
        empty = (em[:, :, 0] < 0).astype(jnp.int32)
        _, w0, w1 = jax.lax.sort(
            (empty, em[:, :, 0], em[:, :, 1]), dimension=1, num_keys=1)
        buf = jnp.stack([w0[:, :CAP], w1[:, :CAP]], axis=-1)
        # per-flush stats as ONE tiny transfer (claimed popcount is
        # computed on the replicated bitmap — identical on every device)
        stats = jnp.stack([
            jnp.sum(jax.lax.population_count(
                state["claimed"][: Np // 32])).astype(jnp.int32),
            state["queue_pos"][0],
            jnp.sum(state["active"]).astype(jnp.int32),
            jnp.sum(cnt)])[None, :]
        return state, buf, stats

    state_spec = dict(counts=sh, ref_len=sh, active=sh, shift_base=sh,
                      first_rid=sh, left_phase=sh, claimed=rep,
                      queue_pos=sh, n_queue=sh)
    flush = jax.jit(jax.shard_map(
        flush_fn, mesh=mesh,
        in_specs=(state_spec, sh, sh, sh, sh, rep),
        out_specs=(state_spec, sh, sh),
        check_vma=False), donate_argnums=(0,))
    return dict(build=build, compact=compact, flush=flush,
                CAP=CAP, Bl=Bl, Npl=Npl, M=M)


class DistReorderEngine:
    """Multi-device counterpart of ReorderEngine: walkers DP, dictionaries
    and packed rows sharded, probe/candidate/row traffic over capacity-
    limited all_to_alls. Same emissions contract as ReorderEngine.run."""

    ordered_emissions = True

    def __init__(self, packed: np.ndarray, lengths: np.ndarray,
                 cfg: DistConfig, mesh: Mesh | None = None):
        self.mesh = mesh or make_mesh()
        n = self.n = int(self.mesh.devices.size)
        self.cfg = cfg
        self.N = packed.shape[0]
        self.W = packed.shape[1]
        self.Lb = self.W * bits.BASES_PER_WORD
        self.Np = max(1 << max(self.N - 1, 1).bit_length(), 64 * n)
        # same auto walker sizing as the single-chip engine (~256 reads
        # per walker), rounded to the mesh
        self.B = int(min(cfg.num_walkers,
                         max(8 * n, self.Np // 256)) // n * n)
        self.windows = dct.default_windows(cfg.max_readlen)
        self._prog = _dist_programs(
            self.mesh, self.Np, self.W, self.B, cfg.candidates,
            cfg.shift_chunk, cfg.accept_slots,
            tuple(w.start for w in self.windows), cfg.thresh,
            cfg.capacity_factor)
        # padded rows + length word; padding rows carry the claimed bit
        # (the only claim bit rows ever hold — live claim state is the
        # replicated bitmap, rows are READ-ONLY)
        packed_p = np.zeros((self.Np, self.W + 1), np.uint32)
        packed_p[: self.N, : self.W] = packed
        lengths_p = np.zeros(self.Np, np.int32)
        lengths_p[: self.N] = lengths
        packed_p[:, self.W] = lengths_p.view(np.uint32)
        packed_p[self.N:, self.W] |= np.uint32(1 << 31)
        self.packed = packed_p
        self.lengths = lengths_p

    def _queue_slices(self, remaining: np.ndarray):
        """Strided split of the seed queue over devices at a FIXED width
        (Npl) so queue compaction never changes the flush shape."""
        n, Npl = self.n, self._prog["Npl"]
        out = np.full((n, Npl), self.Np - 1, np.int32)
        nq = np.zeros((n, 1), np.int32)
        for d in range(n):
            s = remaining[d::n]
            out[d, : len(s)] = s
            nq[d, 0] = len(s)
        return out.reshape(n * Npl), nq.reshape(n)

    def init_state(self):
        n = self.n
        nwords = self.Np // 32 + 2
        claimed = np.zeros(nwords, np.uint32)
        pad = np.zeros(self.Np, bool)
        pad[self.N:] = True
        claimed[: self.Np // 32] = np.packbits(
            pad, bitorder="little").view(np.uint32)
        m = self.mesh
        # every array enters the mesh with its final sharding so the state
        # builds correctly under multi-process meshes too (multihost.py)
        return dict(
            counts=mh.put_sharded(m, np.zeros((self.B, self.Lb),
                                              np.uint32)),
            ref_len=mh.put_sharded(m, np.zeros(self.B, np.int32)),
            active=mh.put_sharded(m, np.zeros(self.B, bool)),
            shift_base=mh.put_sharded(m, np.zeros(self.B, np.int32)),
            first_rid=mh.put_sharded(m, np.zeros(self.B, np.int32)),
            left_phase=mh.put_sharded(m, np.zeros(self.B, bool)),
            claimed=mh.put_replicated(m, claimed),
            queue_pos=mh.put_sharded(m, np.zeros(n, np.int32)),
            n_queue=mh.put_sharded(m, np.zeros(n, np.int32)),
        )

    def run(self, max_rounds: int | None = None,
            progress=None) -> np.ndarray:
        """Full distributed reorder. Returns filtered walker-major
        (rid, flag, pos_delta, rc) rows like ReorderEngine.run."""
        import sys
        import time
        prog = self._prog
        m = self.mesh
        eng.LAST_RUN_STATS.clear()
        t_start = time.time()
        rows_dev = mh.put_sharded(m, self.packed)
        btab, keys_dev, rids, pairs, dropped = prog["build"](rows_dev)
        nd = int(np.asarray(mh.to_host(dropped)).sum())
        if nd:
            print(f"[dict] {nd} keys overflowed the sharded hash tables "
                  "and were dropped", file=sys.stderr)
        stride = max(self.N // max(self.B, 1), 1)
        idx = np.arange(self.N, dtype=np.int32)
        so = (np.concatenate([idx[r::stride] for r in range(stride)])
              if self.N else idx)
        queue = so.astype(np.int32)
        state = self.init_state()
        qslice, nq_arr = self._queue_slices(queue)
        state["n_queue"] = mh.put_sharded(m, nq_arr)
        seed_dev = mh.put_sharded(m, qslice)
        maxshift = mh.put_replicated(m, np.int32(self.cfg.max_shift))
        chunks = []
        rounds = 0
        last_claimed = 0

        def dispatch():
            nonlocal state
            state, buf, stats = prog["flush"](state, btab, pairs,
                                              rows_dev, seed_dev, maxshift)
            try:
                buf.copy_to_host_async()
            except Exception:
                pass
            return buf, stats

        # pipelined loop: flush k+1 is dispatched before flush k's stats
        # are read (single-chip pattern — the speculative flush after the
        # exit runs on a finished state and emits nothing)
        inflight = dispatch()
        while True:
            nxt = dispatch()
            buf_k, stats_k = inflight
            inflight = nxt
            stats_np = np.asarray(mh.to_host(stats_k)).reshape(self.n, 4)
            chunks.append(eng._compact_emit(np.asarray(mh.to_host(buf_k))))
            rounds += eng.FLUSH_ROUNDS
            n_claimed = int(stats_np[0, 0]) - (self.Np - self.N)
            any_active = stats_np[:, 2].sum() > 0
            emitted = int(stats_np[:, 3].sum())
            drained = bool((stats_np[:, 1] >= nq_arr).all())
            if progress is not None:
                progress(n_claimed, self.N)
            if drained and not any_active and (emitted == 0
                                               or n_claimed >= self.N):
                break
            if max_rounds is not None and rounds >= max_rounds:
                break
            # periodic in-bin dictionary compaction (live entries to the
            # front of every bin so the C-cap fetch sees live reads;
            # single-chip analog engine.py _compact_dicts)
            if n_claimed - last_claimed > eng.REBUILD_FRACTION * max(
                    self.N, 1):
                rids, pairs = prog["compact"](keys_dev, rids,
                                              state["claimed"])
                last_claimed = n_claimed
            # endgame seed-queue compaction (drop claimed reads so the
            # tail doesn't burn rounds skipping them batch by batch)
            if n_claimed < self.N and \
                    self.N - n_claimed < 0.5 * max(int(nq_arr.sum()), 1):
                claimed_np = np.unpackbits(
                    np.asarray(mh.to_host(state["claimed"]))
                    [: self.Np // 32].view(np.uint8),
                    bitorder="little")[: self.N].astype(bool)
                remaining = queue[~claimed_np[queue]]
                if len(remaining) < int(nq_arr.sum()):
                    queue = remaining
                    qslice, nq_arr = self._queue_slices(queue)
                    seed_dev = mh.put_sharded(m, qslice)
                    state["n_queue"] = mh.put_sharded(m, nq_arr)
                    state["queue_pos"] = mh.put_sharded(
                        m, np.zeros(self.n, np.int32))
        # drain the speculative in-flight flush
        buf_k, _ = inflight
        chunks.append(eng._compact_emit(np.asarray(mh.to_host(buf_k))))
        out = eng._emissions_from_chunks(chunks)
        dt = time.time() - t_start
        # per-device peak memory while the sharded tables are still live
        # (None where the backend keeps no allocator stats, or for another
        # process's devices)
        peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use")
                 if d.process_index == jax.process_index() else None
                 for d in m.devices.flat]
        eng.LAST_RUN_STATS.update(
            rounds=rounds, flush_wall_s=round(dt, 3),
            ms_per_round=round(1000 * dt / max(rounds, 1), 2),
            emitted=int(len(out)), walkers=self.B, devices=self.n,
            device_peak_bytes=peaks)
        return out
