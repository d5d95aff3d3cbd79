"""Short-read mode: reorder-assemble-encode pipeline (the main path).

Reference analog: the full compress chain preprocess -> reorder -> encoder ->
reorder_compress_streams (src/spring.cpp:139-216) and decompress_short
(src/decompress.cpp:28-436).

Redesign decisions (vs the reference's temp-file dataflow):
  * Reads live in fixed-shape arrays end to end; the reorder search runs as
    a batched JAX program (reorder/engine.py), consensus + noise as
    vectorized array passes (encode/consensus.py).
  * All per-read metadata is laid out in ORIGINAL read order and re-blocked
    into num_reads_per_block blocks — each block's streams are independent,
    which is what gives random access (reference
    src/reorder_compress_streams.cpp:201-427 does the same re-blocking).
  * A read is either `aligned` (flag 1: consensus substring + noise) or
    `literal` (flag 0: raw bases). N-containing reads and singleton-contig
    reads get a second-chance alignment against the built consensus
    (encode/second_chance.py, wired below; reference analog
    src/encoder.h:242-351) before falling back to literal.

Stream members per block b:
  flag.b rlen.b  — all reads;  pos.b rc.b nn.b npos.b nchar.b — aligned;
  literal.b      — literal read bases;  quality.b id.b — as in long mode.
Global members: seq.0 (packed consensus), plus the JSON manifest.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import params as P
from ..codecs import bsc, idcodec, qv
from ..encode import consensus as cons
from ..encode import streams as st
from ..io import fastq, fastq_native, packing
from ..io.container import ArchiveReader, ArchiveWriter
from ..io.ids import check_id_pattern, find_id_pattern, modify_id
from . import quality as qual_mod


def _rss_gb() -> float:
    return _vm()[0]


def _vm() -> tuple[float, float]:
    """(VmRSS, VmHWM) in GB — HWM localizes transient peaks between
    stage marks."""
    rss = hwm = 0.0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    rss = int(line.split()[1]) / 1e6
                elif line.startswith("VmHWM"):
                    hwm = int(line.split()[1]) / 1e6
    except OSError:
        pass
    return rss, hwm


def _gather_ids(idbuf: np.ndarray, idoffs: np.ndarray, idlens: np.ndarray,
                sel: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Ragged gather of ids for the reads in ``sel`` (vectorized)."""
    cnts = idlens[sel].astype(np.int64)
    starts = idoffs[sel]
    tot = int(cnts.sum())
    if not tot:
        return np.empty(0, np.uint8), idlens[sel]
    ends = np.cumsum(cnts)
    inner = np.arange(tot) - np.repeat(ends - cnts, cnts)
    return idbuf[np.repeat(starts, cnts) + inner], idlens[sel]


def check_quality_lengths(blk, path: str) -> None:
    """Reference guard src/preprocess.cpp:200-202: quality and read length
    must match per record (also catches FASTA fed without --fasta-input)."""
    for s, q in zip(blk.seqs, blk.quals):
        if len(s) != len(q):
            raise ValueError(
                f"{path}: quality length != read length "
                "(FASTA input needs --fasta-input)")


# stage wall seconds of the most recent compress_short run — bench.py
# reports this next to the headline so a regression is attributable to a
# stage.
# Module-level by design: one compress call per process (the bench/CLI
# shape) — concurrent compress calls in one process would interleave
# these stats (engine.LAST_RUN_STATS likewise).
LAST_STAGE_SECONDS: dict[str, float] = {}


def compress_short(files: list[str], writer: ArchiveWriter,
                   cp: P.CompressionParams, num_threads: int = 8,
                   _scanned=None) -> None:
    from ..reorder import engine as eng

    trace = os.environ.get("SPRING_TPU_TRACE")
    LAST_STAGE_SECONDS.clear()
    _t = time.time()

    def mark(stage):
        nonlocal _t
        now = time.time()
        LAST_STAGE_SECONDS[stage] = round(
            LAST_STAGE_SECONDS.get(stage, 0.0) + (now - _t), 3)
        if trace:
            rss, hwm = _vm()
            print(f"[trace] {stage}: {now - _t:.2f}s rss={rss:.2f}G "
                  f"hwm={hwm:.2f}G", flush=True)
        _t = now

    block = cp.num_reads_per_block
    want_q = cp.preserve_quality and not cp.fasta_input
    # streaming load: inputs are mmap'd (gz: stream-decompressed to an
    # unlinked temp file), scanned serially, then parsed record-parallel
    # STRAIGHT into the final concatenated arrays — packed 2-bit rows with
    # a sparse N overlay; the byte codes matrix never exists. Reference
    # analog: blockwise preprocess into 2-bit bitsets + temp streams
    # (src/preprocess.cpp:141-285).
    if _scanned is None:
        bufs = [fastq_native.open_buf(f) for f in files]
        infos = [fastq_native.scan_buf(b, f, fasta=cp.fasta_input)
                 for b, f in zip(bufs, files)]
    else:
        bufs, infos = _scanned
    counts = [i.n for i in infos]
    if len(files) == 2 and counts[0] != counts[1]:
        raise ValueError("paired files have different read counts")
    mark("scan")
    n = sum(counts)
    # per-shard read cap: device read ids are int32 (PARITY.md "Beyond
    # 2^31 reads"); larger inputs split into independent super-shards
    # inside one archive. SPRING_TPU_SHARD_READS lowers the cap so the
    # shard machinery is testable at small n.
    cap = min(int(os.environ.get("SPRING_TPU_SHARD_READS", "0"))
              or P.MAX_NUM_READS_SHORT, P.MAX_NUM_READS_SHORT)
    if n > cap:
        if _scanned is not None:
            raise RuntimeError("shard slicing exceeded the read cap")
        _compress_sharded(files, writer, cp, num_threads, bufs, infos, cap)
        return
    cp.num_reads = n
    cp.num_blocks = -(-n // block) if n else 0
    maxlen = max((i.maxlen for i in infos), default=0)
    if maxlen > P.MAX_READ_LEN:
        raise ValueError(
            f"read length {maxlen} > {P.MAX_READ_LEN}; use long mode (-l)")
    cp.max_readlen = maxlen
    paired = cp.paired_end
    per_file = counts[0] if paired else n

    # one index space: file 1 then file 2 (reference src/preprocess.cpp
    # merges the same way), rows padded to the common maxlen
    ml = max(maxlen, 1)
    W = -(-ml // 16)
    # rows over-allocated to the next power of two: the reorder engine
    # transfers this array to the device and gathers its subset there, and
    # a pow2 shape keeps one compiled program per size bucket (np.empty
    # padding pages are never written -> no host RSS cost)
    n_pad = max(1 << max(n - 1, 1).bit_length(), 64)
    # prewarm the device dictionary-build program while the host parses,
    # so its compile overlaps the parse instead of following it (the
    # device is otherwise idle here). The clean-read count usually shares
    # n's padding bucket; a mismatch only wastes the warmup. Errors are
    # swallowed on purpose: the warmup is best-effort, and the real build
    # after the parse compiles the same program and fails loudly.
    if n >= 2_000_000 and maxlen >= 32 and not os.environ.get(
            "SPRING_TPU_DIST"):
        def _prewarm_dict_build(np2=eng.padded_n(n), w2=W, ml2=maxlen):
            try:
                import jax.numpy as jnp
                from ..reorder import dictionary as dct2
                rows = jnp.zeros((np2, w2 + 1), jnp.uint32)
                ws = dct2.default_windows(ml2)
                if ws:
                    out = dct2._build_hash_dict_dev(
                        rows, jnp.asarray(0, jnp.int32), ws[0].start,
                        dct2.table_buckets(np2))
                    out[0].block_until_ready()
            except Exception:
                pass
        import threading
        threading.Thread(target=_prewarm_dict_build, daemon=True).start()
    packed_buf = np.empty((n_pad, W), np.uint32)
    packed_all = packed_buf[:n]
    lengths = np.empty(n, np.int32)
    idbytes = sum(i.idbytes for i in infos)
    idbuf = np.empty(idbytes, np.uint8)
    idlens = np.empty(n, np.uint32)

    # --- quality memory plan: the full (n, ml)
    # quality matrix never exists. Raw rows spill to an unlinked spool
    # during parse and are gathered per output bin later (the reference's
    # bin strategy, src/reorder_compress_quality_id.cpp:64-68) — in
    # EVERY mode: compressing blocks during parse (the round-3 streamer)
    # throttled the parser behind the quality codec (~9 s of the 13 s
    # 10M parse stage), while the spool defers that codec work to the
    # reorder phase, where the host sits idle next to the device engine.
    from . import qualstream
    table = (qual_mod.make_table(cp.quality_mode, cp.qvz_ratio,
                                 cp.bin_thresholds)
             if want_q and cp.quality_mode in ("ill_bin", "binary")
             else None)
    fine_pos = cp.quality_mode == "qvz"
    # leave one core for the main thread, which drives the device engine:
    # with every core in the codec pool, device dispatches stalled on the
    # previous host. Kept until measured on the H100 (ROADMAP 3.2).
    workers = max(1, num_threads - 1)
    pool = ThreadPoolExecutor(max_workers=workers)
    futs = []

    def _sink(name, fn, *args):
        """Submit a codec task that writes its member the moment it
        completes (the spooled writer is thread-safe and emits the tar
        in canonical order at finish) — compressed bytes never pile up
        in retained futures; futs only carries errors to the drain."""
        def run():
            writer.add(name, fn(*args))
        futs.append(pool.submit(run))

    # flipped once the device engine phase ends: during it, codec tasks
    # stay single-OMP-thread (the pool is the parallelism and the main
    # thread keeps its core); in the drain tail the engine's reserved
    # core is idle, so tasks widen to 2 threads (~60 MB of block streams
    # on 3x1 threads was the last ~7 s of a 10M compress)
    device_done = [False]

    def _bsc1(raw):
        return bsc.compress(raw, num_threads=2 if device_done[0] else 1)

    inflight_cap = 2 * workers
    spool = None
    if want_q:
        spool = qualstream.QualSpool(
            n, ml, dir=os.path.dirname(files[0]) or ".")

    # overlap the engine's packed-rows h2d with the parse (single-file
    # inputs; multi-file offsets break the stager's tail-pad ordering).
    # Built for a slow host-device link; kept until measured on the H100
    # (ROADMAP 3.2).
    stager = None
    if (len(files) == 1 and n >= 2_000_000 and maxlen >= 32
            and not os.environ.get("SPRING_TPU_DIST")
            and not os.environ.get("SPRING_TPU_NO_STAGER")):
        stager = eng.DeviceRowStager(n, W, fastq_native._SEG_RECORDS)

    exc_parts = []
    off = 0
    ido = 0
    for buf, info, f in zip(bufs, infos, files):
        if info.n:
            if spool is not None:
                sink = (lambda o: lambda r0, rows:
                        spool.write(o + r0, rows))(off)
            else:
                sink = None
            exc = fastq_native.parse_packed_into(
                buf, f, info, ml, packed_all[off:off + info.n],
                lengths[off:off + info.n], None,
                idbuf[ido:ido + info.idbytes],
                idlens[off:off + info.n],
                fasta=cp.fasta_input, num_threads=num_threads,
                qual_sink=sink,
                row_sink=stager.feed if stager is not None else None)
            if len(exc):
                exc[:, 0] += off
                exc_parts.append(exc)
        off += info.n
        ido += info.idbytes
    del bufs, infos
    overlay = cons.NOverlay.from_pairs(
        np.concatenate(exc_parts) if exc_parts else
        np.empty((0, 2), np.int32))
    del exc_parts
    idoffs = np.concatenate([[0], np.cumsum(idlens.astype(np.int64))])
    mark("load+parse")

    # --- PE id pattern detection (reference src/preprocess.cpp:113-140)
    pattern_code = 0
    pattern_ok = False
    if paired and cp.preserve_id and per_file:
        def _id(i):
            return idbuf[idoffs[i]:idoffs[i + 1]].tobytes()
        pattern_code = find_id_pattern(_id(0), _id(per_file))
        if pattern_code:
            pattern_ok = all(
                check_id_pattern(_id(i), _id(per_file + i), pattern_code)
                for i in range(per_file))
    cp.paired_id_match = bool(pattern_ok and pattern_code)
    cp.paired_id_code = pattern_code if cp.paired_id_match else 0

    # the per-block id gathers run INSIDE the worker so at most
    # num_threads block-sized copies are live at once (submitting the
    # gathered arrays directly would materialize every block up front).
    # The id arrays ride as EXPLICIT task args — once every id task is
    # submitted the main frame drops its references (the blob is ~300 MB
    # at 10M reads) and the memory dies with the last task.
    def _id_task(ib, io_, il, sel):
        return idcodec.compress_ids_raw(*_gather_ids(ib, io_, il, sel))

    def _submit_ids_se(order):
        if not cp.preserve_id:
            return
        for b in range(cp.num_blocks):
            sel = order[b * block:(b + 1) * block]
            _sink(f"id.{b}", _id_task, idbuf, idoffs, idlens, sel)

    def _submit_ids_pe(pairs):
        if not cp.preserve_id:
            return
        nb = -(-per_file // block) if per_file else 0
        for b in range(nb):
            p1 = pairs[b * block:(b + 1) * block]
            idsel = (p1 if cp.paired_id_match
                     else np.concatenate([p1, p1 + per_file]))
            _sink(f"id.{b}", _id_task, idbuf, idoffs, idlens, idsel)

    def _quality_sels(order_or_pairs) -> list:
        """(member name, global row indices) per output quality block —
        the layout the resident-matrix path compressed (PE: file-1 rows
        then file-2 rows of the same pair block)."""
        if paired:
            nb = -(-per_file // block) if per_file else 0
            out = []
            for b in range(nb):
                p1 = order_or_pairs[b * block:(b + 1) * block]
                out.append((f"quality.{b}",
                            np.concatenate([p1, p1 + per_file])))
            return out
        return [(f"quality.{b}",
                 order_or_pairs[b * block:(b + 1) * block])
                for b in range(cp.num_blocks)]

    bin_threads = []

    def _start_quality_bins(sels):
        """Spool-backed quality compression on its own thread (the bin
        gather must not block the engine's flush loop or the stream
        submission; _sink appends futures atomically under the GIL and
        the spooled writer serializes member writes)."""
        if spool is None or not sels:
            return
        import threading
        t = threading.Thread(
            target=qualstream.drive_quality_bins,
            args=(spool, _sink, sels, lengths, cp.quality_mode,
                  table, cp.qvz_ratio, fine_pos, inflight_cap),
            daemon=True)
        t.start()
        bin_threads.append(t)

    # in order-preserving mode the output order is known before the reorder
    # runs — id codec and spooled quality-bin work overlaps the device
    # engine. It is submitted from the engine's first progress callback
    # (after the dict build): codec workers contending with the main
    # thread during the engine's init slowed the dict build on the
    # previous host (kept until measured on the H100, ROADMAP 3.2).
    deferred_submitted = False

    def _release_ids():
        # every id task is submitted (tasks own their array args): drop
        # the main frame's references so the blob dies with the last task
        nonlocal idbuf, idoffs, idlens
        idbuf = idoffs = idlens = None

    def _submit_deferred():
        # order-preserving mode only; in -r mode the flag stays False and
        # the post-reorder paths submit with the final output order
        nonlocal deferred_submitted
        if deferred_submitted or not (cp.preserve_order and n):
            return
        deferred_submitted = True
        if paired:
            cp.num_blocks = -(-per_file // block) if per_file else 0
            pairs = np.arange(per_file, dtype=np.int64)
            _submit_ids_pe(pairs)
            _start_quality_bins(_quality_sels(pairs))
        else:
            order = np.arange(n, dtype=np.int64)
            _submit_ids_se(order)
            _start_quality_bins(_quality_sels(order))
        _release_ids()

    def _progress(_claimed, _total):
        _submit_deferred()

    mark("quantize+idcheck")
    has_n = overlay.has_n_mask(n)
    clean_rids = np.nonzero(~has_n)[0].astype(np.int32)

    # per-read metadata in int32 (the int64 forms were ~2.4 GB of the
    # 100M peak RSS): gpos/noise_off are consensus /
    # noise-array offsets, both guarded < 2^31 below; lay_rank < n which
    # short mode already caps at int32 (params.MAX_NUM_READS_SHORT)
    flag = np.zeros(n, np.uint8)
    gpos = np.zeros(n, np.int32)
    rc = np.zeros(n, np.uint8)
    nn_by_read = np.zeros(n, np.int32)
    noise_off = np.zeros(n, np.int32)      # read -> offset into noise arrays
    lay_rank = np.full(n, -1, np.int32)    # read -> rank in layout order
    noisepos = np.empty(0, np.int32)
    noisechar = np.empty(0, np.uint8)
    seq_codes = np.empty(0, np.uint8)

    # seq stream: u64 length + 2-bit packed consensus. Submitted the
    # moment the consensus is FINAL (after stitch — noise extraction and
    # second chance only read it), so its ~n/2 bytes of xbc work overlap
    # the noise/second-chance device stages instead of joining the drain
    # tail (the full block-stream members cannot move
    # up the same way: flag/gpos/order_out stay unknown until second
    # chance resolves the leftover reads)
    seq_submitted = False

    def _submit_seq():
        nonlocal seq_submitted
        if seq_submitted:
            return
        seq_submitted = True
        _sink("seq.0", _bsc1,
              np.uint64(len(seq_codes)).tobytes()
              + packing.codes_to_bitstream_2bit(
                  seq_codes[None, :], np.array([len(seq_codes)])))

    if len(clean_rids) and maxlen >= 32:
        c_len = lengths[clean_rids]
        use_dist = os.environ.get("SPRING_TPU_DIST")
        if use_dist:
            from ..parallel import dist as dist_mod
            packed = np.ascontiguousarray(packed_all[clean_rids])
            engine = dist_mod.DistReorderEngine(
                packed, c_len, dist_mod.DistConfig(max_readlen=maxlen))
        else:
            cfg = eng.ReorderConfig(max_readlen=maxlen)
            for env, attr in (("SPRING_TPU_WALKERS", "num_walkers"),
                              ("SPRING_TPU_SC", "shift_chunk"),
                              ("SPRING_TPU_SLOTS", "accept_slots"),
                              ("SPRING_TPU_FARDICT", "far_near")):
                v = os.environ.get(env)
                if v:
                    setattr(cfg, attr, int(v))
            # the clean-row gather happens on device (engine `select`)
            engine = eng.ReorderEngine(
                packed_buf, lengths, cfg, select=clean_rids,
                rows_dev=stager.rows() if stager is not None else None)
            if stager is not None:
                # the engine owns the staged table now; run() drops it
                # once the padded row table is assembled
                stager.release()
        mark("dict_build")
        emissions = engine.run(progress=_progress)
        _submit_deferred()      # zero-flush runs never fire the callback
        mark("reorder_run")
        # contigs below MIN_CONTIG_READS don't pay for a consensus copy:
        # their reads join the leftover pool and re-place against the
        # surviving consensus in the second-chance pass (walker seed
        # fragmentation produces many short duplicate contigs; demoting
        # them shrinks the seq stream at no decoder cost)
        min_reads = int(os.environ.get("SPRING_TPU_MIN_CONTIG",
                                       P.MIN_CONTIG_READS))
        layout, _singles = cons.layout_from_emissions(
            emissions, engine.B, c_len, min_reads=min_reads,
            ordered=getattr(engine, "ordered_emissions", False))
        # release the engine's device residency (dict tables, row table,
        # stager buffer) before the consensus/second-chance device work,
        # which needs that device memory
        if hasattr(engine, "release"):
            engine.release()
        else:                       # dist engine: null the device attrs
            for attr in ("_dicts", "_rows_dev", "lengths"):
                if hasattr(engine, attr):
                    setattr(engine, attr, None)
        if stager is not None:
            stager.release()
        engine = None
        mark("assemble_contigs")
        if layout.seq_len:
            g = clean_rids[layout.rids]          # layout order -> global rid
            glay = cons.ContigLayout(rids=g.astype(np.int32),
                                     gpos=layout.gpos, rc=layout.rc,
                                     seq_len=layout.seq_len,
                                     cbase=layout.cbase, clen=layout.clen,
                                     ccount=layout.ccount)
            seq_codes = cons.build_consensus_packed(glay, packed_all,
                                                    lengths)
            mark("consensus")
            # stitch contigs whose heads re-align inside other contigs so
            # overlapping coverage pays for one consensus copy, then
            # re-vote the merged consensus (overlaps gain votes)
            if os.environ.get("SPRING_TPU_STITCH", "1") != "0":
                from ..encode import stitch as stch
                glay2, n_st = stch.stitch_layout(glay, seq_codes, lengths)
                if n_st:
                    glay = glay2
                    g = glay.rids
                    seq_codes = cons.build_consensus_packed(
                        glay, packed_all, lengths)
                mark(f"stitch[{n_st}]")
            if len(seq_codes) <= 2**31 - 1:     # guard below still fires
                _submit_seq()
            nn, noisepos, noisechar = cons.extract_noise_packed(
                glay, seq_codes, packed_all, lengths)
            mark("noise")
            # int32 metadata guards: consensus coords and noise offsets
            # must fit (fails loudly instead of wrapping; >2 Gbase
            # consensus / >2G substitutions is past short-mode scale)
            if len(seq_codes) > 2**31 - 1 or len(noisepos) > 2**31 - 1:
                raise OverflowError(
                    "consensus/noise size exceeds int32 metadata "
                    f"({len(seq_codes)} bases, {len(noisepos)} noise)")
            flag[g] = 1
            gpos[g] = glay.gpos
            rc[g] = glay.rc
            nn_by_read[g] = nn
            noise_off[g] = np.concatenate(
                [[0], np.cumsum(nn.astype(np.int64))[:-1]]).astype(np.int32)
            lay_rank[g] = np.arange(len(g), dtype=np.int32)

    _submit_deferred()      # engine may not have run (no clean reads,
    # maxlen < 32) — make sure order-preserving codec work is in flight

    # second chance: align N-reads and singleton-contig reads against the
    # consensus (reference src/encoder.h:242-351)
    leftover = np.nonzero(flag == 0)[0]
    if len(leftover) and len(seq_codes) >= 16 and maxlen >= 32:
        from ..encode import second_chance as sc
        lens_l = lengths[leftover]
        nm_f, nm_r = overlay.nmask_planes(leftover, lens_l, ml)
        g2pos, g2rc, placed = sc.align_leftovers_packed(
            seq_codes, np.ascontiguousarray(packed_all[leftover]),
            nm_f, nm_r, lens_l)
        g2 = leftover[placed]
        if len(g2):
            order2 = np.argsort(g2pos[placed], kind="stable")
            g2 = g2[order2]
            flag[g2] = 1
            gpos[g2] = g2pos[placed][order2]
            rc[g2] = g2rc[placed][order2]
            lay2 = cons.ContigLayout(rids=g2.astype(np.int32),
                                     gpos=gpos[g2], rc=rc[g2],
                                     seq_len=len(seq_codes))
            nn2, npos2, nchar2 = cons.extract_noise_packed(
                lay2, seq_codes, packed_all, lengths, overlay)
            nn_by_read[g2] = nn2
            if len(noisepos) + len(npos2) > 2**31 - 1:
                raise OverflowError("noise array exceeds int32 offsets")
            noise_off[g2] = (len(noisepos) + np.concatenate(
                [[0], np.cumsum(nn2.astype(np.int64))[:-1]])
            ).astype(np.int32)
            noisepos = np.concatenate([noisepos, npos2])
            noisechar = np.concatenate([noisechar, nchar2])
            lay_rank[g2] = int((lay_rank >= 0).sum()) + np.arange(len(g2))
        mark("second_chance")

    device_done[0] = True       # tail codec tasks may widen to 2 threads

    # reorder quality metric, always computed (one sum): a bin-staleness
    # regression on real data (stale claimed entries displacing live bin
    # candidates while compaction is off) shows up here without needing
    # SPRING_TPU_TRACE — bench.py reports it beside the headline
    unmatched = int((flag == 0).sum())
    eng.LAST_RUN_STATS["unmatched_frac"] = round(unmatched / max(n, 1), 5)
    if trace:
        # reorder quality metrics (reference comparison point: 199,725 of
        # 3,258,816 clean reads unmatched on SRR554369 ~= 6.1%,
        # logs/8_29_18/SRR554369.log:563)
        print(f"[trace] reorder quality: aligned={n - unmatched} "
              f"unmatched={unmatched} ({100 * unmatched / max(n, 1):.2f}%) "
              f"consensus={len(seq_codes)} bases "
              f"({len(seq_codes) / max(n * max(maxlen, 1), 1):.3f}x of "
              f"read bases)", flush=True)

    _submit_seq()       # edge paths (no clean reads, maxlen < 32, empty
    # layout) reach here without the early post-stitch submission

    # ---- free the packed row table before the stream codecs run: its
    # only remaining consumer is the literal stream (unaligned/N reads —
    # 0.04% + N fraction), whose char rows are gathered into a small side
    # table first. At 100M reads the table is ~2.8 GB of the peak host
    # RSS. Skipped when literals are the bulk
    # of the input (no-clean-reads / maxlen<32 paths) — the char matrix
    # would then out-size the packed rows it frees.
    lit_rids = np.nonzero(flag == 0)[0].astype(np.int64)
    lit_chars_all = None
    if lit_rids.size * ml <= packed_buf.nbytes // 2:
        lit_chars_all = packing.CODE_TO_CHAR[
            cons.unpack_rows(packed_all, lit_rids, ml, overlay)]
        packed_all = packed_buf = None

    # --- output order (-r): re-block by the internal reorder instead of the
    # original order. PE keeps pairing implicit by position: output k pairs
    # with output k + n/2 (pe_encode invariant, src/pe_encode.cpp:41-69).
    if cp.preserve_order:
        order_out = np.arange(n, dtype=np.int32)
    else:
        # aligned reads take their layout (contig-walk) rank; literal reads
        # (N / singleton) follow in original order
        seq_rank = lay_rank.copy()
        rest = np.nonzero(seq_rank < 0)[0]
        n_aligned = int((lay_rank >= 0).sum())
        seq_rank[rest] = n_aligned + np.arange(len(rest), dtype=np.int32)
        if paired:
            rank1 = np.argsort(seq_rank[:per_file],
                               kind="stable").astype(np.int32)
            order_out = np.concatenate([rank1, rank1 + per_file])
        else:
            order_out = np.argsort(seq_rank, kind="stable").astype(np.int32)

    def _noise_for(al: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Ragged gather of noise for aligned reads ``al`` (block order),
        positions delta-coded within each read (reference noisepos
        semantics, src/encoder.cpp:76-109)."""
        cnts = nn_by_read[al]
        starts = noise_off[al]
        tot = int(cnts.sum())
        if not tot:
            return np.empty(0, np.int32), np.empty(0, np.uint8)
        ends = np.cumsum(cnts)
        inner = np.arange(tot) - np.repeat(ends - cnts, cnts)
        take = np.repeat(starts, cnts) + inner
        npos_b, nchar_b = noisepos[take], noisechar[take]
        prev = np.concatenate([[0], npos_b[:-1]])
        return np.where(inner == 0, npos_b, npos_b - prev), nchar_b

    def _literal_blob(lit: np.ndarray) -> bytes:
        if lit_chars_all is not None:
            # lit_rids is sorted (np.nonzero) and every flag==0 rid is in
            # it, so searchsorted is an exact index
            lit_chars = lit_chars_all[np.searchsorted(lit_rids, lit)]
        else:
            lit_chars = packing.CODE_TO_CHAR[
                cons.unpack_rows(packed_all, lit, ml, overlay)]
        lit_valid = np.arange(ml)[None, :] < lengths[lit, None]
        return lit_chars[lit_valid].tobytes()

    if paired:
        # --- PE pair-delta layout (reference flags 0-4 + int16 pair
        # distance + relative-RC bit, src/reorder_compress_streams.cpp:
        # 34-64,283-306): blocks hold `block` read PAIRS, so a properly
        # paired file-2 read costs ~2 bytes of metadata.
        cp.num_blocks = -(-per_file // block) if per_file else 0
        pairs_out = order_out[:per_file]
        if not deferred_submitted:
            _submit_ids_pe(pairs_out)
            _start_quality_bins(_quality_sels(pairs_out))
            _release_ids()
        for b in range(cp.num_blocks):
            p1 = pairs_out[b * block:(b + 1) * block]
            p2 = p1 + per_file
            f1 = flag[p1] == 1
            f2 = flag[p2] == 1
            pdist = gpos[p2] - gpos[p1]
            near = np.abs(pdist) < 32767
            pflag = np.select(
                [f1 & f2 & near, f1 & f2, ~f1 & ~f2, f1 & ~f2],
                [0, 1, 2, 3], default=4).astype(np.uint8)
            pl0 = pflag == 0
            al1 = p1[f1]                      # flags 0,1,3 in pair order
            al2u = p2[f2 & ~pl0]              # flags 1,4 (unpaired r2)
            alr = np.concatenate([al1, p2[f2]])   # noise order: r1s, r2s
            lit = np.concatenate([p1[~f1], p2[~f2]])
            npos_b, nchar_b = _noise_for(alr)
            members = {
                f"flag.{b}": st.encode_u8(pflag),
                f"rlen.{b}": st.encode_u16(
                    np.stack([lengths[p1], lengths[p2]], 1).ravel()),
                f"pos.{b}": st.encode_deltas_u16(gpos[al1]),
                f"pos2.{b}": st.encode_deltas_u16(gpos[al2u]),
                f"pospair.{b}": st.encode_u16(
                    pdist[pl0].astype(np.int16).view(np.uint16)),
                f"rcpair.{b}": st.encode_u8(
                    (rc[p1[pl0]] == rc[p2[pl0]]).astype(np.uint8)),
                f"rc.{b}": st.encode_u8(
                    np.concatenate([rc[al1], rc[al2u]])),
                f"nn.{b}": st.encode_u16(nn_by_read[alr]),
                f"npos.{b}": st.encode_u16(npos_b),
                f"nchar.{b}": st.encode_u8(nchar_b),
                f"literal.{b}": _literal_blob(lit),
            }
            for name, raw in members.items():
                _sink(name, _bsc1, raw)
    else:
        if not deferred_submitted:
            _submit_ids_se(order_out)
            _start_quality_bins(_quality_sels(order_out))
            _release_ids()
        for b in range(cp.num_blocks):
            s, e = b * block, min((b + 1) * block, n)
            sel = order_out[s:e]
            al = sel[flag[sel] == 1]
            lit = sel[flag[sel] == 0]
            npos_b, nchar_b = _noise_for(al)
            members = {
                f"flag.{b}": st.encode_u8(flag[sel]),
                f"rlen.{b}": st.encode_u16(lengths[sel]),
                f"pos.{b}": st.encode_deltas_u16(gpos[al]),
                f"rc.{b}": st.encode_u8(rc[al]),
                f"nn.{b}": st.encode_u16(nn_by_read[al]),
                f"npos.{b}": st.encode_u16(npos_b),
                f"nchar.{b}": st.encode_u8(nchar_b),
                f"literal.{b}": _literal_blob(lit),
            }
            for name, raw in members.items():
                _sink(name, _bsc1, raw)

    mark("block_streams_submit")
    for t in bin_threads:
        t.join()
    mark("qbins_join")
    for fut in futs:
        fut.result()        # propagate codec/writer errors
    pool.shutdown()
    if spool is not None:
        spool.close()
    mark("codec+write")


# ---------------- super-shard container (> per-shard read cap) ----------
#
# Reference ceiling: 4.29e9 reads via uint32 ids (src/params.h:24). Here
# one compression shard holds <= 2^31-2 reads (int32 device rids); larger
# inputs become k independent sub-archives inside ONE container — shard
# j's members under "sh<j>/" with a per-shard manifest, the top manifest
# carrying shard_reads for routing. PE shards split at pair granularity
# so the pe_encode invariant holds per shard. Design note: PARITY.md
# "Beyond 2^31 reads".


class _ShardWriter:
    """Routes writer.add under a shard prefix (writer API used by the
    compress body is add() only)."""

    def __init__(self, inner, prefix: str):
        self._inner = inner
        self._prefix = prefix

    def add(self, name: str, data: bytes) -> None:
        self._inner.add(self._prefix + name, data)


class _ShardReader:
    """Reader view of one shard: get/get_block under the prefix, params
    from the shard's own manifest."""

    def __init__(self, inner, prefix: str):
        self._inner = inner
        self._prefix = prefix
        self.params = P.CompressionParams.from_json(
            inner.get(prefix + "params.json").decode())

    def get(self, name: str) -> bytes:
        return self._inner.get(self._prefix + name)

    def get_block(self, stream: str, block: int) -> bytes:
        return self._inner.get(f"{self._prefix}{stream}.{block}")


def _slice_scan(info, a: int, b: int, stride: int):
    """ScanInfo view covering records [a, b) of a scanned buffer. `a`
    must sit on a checkpoint boundary; ckpt_byte offsets stay absolute
    (the shard parses the ORIGINAL buffer), ckpt_id rebases to the
    shard's first id byte (the parse writes ids relative to its slice)."""
    assert a % stride == 0
    c0 = a // stride
    if b % stride == 0 and b // stride < len(info.ckpt_id) and b < info.n:
        id_end = int(info.ckpt_id[b // stride])
    else:
        id_end = info.idbytes
    idb0 = int(info.ckpt_id[c0])
    return fastq_native.ScanInfo(
        n=b - a, maxlen=info.maxlen, idbytes=id_end - idb0,
        ckpt_byte=info.ckpt_byte[c0:],
        ckpt_id=info.ckpt_id[c0:] - idb0)


def _compress_sharded(files, writer, cp, num_threads, bufs, infos,
                      cap: int) -> None:
    import dataclasses

    stride = fastq_native.ckpt_stride()
    nfiles = len(files)
    per_file = infos[0].n
    # consistency guard: shard slicing trusts the scan's checkpoint
    # table; a claimed read count the table cannot cover would send the
    # native parser past its buffers. Fail loudly instead.
    for i, f in zip(infos, files):
        if (i.n - 1) // stride + 1 > len(i.ckpt_byte):
            raise ValueError(
                f"{f}: inconsistent scan (checkpoint table covers fewer "
                f"records than the claimed {i.n})")
    lim = cap // nfiles
    per_shard = (lim // stride) * stride
    if per_shard <= 0:
        raise ValueError(
            f"shard cap {cap} is below the parser checkpoint stride "
            f"({stride} records)")
    ranges = [(x, min(x + per_shard, per_file))
              for x in range(0, per_file, per_shard)]
    shard_reads = []
    maxlen = 0
    for j, (a, b) in enumerate(ranges):
        cpj = dataclasses.replace(cp, num_reads=0, num_blocks=0,
                                  shard_reads=())
        sub = [_slice_scan(i, a, b, stride) for i in infos]
        pw = _ShardWriter(writer, f"sh{j}/")
        compress_short(files, pw, cpj, num_threads, _scanned=(bufs, sub))
        pw.add("params.json", cpj.to_json().encode())
        shard_reads.append(cpj.num_reads)
        maxlen = max(maxlen, cpj.max_readlen)
    cp.num_reads = nfiles * per_file
    cp.max_readlen = maxlen
    cp.num_blocks = 0
    cp.shard_reads = tuple(shard_reads)


def decompress_short_sharded(reader, out_paths: list[str], gzipped: bool,
                             num_threads: int = 8,
                             read_range: tuple[int, int] | None = None
                             ) -> None:
    """Decompress a super-shard archive: shards decode in order and
    append to the output(s). PE single-output needs two passes (all
    shards' file-1 halves, then file-2) to match the unsharded layout."""
    cp = reader.params
    paired = cp.paired_end
    nfiles = 2 if paired else 1
    shard_n = list(cp.shard_reads)
    pf = [s // nfiles for s in shard_n]          # per-file reads per shard
    base = np.concatenate([[0], np.cumsum(pf)]).astype(np.int64)
    pf_total = int(base[-1])
    lo, hi = ((0, cp.num_reads) if read_range is None else read_range)
    single_out = len(out_paths) == 1

    def segs(glo: int, ghi: int, half: int):
        """Shard-local [a, b) segments of global per-file range
        [glo, ghi), mapped into half `half` of each shard's local index
        space."""
        out = []
        for j in range(len(shard_n)):
            a = max(glo - int(base[j]), 0)
            b = min(ghi - int(base[j]), pf[j])
            if a < b:
                out.append((j, half * pf[j] + a, half * pf[j] + b))
        return out

    if paired:
        plan1 = segs(max(lo, 0), min(hi, pf_total), 0)
        plan2 = segs(max(lo - pf_total, 0), min(hi - pf_total, pf_total), 1)
        if single_out:
            plan = [(s, 0) for s in plan1] + [(s, 0) for s in plan2]
        else:
            # full-shard fast path: one call decodes both halves per shard
            if read_range is None:
                plan = None
                for j in range(len(shard_n)):
                    decompress_short(_ShardReader(reader, f"sh{j}/"),
                                     out_paths, gzipped, num_threads,
                                     None, append=j > 0)
                return
            plan = [(s, 0) for s in plan1] + [(s, 1) for s in plan2]
    else:
        plan = [(s, 0) for s in segs(lo, hi, 0)]

    started: set = set()
    for (j, a, b), w in plan:
        decompress_short(_ShardReader(reader, f"sh{j}/"),
                         [out_paths[w]], gzipped, num_threads, (a, b),
                         append=out_paths[w] in started)
        started.add(out_paths[w])
    # a range can select zero reads for some outputs — still create them
    for p in out_paths:
        if p not in started:
            open(p, "wb").close()


def _windowed(pool, tasks, window: int):
    """Submit (fn, *args) tasks keeping at most `window` in flight; yield
    results in submission order (bounds decoded-block memory: completed
    blocks can't pile up faster than the writer drains them)."""
    from collections import deque
    dq = deque()
    for t in tasks:
        dq.append(pool.submit(*t))
        if len(dq) >= window:
            yield dq.popleft().result()
    while dq:
        yield dq.popleft().result()


def decompress_short(reader: ArchiveReader, out_paths: list[str],
                     gzipped: bool, num_threads: int = 8,
                     read_range: tuple[int, int] | None = None,
                     append: bool = False) -> None:
    cp = reader.params
    block = cp.num_reads_per_block
    n = cp.num_reads
    paired = cp.paired_end
    nfiles = 2 if paired else 1
    per_file = n // nfiles
    single_out = len(out_paths) == 1
    lo, hi = (0, n) if read_range is None else read_range

    raw = bsc.decompress(reader.get("seq.0"))
    seq_len = int(np.frombuffer(raw[:8], dtype=np.uint64)[0])
    seq_codes = packing.bitstream_2bit_to_flat(raw[8:], seq_len)

    pool = ThreadPoolExecutor(max_workers=num_threads)
    writers = [fastq.BlockWriter(p, gzipped=gzipped, fasta=cp.fasta_input,
                                 num_threads=num_threads, append=append)
               for p in out_paths]
    # per-block native thread budget: blocks are the outer parallelism, but
    # a short file (or the tail) has fewer blocks than threads — give the
    # sharded qv codec the leftover cores
    bt = max(1, num_threads // max(min(cp.num_blocks, num_threads), 1))

    # record formatting runs INSIDE the block workers (the ~0.5 s/block
    # serial format+write tail otherwise adds up after the last decode);
    # the main thread only appends ready blobs in block order
    try:
        if paired:
            # blocks hold read PAIRS; file j is half j of each block
            fl = [(max(lo, 0), min(hi, per_file)),
                  (max(lo - per_file, 0), max(min(hi - per_file, per_file),
                                              0))]
            if not single_out and fl[0] == fl[1] and fl[0][0] < fl[0][1]:
                flo, fhi = fl[0]
                b0, b1 = flo // block, (fhi - 1) // block
                res = _windowed(pool, ((_decode_fmt_pe, reader, cp, b,
                                        seq_codes, per_file, bt, flo, fhi,
                                        (0, 1))
                                       for b in range(b0, b1 + 1)),
                                2 * num_threads)
                for blobs in res:
                    for j in (0, 1):
                        writers[j].write_bytes(blobs[j])
            else:
                for j in range(2):
                    flo, fhi = fl[j]
                    if flo >= fhi:
                        continue
                    w = writers[0] if single_out else writers[j]
                    b0, b1 = flo // block, (fhi - 1) // block
                    res = _windowed(pool, ((_decode_fmt_pe, reader, cp, b,
                                            seq_codes, per_file, bt, flo,
                                            fhi, (j,))
                                           for b in range(b0, b1 + 1)),
                                    2 * num_threads)
                    for blobs in res:
                        w.write_bytes(blobs[0])
        else:
            w = writers[0]
            if lo < hi:
                b0, b1 = lo // block, (hi - 1) // block
                res = _windowed(pool, ((_decode_fmt, reader, cp, b,
                                        seq_codes, per_file, bt, lo, hi)
                                       for b in range(b0, b1 + 1)),
                                2 * num_threads)
                for blob in res:
                    w.write_bytes(blob)
    finally:
        pool.shutdown()
        for w in writers:
            w.close()


def _fmt_half(half, s: int, e: int) -> bytes:
    idbuf, idlens, chars, rlen, qmat = half
    idoffs = np.concatenate([[0], np.cumsum(idlens.astype(np.int64))])
    return fastq_native.format_records(
        chars[s:e], rlen[s:e], qmat[s:e] if qmat is not None else None,
        idbuf[idoffs[s]:idoffs[e]], idlens[s:e])


def _decode_fmt(reader, cp, b, seq_codes, per_file, bt, flo, fhi) -> bytes:
    half = _decode_block(reader, cp, b, seq_codes, per_file, bt)
    block = cp.num_reads_per_block
    s = max(flo - b * block, 0)
    e = min(fhi - b * block, len(half[3]))
    return _fmt_half(half, s, e)


def _decode_fmt_pe(reader, cp, b, seq_codes, per_file, bt, flo, fhi,
                   which) -> list[bytes]:
    halves = _decode_block_pe(reader, cp, b, seq_codes, per_file, bt)
    block = cp.num_reads_per_block
    s = max(flo - b * block, 0)
    e = min(fhi - b * block, len(halves[0][3]))
    return [_fmt_half(halves[j], s, e) for j in which]


def _undo_noise_delta(nn: np.ndarray, npos: np.ndarray) -> np.ndarray:
    """Undo per-read delta coding of noise positions (segmented cumsum)."""
    if not len(npos):
        return npos.astype(np.int32)
    cnts_d = nn.astype(np.int64)
    csum = np.cumsum(npos.astype(np.int64))
    starts_d = np.cumsum(cnts_d) - cnts_d
    base = np.where(starts_d > 0, csum[np.maximum(starts_d - 1, 0)], 0)
    return (csum - np.repeat(base, cnts_d)).astype(np.int32)


def _fill_rows(m, L, rlen, al, aligned_rows, lit):
    """Scatter aligned rows + literal bytes into an (m, L) char matrix.

    Row padding may be nonzero ('A' from code 0) — downstream only the
    first rlen[r] bytes of each row are read (native formatter)."""
    codes = np.zeros((m, L), np.uint8)
    if len(al):
        codes[al, : aligned_rows.shape[1]] = aligned_rows
    chars = packing.CODE_TO_CHAR[codes]
    li = np.setdiff1d(np.arange(m), al, assume_unique=False)
    if len(li):
        lvalid = np.arange(L)[None, :] < rlen[li, None]
        lrows = np.zeros((len(li), L), np.uint8)
        lrows[lvalid] = lit
        chars[li] = lrows
    return chars


def _decode_block_pe(reader: ArchiveReader, cp: P.CompressionParams, b: int,
                     seq_codes: np.ndarray, per_file: int,
                     num_threads: int = 1):
    """Decode one PE pair-block into (file-1 half, file-2 half), each
    (idbuf, idlens, chars, rlen, qmat). Inverse of the pair-delta layout
    (reference src/decompress.cpp:277-318)."""
    block = cp.num_reads_per_block
    s = b * block
    m = min(block, per_file - s)
    pflag = st.decode_u8(bsc.decompress(reader.get_block("flag", b), num_threads))
    rlen_i = st.decode_u16(bsc.decompress(reader.get_block("rlen", b), num_threads))
    rlen1 = rlen_i[0::2].astype(np.int32)
    rlen2 = rlen_i[1::2].astype(np.int32)
    pos1 = st.decode_deltas_u16(bsc.decompress(reader.get_block("pos", b), num_threads))
    pos2u = st.decode_deltas_u16(bsc.decompress(reader.get_block("pos2", b), num_threads))
    # raw int16 pair distances (decode_u16 widens to int32 — view first)
    pospair = np.frombuffer(
        bsc.decompress(reader.get_block("pospair", b), num_threads),
        np.uint16).view(np.int16).astype(np.int64)
    rcpair = st.decode_u8(bsc.decompress(reader.get_block("rcpair", b), num_threads))
    rcs = st.decode_u8(bsc.decompress(reader.get_block("rc", b), num_threads))
    nn = st.decode_u16(bsc.decompress(reader.get_block("nn", b), num_threads))
    npos = _undo_noise_delta(
        nn, st.decode_u16(bsc.decompress(reader.get_block("npos", b), num_threads)))
    nchar = st.decode_u8(bsc.decompress(reader.get_block("nchar", b), num_threads))
    lit = np.frombuffer(bsc.decompress(reader.get_block("literal", b), num_threads),
                        np.uint8)

    f0 = pflag == 0
    al1m = f0 | (pflag == 1) | (pflag == 3)
    al2m = f0 | (pflag == 1) | (pflag == 4)
    al2um = (pflag == 1) | (pflag == 4)
    n_al1 = int(al1m.sum())
    gpos_r1 = np.zeros(m, np.int64)
    rc_r1 = np.zeros(m, np.uint8)
    gpos_r1[al1m] = pos1
    rc_r1[al1m] = rcs[:n_al1]
    gpos_r2 = np.zeros(m, np.int64)
    rc_r2 = np.zeros(m, np.uint8)
    gpos_r2[f0] = gpos_r1[f0] + pospair
    rc_r2[f0] = np.where(rcpair == 1, rc_r1[f0], 1 - rc_r1[f0])
    gpos_r2[al2um] = pos2u
    rc_r2[al2um] = rcs[n_al1:]

    gpos_al = np.concatenate([gpos_r1[al1m], gpos_r2[al2m]])
    rc_al = np.concatenate([rc_r1[al1m], rc_r2[al2m]])
    rlen_al = np.concatenate([rlen1[al1m], rlen2[al2m]])
    rows = cons.reconstruct_reads(seq_codes, gpos_al, rlen_al, rc_al,
                                  nn, npos, nchar,
                                  num_threads=num_threads) \
        if len(gpos_al) else np.zeros((0, 1), np.uint8)
    L = max(int(rlen_i.max()) if len(rlen_i) else 0, 1)
    # split aligned rows / literal bytes back into the two files
    lit1_len = int(rlen1[~al1m].sum())
    al1 = np.nonzero(al1m)[0]
    al2 = np.nonzero(al2m)[0]
    chars1 = _fill_rows(m, L, rlen1, al1, rows[:n_al1], lit[:lit1_len])
    chars2 = _fill_rows(m, L, rlen2, al2, rows[n_al1:], lit[lit1_len:])

    qmat1 = qmat2 = None
    if cp.preserve_quality and not cp.fasta_input:
        qmat, _q = qv.decompress_rows(reader.get_block("quality", b),
                                      max_len=L, num_threads=num_threads)
        qmat1, qmat2 = qmat[:m], qmat[m:]
    def pack_ids(ids):
        return (np.frombuffer(b"".join(ids), np.uint8),
                np.fromiter((len(i) for i in ids), np.uint32, len(ids)))

    if cp.preserve_id:
        if cp.paired_id_match:
            ids1 = idcodec.decompress_ids(reader.get_block("id", b), m)
            ids2 = [modify_id(i, cp.paired_id_code) for i in ids1]
            id1buf, id1lens = pack_ids(ids1)
            id2buf, id2lens = pack_ids(ids2)
        else:
            buf2, lens2 = idcodec.decompress_ids_raw(
                reader.get_block("id", b), 2 * m)
            split = int(lens2[:m].sum())
            id1buf, id1lens = buf2[:split], lens2[:m]
            id2buf, id2lens = buf2[split:], lens2[m:]
    else:
        pre = ">" if cp.fasta_input else "@"
        id1buf, id1lens = pack_ids(
            [f"{pre}{s + i + 1}/1".encode() for i in range(m)])
        id2buf, id2lens = pack_ids(
            [f"{pre}{s + i + 1}/2".encode() for i in range(m)])
    return ((id1buf, id1lens, chars1, rlen1, qmat1),
            (id2buf, id2lens, chars2, rlen2, qmat2))


def _decode_block(reader: ArchiveReader, cp: P.CompressionParams, b: int,
                  seq_codes: np.ndarray, per_file: int,
                  num_threads: int = 1):
    trace = os.environ.get("SPRING_TPU_TRACE")
    _t0 = time.time()
    block = cp.num_reads_per_block
    s = b * block
    flag = st.decode_u8(bsc.decompress(reader.get_block("flag", b), num_threads))
    rlen = st.decode_u16(bsc.decompress(reader.get_block("rlen", b), num_threads))
    gpos = st.decode_deltas_u16(bsc.decompress(reader.get_block("pos", b), num_threads))
    rc = st.decode_u8(bsc.decompress(reader.get_block("rc", b), num_threads))
    nn = st.decode_u16(bsc.decompress(reader.get_block("nn", b), num_threads))
    npos = st.decode_u16(bsc.decompress(reader.get_block("npos", b), num_threads))
    nchar = st.decode_u8(bsc.decompress(reader.get_block("nchar", b), num_threads))
    if len(npos):
        # undo per-read delta coding: segmented cumulative sum
        cnts_d = nn.astype(np.int64)
        csum = np.cumsum(npos.astype(np.int64))
        starts_d = np.cumsum(cnts_d) - cnts_d
        base = np.where(starts_d > 0, csum[np.maximum(starts_d - 1, 0)], 0)
        npos = (csum - np.repeat(base, cnts_d)).astype(np.int32)
    lit = np.frombuffer(bsc.decompress(reader.get_block("literal", b), num_threads),
                        np.uint8)
    _t1 = time.time()

    m = len(flag)
    L = max(int(rlen.max()) if m else 0, 1)
    al = np.nonzero(flag == 1)[0]
    codes = np.zeros((m, L), np.uint8)
    if len(al):
        # num_threads is this block's share of the core budget — blocks
        # are the outer parallelism; a full-width OMP team per block
        # oversubscribes the host with spinning barriers
        rows = cons.reconstruct_reads(seq_codes, gpos, rlen[al],
                                      rc, nn, npos, nchar,
                                      num_threads=num_threads)
        codes[al, : rows.shape[1]] = rows
    # row padding is never read downstream (the native formatter copies
    # lens[r] bytes per row) — skip the full-matrix masking passes; fresh
    # page faults on this host cost more than the compute
    chars = packing.CODE_TO_CHAR[codes]
    li = np.nonzero(flag == 0)[0]
    if len(li):
        lvalid = np.arange(L)[None, :] < rlen[li, None]
        lrows = np.zeros((len(li), L), np.uint8)
        lrows[lvalid] = lit
        chars[li] = lrows
    _t2 = time.time()

    qmat = None
    if cp.preserve_quality and not cp.fasta_input:
        qmat, _qlens = qv.decompress_rows(
            reader.get_block("quality", b), max_len=L,
            num_threads=num_threads)
    _t3 = time.time()
    if cp.preserve_id:
        if cp.paired_id_match and s >= per_file:
            ids = _pe_ids_range(reader, cp, s, s + m, per_file)
            idbuf = np.frombuffer(b"".join(ids), np.uint8)
            idlens = np.fromiter((len(i) for i in ids), np.uint32, len(ids))
        elif cp.paired_id_match and s + m > per_file:
            # block straddles the file boundary: tail ids derive from
            # file-1 ids
            ids = idcodec.decompress_ids(reader.get_block("id", b), m)
            ids = ids[: per_file - s] + _pe_ids_range(
                reader, cp, per_file, s + m, per_file)
            idbuf = np.frombuffer(b"".join(ids), np.uint8)
            idlens = np.fromiter((len(i) for i in ids), np.uint32, len(ids))
        else:
            # array fast path: no per-id bytes objects
            idbuf, idlens = idcodec.decompress_ids_raw(
                reader.get_block("id", b), m)
    else:
        # fake ids: per-file index + /1 or /2 (reference
        # src/decompress.cpp:374-378); FASTA headers must start with '>'
        pre = ">" if cp.fasta_input else "@"
        ids = [(f"{pre}{g - per_file + 1}/2" if cp.paired_end
                and (g := s + i) >= per_file
                else f"{pre}{s + i + 1}/1").encode() for i in range(m)]
        idbuf = np.frombuffer(b"".join(ids), np.uint8)
        idlens = np.fromiter((len(i) for i in ids), np.uint32, len(ids))
    if trace:
        print(f"[trace] decode_block {b}: streams {_t1 - _t0:.2f}s "
              f"reads {_t2 - _t1:.2f}s quality {_t3 - _t2:.2f}s "
              f"ids {time.time() - _t3:.2f}s", flush=True)
    return idbuf, idlens, chars, rlen.astype(np.int32), qmat


def _pe_ids_range(reader, cp, g0: int, g1: int, per_file: int) -> list[bytes]:
    """Ids for global reads [g0, g1) in file 2, derived from file-1 ids."""
    block = cp.num_reads_per_block
    out = []
    src0, src1 = g0 - per_file, g1 - per_file
    b0, b1 = src0 // block, (src1 - 1) // block
    for b in range(b0, b1 + 1):
        ids1 = idcodec.decompress_ids(
            reader.get_block("id", b),
            min((b + 1) * block, per_file) - b * block)
        s = max(src0 - b * block, 0)
        e = min(src1 - b * block, len(ids1))
        out.extend(modify_id(i, cp.paired_id_code) for i in ids1[s:e])
    return out
