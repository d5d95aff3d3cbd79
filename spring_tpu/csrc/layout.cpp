// Native emissions -> contig layout (the assemble_contigs hot path).
//
// Reference analog: the reference never materializes a global layout —
// contigs are encoded inside each reorder thread (src/encoder.cpp:32-74).
// Our pipeline builds ONE concatenated layout for the whole dataset
// (encode/consensus.py:layout_from_emissions); the numpy form of that
// pass is ~15 s at 10M reads on the 4-core host (25+ full-array
// bandwidth-bound passes plus a 10M argsort). This kernel does the same
// in three passes:
//   1. serial segmented scan: contig ids + positions from the walker
//      timeline (flag 0 seeds, 1 extends right, 2 is the left phase)
//   2. per-contig stable sort by position — contigs are CONTIGUOUS
//      ranges of the walker-major stream, so sorting is embarrassingly
//      parallel over contigs (avg ~256 reads each), no global sort
//   3. keep/drop by read count, prefix-sum bases, parallel emit
// Semantics match layout_from_emissions exactly (it asserts equality in
// tests); ties in (contig, pos) keep timeline order (stable).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
inline int layout_threads(int num_threads) {
#ifdef _OPENMP
  return num_threads > 0 ? num_threads : omp_get_max_threads();
#else
  (void)num_threads;
  return 1;
#endif
}
}  // namespace

extern "C" {

// em: (n, 4) int32 rows (rid, flag, t, rc), walker-major, contig entries
// contiguous (flag==0 starts a contig). lengths indexed by rid.
// Outputs are caller-allocated: rid_out/gpos_out/rc_out size n,
// cbase/clen/ccount size n (worst case one contig per row), singles size
// n. out_counts[4] = {kept_reads, kept_contigs, n_singles, seq_len}.
// Returns 0, or -1 on malformed input (first row not a seed / bad flag).
int32_t stpu_layout_from_emissions(
    const int32_t* em, int64_t n, const int32_t* lengths,
    int64_t min_reads, int32_t num_threads, int32_t* rid_out,
    int64_t* gpos_out, uint8_t* rc_out, int64_t* cbase_out,
    int64_t* clen_out, int64_t* ccount_out, int32_t* singles_out,
    int64_t* out_counts) {
  out_counts[0] = out_counts[1] = out_counts[2] = out_counts[3] = 0;
  if (n <= 0) return 0;
  if (em[1] != 0) return -1;  // first row must seed a contig

  // pass 1: contig starts + per-row (pos, rc'), serial segmented scan
  std::vector<int64_t> pos(n);
  std::vector<uint8_t> rcv(n);
  std::vector<int64_t> cstart;  // first row index of each contig
  cstart.reserve(n / 64 + 16);
  int64_t right_sum = 0, left_sum = 0, l0 = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t* e = em + 4 * i;
    int32_t flag = e[1];
    if (flag == 0) {
      cstart.push_back(i);
      right_sum = 0;
      left_sum = 0;
      l0 = lengths[e[0]];
    } else if (flag != 1 && flag != 2) {
      return -1;
    }
    if (flag == 2) {
      left_sum += e[2];
      pos[i] = l0 - left_sum - lengths[e[0]];
      rcv[i] = static_cast<uint8_t>(1 - e[3]);
    } else {
      right_sum += e[2];
      pos[i] = right_sum;
      rcv[i] = static_cast<uint8_t>(e[3]);
    }
  }
  const int64_t nc = static_cast<int64_t>(cstart.size());
  cstart.push_back(n);

  // pass 2: per-contig stable sort by pos (order index per row), then
  // rebase to min 0 and record extents
  std::vector<int32_t> ord(n);
  std::vector<int64_t> cext(nc);
  const int T = layout_threads(num_threads);
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(T)
#endif
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = cstart[c], e = cstart[c + 1];
    int32_t* o = ord.data() + s;
    for (int64_t i = s; i < e; ++i) o[i - s] = static_cast<int32_t>(i - s);
    std::stable_sort(o, o + (e - s), [&](int32_t a, int32_t b) {
      return pos[s + a] < pos[s + b];
    });
    const int64_t pmin = pos[s + o[0]];
    int64_t ext = 0;
    for (int64_t k = 0; k < e - s; ++k) {
      const int64_t i = s + o[k];
      const int64_t p = pos[i] - pmin;
      pos[i] = p;
      const int64_t x = p + lengths[em[4 * i]];
      if (x > ext) ext = x;
    }
    cext[c] = ext;
  }

  // pass 3: keep mask + prefix sums (serial over nc), parallel emit
  std::vector<int64_t> rbase(nc + 1), gbase(nc), sbase(nc + 1),
      kbase(nc + 1);
  int64_t kept_reads = 0, kept_contigs = 0, n_singles = 0, seq = 0;
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t cnt = cstart[c + 1] - cstart[c];
    const bool keep = cnt >= min_reads;
    rbase[c] = kept_reads;
    sbase[c] = n_singles;
    kbase[c] = kept_contigs;
    gbase[c] = seq;
    if (keep) {
      kept_reads += cnt;
      cbase_out[kept_contigs] = seq;
      clen_out[kept_contigs] = cext[c];
      ccount_out[kept_contigs] = cnt;
      seq += cext[c];
      ++kept_contigs;
    } else {
      n_singles += cnt;
    }
  }
  rbase[nc] = kept_reads;
  sbase[nc] = n_singles;
  kbase[nc] = kept_contigs;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(T)
#endif
  for (int64_t c = 0; c < nc; ++c) {
    const int64_t s = cstart[c], e = cstart[c + 1];
    const bool keep = (e - s) >= min_reads;
    const int32_t* o = ord.data() + s;
    if (keep) {
      const int64_t w0 = rbase[c], g0 = gbase[c];
      for (int64_t k = 0; k < e - s; ++k) {
        const int64_t i = s + o[k];
        rid_out[w0 + k] = em[4 * i];
        gpos_out[w0 + k] = g0 + pos[i];
        rc_out[w0 + k] = rcv[i];
      }
    } else {
      const int64_t w0 = sbase[c];
      for (int64_t k = 0; k < e - s; ++k)
        singles_out[w0 + k] = em[4 * (s + o[k])];
    }
  }
  out_counts[0] = kept_reads;
  out_counts[1] = kept_contigs;
  out_counts[2] = n_singles;
  out_counts[3] = seq;
  return 0;
}

// Fused stitch transform (encode/stitch.py): per-read merged-frame
// coordinates, orientation, read length, group rank, and the composite
// (grank, pos) sort key — ONE parallel pass over contig segments. The
// numpy chain this replaces allocated ~10 full-length temporaries, and
// a host with lazily-backed memory runs fresh-page numpy at ~60 MB/s
// (5+ s at 10M reads); the fused pass touches each output
// once. Returns 0, or -1 if any merged coordinate falls outside int32
// (a >2 Gbase stitched chain — caller raises instead of corrupting).
//
// counts/bases: per-contig read counts and first-read offsets into the
// concatenated layout; gpos: per-read absolute layout positions;
// rids+lengths: read lengths via the global length table; fr/orr: each
// contig's affine map to its group root (flip, offset); rc: per-read
// orientation; grank_c: per-contig output-group rank.
int32_t stpu_stitch_transform(
    const int64_t* counts, int64_t nc, const int64_t* gpos,
    const int64_t* bases, const int32_t* rids, const int32_t* lengths,
    const uint8_t* fr, const int64_t* orr, const uint8_t* rc,
    const int32_t* grank_c, int64_t n, int32_t num_threads,
    int32_t* pos_r_out, uint8_t* rc_new_out, int32_t* rlen_out,
    int32_t* grank_out, int64_t* key_out) {
  const int T = layout_threads(num_threads);
  std::vector<int64_t> cstart(nc + 1);
  cstart[0] = 0;
  for (int64_t c = 0; c < nc; ++c) cstart[c + 1] = cstart[c] + counts[c];
  if (cstart[nc] != n) return -1;

  int64_t pmin = INT64_MAX, pmax = INT64_MIN, lmax = 0;
#ifdef _OPENMP
#pragma omp parallel num_threads(T) reduction(min : pmin) \
    reduction(max : pmax) reduction(max : lmax)
#endif
  {
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 256)
#endif
    for (int64_t c = 0; c < nc; ++c) {
      const int64_t s = cstart[c], e = cstart[c + 1];
      const int64_t off = orr[c], base = bases[c];
      const uint8_t flip = fr[c];
      const int32_t gr = grank_c[c];
      for (int64_t i = s; i < e; ++i) {
        const int64_t pl = gpos[i] - base;
        const int32_t rl = lengths[rids[i]];
        const int64_t p = flip == 0 ? off + pl : off - pl - rl;
        key_out[i] = p;  // staged; pass 2 folds in the group rank
        rc_new_out[i] = rc[i] ^ (uint8_t)flip;
        rlen_out[i] = rl;
        grank_out[i] = gr;
        if (p < pmin) pmin = p;
        if (p > pmax) pmax = p;
        if (rl > lmax) lmax = rl;
      }
    }
  }
  if (n == 0) return 0;
  if (pmin < INT32_MIN || pmax > INT32_MAX) return -1;
  const int64_t span = pmax + lmax - pmin + 1;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(T)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const int64_t p = key_out[i];
    pos_r_out[i] = (int32_t)p;
    key_out[i] = (int64_t)grank_out[i] * span + (p - pmin);
  }
  return 0;
}

// Stitch relayout: apply the (grank, pos)-sorted permutation and rebuild
// concatenated coordinates in two parallel passes over group segments.
// Replaces a numpy chain of ~6 full-length gathers/temporaries (17.6 s
// at 100M reads on this host's fresh-page memory). Groups are
// CONTIGUOUS runs of the sorted order and each group's rows are
// pos-ascending, so group g's min pos is its first row's.
//
// order: the sort permutation (int64); group_first: per-group first row
// in sorted order (ngroups+1, from the contig-level counts). Outputs:
// per-read rid/gpos/rc in sorted order, per-group concatenated base and
// length. Returns total consensus length.
int64_t stpu_stitch_relayout(
    const int64_t* order, const int64_t* group_first, int64_t ngroups,
    const int32_t* rids, const uint8_t* rc, const int32_t* pos_r,
    const int32_t* rlen, int64_t n, int32_t num_threads,
    int32_t* rid_out, int64_t* gpos_out, uint8_t* rc_out,
    int64_t* gbase_out, int64_t* glen_out) {
  const int T = layout_threads(num_threads);
  (void)n;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(T)
#endif
  for (int64_t g = 0; g < ngroups; ++g) {
    const int64_t s = group_first[g], e = group_first[g + 1];
    const int32_t minp = pos_r[order[s]];
    int64_t len = 0;
    for (int64_t i = s; i < e; ++i) {
      const int64_t oi = order[i];
      const int64_t ext = (int64_t)(pos_r[oi] - minp) + rlen[oi];
      if (ext > len) len = ext;
    }
    glen_out[g] = len;
    gbase_out[g] = minp;  // staged: pass 2 swaps in the running base
  }
  int64_t base = 0;
  std::vector<int64_t> minp_g(ngroups);
  for (int64_t g = 0; g < ngroups; ++g) {
    minp_g[g] = gbase_out[g];
    gbase_out[g] = base;
    base += glen_out[g];
  }
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) num_threads(T)
#endif
  for (int64_t g = 0; g < ngroups; ++g) {
    const int64_t s = group_first[g], e = group_first[g + 1];
    const int64_t b = gbase_out[g] - minp_g[g];
    for (int64_t i = s; i < e; ++i) {
      const int64_t oi = order[i];
      rid_out[i] = rids[oi];
      gpos_out[i] = b + pos_r[oi];
      rc_out[i] = rc[oi];
    }
  }
  return base;
}

}  // extern "C"
