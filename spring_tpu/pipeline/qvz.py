"""QVZ-style rate-distortion quality quantization (lossy mode ``-q qvz``).

Reference analog: the embedded QVZ library (src/qvz/) — per-column
conditional PMFs (src/qvz/src/pmf.cpp), Lloyd-Max codebooks per
(column, previous-symbol) context (generate_codebooks,
src/qvz/src/codebook.cpp:421), used by Spring quantize-only, in place
(src/qvz/src/qvz.cpp:22-60); entropy coding happens downstream in the
block codec, exactly as Spring feeds QVZ output to BSC.

Vectorized redesign (not a port): the reference trains one scalar quantizer
per (column, previous symbol) pair with a WELL-RNG hi/lo dither. Here the
whole training pass is dense linear algebra over a (columns, contexts,
levels) histogram tensor:
  * conditional histograms by vectorized bincount over all reads at once;
  * Lloyd-Max iterations as cumulative-sum centroid updates (no loops over
    reads, only over the 64-symbol alphabet);
  * the level budget per column follows the reference's MODE_RATIO
    semantics: target bits ~= column entropy / ratio.
Quantization itself is a gather: q[i, col] = codebook[col, ctx, value].
"""
from __future__ import annotations

import numpy as np

QMIN, QMAX = 33, 104          # printable Phred range
NSYM = QMAX - QMIN + 1
NCTX = 8                      # previous-symbol context buckets
LLOYD_ITERS = 12


def _entropy(p: np.ndarray) -> np.ndarray:
    nz = p > 0
    h = np.zeros(p.shape[:-1])
    h = -np.sum(np.where(nz, p * np.log2(np.maximum(p, 1e-30)), 0), axis=-1)
    return h


def _lloyd_max(hist: np.ndarray, k: int) -> np.ndarray:
    """1-D Lloyd-Max on a histogram over NSYM symbols -> (NSYM,) mapping
    symbol -> reconstruction symbol, with k levels."""
    total = hist.sum()
    if total == 0 or k >= NSYM:
        return np.arange(NSYM)
    # init boundaries at quantiles
    cdf = np.cumsum(hist) / total
    bounds = np.searchsorted(cdf, np.arange(1, k) / k)
    sym = np.arange(NSYM)
    for _ in range(LLOYD_ITERS):
        level = np.searchsorted(bounds, sym, side="right")
        # centroids per level
        cent = np.zeros(k)
        for l in range(k):
            m = level == l
            w = hist[m]
            cent[l] = (np.sum(w * sym[m]) / w.sum()) if w.sum() else 0
        nb = np.round((cent[:-1] + cent[1:]) / 2).astype(np.int64)
        if np.array_equal(nb, bounds):
            break
        bounds = nb
    level = np.searchsorted(bounds, sym, side="right")
    cent = np.zeros(k)
    for l in range(k):
        m = level == l
        w = hist[m]
        if w.sum():
            # reconstruction at the rounded conditional mean (QVZ uses
            # unconstrained centroids too, src/qvz/src/quantizer.c) — the
            # snapped-to-observed variant cost ~2 MSE at low rates; the
            # codec's fine position contexts absorb the larger output
            # alphabet that centroid means produce
            cent[l] = np.round(np.sum(w * sym[m]) / w.sum())
    return cent[level].astype(np.int64)


def _column_curve(hist: np.ndarray) -> tuple[np.ndarray, np.ndarray, list]:
    """Candidate (rate, mse) points for one column's unconditional histogram.

    Returns (rates, mses, maps) for level counts k = 1.. ascending; rates in
    bits/symbol (entropy of the merged distribution), mses per symbol.
    """
    total = hist.sum()
    sym = np.arange(NSYM, dtype=np.float64)
    h_full = float(_entropy(hist / max(total, 1)))
    rates, mses, maps = [], [], []
    for k in range(1, NSYM + 1):
        m = _lloyd_max(hist, k)
        pq = np.bincount(m, weights=hist.astype(np.float64), minlength=NSYM)
        r = float(_entropy(pq / max(total, 1)))
        d = float(np.sum(hist * (m - sym) ** 2) / max(total, 1))
        rates.append(r)
        mses.append(d)
        maps.append(m)
        if r >= h_full - 1e-9 or d <= 1e-12:
            break
    return np.asarray(rates), np.asarray(mses), maps


def _allocate_targets(hists: np.ndarray, weights: np.ndarray,
                      budget_per_sym: float) -> np.ndarray:
    """Per-column rate targets by global Lagrangian allocation.

    The reference applies ONE entropy target to every (column, context)
    quantizer (MODE_FIXED, src/qvz/src/codebook.cpp:470-527), which wastes
    budget on low-variance columns and starves high-variance ones. Here the
    total budget ``budget_per_sym * sum(weights)`` is spread across columns
    by bisecting a multiplier lam so that per column k* = argmin(mse + lam *
    rate); rate(lam) is monotone, so ~45 bisection steps pin the budget.
    Returns the chosen unconditional rate per column, used downstream as
    that column's conditional entropy ceiling.
    """
    L = hists.shape[0]
    curves = [_column_curve(hists[c]) for c in range(L)]
    total_w = float(weights.sum())
    if total_w <= 0:
        return np.zeros(L)
    budget = budget_per_sym * total_w
    full = float(sum(w * r[-1] for (r, _, _), w in zip(curves, weights)))
    if full <= budget:
        return np.array([r[-1] for r, _, _ in curves])

    def spend(lam: float) -> tuple[float, np.ndarray]:
        t = np.empty(L)
        s = 0.0
        for c, (r, d, _) in enumerate(curves):
            k = int(np.argmin(d + lam * r))
            t[c] = r[k]
            s += weights[c] * r[k]
        return s, t

    lo, hi = 0.0, 1.0
    while spend(hi)[0] > budget and hi < 1e9:
        hi *= 4.0
    for _ in range(45):
        mid = (lo + hi) / 2.0
        if spend(mid)[0] > budget:
            lo = mid
        else:
            hi = mid
    return spend(hi)[1]


def quantize_block(quals: list[bytes], ratio: float) -> list[bytes]:
    """Quantize quality strings in place (returns new list).

    Keeps read lengths; empty strings pass through.
    """
    if not quals:
        return quals
    L = max(len(q) for q in quals)
    if L == 0:
        return quals
    n = len(quals)
    mat = np.full((n, L), 255, np.uint8)
    for i, q in enumerate(quals):
        mat[i, : len(q)] = np.frombuffer(q, np.uint8)
    lens = np.fromiter((len(q) for q in quals), np.int64, n)
    res = quantize_matrix(mat, lens, ratio)
    return [res[i, : len(q)].tobytes() for i, q in enumerate(quals)]


def quantize_matrix(mat: np.ndarray, lengths: np.ndarray,
                    ratio: float) -> np.ndarray:
    """Quantize a padded (n, L) quality matrix; padding stays 0."""
    n, L = mat.shape
    if n == 0 or L == 0:
        return mat
    valid = np.arange(L)[None, :] < np.asarray(lengths)[:, None]
    sym = np.where(valid, np.clip(mat.astype(np.int32) - QMIN, 0, NSYM - 1), 0)

    # context: the previous column's quantized value, as its RANK in that
    # column's output alphabet (the reference conditions codebooks on the
    # exact quantized previous symbol, src/qvz/src/codebook.cpp:494-527;
    # value-bucket contexts blurred that and cost ~20% rate at mid
    # ratios). With few reads the conditional histograms are too noisy,
    # so pool contexts.
    pool = n < NCTX * 64
    max_ctx = 16

    # rate semantics: `ratio` is an ABSOLUTE bits/symbol budget like the
    # reference's MODE_FIXED (src/util.cpp:151-164), but spent globally:
    # per-column targets come from a Lagrangian allocation over the
    # unconditional column histograms instead of one flat per-column
    # target (which left the RD curve with a cliff between the flat
    # target and full collapse at mid ratios)
    weights = valid.sum(axis=0).astype(np.float64)
    uncond = np.stack([
        np.bincount(sym[valid[:, c], c], minlength=NSYM) for c in range(L)])
    targets = _allocate_targets(uncond, weights, float(ratio))
    out = np.zeros_like(sym)
    ctx = np.zeros(n, np.int32)
    nctx = 1
    for col in range(L):
        target = float(targets[col])
        v = valid[:, col]
        idx = ctx * NSYM + sym[:, col]
        hist = np.bincount(idx[v], minlength=nctx * NSYM).reshape(nctx, NSYM)
        p = hist / np.maximum(hist.sum(axis=1, keepdims=True), 1)
        h = _entropy(p)                      # (nctx,)
        maps = np.empty((nctx, NSYM), np.int64)
        for c in range(nctx):
            if h[c] <= target:
                maps[c] = np.arange(NSYM)
                continue
            # largest level count whose quantized entropy stays <= target
            # (the reference's per-value hi/lo dither would inject choice
            # noise the downstream codec cannot model; a hard floor keeps
            # the rate budget honest)
            m_lo = _lloyd_max(hist[c], 1)
            for k in range(2, NSYM + 1):
                m_k = _lloyd_max(hist[c], k)
                pq = np.bincount(m_k, weights=hist[c].astype(np.float64),
                                 minlength=NSYM)
                tot = pq.sum()
                h_k = float(_entropy(pq / tot)) if tot else 0.0
                if h_k > target:
                    break
                m_lo = m_k
            maps[c] = m_lo
        out[:, col] = maps[ctx, sym[:, col]]
        if pool:
            continue
        alpha = np.unique(out[v, col]) if v.any() else np.zeros(1, np.int64)
        nctx = int(max(1, min(len(alpha), max_ctx)))
        rank = np.searchsorted(alpha, out[:, col]).clip(0, nctx - 1)
        ctx = np.where(v, rank, ctx).astype(np.int32)
    return np.where(valid, out + QMIN, 0).astype(np.uint8)
