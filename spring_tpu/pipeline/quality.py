"""Quality-score quantization modes.

Reference analog: quantize_quality + the Illumina-8-level and binary binning
tables (src/util.cpp:143-188) and QVZ invocation (src/util.cpp:151-164).
Tables operate on Phred+33 ASCII qualities. The QVZ quantizer itself lives
in spring_tpu/pipeline/qvz.py (a vectorized numpy reimplementation —
per-column PMFs and Lloyd-Max codebooks are dense histogram math).
"""
from __future__ import annotations

import numpy as np


def illumina_binning_table() -> np.ndarray:
    """Illumina 8-level quality binning (same level boundaries as the
    reference, src/util.cpp:166-182)."""
    table = np.arange(256, dtype=np.uint8)
    levels = [  # (lo_q, hi_q, out_q) inclusive ranges in phred units
        (-33, 1, 0), (2, 9, 6), (10, 19, 15), (20, 24, 22),
        (25, 29, 27), (30, 34, 33), (35, 39, 37), (40, 127 - 33, 40),
    ]
    for lo, hi, out in levels:
        table[max(0, 33 + lo): 33 + hi + 1] = 33 + out
    table[128:] = 33 + 40
    return table


def binary_binning_table(thr: int, high: int, low: int) -> np.ndarray:
    """Binary thresholding (reference src/util.cpp:184-188)."""
    table = np.empty(256, dtype=np.uint8)
    table[: 33 + thr] = 33 + low
    table[33 + thr:] = 33 + high
    return table


def quantize_block(quals: list[bytes], table: np.ndarray) -> list[bytes]:
    out = []
    for q in quals:
        arr = np.frombuffer(q, dtype=np.uint8)
        out.append(table[arr].tobytes())
    return out


def quantize_matrix(mat: np.ndarray, lengths: np.ndarray,
                    table: np.ndarray) -> np.ndarray:
    """Vectorized table binning over a padded (n, L) quality matrix;
    padding bytes (beyond each row's length) stay 0."""
    L = mat.shape[1]
    valid = np.arange(L)[None, :] < lengths[:, None]
    return np.where(valid, table[mat], 0).astype(np.uint8)


def make_table(mode: str, qvz_ratio: float = 8.0,
               bin_thresholds: tuple = ()) -> np.ndarray | None:
    if mode == "lossless" or mode == "qvz":
        return None  # qvz handled separately (data-dependent)
    if mode == "ill_bin":
        return illumina_binning_table()
    if mode == "binary":
        thr, high, low = bin_thresholds
        return binary_binning_table(thr, high, low)
    raise ValueError(f"unknown quality mode {mode}")
