"""JAX primitives over 2-bit-packed DNA reads.

Reference analog: the bitset operations at the core of SPRING's matching —
Hamming distance via ``((ref^read)&mask).count()`` (src/reorder.h:292-301),
``generatemasks`` shifted-compare masks (src/bitset_util.h:223-236), and the
string<->bitset converters (src/bitset_util.h:57-62).

Accelerator-first redesign: reads are (n, W) uint32 arrays, 16 bases/word,
base i at bits 2*(i%16) of word i//16 (see io/packing.py). All ops are
elementwise / gather ops over fixed shapes so XLA maps them onto the
device's vector units; Hamming distance is XOR + fold-odd-even +
population_count, ~3 ops per 16 bases.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BASES_PER_WORD = 16

_ODD_MASK = jnp.uint32(0x55555555)   # low bit of each 2-bit lane
_LANE_MASK = jnp.uint32(0x3)


def words_per_read(max_len: int) -> int:
    return -(-max_len // BASES_PER_WORD)


def unpack(packed: jnp.ndarray, max_len: int) -> jnp.ndarray:
    """(..., W) uint32 -> (..., max_len) int32 base codes 0..3."""
    shifts = 2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32)
    codes = (packed[..., None] >> shifts) & _LANE_MASK
    return codes.reshape(*packed.shape[:-1], -1)[..., :max_len].astype(jnp.int32)


def pack(codes: jnp.ndarray) -> jnp.ndarray:
    """(..., L) int codes 0..3 -> (..., ceil(L/16)) uint32."""
    L = codes.shape[-1]
    W = words_per_read(L)
    pad = W * BASES_PER_WORD - L
    if pad:
        codes = jnp.concatenate(
            [codes, jnp.zeros((*codes.shape[:-1], pad), codes.dtype)], axis=-1)
    lanes = codes.reshape(*codes.shape[:-1], W, BASES_PER_WORD).astype(jnp.uint32)
    shifts = 2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32)
    return jnp.bitwise_or.reduce(lanes << shifts, axis=-1)


def hamming_packed(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Per-read base-mismatch count between two packed arrays (..., W).

    mismatch bit per 2-bit lane = OR of the two xor bits, folded to the odd
    position; population_count sums 16 lanes/word at once. Padding lanes must
    be equal in both inputs (they are zero-padded), so they never count.
    """
    d = a ^ b
    m = (d | (d >> 1)) & _ODD_MASK
    return jnp.sum(jax.lax.population_count(m), axis=-1).astype(jnp.int32)


def mismatch_mask(a_codes: jnp.ndarray, b_codes: jnp.ndarray,
                  valid: jnp.ndarray) -> jnp.ndarray:
    """Elementwise mismatch over code arrays, False where not ``valid``."""
    return (a_codes != b_codes) & valid


def revcomp_codes(codes: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Reverse-complement padded code rows within their own lengths.

    codes: (..., L) int codes 0..3; lengths: (...,) int32.
    out[..., j] = 3 - codes[..., len-1-j] for j < len, 0 beyond.
    """
    L = codes.shape[-1]
    idx = lengths[..., None] - 1 - jnp.arange(L)
    valid = idx >= 0
    gathered = jnp.take_along_axis(codes, jnp.maximum(idx, 0), axis=-1)
    return jnp.where(valid, 3 - gathered, 0)


def extract_key(codes: jnp.ndarray, start, width: int) -> jnp.ndarray:
    """Pack ``width`` consecutive base codes starting at ``start`` (static or
    traced per-row) into a uint32 key. width <= 16.

    Reference analog: dictionary key extraction from read bitsets
    (src/bitset_util.h:57-62 used by constructdictionary src/bitset_util.h:83-96).
    """
    assert width <= 16
    L = codes.shape[-1]
    offs = jnp.arange(width)
    if isinstance(start, int):
        window = jax.lax.dynamic_slice_in_dim(codes, start, width, axis=-1)
    else:
        idx = jnp.clip(start[..., None] + offs, 0, L - 1)
        window = jnp.take_along_axis(codes, idx, axis=-1)
    shifts = (2 * offs).astype(jnp.uint32)
    return jnp.sum(window.astype(jnp.uint32) << shifts, axis=-1).astype(jnp.uint32)


def pack_np(codes: np.ndarray) -> np.ndarray:
    """Host-side pack, same layout (delegates to io.packing)."""
    from ..io.packing import pack_codes
    return pack_codes(codes)


# ---------- packed-domain bit arithmetic (no gathers, elementwise) ----------
#
# Dynamic per-row base shifts via word-select + funnel shifts: a traced
# shift s decomposes as s = 16*q + r; the word part is a select over the
# (small, static) range of q, the bit part is an elementwise variable
# shift. This replaces take_along_axis gathers, which lowered to scattered
# per-element loads on the previous accelerator (kept until measured on
# the H100, ROADMAP 3.3).

def _word_shift_left(pk: jnp.ndarray, q: int) -> jnp.ndarray:
    """out[w] = pk[w+q] (zeros beyond) — static word shift."""
    if q == 0:
        return pk
    z = jnp.zeros((*pk.shape[:-1], q), pk.dtype)
    return jnp.concatenate([pk[..., q:], z], axis=-1)


def _word_shift_right(pk: jnp.ndarray, q: int) -> jnp.ndarray:
    if q == 0:
        return pk
    z = jnp.zeros((*pk.shape[:-1], q), pk.dtype)
    return jnp.concatenate([z, pk[..., :-q]], axis=-1)


def shift_bases_left(pk: jnp.ndarray, s: jnp.ndarray,
                     max_shift: int) -> jnp.ndarray:
    """Packed equivalent of codes[..., p] = codes[..., p + s] (zero fill).

    pk: (..., W) uint32; s: (...,) traced base shift in [0, max_shift].
    """
    q = s // BASES_PER_WORD
    r = s % BASES_PER_WORD
    out = _word_shift_left(pk, 0)
    for qq in range(1, max_shift // BASES_PER_WORD + 1):
        out = jnp.where((q == qq)[..., None], _word_shift_left(pk, qq), out)
    hi = _word_shift_left(out, 1)
    r2 = (2 * r)[..., None].astype(jnp.uint32)
    shifted = (out >> r2) | jnp.where(r2 > 0, hi << (32 - r2), 0)
    return jnp.where(r2 > 0, shifted, out)


def shift_bases_right(pk: jnp.ndarray, s: jnp.ndarray,
                      max_shift: int) -> jnp.ndarray:
    """Packed equivalent of out[..., p] = codes[..., p - s] (zero fill)."""
    q = s // BASES_PER_WORD
    r = s % BASES_PER_WORD
    out = _word_shift_right(pk, 0)
    for qq in range(1, max_shift // BASES_PER_WORD + 1):
        out = jnp.where((q == qq)[..., None], _word_shift_right(pk, qq), out)
    lo = _word_shift_right(out, 1)
    r2 = (2 * r)[..., None].astype(jnp.uint32)
    shifted = (out << r2) | jnp.where(r2 > 0, lo >> (32 - r2), 0)
    return jnp.where(r2 > 0, shifted, out)


def _reverse_lanes(pk: jnp.ndarray) -> jnp.ndarray:
    """Reverse the 16 2-bit lanes within each uint32."""
    x = pk
    x = ((x & jnp.uint32(0x33333333)) << 2) | ((x >> 2) & jnp.uint32(0x33333333))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << 4) | ((x >> 4) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x00FF00FF)) << 8) | ((x >> 8) & jnp.uint32(0x00FF00FF))
    x = (x << 16) | (x >> 16)
    return x


def revcomp_packed(pk: jnp.ndarray, nbases: jnp.ndarray,
                   max_shift_unused: int = 0) -> jnp.ndarray:
    """Packed reverse complement within each row's own length.

    pk: (..., W); nbases: (...,). Bits beyond nbases must be zero on input;
    output also has zeros beyond nbases.
    """
    W = pk.shape[-1]
    full = _reverse_lanes(~pk)[..., ::-1]       # reverse of full W*16 window
    # the reversed read sits at the top; slide it down by W*16 - nbases.
    # padding lanes of ~pk are 0b11 (T) — the left shift drops exactly those.
    return shift_bases_left(full, W * BASES_PER_WORD - nbases,
                            W * BASES_PER_WORD)


def shift_bases_left_static(pk: jnp.ndarray, s: int) -> jnp.ndarray:
    """Static-shift variant of shift_bases_left (constant funnel)."""
    a, b = divmod(s, BASES_PER_WORD)
    out = _word_shift_left(pk, a)
    if b == 0:
        return out
    hi = _word_shift_left(out, 1)
    return (out >> (2 * b)) | (hi << (32 - 2 * b))


def shift_bases_right_static(pk: jnp.ndarray, s: int) -> jnp.ndarray:
    a, b = divmod(s, BASES_PER_WORD)
    out = _word_shift_right(pk, a)
    if b == 0:
        return out
    lo = _word_shift_right(out, 1)
    return (out << (2 * b)) | (lo >> (32 - 2 * b))


def extract_key_packed(pk: jnp.ndarray, start: int) -> jnp.ndarray:
    """16-base key at static base offset ``start`` from packed rows."""
    a, b = divmod(start, BASES_PER_WORD)
    lo = pk[..., a]
    if b == 0:
        return lo
    W = pk.shape[-1]
    hi = pk[..., a + 1] if a + 1 < W else jnp.zeros_like(lo)
    return (lo >> (2 * b)) | (hi << (32 - 2 * b))
