"""2-bit base packing and packed-word bit kernels.

Bases are packed 16 per uint32 word, first base in the two MOST significant
bits, so unsigned comparison of words equals lexicographic comparison of
bases and a left shift moves bases toward lower positions.

The verify hot path works entirely on packed words: a candidate window is
assembled from two overlapping genome words per output word (shift +
combine), compared with XOR, and mismatches are counted with a 2-bit-lane
OR-fold + population count -- 16 bases per ALU op instead of one per byte.
This replaces the reference's per-base verification loop
(src/walt/mapping.cpp:288-304) with HBM-friendly word traffic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

#: lo bits of every 2-bit lane
LANE_LO = 0x55555555


def words_per_read(length: int) -> int:
    return (length + 15) // 16


def pack_codes_np(codes: np.ndarray) -> np.ndarray:
    """(…, L) uint8 codes (low 2 bits used) -> (…, ceil(L/16)) uint32,
    MSB-first.  Lane-strided accumulation: peak temporary is one lane
    (L/16 words), not a (…, W, 16) expansion -- this packs whole genomes."""
    L = codes.shape[-1]
    W = words_per_read(L)
    out = np.zeros(codes.shape[:-1] + (W,), dtype=np.uint32)
    for i in range(16):
        lane = codes[..., i::16]
        if lane.shape[-1] == 0:
            break
        lane = (lane & 3).astype(np.uint32)
        lane <<= np.uint32(30 - 2 * i)
        out[..., : lane.shape[-1]] |= lane
    return out


def pack_genome_np(seq_codes: np.ndarray, tail_words: int = 16) -> np.ndarray:
    """Genome codes -> packed words with ``tail_words`` zero words appended
    so window extraction never reads past the end."""
    packed = pack_codes_np(seq_codes[None, :])[0]
    return np.concatenate([packed, np.zeros(tail_words, dtype=np.uint32)])


def convert_ct(words):
    """C->T on packed words (lane 01 -> 11), device-side."""
    lo = jnp.uint32(LANE_LO)
    is_c = (~words >> 1) & words & lo
    return words | (is_c << 1)


def convert_ga(words):
    """G->A on packed words (lane 10 -> 00), device-side."""
    lo = jnp.uint32(LANE_LO)
    is_g = (words >> 1) & ~words & lo
    return words & ~(is_g << 1)


def extract_lane(words, pos: int):
    """Base code at static position ``pos`` from (…, W) packed words."""
    return (words[..., pos // 16] >> jnp.uint32(30 - 2 * (pos % 16))) & 3


def len_lane_masks(lens, n_words: int):
    """(B, W) uint32 masks with the lo bit set for every lane < len."""
    w = jnp.arange(n_words, dtype=jnp.int32)[None, :]
    nvalid = jnp.clip(lens[:, None] - 16 * w, 0, 16)
    sh = (2 * (16 - nvalid)).astype(jnp.uint32)
    # ((L << (sh-1)) << 1) avoids the undefined <<32 when nvalid == 0
    full = jnp.uint32(LANE_LO)
    return jnp.where(
        nvalid > 0,
        jnp.where(nvalid == 16, full, (full << (sh - 1)) << 1),
        jnp.uint32(0),
    )


def window_words(pseq, gpos, n_words: int):
    """Packed windows of ``n_words`` words starting at base ``gpos``.

    pseq: (Wg,) packed genome; gpos: int32 (...) start positions.
    Returns (…, n_words) uint32, base gpos+16*j first in word j.
    Uses a contiguous (n_words+1)-word slice gather so the HBM traffic is
    sequential, then aligns with shifts.
    """
    word0 = (gpos >> 4).astype(jnp.int32)
    sh = ((gpos & 15) << 1).astype(jnp.uint32)  # 0..30
    # jnp.take with explicit per-word indices: one (…, n_words+1) index
    # gather rather than a gather with slice_sizes
    widx = word0[..., None] + jnp.arange(n_words + 1, dtype=jnp.int32)
    slices = jnp.take(pseq, widx, mode="clip")
    lo = slices[..., :n_words]
    hi = slices[..., 1:]
    sh_b = sh[..., None]
    # (hi >> (32-sh)) via the shift-by-31-then-1 guard (sh may be 0)
    return jnp.where(
        sh_b == 0, lo, (lo << sh_b) | ((hi >> (jnp.uint32(31) - sh_b)) >> 1)
    )


def window_cols(pseq, gpos, n_words: int):
    """Like :func:`window_words` but as a LIST of 1-D aligned word columns.

    For very wide rows (tens of millions) XLA can pick a padded layout for
    the (M, n_words+1) 2-D gather, a temporary many times the gather's own
    bytes.  n_words+1 separate 1-D gathers move the same bytes with plain
    layouts.
    """
    word0 = (gpos >> 4).astype(jnp.int32)
    sh = ((gpos & 15) << 1).astype(jnp.uint32)
    cols = [jnp.take(pseq, word0 + j, mode="clip") for j in range(n_words + 1)]
    out = []
    for j in range(n_words):
        lo, hi = cols[j], cols[j + 1]
        out.append(jnp.where(
            sh == 0, lo, (lo << sh) | ((hi >> (jnp.uint32(31) - sh)) >> 1)
        ))
    return out


def count_mismatch_words(a, b, lane_mask):
    """Per-word mismatching-lane count: popcount of the 2-bit OR-fold."""
    d = a ^ b
    m = (d | (d >> 1)) & lane_mask
    return jax.lax.population_count(m)


def verify_words(pseq, gpos, conv, lane, n_words: int):
    """The verify op: per row, the aligned genome window at ``gpos`` and
    the count of its bases that differ from the converted read ``conv``
    under the read-length ``lane`` mask.

    Returns (mm (…,) int32, win (…, n_words) uint32).  XLA fuses the
    window gather, XOR, fold and popcount into one loop; a hand-written
    Pallas kernel measured no faster on the H100 (PERF.md).
    """
    win = window_words(pseq, gpos, n_words)
    mm = jnp.sum(count_mismatch_words(win, conv, lane), axis=-1,
                 dtype=jnp.int32)
    return mm, win
