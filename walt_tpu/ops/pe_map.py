"""Fused paired-end mate mapping: both strand tables in ONE XLA program.

Dispatching ``map_strand_device`` twice per mate would fetch three padded
(B, C) slab arrays per strand -- ~9 C bytes/read of D2H traffic and four
dispatches per batch.

This step maps one mate against its '+' and '-' tables inside one jitted
program and returns the candidates FLAT-COMPACTED across the whole chunk:

- ``meta`` (B,) uint32: per-read counts of the candidates that landed in
  ``flat`` for each strand (bits 0-7 strand '+', bits 8-15 strand '-')
  plus the fallback bit (16) -- set when either strand's pipeline flagged
  the read OR its candidates spilled the flat capacity;
- ``flat`` (M, 2) uint32 with M = flat_factor * B: per candidate
  [genome_pos, (mm << 8) | (seed << 2) | (strand << 1)], read-major, and
  within a read strand '+' then '-', each in examination order -- exactly
  the stream order the bounded-heap replay consumes
  (src/walt/paired.cpp:106-201, 684-692).

Typical occupancy is 1-4 candidates/read, so the fetch is ~16-40 bytes/read
instead of ~9 C: >20x less transfer, and one dispatch per mate.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from walt_tpu.ops import pipeline

#: flat candidate slots per read in a chunk; spills take the exact host path
FLAT_FACTOR = 8


def flat_from_wl(wls, cnts, fb, flat_factor: int, cand_slab: int):
    """Emit (meta (B,), flat (M, 2)) straight from two strand WORKLISTS.

    ``wls``: [(wl_read, col, pos, mm, shift, keep)] for strand '+' then
    '-' -- the ``emit_wl`` outputs of ``pipeline.map_strand_core``, where
    ``col`` is each kept candidate's per-read slab position (examination
    order).  ``cnts``: the two (B,) capped per-read counts.

    The worklists hold only the real candidates (~2 wl_factor * B rows)
    with their slab positions already computed, so no B * 2C slab is
    scanned.  Layout: read-major, strand '+' then '-', examination order
    within.  A read whose candidates run past M is flagged fallback, and
    ``meta`` counts only its rows that landed, so the host decode's
    offsets stay aligned with ``flat``.
    """
    B = cnts[0].shape[0]
    M = flat_factor * B
    c0, c1 = cnts
    total = c0 + c1
    read_base = jnp.cumsum(total) - total  # (B,)
    spill = (read_base + total) > M
    flat = jnp.zeros((M, 2), dtype=jnp.uint32)
    for s, (wlr, col, pos, mm, shift, keep) in enumerate(wls):
        Mw = wlr.shape[0]
        base_r = read_base + (c0 if s else 0)
        dest = jnp.take(base_r, wlr, mode="clip") + col
        ok = keep & (col < cand_slab) & (dest < M)
        # distinct OOB slots per dropped row keep the scatter collision-free
        dest = jnp.where(ok, dest, M + jnp.arange(Mw, dtype=jnp.int32))
        word1 = (
            (mm.astype(jnp.uint32) << 8)
            | (jnp.maximum(shift, 0).astype(jnp.uint32) << 2)
            | (jnp.uint32(s) << 1)
        )
        flat = flat.at[dest, 0].set(pos, mode="drop", unique_indices=True)
        flat = flat.at[dest, 1].set(word1, mode="drop", unique_indices=True)
    # rows that landed: strand '+' fills [read_base, read_base + c0),
    # strand '-' the c1 slots after it; everything at or past M dropped
    room = M - read_base
    l0 = jnp.clip(room, 0, c0)
    l1 = jnp.clip(room - c0, 0, c1)
    meta = (l0.astype(jnp.uint32) | (l1.astype(jnp.uint32) << 8)
            | ((fb | spill).astype(jnp.uint32) << 16))
    return meta, flat


@functools.partial(
    jax.jit,
    static_argnames=(
        "pattern_name", "ag_wildcard", "search_bits", "verify_slab",
        "cand_slab", "wl_factor", "exact_b", "flat_factor", "uniq_bits",
        "full_mask",
    ),
)
def map_mate_device(preads, lens, b, max_mm, tables, *, pattern_name: str,
                    ag_wildcard: bool, search_bits: tuple,
                    verify_slab: int = pipeline.VERIFY_SLAB_T1,
                    cand_slab: int = pipeline.CAND_SLAB,
                    wl_factor: int = pipeline.WL_FACTOR,
                    exact_b: bool = False,
                    flat_factor: int = FLAT_FACTOR,
                    uniq_bits: tuple = (0, 0), full_mask: bool = False):
    """One mate against both strand tables -> (meta (B,), flat (M, 2)).

    ``tables``: tuple of two device-table dicts ('+' first, the file order
    of paired.cpp:660-661).
    """
    wls, cnts = [], []
    fb = None
    for t, bits, ubits in zip(tables, search_bits, uniq_bits):
        wl, cnt, f = pipeline.map_strand_core(
            preads, lens, b, max_mm, t["pseq"], t["counter"], t["index"],
            t["key_words"], t["start_index"], t["bucket_flagged"],
            pattern_name=pattern_name, ag_wildcard=ag_wildcard,
            search_bits=bits, verify_slab=verify_slab, cand_slab=cand_slab,
            wl_factor=wl_factor, exact_b=exact_b,
            uniq_words=t.get("uniq_words"), uniq_off=t.get("uniq_off"),
            uniq_counter=t.get("uniq_counter"), uniq_bits=ubits,
            full_mask=full_mask, emit_wl=True,
        )
        wls.append(wl)
        cnts.append(cnt)
        fb = f if fb is None else (fb | f)
    return flat_from_wl(wls, cnts, fb, flat_factor, cand_slab)
