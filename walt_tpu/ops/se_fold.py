"""Device-side single-end best-hit fold + the fused SE mapping step.

Folds the candidate slabs of both strand tables into per-read BestMatch
state entirely on device, so one chunk costs one tiny host fetch
((B,)-shaped results) instead of shipping candidate slabs over PCIe.

The fold is the jnp port of walt_tpu.host.replay_vec (itself the vectorized
form of the sequential BestMatch state machine, mapping.cpp:224-316 with
the seed early-exit gate of mapping.cpp:248-263): identical arithmetic,
identical ``times`` / stored-position / strand semantics.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from walt_tpu.constants import get_pattern
from walt_tpu.ops import pipeline

#: improvement-reset anchor: never equals a real genome position (the
#: reference caps genomes at uint32 positions and a chromosome end strictly
#: below 2^32 - 1)
_FRESH = jnp.uint32(0xFFFFFFFF)


#: "no candidates in this segment" mismatch sentinel
_BIG = 1 << 30


def segment_summaries(cand_seed, cand_pos, cand_mm, pattern):
    """Per-(read, seed) fold summaries of one strand's candidate slab.

    The BestMatch fold visits (strand, seed) segments in a fixed order, and
    whenever a segment is ACTIVE its new best equals the segment minimum --
    so the contributor set is always "candidates achieving the segment
    min", computable from the slab alone.  Everything the fold needs per
    segment is then five (B, S) numbers:

    - ``seg_min``: min mismatch in the segment (_BIG when empty);
    - ``inner_t``: adjacent-distinct-position transitions AMONG the
      min-achieving contributors (excluding the anchor comparison);
    - ``first_pos`` / ``last_pos``: first / last contributor position;
    - ``has``: any contributor.

    This is what makes cheap tensor-parallel SE mapping possible: a
    (read, seed) bucket lives wholly on one tp shard, so shards exchange
    these summaries (5 small (B, S) arrays, a select to combine) instead of
    full candidate slabs (a scatter-bound (T, B, C) slab merge).
    """
    B, C = cand_seed.shape
    S = pattern.pattern_len
    big = jnp.int32(_BIG)

    def shift_right(x, d):
        return jnp.pad(x, ((0, 0), (0, 0), (d, 0)))[:, :, :C]

    seed32 = cand_seed.astype(jnp.int32)
    # (B, S, C) masks per seed segment
    mask = seed32[:, None, :] == jnp.arange(S, dtype=jnp.int32)[None, :, None]
    seg_mm = jnp.where(mask, cand_mm[:, None, :], big)
    seg_min = seg_mm.min(axis=2)  # (B, S)
    contrib = mask & (cand_mm[:, None, :] == seg_min[:, :, None])

    # last contributing position at-or-before each slot, by log-shift
    # propagation: gather-free (these are pure
    # vector selects)
    v = jnp.where(contrib, cand_pos[:, None, :], jnp.uint32(0))
    h = contrib
    d = 1
    while d < C:
        v = jnp.where(h, v, shift_right(v, d))
        h = h | shift_right(h, d)
        d *= 2
    prev_has = shift_right(h, 1)
    prev_pos = shift_right(v, 1)
    inner = contrib & prev_has & (cand_pos[:, None, :] != prev_pos)
    inner_t = inner.sum(axis=2, dtype=jnp.int32)  # (B, S)
    first = contrib & ~prev_has
    first_pos = jnp.sum(
        jnp.where(first, cand_pos[:, None, :], jnp.uint32(0)),
        axis=2, dtype=jnp.uint32,
    )
    return dict(seg_min=seg_min, inner_t=inner_t, first_pos=first_pos,
                last_pos=v[:, :, -1], has=h[:, :, -1])


def combine_summaries(parts):
    """Combine per-shard summaries: at most one shard has contributors for
    a given (read, seed) (buckets are shard-disjoint), so this is a
    first-``has``-wins select; ``seg_min`` is min-combined for safety."""
    out = dict(parts[0])
    for p in parts[1:]:
        take = ~out["has"] & p["has"]
        out["seg_min"] = jnp.minimum(out["seg_min"], p["seg_min"])
        for k in ("inner_t", "first_pos", "last_pos"):
            out[k] = jnp.where(take, p[k], out[k])
        out["has"] = out["has"] | p["has"]
    return out


def fold_summaries(summaries, max_mm, pattern):
    """BestMatch fold over per-strand segment summaries.

    ``summaries``: [dict per strand] ('+' then '-') from
    :func:`segment_summaries`.  Exact port of the sequential state machine
    (mapping.cpp:224-316 + the seed early-exit gates of :248-263): the
    anchor comparison (first contributor vs the stored position, or vs a
    fresh sentinel after an improvement) is re-added here, the only part of
    the transition count that depends on fold state.
    """
    B = summaries[0]["seg_min"].shape[0]
    best = jnp.broadcast_to(jnp.asarray(max_mm, jnp.int32), (B,))
    times = jnp.zeros(B, dtype=jnp.int32)
    stored = jnp.zeros(B, dtype=jnp.uint32)  # BestMatch() starts at position 0
    minus = jnp.zeros(B, dtype=bool)

    for strand_idx, s in enumerate(summaries):
        for seed in range(pattern.pattern_len):
            seg_min = s["seg_min"][:, seed]
            has = s["has"][:, seed]
            allowed = ~((best == 0) & (seed > 0)) & ~(
                (best == 1) & (seed >= pattern.exit1_seed)
            )
            improve = allowed & (seg_min < best)
            equal = allowed & (seg_min == best)
            active = improve | equal
            # anchor term: the first contributor counts as a transition
            # unless it equals the stored position (never after an
            # improvement -- the anchor is then the fresh sentinel)
            anchor_ne = improve | (s["first_pos"][:, seed] != stored)
            tdelta = jnp.where(
                has, s["inner_t"][:, seed] + anchor_ne.astype(jnp.int32), 0
            )
            upd = active & has
            times = jnp.where(
                upd, jnp.where(improve, tdelta, times + tdelta), times
            )
            stored = jnp.where(upd, s["last_pos"][:, seed], stored)
            minus = jnp.where(active & (tdelta > 0), strand_idx == 1, minus)
            best = jnp.where(active, jnp.minimum(seg_min, best), best)

    return stored, times, minus, best


def se_fold(slabs, max_mm, pattern):
    """Fold [(cand_seed, cand_pos, cand_mm)] ('+' then '-') to BestMatch.

    Returns (pos (B,) uint32, times (B,) int32, minus (B,) bool,
    mismatch (B,) int32).
    """
    return fold_summaries(
        [segment_summaries(cs, cp, cm, pattern) for cs, cp, cm in slabs],
        max_mm, pattern,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "pattern_name", "ag_wildcard", "search_bits", "verify_slab",
        "cand_slab", "seeds", "wl_factor", "exact_b", "uniq_bits",
        "full_mask",
    ),
)
def map_single_end_device(preads, lens, b, max_mm, tables, *,
                          pattern_name: str, ag_wildcard: bool,
                          search_bits: tuple,
                          verify_slab: int = pipeline.VERIFY_SLAB,
                          cand_slab: int = pipeline.CAND_SLAB,
                          seeds: tuple | None = None,
                          wl_factor: int = pipeline.WL_FACTOR,
                          exact_b: bool = False,
                          uniq_bits: tuple = (0, 0),
                          full_mask: bool = False):
    """Full SE mapping step: both strand tables -> per-read BestMatch.

    ``tables``: tuple of two dicts (keys: pseq, counter, index, key_words,
    start_index, bucket_flagged), '+' table first (mapping.cpp:491-499 file
    order).  Returns ONE (B, 3) uint32 array -- [pos, times,
    (mm << 2) | (minus << 1) | fallback] -- so a chunk's result costs a
    single device-to-host fetch; unpack with
    :func:`unpack_se_result`.
    """
    pattern = get_pattern(pattern_name)
    slabs = []
    fallback = None
    for t, bits, ubits in zip(tables, search_bits, uniq_bits):
        cs, cp, cm, _, fb = pipeline.map_strand_core(
            preads, lens, b, max_mm, t["pseq"], t["counter"], t["index"],
            t["key_words"], t["start_index"], t["bucket_flagged"],
            pattern_name=pattern_name, ag_wildcard=ag_wildcard,
            search_bits=bits, verify_slab=verify_slab, cand_slab=cand_slab,
            seeds=seeds, wl_factor=wl_factor, exact_b=exact_b,
            uniq_words=t.get("uniq_words"), uniq_off=t.get("uniq_off"),
            uniq_counter=t.get("uniq_counter"), uniq_bits=ubits,
            full_mask=full_mask,
        )
        slabs.append((cs, cp, cm))
        fallback = fb if fallback is None else (fallback | fb)
    pos, times, minus, mm = se_fold(slabs, max_mm, pattern)
    flags = (
        (mm.astype(jnp.uint32) << 2)
        | (minus.astype(jnp.uint32) << 1)
        | fallback.astype(jnp.uint32)
    )
    return jnp.stack([pos, times.astype(jnp.uint32), flags], axis=1)


def unpack_se_result(packed: "np.ndarray"):
    """(B, 3) uint32 -> (pos u32, times i32, minus bool, mm i32, fb bool)."""
    pos = packed[:, 0]
    times = packed[:, 1].astype("int32")
    flags = packed[:, 2]
    minus = (flags & 2).astype(bool)
    fb = (flags & 1).astype(bool)
    mm = (flags >> 2).astype("int32")
    return pos, times, minus, mm, fb
