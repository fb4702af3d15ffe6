"""The jitted device mapping pipeline: seed -> refine -> verify -> compact.

One XLA program maps a fixed-shape read batch against one table:

1. seed hashing: the 12 cared bases per (read, shift) are extracted from the
   2-bit-packed read words at static offsets and packed to a bucket key
   (util.hpp:175-182);
2. bucket refinement, restructured for the device: ONE masked-prefix
   lower-bound binary search over precomputed packed key words finds where
   the refined run starts, and membership in the run is then decided per
   verified entry by a cared-position masked popcount on the SAME genome
   window the verifier gathers anyway -- no upper-bound search, no extra
   probes.  For an unflagged bucket (monotone stored order,
   ops/device_index.py) the match set equals the reference's IndexRegion
   equal range (mapping.cpp:166-222);
3. the -b cap on the refined count (mapping.cpp:275-277) and chromosome
   boundary rejections (mapping.cpp:281-286);
4. verification: the candidate window is assembled from the packed converted
   genome (contiguous word-slice gather + align) and compared against the
   packed converted read with XOR + lane-fold + popcount -- 16 bases per op
   (equals the reference's no-cared + tail count; see core/refmap.py), with
   the pattern-typo corrections;
5. ordered compaction of candidates with mismatch <= -m into a fixed slab,
   preserving (seed asc, bucket position asc) examination order for the host
   replay / device fold.

The verify slab is deliberately small (VERIFY_SLAB_T1): refined runs are
almost always tiny, and slab size is the dominant term in per-read HBM
traffic.  A read whose run might extend past the slab (every examined slot
still matched and bucket entries remain) raises ``fallback``; the driver
re-runs those reads with a larger slab and only then the exact host path.
Flagged buckets (boundary sort quirks) always take the host path.

All read/genome base data is packed 16 bases per uint32 word (ops/packing);
reads are packed on host, conversion (C->T / G->A, mapping.cpp:142-164)
happens on device with bit tricks.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from walt_tpu.constants import get_pattern
from walt_tpu.ops import packing


#: tier-1 verify slab: refined entries verified per (read, seed); tiny on
#: purpose -- see module docstring
VERIFY_SLAB_T1 = 8
#: tier-2 verify slab for reads that overflowed tier 1
VERIFY_SLAB = 64
#: max surviving candidates per (read, strand)
CAND_SLAB = 32
#: worklist slots per read in a chunk (cross-read compaction of refined
#: survivors before the genome-window gather); spills take the host path
WL_FACTOR = 4

#: per-device-local CSR entry-count ceiling.  Entry INDICES (lo/hi bounds,
#: worklist slots) are int32 inside the pipeline; genome POSITIONS are u32
#: (4 Gbp format limit).  A table whose device-local index would hold
#: >= 2^31 entries must be tp-sharded first (hg19's ~3 Gbp entries at tp=4
#: leave ~2^30 per shard) -- walt_tpu.hbm_plan reaches the same conclusion
#: from HBM capacity alone.
ENTRY_LIMIT = 1 << 31


def check_entry_limit(n_entries: int, where: str) -> None:
    """Raise before a device-local table silently wraps its int32 indices."""
    if n_entries >= ENTRY_LIMIT:
        raise ValueError(
            f"{where}: {n_entries} entries >= 2^31 would overflow the "
            f"pipeline's int32 entry indices; shard the table (tp) so each "
            f"device-local CSR stays below {ENTRY_LIMIT} entries"
        )


def _lex_ge(es, rs):
    """Lexicographic (entry >= read) on N masked word pairs."""
    ge = es[-1] >= rs[-1]
    for e, r in zip(reversed(es[:-1]), reversed(rs[:-1])):
        ge = (e > r) | ((e == r) & ge)
    return ge


def _search_k() -> int:
    """Arity of the refinement search (WALTX_SEARCH_K, default 2 = binary).

    A k-ary round issues k-1 independent gathers and divides the interval
    by k, trading serial depth (ceil(bits/log2 k) rounds) for total probe
    traffic ((k-1) * rounds gathers).  Binary issues the fewest probes
    (= bits, the comparison-based minimum); k > 2 can only win where the
    search is bound by gather latency rather than by gather issue rate.
    Which holds on the GPU is open (ROADMAP A4).
    """
    import os

    return max(2, int(os.environ.get("WALTX_SEARCH_K", "2")))


def _kary_lower(l, r, probe, bits: int, k: int):
    """First index in [l, r) where monotone ``probe`` holds (lower bound).

    ``probe(idx) -> bool array``: False...False True...True over the
    interval (vacuously all-False allowed -> returns r).  ``bits``: static
    bound with interval length <= 2^bits - 1.  Runs
    ``ceil(bits / log2 k)`` unrolled rounds; each round's k-1 probes are
    independent gathers.  Worst-case interval shrink per round is
    floor(n/k) (lower-bound split arithmetic), so floor(n / k^R) = 0 at
    R = ceil(log_k(n + 1)) <= ceil(bits / log2 k).
    """
    import math

    rounds = max(1, math.ceil(bits / math.log2(k)))
    for _ in range(rounds):
        active = l < r
        n = r - l
        ms = [l + (n * j) // k for j in range(1, k)]
        ges = [probe(m) for m in ms]
        new_r = r
        for m, ge in zip(reversed(ms), reversed(ges)):
            new_r = jnp.where(ge, m, new_r)
        new_l = ms[-1] + 1
        prev = [l] + [m + 1 for m in ms[:-1]]
        for j in range(k - 2, -1, -1):
            new_l = jnp.where(ges[j], prev[j], new_l)
        l = jnp.where(active, new_l, l)
        r = jnp.where(active, new_r, r)
    return l


def map_strand_core(preads, lens, b, max_mm, pseq, counter, index, key_words,
                    start_index, bucket_flagged, *, pattern_name: str,
                    ag_wildcard: bool, search_bits: int,
                    verify_slab: int = VERIFY_SLAB_T1,
                    cand_slab: int = CAND_SLAB,
                    key_base=None, seeds: tuple | None = None,
                    wl_factor: int = WL_FACTOR, exact_b: bool = False,
                    uniq_words=None, uniq_off=None, uniq_counter=None,
                    uniq_bits: int = 0, full_mask: bool = False,
                    tp_route: int = 0, emit_wl: bool = False,
                    stage_out: str | None = None):
    """Map a read batch against one table (trace-level core).

    preads: (B, W) uint32 packed read codes; lens: (B,) int32; pseq: packed
    converted genome words (padded).  Returns (cand_seed i8, cand_pos u32,
    cand_mm i32, cand_cnt i32, fallback bool) with slab axis cand_slab.

    ``key_base``: when the hash table is sharded by bucket range (the
    tensor-parallel layout of walt_tpu.parallel), the local ``counter`` spans
    buckets [key_base, key_base + counter_size); keys outside it yield empty
    regions on this shard.

    ``exact_b``: membership/refinement strategy (static).  False (the
    default, valid whenever ``b >= verify_slab``): the lower-bound search
    and slab admission probe only the FIRST packed key word, and equality
    of the remaining cared positions is enforced from the verify window
    with static lane masks -- pure vector compute instead of a second set
    of scattered HBM gathers.  The word-0 run is a superset of the true
    refined run, so the overflow promotion stays conservative and the
    -b cap (which cannot trigger below the slab size) is unaffected.
    True: the original full-lexicographic formulation, required when the
    runtime ``b`` is smaller than the verify slab so the refined COUNT
    itself (mapping.cpp:275-277) must be exact within the slab.

    ``uniq_words``/``uniq_off``/``uniq_counter``/``uniq_bits``: the deduped
    word-0 run structure (ops/device_index.build_uniq_device).  Entries
    within a bucket are stored sorted, so equal word-0 lookup keys form
    contiguous runs; ``uniq_words[u]`` is run u's key word, ``uniq_off[u]``
    its first entry index, ``uniq_counter`` the per-bucket CSR over runs.
    With ``uniq_bits > 0`` (and not ``exact_b``) the refinement searches the
    RUN space instead of the entry space: the lower-bound needs
    ceil(log2(max runs/bucket)) probes instead of ceil(log2(max
    entries/bucket)) -- never more, far fewer on repeat-heavy genomes -- and
    slab admission becomes pure arithmetic on the run bounds instead of
    ``verify_slab`` gathered key words per (read, seed).  ``key_words`` may
    then be a dummy array (it is only read on the ``exact_b`` path).

    ``full_mask``: static promise that every real read in the chunk compares
    a FULL first key word (seed_len >= key_weight + 16, e.g. every >=86bp
    read under pattern 3).  The refined run is then exactly one word-0 run
    and its end is one ``uniq_off`` gather past the lower bound; without the
    promise a second (upper-bound) probe chain finds the end of the
    masked-prefix run group.

    ``tp_route`` (static, requires ``key_base``): the tp mesh size T.  A
    bucket lives wholly on one tp shard, so of a chunk's B*S (read, seed)
    pairs only ~B*S/T are owned by this shard -- but the probe chains,
    slab admission and worklist machinery are fixed-shape and would run at
    full (B, S) size on every shard, which is why tp=2 measured only 0.69
    efficiency (SCALING.json round 4).  With ``tp_route`` = T > 1 the owned
    pairs are COMPACTED into K ~= 1.25 * B*S/T rows first (order-preserving,
    so examination order is untouched) and everything from the probe chains
    down runs at 1/T size; the worklist shrinks by T as well.  Reads whose
    owned pairs spill K take the host path (``fallback``), exactly like
    worklist spills.  This is the all-to-all-by-key half of the scaling-book
    recipe: reads are routed to the shard that owns their bucket instead of
    every shard scanning every read.
    """
    pattern = get_pattern(pattern_name)
    plen = pattern.pattern_len
    seeds = tuple(range(plen)) if seeds is None else seeds
    S = len(seeds)
    kw = pattern.key_weight
    cared = pattern.cared
    B, W = preads.shape
    Lmax = W * 16
    n_entries = index.shape[0]
    C = verify_slab

    # --- read conversion (mapping.cpp:142-164) on packed words ---
    conv = packing.convert_ga(preads) if ag_wildcard else packing.convert_ct(preads)

    read_ok = lens >= pattern.min_read_len  # (B,)
    repeats = jnp.minimum((lens - plen + 1) // plen, pattern.max_repeats())
    seed_len = jnp.minimum(repeats * pattern.cared_weight, pattern.cared_size)

    # cared-base extraction, fully vectorized over static position tables:
    # pos[s][p] = cared[p] + seed shift s -> word index / in-word shift
    n_cared = min(pattern.cared_size, kw + 48)
    pos_tab = np.asarray(
        [[int(cared[p]) + s for p in range(n_cared)] for s in seeds]
    )  # (S, n_cared)
    in_range_tab = pos_tab < Lmax
    word_tab = jnp.asarray(np.where(in_range_tab, pos_tab // 16, 0))
    shift_tab = jnp.asarray(
        (30 - 2 * (pos_tab % 16)).astype(np.uint32)[None, :, :]
    )  # (1, S, n_cared)
    # (B, S, n_cared) base codes at every (shift, cared position)
    cvals = (conv[:, word_tab] >> shift_tab) & 3
    cvals = jnp.where(jnp.asarray(in_range_tab)[None, :, :], cvals, 0)

    def pack16(vals):
        """(…, k<=16) 2-bit codes -> one uint32, first value most significant."""
        k = vals.shape[-1]
        w = jnp.asarray(
            np.arange(k - 1, -1, -1, dtype=np.uint32) * 2
        )
        return jnp.sum(vals << w, axis=-1, dtype=jnp.uint32)

    # --- seed hash keys: (B, S) ---
    key = pack16(cvals[..., :kw])

    use_uniq = uniq_bits > 0 and not exact_b and uniq_words is not None
    route = tp_route > 1 and key_base is not None
    # bucket_flagged is a per-bucket bit mask: bit0 = host-fallback in the
    # fast path, bit1 = host-fallback in the exact_b path (device_index).
    # On the uniq path lo/hi are RUN-space bucket bounds (uniq_counter);
    # otherwise entry-space (counter).
    bounds = uniq_counter if use_uniq else counter
    fbit = jnp.uint8(2 if exact_b else 1)
    if key_base is None:
        lo = jnp.take(bounds, key).astype(jnp.int32)  # (B, S)
        hi = jnp.take(bounds, key + 1).astype(jnp.int32)
        flagged = (jnp.take(bucket_flagged, key) & fbit) != 0  # (B, S)
    else:
        local = key - jnp.uint32(key_base)  # wraps below base -> large
        in_range = local < jnp.uint32(bounds.shape[0] - 1)
        lidx = jnp.where(in_range, local, 0).astype(jnp.int32)
        flagged = in_range & ((jnp.take(bucket_flagged, lidx) & fbit) != 0)
        if not route:
            lo = jnp.where(
                in_range, jnp.take(bounds, lidx).astype(jnp.int32), 0
            )
            hi = jnp.where(
                in_range, jnp.take(bounds, lidx + 1).astype(jnp.int32), 0
            )

    # stage_out: profiling hook (tools/device_profile.py).  Returning a tiny
    # checksum right after a stage lets XLA dead-code-eliminate everything
    # downstream, so timing the truncated programs yields a per-stage cost
    # breakdown of the REAL compiled pipeline (not a re-implementation).
    if stage_out == "keys":
        if route:
            return jnp.sum(in_range) + jnp.sum(flagged)
        return jnp.sum(lo) + jnp.sum(hi) + jnp.sum(flagged)

    # --- read prefix key words (cared[kw..kw+47] per shift) + masks ---
    # words actually probed: reads fitting W packed words cannot have a
    # seed_len past seed_len_for_len(W*16), so deeper key words are always
    # fully masked -- drop their probe gathers statically (a third of probe
    # HBM traffic for <=133bp batches under pattern 3)
    max_seed_len = min(int(pattern.seed_len_for_len(Lmax)), kw + 48)
    npw = max(1, min(3, -(-(max_seed_len - kw) // 16)))
    rwords = []
    for w in range(npw):
        a, z = kw + w * 16, min(kw + w * 16 + 16, n_cared)
        if a >= z:
            rwords.append(jnp.zeros((B, S), dtype=jnp.uint32))
            continue
        vals = cvals[..., a:z]
        word = pack16(vals) << jnp.uint32(2 * (16 - (z - a)))
        rwords.append(word)  # (B, S)
    # number of compared positions per word, from per-read seed_len
    masks = []
    for w in range(npw):
        nbits = jnp.clip(seed_len[:, None] - kw - 16 * w, 0, 16) * 2  # (B,1)
        shift = jnp.clip(32 - nbits, 0, 31).astype(jnp.uint32)
        m = jnp.where(
            nbits > 0, jnp.uint32(0xFFFFFFFF) << shift, jnp.uint32(0)
        )
        masks.append(jnp.broadcast_to(m, (B, S)))
    rws = [rw & m for rw, m in zip(rwords, masks)]

    if route:
        # --- compact this shard's OWNED (read, seed) pairs into K rows.
        # Flat pair order is read-major then seed asc, so the compaction
        # preserves examination order; everything downstream runs in the
        # compacted row space (K,) instead of (B, S).
        pairs = B * S
        K = min(pairs, int(1.25 * pairs / tp_route) + 128)
        own_flat = in_range.reshape(pairs)
        gq = jnp.cumsum(own_flat.astype(jnp.int32)) - 1
        r_src = jnp.full((K,), -1, dtype=jnp.int32).at[
            jnp.where(own_flat & (gq < K), gq, K)
        ].set(jnp.arange(pairs, dtype=jnp.int32), mode="drop")
        # reads whose owned pairs spilled the route capacity -> host path
        route_spill = jnp.any(
            (own_flat & (gq >= K)).reshape(B, S), axis=1
        )
        rvalid = r_src >= 0
        r_flat = jnp.maximum(r_src, 0)
        r_read = r_flat // S
        r_seedi = r_flat % S

        def rgat(x):  # (B, S) -> (K,)
            return jnp.take(x.reshape(-1), r_flat)

        lidx_r = rgat(lidx)
        lo = jnp.where(
            rvalid, jnp.take(bounds, lidx_r).astype(jnp.int32), 0
        )
        hi = jnp.where(
            rvalid, jnp.take(bounds, lidx_r + 1).astype(jnp.int32), 0
        )
        flagged_r = rgat(flagged) & rvalid
        masks = [rgat(m) for m in masks]
        rws = [rgat(w) for w in rws]

        def by_read(v):  # (K,) bool -> (B,) any
            return jnp.zeros((B,), jnp.int32).at[r_read].add(
                (v & rvalid).astype(jnp.int32), mode="drop"
            ) > 0

    # number of key words probed by the search and the slab admission; the
    # fast path defers words beyond the first to the window cared check
    nprobe = npw if exact_b else 1
    run_len = None
    # 16-bit prefix keys (ops/device_index.build_key16_device): the stored
    # key is the TOP 8 cared bases of word 0 only; the search lands at the
    # refined run GROUP and the window cared check (below) verifies the
    # rest -- half the per-entry HBM of u32 word-0 tables
    key16 = (not use_uniq) and key_words.ndim == 1 \
        and key_words.dtype == jnp.uint16
    if key16 and exact_b:
        raise ValueError("exact_b path needs full key words, not key16")
    if not use_uniq and not key16:
        # the device table may carry fewer packed key words than the read
        # needs (word0-only tables halve per-entry HBM for default -b runs,
        # which never take the exact_b path); probing more words than stored
        # is a caller error
        if key_words.ndim == 1:
            key_words = key_words[:, None]
        if key_words.shape[1] < nprobe:
            raise ValueError(
                f"device table stores {key_words.shape[1]} key word(s) but "
                f"the exact_b={exact_b} path probes {nprobe}; rebuild the "
                f"table with n_key_words={nprobe}"
            )
        kws = [key_words[:, w] for w in range(min(npw, key_words.shape[1]))]

        def probe(mid):
            # mode="clip" folds the bounds guard into the gather
            es = [jnp.take(kw_, mid, mode="clip") & m
                  for kw_, m in zip(kws[:nprobe], masks[:nprobe])]
            return _lex_ge(es, rws[:nprobe])

        # first entry >= read prefix: the refined run starts here.  The
        # rounds are UNROLLED (search_bits is static, <= 32): lax.fori_loop's
        # per-trip loop machinery costs more than the duplicated body on this
        # gather-latency-bound chain.  All interval arithmetic uses the
        # overflow-free l + (r-l)*j//k form: (l+r)//2 wraps int32 once a
        # shard holds > 2^30 entries -- hg19's T-rich shard has 1.55e9, and
        # the wrapped search silently returned empty runs (930 reads lost;
        # caught by tools/hg19_scale parity, round 4).  Single-word probes
        # take the k-ary search (see _search_k); multi-word (exact_b) probes
        # stay binary -- k-ary would multiply the per-round gathers by npw.
        lower = _kary_lower(lo, hi, probe, search_bits,
                            _search_k() if nprobe == 1 else 2)
    elif key16:
        kw16 = key_words
        m16 = masks[0] >> jnp.uint32(16)
        rw16 = rws[0] >> jnp.uint32(16)  # rws already masked

        def probe16(mid):
            e = jnp.take(kw16, mid, mode="clip").astype(jnp.uint32) & m16
            return e >= rw16

        lower = _kary_lower(lo, hi, probe16, search_bits, _search_k())
    else:
        # run-space refinement: lo/hi bound the bucket's word-0 RUNS; the
        # lower bound over uniq_words needs uniq_bits probes (<= the entry
        # search's, usually far fewer), and the run bounds then give the
        # refined region in entry space with two uniq_off gathers -- no
        # per-slab-slot membership gathers at all.
        m0, rw0 = masks[0], rws[0]

        def uprobe(mid, strict):
            e = jnp.take(uniq_words, mid, mode="clip") & m0
            return (e > rw0) if strict else (e >= rw0)

        lu = _kary_lower(lo, hi, lambda m: uprobe(m, False), uniq_bits,
                         _search_k())
        elo = jnp.take(uniq_off, lu, mode="clip").astype(jnp.int32)
        if full_mask:
            # every real read compares a full word 0, so the refined region
            # is exactly one run: present iff uniq_words[lu] equals it
            uw = jnp.take(uniq_words, lu, mode="clip") & m0
            hit = (lu < hi) & (uw == rw0)
            ehi = jnp.where(
                hit,
                jnp.take(uniq_off, lu + 1, mode="clip").astype(jnp.int32),
                elo,
            )
        else:
            # masked (short-read) prefixes can span several runs: a second
            # probe chain finds the first run past the prefix group
            l2 = _kary_lower(lu, hi, lambda m: uprobe(m, True),
                             uniq_bits, _search_k())
            ehi = jnp.take(uniq_off, l2, mode="clip").astype(jnp.int32)
        lower = elo
        run_len = jnp.maximum(ehi - elo, 0)
    if stage_out == "search":
        return jnp.sum(lower) + (jnp.sum(run_len) if use_uniq else 0)

    # --- slab membership from the SAME packed lookup keys the probes read:
    # an entry is in the reference's refined equal range iff its cared bases
    # beyond the hash key all equal the read's (mapping.cpp:198-222), i.e.
    # its masked key words EQUAL the read's masked prefix words.  This costs
    # npw (<=3) gathered words per slot instead of the W+1 genome-window
    # words the old formulation compared under a cared mask.
    shifts = jnp.asarray(seeds, dtype=jnp.int32)  # (S,)
    j = jnp.arange(C, dtype=jnp.int32)
    # row space: (B, S) unrouted, (K,) routed; jC broadcasts the slab axis
    jC = j[None, :] if route else j[None, None, :]
    if use_uniq:
        # run bounds are exact: slab admission is pure arithmetic
        refined_cnt = jnp.minimum(run_len, C)
        refined = jC < refined_cnt[..., None]
        capped = refined_cnt > b  # never fires in the fast path (b >= slab)
        overflow = (run_len > C) & ~capped
    else:
        in_bucket = jC < (hi - lower)[..., None]
        slot = lower[..., None] + jC
        slotc = jnp.clip(slot, 0, n_entries - 1)
        refined = in_bucket
        if key16:
            es = jnp.take(kw16, slotc).astype(jnp.uint32) & m16[..., None]
            refined = refined & (es == rw16[..., None])
        else:
            for kw_, m, rw in zip(kws[:nprobe], masks[:nprobe], rws[:nprobe]):
                es = jnp.take(kw_, slotc) & m[..., None]
                refined = refined & (es == rw[..., None])

        refined_cnt = jnp.sum(refined, axis=-1, dtype=jnp.int32)
        # seed skipped entirely (mapping.cpp:275-277)
        capped = refined_cnt > b
        # run may extend past the slab: every examined slot matched and
        # bucket entries remain beyond it -> this read needs a larger slab
        examined = jnp.clip(hi - lower, 0, C)
        # a capped seed is skipped no matter how long the run really is, so
        # a partial count > b is already exact and needs no larger slab
        overflow = (refined_cnt == examined) & ((hi - lower) > C) & ~capped

    if stage_out == "membership":
        return jnp.sum(refined_cnt) + jnp.sum(overflow)

    row_ok = (jnp.take(read_ok, r_read) if route
              else read_ok[:, None])  # broadcasts over the row space
    keep_pre = (
        refined
        & ~capped[..., None]
        & ~overflow[..., None]
        & row_ok[..., None]
    )

    # --- compact the refined survivors into one flat cross-read worklist;
    # windows are gathered and verified ONLY for real candidates (typically
    # ~1-2 per read) instead of every slab slot.  Worklist order is flat
    # (read, seed asc, bucket position asc) = the reference's examination
    # order, so downstream per-read compaction stays ordered.
    # wl_factor may be fractional (slots per read): every worklist-sized op
    # -- the (W+1)-word window gather, the read-row gather, the compaction
    # scatter -- scales with M, and survivors average ~1.2/read, so shaving
    # slots is direct device time (spills stay correct via the host path).
    # routed shards carry ~1/T of the chunk's survivors, so the worklist
    # (and every fixed-M op scaling with it) shrinks by T as well
    M = max(1, int(wl_factor * B / max(1, tp_route if route else 1)))
    n_rows = K if route else B * S
    keep_flat = keep_pre.reshape(n_rows * C)
    gidx = jnp.cumsum(keep_flat.astype(jnp.int32)) - 1
    wl_src = jnp.full((M,), -1, dtype=jnp.int32).at[
        jnp.where(keep_flat & (gidx < M), gidx, M)
    ].set(jnp.arange(n_rows * C, dtype=jnp.int32), mode="drop")
    # reads whose survivors spilled past the worklist take the host path
    if route:
        wl_spill = by_read(
            jnp.any((keep_flat & (gidx >= M)).reshape(K, C), axis=1)
        )
    else:
        wl_spill = jnp.any(
            (keep_flat & (gidx >= M)).reshape(B, S * C), axis=1
        )

    wl_valid = wl_src >= 0
    wl_flat = jnp.maximum(wl_src, 0)
    wl_bs = wl_flat // C
    if route:
        wl_read = jnp.take(r_read, wl_bs)
        wl_seedi = jnp.take(r_seedi, wl_bs)
        wl_entryidx = jnp.take(lower, wl_bs) + (wl_flat % C)
    else:
        wl_read = wl_flat // (S * C)
        wl_seedi = wl_bs % S
        wl_entryidx = jnp.take(lower.reshape(-1), wl_bs) + (wl_flat % C)
    wl_shift = jnp.take(shifts, wl_seedi)  # (M,)
    # Genome POSITIONS stay uint32 end to end: the format allows genomes up
    # to 4 Gbp (u32 positions, reference.cpp:302-322), so int32 would wrap
    # beyond 2 Gbp (hg19 is 3.1 Gbp).  The u32 subtractions below are exact:
    # wl_entry >= ch_start by construction (searchsorted of the entry's own
    # chromosome), and a wrapped wl_gpos (entry < shift) only occurs on rows
    # ok_head already discards.  (Entry INDICES -- lo/hi/wl_entryidx -- stay
    # int32: per-device-local CSRs must hold < 2^31 entries, asserted by
    # check_entry_limit at table build/shard time.)
    wl_entry = jnp.take(index, jnp.clip(wl_entryidx, 0, n_entries - 1))
    si_u = start_index  # uint32
    chrom = jnp.searchsorted(si_u, wl_entry, side="right") - 1
    ch_start = si_u[chrom]
    ch_end = si_u[jnp.minimum(chrom + 1, si_u.shape[0] - 1)]
    wl_shift_u = wl_shift.astype(jnp.uint32)
    ok_head = (wl_entry - ch_start) >= wl_shift_u  # mapping.cpp:282-283
    wl_gpos = wl_entry - wl_shift_u
    wl_len = jnp.take(lens, wl_read)
    # mapping.cpp:285 ('>=' skips); u32 add cannot wrap for positions below
    # the 4 Gbp format limit minus MAX_LINE_LENGTH
    ok_tail = (wl_gpos + wl_len.astype(jnp.uint32)) < ch_end

    if stage_out == "worklist":
        return (jnp.sum(wl_gpos) + jnp.sum(ok_head) + jnp.sum(ok_tail)
                + jnp.sum(wl_spill))

    # converted read words + length lane masks for the worklist rows
    conv_flat = conv.reshape(-1)
    wl_conv = jnp.take(
        conv_flat,
        wl_read[:, None] * W + jnp.arange(W, dtype=jnp.int32)[None, :],
    )  # (M, W)
    wl_lane = packing.len_lane_masks(wl_len, W)  # (M, W)

    mm, win = packing.verify_words(pseq, wl_gpos, wl_conv, wl_lane, W)

    wl_rep = jnp.take(repeats, wl_read)
    for shift, min_rep, posn in pattern.verify_skip:
        if posn < Lmax:
            wv = (win[..., posn // 16] >> jnp.uint32(30 - 2 * (posn % 16))) & 3
            rv = packing.extract_lane(wl_conv, posn)
            cond = (
                (wl_shift == shift)
                & (wl_rep >= min_rep)
                & (posn < wl_len)
                & (wv != rv)
            )
            mm = mm - cond.astype(jnp.int32)

    wl_keep = wl_valid & ok_head & ok_tail & (mm <= max_mm)
    if stage_out == "verify":
        return jnp.sum(mm) + jnp.sum(wl_keep)

    if not exact_b and (npw > 1 or key16):
        # Window cared check: a fast-path worklist row is only known to
        # match the read on the hash key + the first packed key word (or
        # its 16-bit prefix on key16 tables); the reference's refined
        # region additionally requires equality at the remaining cared
        # positions kw+16 (key16: kw+8) ..seed_len-1 (mapping.cpp:198-222).
        # Those bases sit inside the verify window already in registers, so
        # the check is an AND of the existing XOR-fold against (a) a static
        # per-shift cared-lane mask and (b) a per-row cutoff mask at
        # cared[seed_len] -- no extra HBM traffic.
        check_from = kw + 8 if key16 else kw + 16
        cared_np = np.zeros((S, W), dtype=np.uint32)
        for si, s in enumerate(seeds):
            for jj in range(check_from, n_cared):
                p = int(cared[jj]) + s
                if p < Lmax:
                    cared_np[si, p // 16] |= np.uint32(1) << np.uint32(
                        30 - 2 * (p % 16)
                    )
        d2 = win ^ wl_conv
        fold2 = (d2 | (d2 >> 1)) & wl_lane
        # cared[j] is periodic-affine: (j // cw) * plen + cared[j % cw]
        cwt = pattern.cared_weight
        assert all(
            int(cared[j]) == (j // cwt) * plen + int(cared[j % cwt])
            for j in range(n_cared)
        ), "cared table is not periodic-affine; exact_b path required"
        slj = jnp.minimum(wl_rep * cwt, n_cared)  # (M,) seed_len per row
        offv = jnp.full_like(slj, int(cared[0]))
        for r_ in range(1, cwt):
            offv = jnp.where(slj % cwt == r_, int(cared[r_]), offv)
        cutoff = (slj // cwt) * plen + offv + wl_shift
        cut_mask = packing.len_lane_masks(cutoff, W)  # lanes < cutoff
        viol = jnp.zeros((M,), dtype=jnp.uint32)
        for w in range(W):
            cmw = jnp.full((M,), cared_np[S - 1, w], dtype=jnp.uint32)
            for si in range(S - 2, -1, -1):
                cmw = jnp.where(
                    wl_seedi == si, jnp.uint32(cared_np[si, w]), cmw
                )
            viol = viol | (fold2[:, w] & cmw & cut_mask[:, w])
        wl_keep = wl_keep & (viol == 0)

    # --- ordered compaction into the per-read candidate slab ---
    cnt = jnp.zeros((B,), dtype=jnp.int32).at[wl_read].add(
        wl_keep.astype(jnp.int32), mode="drop"
    )
    base = jnp.cumsum(cnt) - cnt  # kept entries before each read
    rank = jnp.cumsum(wl_keep.astype(jnp.int32)) - 1
    dest = rank - jnp.take(base, wl_read)
    dest = jnp.where(wl_keep, dest, cand_slab)  # dropped by scatter mode
    cand_cnt = cnt

    if not emit_wl:
        def compact(vals, fill, dtype):
            out = jnp.full((B, cand_slab), fill, dtype=dtype)
            return out.at[wl_read, dest].set(vals.astype(dtype), mode="drop")

        cand_seed = compact(wl_shift, -1, jnp.int8)
        cand_pos = compact(wl_gpos, 0, jnp.uint32)
        cand_mm = compact(mm, 0, jnp.int32)

    if route:
        fallback = (
            (by_read(overflow)
             # flagged buckets: stored order / padding quirks make the
             # refined run irreproducible on device -> exact host path
             | by_read(flagged_r & (hi > lo)))
            & read_ok
            | (seed_len > kw + 48)
            | (cand_cnt > cand_slab)
            | wl_spill
            | route_spill
        )
    else:
        fallback = (
            (
                jnp.any(overflow, axis=1)
                # flagged buckets: stored order / padding quirks make the
                # refined run irreproducible on device -> exact host path
                | jnp.any(flagged & (hi > lo), axis=1)
            )
            & read_ok
            # packed key words cover cared positions kw..kw+47 only; longer
            # seeds (pattern 7 reads > 111bp) need the host path
            | (seed_len > kw + 48)
            | (cand_cnt > cand_slab)
            | wl_spill
        )
    if emit_wl:
        # worklist-level stream for the PE flat emission
        # (ops/pe_map.flat_from_wl): the per-read slab col in ``dest`` plus
        # the raw candidate fields, skipping the 3 slab scatters entirely
        return ((wl_read, dest, wl_gpos, mm, wl_shift, wl_keep),
                jnp.minimum(cand_cnt, cand_slab), fallback)
    return cand_seed, cand_pos, cand_mm, jnp.minimum(cand_cnt, cand_slab), fallback


@functools.partial(
    jax.jit,
    static_argnames=(
        "pattern_name", "ag_wildcard", "search_bits", "verify_slab",
        "cand_slab", "seeds", "wl_factor", "exact_b", "uniq_bits",
        "full_mask", "stage_out",
    ),
)
def map_strand_stage(preads, lens, b, max_mm, pseq, counter, index, key_words,
                     start_index, bucket_flagged, *, pattern_name: str,
                     ag_wildcard: bool, search_bits: int, stage_out: str,
                     verify_slab: int = VERIFY_SLAB_T1,
                     cand_slab: int = CAND_SLAB, seeds: tuple | None = None,
                     wl_factor: int = WL_FACTOR, exact_b: bool = False,
                     uniq_words=None, uniq_off=None, uniq_counter=None,
                     uniq_bits: int = 0, full_mask: bool = False):
    """Stage-truncated pipeline for device profiling (tools/device_profile)."""
    return map_strand_core(
        preads, lens, b, max_mm, pseq, counter, index, key_words,
        start_index, bucket_flagged, pattern_name=pattern_name,
        ag_wildcard=ag_wildcard, search_bits=search_bits,
        verify_slab=verify_slab, cand_slab=cand_slab, seeds=seeds,
        wl_factor=wl_factor, exact_b=exact_b, uniq_words=uniq_words,
        uniq_off=uniq_off, uniq_counter=uniq_counter, uniq_bits=uniq_bits,
        full_mask=full_mask, stage_out=stage_out,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "pattern_name", "ag_wildcard", "search_bits", "verify_slab",
        "cand_slab", "seeds", "wl_factor", "exact_b", "uniq_bits",
        "full_mask",
    ),
)
def map_strand_device(preads, lens, b, max_mm, pseq, counter, index, key_words,
                      start_index, bucket_flagged, *, pattern_name: str,
                      ag_wildcard: bool, search_bits: int,
                      verify_slab: int = VERIFY_SLAB,
                      cand_slab: int = CAND_SLAB, seeds: tuple | None = None,
                      wl_factor: int = WL_FACTOR, exact_b: bool = False,
                      uniq_words=None, uniq_off=None, uniq_counter=None,
                      uniq_bits: int = 0, full_mask: bool = False):
    """Single-chip jitted entry over the full (unsharded) table."""
    return map_strand_core(
        preads, lens, b, max_mm, pseq, counter, index, key_words,
        start_index, bucket_flagged, pattern_name=pattern_name,
        ag_wildcard=ag_wildcard, search_bits=search_bits,
        verify_slab=verify_slab, cand_slab=cand_slab, seeds=seeds,
        wl_factor=wl_factor, exact_b=exact_b, uniq_words=uniq_words,
        uniq_off=uniq_off, uniq_counter=uniq_counter, uniq_bits=uniq_bits,
        full_mask=full_mask,
    )
