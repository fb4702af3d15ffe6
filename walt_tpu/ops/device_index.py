"""Device-resident index: packed lookup keys over the CSR hash table.

The reference refines a hash bucket by binary-searching one cared position at
a time, re-reading the genome at every probe (mapping.cpp:166-222).  On a
card every probe is a device-memory gather, so the refinement is
restructured around *precomputed packed keys*: for every index entry, the raw genome bases at
cared positions 12..59 are packed 2 bits each into three uint32 words.  The
whole refinement then becomes two masked-prefix binary searches (lower/upper
bound) of ~log2(bucket) probes each, instead of 48 x 2 searches.

Semantics note: the reference's lookup compares raw concatenated-genome
bytes, which cross chromosome boundaries, and its sort order treats
past-the-chromosome positions specially (reference.cpp:258-288), so raw
order and sort order can disagree for entries within cared[59] (=178) bases
of a chromosome end.  Buckets where the stored order is ACTUALLY
non-monotone are flagged at load time (a 2-bit mask, see
build_device_table) and routed to the exact host fallback; everywhere else
the packed-key equal-range search plus the chromosome-fit rejection is
exactly the reference's refined region.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from walt_tpu.constants import SeedPattern
from walt_tpu.genome import Genome
from walt_tpu.index.build import HashTable
from walt_tpu.ops.packing import pack_genome_np

#: positions per packed 32-bit key word (2 bits per base)
POS_PER_WORD = 16
N_KEY_WORDS = 3  # cared positions 12..59


@dataclasses.dataclass
class DeviceTable:
    """One converted-genome table, ready to be placed on device."""

    pseq: np.ndarray  # uint32 packed converted genome words (+ zero tail)
    counter: np.ndarray  # uint32 (4^12 + 1,)
    index: np.ndarray  # uint32 (n,)
    key_words: np.ndarray | None  # uint32 (n, 3) packed cared[12..59];
    # None when they are to be computed on device from pseq + index
    # (build_key_words_device) -- they are 3x the index's bytes, so host
    # construction + transfer dominates table prep at genome scale
    start_index: np.ndarray  # uint32 (n_chroms + 1,)
    bucket_flagged: np.ndarray  # uint8 bit mask (4^12,): 1=fast, 2=exact_b
    max_bucket_bits: int  # static: iterations for the binary search
    strand: str
    #: static probe count for the run-space (uniq) search; 0 = not built
    uniq_bits: int = 0

    def nbytes(self) -> int:
        return (
            self.pseq.nbytes + self.counter.nbytes + self.index.nbytes
            + self.key_words.nbytes + self.bucket_flagged.nbytes
        )


def pack_key_words(seq_padded: np.ndarray, entries: np.ndarray,
                   pattern: SeedPattern,
                   n_words: int = None) -> np.ndarray:
    """Pack raw genome bases at cared[12..59] into (n, n_words) uint32 words.

    Word w holds cared positions 12+16w .. 27+16w, first position in the two
    most significant bits, so unsigned comparison of a masked word equals
    lexicographic comparison of the bases.  ``n_words`` < 3 (e.g. word 0
    only, the input to uniq-run/key16 accel structures) skips the deeper
    gather passes -- at hg19 scale each word is 4 bytes/entry (~12 GB).
    """
    if n_words is None:
        n_words = N_KEY_WORDS
    n = entries.shape[0]
    words = np.zeros((n, n_words), dtype=np.uint32)
    kw = pattern.key_weight
    # chunked so the int64 gather temporaries stay ~4 GB no matter the
    # entry count (an unchunked hg19 table would hold two ~24 GB int64
    # scratch arrays on top of the output)
    step = 1 << 28
    for a in range(0, n, step):
        z = min(a + step, n)
        e64 = entries[a:z].astype(np.int64)
        posbuf = np.empty(z - a, dtype=np.int64)
        val = np.empty(z - a, dtype=np.uint8)
        for w in range(n_words):
            acc = np.zeros(z - a, dtype=np.uint32)
            for i in range(POS_PER_WORD):
                p = kw + w * POS_PER_WORD + i
                if p >= pattern.cared_size:
                    acc <<= np.uint32(2)
                    continue
                off = int(pattern.cared[p])
                acc <<= np.uint32(2)
                np.add(e64, off, out=posbuf)
                np.take(seq_padded, posbuf, out=val)
                # & 3: past-the-genome pad bytes only occur in flagged
                # buckets (whose keys are never used); keep them from
                # polluting the word.
                np.bitwise_and(val, 3, out=val)
                acc |= val
            words[a:z, w] = acc
    return words


def build_device_table(genome: Genome, table: HashTable,
                       pattern: SeedPattern,
                       with_key_words: bool = False) -> DeviceTable:
    """Prepare one table for the device pipeline (host-side, NumPy).

    ``with_key_words``: build the packed lookup keys on host.  The default
    leaves them to :func:`build_key_words_device` (key_words are 3x the
    index's bytes; computing them from the already-uploaded packed genome
    avoids both the 48-gather host pass and the transfer).
    """
    from walt_tpu.core.refmap import padded_seq
    from walt_tpu.index.build import seed_keys

    # Entries whose deep cared positions run past their chromosome were
    # sorted with the boundary-aware comparator (reference.cpp:258-288), so
    # the bucket's raw-byte order MAY differ from its stored order.  The
    # masked-prefix binary search is exact whenever the stored key_words
    # sequence is still lexicographically non-decreasing (any prefix of a
    # sorted sequence is sorted), so only buckets that contain a boundary
    # entry AND are actually non-monotone take the exact host path.
    #
    # Boundary entries live at genome positions within cared[-1] bases of a
    # chromosome end (a few hundred positions total), so their BUCKETS are
    # found by hashing those positions directly -- no O(n) chrom_id /
    # remain pass over the whole index (which took ~2 min/table at 512 Mbp
    # on fault-expensive hosts; round-2 warmup cost).
    last = int(pattern.cared[-1])
    starts = genome.start_index.astype(np.int64)
    seq_pad = padded_seq(genome, pattern)

    def _boundary_positions(tail_from_end: int):
        parts = []
        for c in range(genome.n_chroms):
            a, e = int(starts[c]), int(starts[c + 1])
            if e - a < pattern.min_seed_len:
                continue
            lo = max(a, e - tail_from_end)
            hi = e - pattern.min_seed_len
            if hi > lo:
                parts.append(np.arange(lo, hi, dtype=np.int64))
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.int64))

    def _buckets_of(positions: np.ndarray) -> np.ndarray:
        if positions.size == 0:
            return positions
        keys = seed_keys(seq_pad, positions, pattern)
        # keep only buckets that actually hold entries (erased/empty ones
        # have nothing to flag)
        keys = np.unique(keys)
        has = table.counter[keys + 1] > table.counter[keys]
        return keys[has]
    # Two flag tiers, packed as bits (pipeline selects by its static
    # ``exact_b`` mode):
    #  bit0 (fast path, b >= verify_slab): buckets whose STORED order is
    #    actually non-monotone under the device's packed-key model or the
    #    host oracle's LOOKUP_PAD model -- the lower-bound search is invalid
    #    there.  Global-end entries themselves need no flag on this path:
    #    any candidate whose compared cared positions cross the genome end
    #    also fails the chromosome-fit check (ok_head/ok_tail,
    #    mapping.cpp:281-286), exactly as the reference's pad byte never
    #    equals a read base, and the -b cap cannot trigger below the slab.
    #  bit1 (exact path, b < verify_slab): bit0 plus every bucket holding a
    #    global-end entry, because there the refined COUNT itself feeds the
    #    -b cap and the pad model cannot be reproduced in 2-bit words.
    flagged = np.zeros(pattern.n_buckets, dtype=np.uint8)
    chrom_tail = _boundary_positions(last)
    # global-end entries are a subset of chromosome-end entries
    # (their own chromosome's end is at most the genome end away)
    glob_tail = chrom_tail[chrom_tail >= genome.length_of_genome - last]
    flagged[_buckets_of(glob_tail)] |= 2
    if chrom_tail.size:
        # monotonicity only matters inside buckets that contain a boundary
        # entry -- a handful per chromosome end -- so key_words are built
        # just for those buckets' entries
        seq = seq_pad
        kw = pattern.key_weight
        deep = [int(pattern.cared[p])
                for p in range(kw, min(pattern.cared_size,
                                       kw + POS_PER_WORD * N_KEY_WORDS))]
        bids = _buckets_of(chrom_tail)
        for bid in bids:
            lo, hi = int(table.counter[bid]), int(table.counter[bid + 1])
            if hi - lo <= 1:
                continue
            kwds = pack_key_words(seq, table.index[lo:hi], pattern)
            a, b = kwds[:-1], kwds[1:]
            desc = (
                (a[:, 0] > b[:, 0])
                | ((a[:, 0] == b[:, 0]) & (a[:, 1] > b[:, 1]))
                | ((a[:, 0] == b[:, 0]) & (a[:, 1] == b[:, 1]) & (a[:, 2] > b[:, 2]))
            )
            if not desc.any():
                # the &3-packed model is monotone; also require the oracle's
                # raw-byte model (pad sorts above every base) to agree, so
                # the search result equals the oracle's on this bucket
                ent = table.index[lo:hi].astype(np.int64)
                raw = seq[ent[:, None] + np.asarray(deep)[None, :]]
                desc = (raw[:-1] > raw[1:]).astype(np.int8) - (
                    raw[:-1] < raw[1:]
                ).astype(np.int8)
                first = np.argmax(desc != 0, axis=1)
                desc = desc[np.arange(desc.shape[0]), first] > 0
            if desc.any():
                flagged[bid] |= 1 | 2

    sizes = np.diff(table.counter.astype(np.int64))
    max_bucket = int(sizes.max()) if sizes.size else 1
    key_words = None
    if with_key_words:
        # True: all 3 words (exact_b path).  "word0": first word only --
        # enough to derive the uniq run index or the key16 prefix table,
        # at a third of the host bytes (matters at hg19 scale).
        key_words = pack_key_words(
            seq_pad, table.index, pattern,
            n_words=(1 if with_key_words == "word0" else N_KEY_WORDS),
        )
    return DeviceTable(
        # tail must cover a full max-length window so the clip-mode slice
        # gather never shifts a near-end window's start (MAX_LINE_LENGTH
        # caps reads at 1000bp -> 63 words)
        pseq=pack_genome_np(genome.seq, tail_words=66),
        counter=table.counter,
        index=table.index,
        key_words=key_words,
        start_index=genome.start_index,
        bucket_flagged=flagged,
        max_bucket_bits=max(1, int(np.ceil(np.log2(max_bucket + 1)))),
        strand=genome.strand,
    )


def build_uniq_host(word0: np.ndarray, counter: np.ndarray):
    """Dedup word-0 runs within buckets (host NumPy; see build_uniq_device).

    ``word0``: (n,) uint32 first packed lookup key word per entry (stored
    bucket order); ``counter``: (nb + 1,) uint32 CSR offsets.  Returns
    (uniq_words (U,) u32, uniq_off (U + 1,) u32, uniq_counter (nb + 1,) u32,
    uniq_bits int).
    """
    n = int(word0.shape[0])
    breaks = np.zeros(n, dtype=bool)
    if n:
        breaks[0] = True
        breaks[1:] |= word0[1:] != word0[:-1]
        # a bucket boundary always starts a new run, even on equal words
        c = counter[(counter > 0) & (counter < n)]
        breaks[c.astype(np.int64)] = True
    starts = np.flatnonzero(breaks).astype(np.uint32)
    uniq_words = word0[starts.astype(np.int64)]
    uniq_off = np.append(starts, np.uint32(n)).astype(np.uint32)
    uniq_counter = np.searchsorted(starts, counter).astype(np.uint32)
    mx = int(np.diff(uniq_counter.astype(np.int64)).max()) if n else 0
    return (uniq_words, uniq_off, uniq_counter,
            max(1, int(np.ceil(np.log2(mx + 1)))))


def build_uniq_device(pseq_dev, index_dev, counter_dev, pattern: SeedPattern,
                      chunk: int = 1 << 25, counter_np: np.ndarray | None = None,
                      max_bytes: int | None = None):
    """Dedup word-0 runs within buckets, computed on device.

    Entries within a bucket are stored sorted by their cared positions, so
    equal word-0 lookup keys form contiguous runs.  The mapping pipeline's
    uniq path (ops/pipeline.map_strand_core) binary-searches RUNS instead of
    entries: the probe count drops from log2(max entries/bucket) to
    log2(max runs/bucket) and slab admission loses its per-slot key gathers
    entirely.  Repeat-heavy buckets (the Table S2 tail that sets the static
    search depth) collapse hardest: a tandem repeat's near-identical
    suffixes are a handful of runs.

    SINGLE pass into capacity-``n`` outputs: a count-then-fill two-pass
    design would size the outputs exactly but run the gather-bound
    ``chunk_runs`` body twice.  Run ratios U/n are 0.93-1.0 in practice,
    so exact sizing saves under 8% of the output bytes while the count
    pass costs about half the build.  The outputs are
    allocated once at 8(n+1) bytes (the budget pre-check uses that
    capacity), unwritten ``uniq_off`` slots are pre-filled with ``n`` so
    the array stays sorted for the final searchsorted, and the running
    output offset is carried ON DEVICE between chunk dispatches -- no
    host sync inside the loop.  Peak extra HBM beyond the resident
    tables: the outputs plus one chunk of temporaries plus an n/8-byte
    bucket-start bitmap.

    ``counter_np``: optional host copy of ``counter_dev``; when given, the
    bucket-start bitmap is built on host (packed bits, n/8 bytes uploaded)
    instead of holding an n-byte device bool array.

    Everything else runs from the already-resident device arrays (no host
    pass over the index, no extra upload).  Returns (uniq_words (U,)
    u32, uniq_off (U + 1,) u32, uniq_counter (nb + 1,) u32, uniq_bits int),
    all device arrays.
    """
    import functools

    import jax
    import jax.numpy as jnp

    from walt_tpu.ops import packing

    kw = pattern.key_weight
    offs = tuple(int(pattern.cared[p]) for p in
                 range(kw, min(pattern.cared_size, kw + POS_PER_WORD)))
    n_win = (max(offs) >> 4) + 2 if offs else 1
    n = int(index_dev.shape[0])
    nb1 = counter_dev.shape[0]
    if n == 0:
        z = jnp.zeros((0,), jnp.uint32)
        return z, jnp.zeros((1,), jnp.uint32), jnp.zeros((nb1,), jnp.uint32), 1
    chunk = min(chunk, n)

    # bucket-start bitmap, packed 32 starts/word (n/8 bytes instead of n)
    nbw = (n + 31) >> 5
    if counter_np is not None:
        bw = np.zeros(nbw, dtype=np.uint32)
        pos = np.unique(counter_np[counter_np < n].astype(np.int64))
        np.bitwise_or.at(bw, pos >> 5, np.uint32(1) << (pos & 31).astype(np.uint32))
        bits_full = jnp.asarray(bw)
    else:
        # counter is sorted, so duplicate offsets (empty buckets) are
        # adjacent: zero all but the first of each run, then scatter-ADD --
        # every surviving (word, bit) pair is distinct, so add == OR
        cd = jnp.where(counter_dev < n, counter_dev, 0).astype(jnp.int32)
        bit = jnp.where(counter_dev < n,
                        jnp.uint32(1) << (cd & 31).astype(jnp.uint32),
                        jnp.uint32(0))
        seg = jnp.concatenate([jnp.ones((1,), jnp.bool_), cd[1:] != cd[:-1]])
        bit = jnp.where(seg, bit, jnp.uint32(0))
        bits_full = jnp.zeros((nbw,), jnp.uint32).at[cd >> 5].add(
            bit, mode="drop"
        )

    n_chunks = -(-n // chunk)
    # output capacity: every run when unbudgeted, else what the budget
    # allows.  A table whose true run count exceeds the budgeted capacity
    # is detected at the end (total > cap) and discarded -- semantically
    # the old post-count check, without the counting pass.
    cap = n if max_bytes is None else min(
        n, (max_bytes - nbw * 4) // 8 - 1
    )
    if cap <= 0:
        return None

    def chunk_runs(pseq, index_dev, bits_full, base, carry):
        """(w0, breaks) for entries [base, base+chunk); base is traced."""
        i32 = jnp.arange(chunk, dtype=jnp.int32)
        gpos = jnp.minimum(base + i32, n - 1)
        ent = jnp.take(index_dev, gpos).astype(jnp.int32)
        bs = ((jnp.take(bits_full, gpos >> 5) >>
               (gpos & 31).astype(jnp.uint32)) & 1).astype(jnp.bool_)
        win = packing.window_cols(pseq, ent, n_win - 1)
        w0 = jnp.zeros((chunk,), dtype=jnp.uint32)
        for i in range(POS_PER_WORD):
            w0 = w0 << jnp.uint32(2)
            if i < len(offs):
                off = offs[i]
                w0 = w0 | (
                    (win[off >> 4] >> jnp.uint32(30 - 2 * (off & 15))) & 3
                )
        prev = jnp.concatenate([carry, w0[:-1]])
        breaks = (bs | (w0 != prev)) & (base + i32 < n)
        return w0, breaks

    # The pass dispatches one jitted program PER CHUNK, eagerly, instead of
    # fusing the chunks into one program (lax.fori_loop, or a static unroll
    # with optimization barriers); whether fusing pays on the GPU is open
    # (ROADMAP A2).  Dispatch overhead is bounded by using large chunks
    # (default 32M entries) and no per-chunk syncs (the output offset is
    # carried on device).
    import time as _time

    from walt_tpu import perf as _perf

    _t0 = _time.perf_counter()

    @functools.partial(jax.jit, donate_argnums=(5, 6))
    def fill_chunk(pseq, index_dev, bits_full, base, carry, uw_full, us_full,
                   off_dev):
        U = uw_full.shape[0]  # capacity n
        w0, breaks = chunk_runs(pseq, index_dev, bits_full, base, carry)
        i32 = jnp.arange(chunk, dtype=jnp.int32)
        uid = jnp.cumsum(breaks.astype(jnp.int32)) - 1
        # non-break rows drop past the end at DISTINCT slots (U + 1 + i):
        # every index in the scatter is then unique, which lets XLA lower a
        # no-collision scatter instead of the serialized general scatter a
        # shared OOB sentinel forces
        dest = jnp.where(breaks, off_dev + uid, U + 1 + i32)
        uw_full = uw_full.at[dest].set(w0, mode="drop", unique_indices=True)
        us_full = us_full.at[dest].set(
            (base + i32).astype(jnp.uint32), mode="drop", unique_indices=True
        )
        return w0[-1:], uw_full, us_full, off_dev + uid[-1] + 1

    uw_full = jnp.zeros((cap,), jnp.uint32)
    # pre-fill with n: unwritten capacity slots sort AFTER every real run
    # start, so the final searchsorted over [:-1] stays valid, and the
    # terminator value at slot U is n by construction
    us_full = jnp.full((cap + 1,), jnp.uint32(n))
    carry = jnp.zeros((1,), jnp.uint32)
    off_dev = jnp.zeros((), jnp.int32)
    for i in range(n_chunks):
        carry, uw_full, us_full, off_dev = fill_chunk(
            pseq_dev, index_dev, bits_full, jnp.int32(i * chunk), carry,
            uw_full, us_full, off_dev,
        )
    uniq_words, uniq_off = uw_full, us_full
    total = int(off_dev)  # one sync for the whole pass
    _perf.note(f"uniq fill: {_time.perf_counter() - _t0:.1f}s "
               f"({n_chunks} chunks, {total} runs, cap {cap})")
    if total > cap:
        # true run count exceeds the budgeted capacity: runs past cap were
        # dropped by the scatter -- the structure is incomplete, so the
        # caller degrades to a key-word rung (old post-count semantics)
        return None
    # uniq_off capacity slots [total:] all hold n (terminator + pad)
    uniq_counter = jnp.searchsorted(
        uniq_off[:-1], counter_dev, side="left"
    ).astype(jnp.uint32)
    mx = int(jnp.max(
        uniq_counter[1:].astype(jnp.int32) - uniq_counter[:-1].astype(jnp.int32)
    ))
    return (uniq_words, uniq_off, uniq_counter,
            max(1, int(np.ceil(np.log2(mx + 1)))))


def build_key16_device(pseq_dev, index_np: np.ndarray,
                       pattern: SeedPattern, chunk: int = 1 << 23):
    """(n,) uint16: the top 16 bits (8 cared bases) of lookup key word 0.

    The fast-path lower-bound search only needs a sorted prefix to land at
    the start of the refined run GROUP; equality of the remaining cared
    positions is enforced from the verify window (pipeline's window cared
    check), exactly as it already is for words 1-2.  Halves the dominant
    per-entry HBM cost of the word-0 ladder rung (hg19: ~12 GB across the
    SE tables).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from walt_tpu.ops import packing

    kw = pattern.key_weight
    offs = [int(pattern.cared[p]) for p in
            range(kw, min(pattern.cared_size, kw + 8))]
    n_win = (max(offs) >> 4) + 2 if offs else 1
    n = index_np.shape[0]
    if n == 0:
        return jnp.zeros((0,), dtype=jnp.uint16)

    @functools.partial(jax.jit, donate_argnums=(2,))
    def one_chunk(pseq, entries, out, base):
        win = packing.window_cols(pseq, entries, n_win - 1)
        acc = jnp.zeros(entries.shape, dtype=jnp.uint32)
        for i in range(8):
            acc = acc << jnp.uint32(2)
            if i < len(offs):
                off = offs[i]
                acc = acc | (
                    (win[off >> 4] >> jnp.uint32(30 - 2 * (off & 15))) & 3
                )
        i32 = jnp.arange(entries.shape[0], dtype=jnp.int32)
        dest = jnp.where(base + i32 < n, base + i32, n)
        return out.at[dest].set(acc.astype(jnp.uint16), mode="drop")

    out = jnp.zeros((n,), dtype=jnp.uint16)
    for a in range(0, n, chunk):
        z = min(a + chunk, n)
        # u32: genome positions may exceed int32 (4 Gbp format)
        ent = np.zeros(chunk, dtype=np.uint32)
        ent[: z - a] = index_np[a:z]
        out = one_chunk(pseq_dev, jnp.asarray(ent), out, jnp.int32(a))
    return out


def build_key_words_device(pseq_dev, index_np: np.ndarray,
                           pattern: SeedPattern, chunk: int = 1 << 22,
                           n_key_words: int = N_KEY_WORDS):
    """(n, n_key_words) uint32 packed lookup keys, computed on device.

    Gathers a (chunk, n_win)-word window per entry from the packed converted
    genome (zero tail past the genome end == the &3-masked pad of
    :func:`pack_key_words`) and extracts cared positions [kw, kw+48) with
    static shifts.  Returns a device array.

    ``n_key_words``: how many packed words to store.  The fast mapping path
    (exact_b=False, i.e. every run whose -b exceeds the verify slabs) only
    probes word 0 -- the remaining cared positions are checked from the
    verify window -- so genome-scale tables store 1 word and save 8
    bytes/entry of HBM (hg19: ~22 GB across the 4 tables).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from walt_tpu.ops import packing

    kw = pattern.key_weight
    offs = [int(pattern.cared[p]) for p in
            range(kw, min(pattern.cared_size, kw + POS_PER_WORD * n_key_words))]
    n_win = (max(offs) >> 4) + 2 if offs else 1

    n = index_np.shape[0]

    @functools.partial(jax.jit, donate_argnums=(2,))
    def one_chunk(pseq, entries, out, base):
        win = packing.window_words(pseq, entries, n_win - 1)  # (m, n_win-1)
        words = []
        for w in range(n_key_words):
            acc = jnp.zeros(entries.shape, dtype=jnp.uint32)
            for i in range(POS_PER_WORD):
                p = kw + w * POS_PER_WORD + i
                acc = acc << jnp.uint32(2)
                if p - kw < len(offs):
                    off = offs[p - kw]
                    acc = acc | (
                        (win[:, off >> 4] >> jnp.uint32(30 - 2 * (off & 15))) & 3
                    )
            words.append(acc)
        vals = jnp.stack(words, axis=1)  # (chunk, n_key_words)
        # rows past the valid range drop at n (donated in-place update)
        i32 = jnp.arange(entries.shape[0], dtype=jnp.int32)
        dest = jnp.where(base + i32 < n, base + i32, n)
        return out.at[dest].set(vals, mode="drop")

    if n == 0:
        return jnp.zeros((0, n_key_words), dtype=jnp.uint32)
    # exact-size output filled chunk-by-chunk with buffer donation: peak HBM
    # is the output plus ONE chunk of temporaries (no parts + concatenate)
    out = jnp.zeros((n, n_key_words), dtype=jnp.uint32)
    for a in range(0, n, chunk):
        z = min(a + chunk, n)
        # u32: genome positions may exceed int32 (4 Gbp format)
        ent = np.zeros(chunk, dtype=np.uint32)
        ent[: z - a] = index_np[a:z]
        out = one_chunk(pseq_dev, jnp.asarray(ent), out, jnp.int32(a))
    return out
