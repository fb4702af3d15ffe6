"""JAX mapping backend.

Wraps the jitted device pipeline (walt_tpu.ops.pipeline / se_fold):
prepares device-resident tables (packed genome words + packed lookup keys),
packs read batches to 2-bit words on host, tiles them into fixed-shape
chunks (one compile per (chunk, W) shape, reused across batches), dispatches
all chunks asynchronously and fetches results afterwards so compute and
host-device transfers overlap.

For single-end mapping the entire per-read BestMatch fold happens on device
(ops/se_fold) and only (B,)-shaped results come back.  Reads whose
candidates do not fit the fixed device shapes (or touch flagged buckets)
are flagged for the exact host path -- output is identical either way.
"""

from __future__ import annotations

import os

import numpy as np

import jax.numpy as jnp

from walt_tpu.constants import SeedPattern
from walt_tpu.core import refmap
from walt_tpu.genome import Genome
from walt_tpu.hbm_plan import HBM_RESERVE
from walt_tpu.index.build import HashTable
from walt_tpu.ops import packing, pipeline, se_fold
from walt_tpu.ops.device_index import build_device_table


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


#: H2D transfer piece for multi-GB arrays (see _upload_pieces)
UPLOAD_PIECE = 128 << 20


def _upload_pieces(arr: np.ndarray, label: str,
                   piece_bytes: int = UPLOAD_PIECE):
    """Upload a large 1-D host array in pieces, with progress notes.

    Each piece is synced before the next, so the perf.note per piece
    reports the live MB/s of the transfer.  The device buffer is assembled
    with donated dynamic_update_slice calls; the final short piece
    re-writes an overlapping full-size window (same bytes) so one compiled
    shape covers every piece.
    """
    import functools
    import time

    import jax

    from walt_tpu import perf

    if arr.ndim != 1 or arr.nbytes <= piece_bytes:
        return jnp.asarray(arr)
    n = arr.shape[0]
    step = piece_bytes // arr.itemsize

    @functools.partial(jax.jit, donate_argnums=(0,))
    def upd(out, piece, at):
        return jax.lax.dynamic_update_slice(out, piece, (at,))

    out = jnp.zeros((n,), dtype=arr.dtype)
    done = 0
    t0 = time.perf_counter()
    for a in range(0, n, step):
        if a + step > n:
            a = n - step  # overlap: rewrites identical bytes
        piece = jnp.asarray(np.ascontiguousarray(arr[a : a + step]))
        out = upd(out, piece, jnp.int32(a))
        np.asarray(piece[-1:])  # sync, so the note reflects completion
        done = min(done + step, n)
        dt_s = max(time.perf_counter() - t0, 1e-9)
        perf.note(
            f"{label}: {done * arr.itemsize >> 20}/{arr.nbytes >> 20} MB "
            f"({done * arr.itemsize / dt_s / 2**20:.0f} MB/s)"
        )
    return out


#: compile-cache directory used when JAX_COMPILATION_CACHE_DIR is unset
#: (inside the checkout, gitignored)
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    "bench_cache", "jaxcache",
)


def enable_compile_cache():
    """Persistent on-disk XLA compile cache.

    JAX itself honours ``JAX_COMPILATION_CACHE_DIR``; when it is set this
    sets nothing.  Otherwise the cache lives at :data:`COMPILE_CACHE_DIR`.
    Call before the first compile: JAX decides once per process whether
    the cache is in use.
    """
    import jax

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


from walt_tpu.core.errors import HbmBudgetError  # noqa: E402  (re-export)


class JaxBackend:
    name = "jax"

    def __init__(self, chunk: int = 131072, small_chunk: int = 2048,
                 len_pad: int = 16,
                 verify_slab: int = pipeline.VERIFY_SLAB,
                 cand_slab: int = pipeline.CAND_SLAB,
                 verify_slab_t1: int = pipeline.VERIFY_SLAB_T1,
                 mesh=None, tp: int | None = None, tp_accel: str = "uniq"):
        """``mesh``: a ('dp','tp') jax Mesh, the string 'auto' (all visible
        devices, ``tp``-way table sharding), or None (single default device).
        With a mesh, every batch runs through the sharded multi-chip
        pipeline (walt_tpu.parallel.sharded) -- the production replacement
        for the reference's OpenMP read fan-out (mapping.cpp:477-499).

        ``tp_accel``: per-shard refinement structure for tp-sharded tables,
        'uniq' (word-0 run index; default) or 'key16' (16-bit prefix keys,
        the hg19-class HBM rung -- see walt_tpu.hbm_plan.plan_tables)."""
        chunk = int(os.environ.get("WALTX_CHUNK", chunk))
        self.chunk = chunk
        self.small_chunk = small_chunk
        self.len_pad = len_pad
        self.verify_slab = verify_slab
        self.cand_slab = cand_slab
        self.verify_slab_t1 = verify_slab_t1
        if mesh == "auto":
            import jax

            from walt_tpu.parallel import make_mesh

            devs = jax.devices()
            mesh = make_mesh(devs, tp=tp or 1) if len(devs) > 1 else None
        self.mesh = mesh
        self.tp_accel = tp_accel
        self._dp = int(mesh.shape["dp"]) if mesh is not None else 1
        self._tp = int(mesh.shape["tp"]) if mesh is not None else 1
        self._tables = {}
        #: table keys whose build already failed the HBM budget; the
        #: failure is deterministic, so later batches short-circuit instead
        #: of repeating upload/build work before re-raising.  Values pin the
        #: (genome, table) objects so the id()-based key cannot be reused.
        self._failed_tables = {}
        #: how many tables the current run will keep resident (2 SE, 4 PE);
        #: the HBM budget ladder splits the free budget evenly across the
        #: tables not yet built so early tables cannot starve later ones
        #: (drivers set this; 0 = give each table everything that is free)
        self.table_budget_hint = 0
        self.fallback_reads = 0
        self.total_reads = 0
        #: batches a driver mapped on the exact host path because the
        #: device ran out of memory (runtime OOM or HbmBudgetError)
        self.device_oom_batches = 0
        self.reset_adaptive()
        enable_compile_cache()

    def reset_adaptive(self):
        """Reset the per-workload throughput heuristics.

        The CLI calls this between input files so file N's phase schedule /
        worklist sizing never depends on file N-1's error profile (the
        mapped BYTES are identical either way; only device-time allocation
        adapts).
        """
        # measured fraction of reads whose best hit resolves at seed 0 with 0
        # mismatches (the reference's early exit, mapping.cpp:248-263); decides
        # whether a dedicated seed-0 phase pays for itself on this workload
        self._seed0_rate = None
        # tier-1 worklist slots per read: every worklist-sized op (window
        # gather, read-row gather, compaction scatter) scales with it, and
        # typical occupancy is <1 row/read, so start tight and escalate for
        # workloads that actually spill (spilled reads stay correct -- they
        # ride the tier/host fallback -- it is purely a throughput knob).
        # Survivors average ~1.2/read, so 1.5 slots rarely spill.
        self._wl1 = float(os.environ.get("WALTX_WL1", "1.5"))
        # PE mate-program shapes: candidate density is higher than SE's
        # (no 0/1-mm early exit, all candidates <= -m collected for the
        # top-k heaps), so the PE worklist and verify slab get their own
        # knobs (tools/pe_tune.py sweeps them).  Slab 16 / wl 3 / flat 12
        # sends about a third as many pairs to the host as the SE-shaped
        # 8 / 2 / 8 on the repeat-structured 256 Mbp genome.
        self.pe_verify_slab = int(os.environ.get("WALTX_PE_SLAB", "16"))
        self.pe_wl = float(os.environ.get("WALTX_PE_WL", "3"))
        self.pe_flat_factor = int(os.environ.get("WALTX_PE_FLAT", "12"))

    def _device_table(self, genome: Genome, table: HashTable,
                      pattern: SeedPattern, n_key_words: int = 1,
                      wide_kw: bool = False):
        """``n_key_words``: packed lookup key words the run needs on device.
        1 suffices for every run whose -b is at least the largest verify
        slab (the exact_b path is then never taken); callers with a smaller
        -b ask for 3 and an existing 1-word table is rebuilt.

        ``wide_kw``: prefer the wider u32 word-0 rung over key16 when uniq
        does not fit.  The PE paths set it: PE collects every candidate
        <= -m (no 0/1-mm early exit), so key16's coarser run groups
        overflow the PE tier-1 slab far more often (on the 256 Mbp
        repeat-structured genome about 3x the host-fallback share of
        word0), while SE orders key16 first (see
        :meth:`_build_single_device_table`)."""
        # The cache entry holds strong references to (genome, table): the
        # id()-based key is only unambiguous while those objects are alive
        # (CPython reuses addresses after GC, so a dropped-and-reloaded
        # genome could otherwise silently hit a stale entry).
        key = (id(genome), id(table), pattern.name)
        got = self._tables.get(key)
        if got is not None:
            kw_arr = got[1]["key_words"]
            # stored word depth: (n, k) u32 stores k words; a 1-D u16
            # prefix table (build_key16_device) counts as one word for the
            # fast path but never satisfies the 3-word exact_b request
            stored = kw_arr.shape[-1] if kw_arr.ndim == 2 else 1
            if stored < n_key_words:
                del self._tables[key]  # rebuild with the deeper key words
        if key not in self._tables:
            if key in self._failed_tables:
                raise HbmBudgetError(
                    "table build already failed the HBM budget this run"
                )
            if self.mesh is not None:
                from walt_tpu.parallel import shard_and_place

                # exact_b runs (-b below the verify slabs) need all 3 key
                # words and therefore the uniq accel; default runs build
                # word 0 only (a third of the host bytes -- ~12 GB saved
                # per hg19-scale table) and take the configured accel
                need_full = n_key_words >= 3
                dt = build_device_table(
                    genome, table, pattern,
                    with_key_words=(True if need_full else "word0"),
                )
                # streamed shard+place: one shard row materialized at a
                # time (hg19-scale tables OOM the host otherwise)
                dev, uniq_bits = shard_and_place(
                    dt, self.mesh,
                    accel=("uniq" if need_full else self.tp_accel),
                )
                dt.uniq_bits = uniq_bits
                dt.key_words = None  # free the host copy (3x index bytes)
            else:
                try:
                    dt, dev = self._build_single_device_table(
                        genome, table, pattern, n_key_words, wide_kw=wide_kw
                    )
                except HbmBudgetError:
                    self._failed_tables[key] = (genome, table)
                    raise
            self._tables[key] = (dt, dev, genome, table)
        return self._tables[key][:2]

    def free_tables(self):
        """Drop every cached device table (and its HBM) explicitly."""
        self._tables.clear()
        self._failed_tables.clear()

    # ---- HBM budgeting -------------------------------------------------
    #: bytes kept free for the mapping working set on top of the resident
    #: tables (walt_tpu.hbm_plan owns the number)
    HBM_RESERVE = HBM_RESERVE

    def _hbm_budget(self) -> int | None:
        """Device memory budget in bytes, or None when unconstrained.

        ``WALTX_HBM_GB`` overrides; a CPU device has no budget; an
        accelerator's budget is the ``bytes_limit`` its allocator reports,
        and one that reports none is an error rather than a guessed size.
        """
        import jax

        env = os.environ.get("WALTX_HBM_GB")
        if env:
            return int(float(env) * (1 << 30))
        dev = jax.devices()[0]
        if dev.platform == "cpu":
            return None
        limit = (dev.memory_stats() or {}).get("bytes_limit")
        if not limit:
            raise RuntimeError(
                f"{dev.platform} device {dev.device_kind!r} reports no "
                f"memory bytes_limit; set WALTX_HBM_GB to give the budget"
            )
        return int(limit)

    def table_report(self) -> list:
        """Per cached single-device table: its strand, the rung it took
        (uniq / key16 / word0 / 3-word), the bytes uploaded from the host
        and the bytes it holds on the device."""
        out = []
        for dt, dev, genome, _ in self._tables.values():
            kw = dev["key_words"]
            rung = ("uniq" if dt.uniq_bits else
                    "key16" if kw.dtype == jnp.uint16 else
                    "word0" if kw.shape[-1] == 1 else "3-word")
            nbytes = {k: int(np.prod(v.shape)) * v.dtype.itemsize
                      for k, v in dev.items()}
            out.append(dict(
                strand=genome.strand, rung=rung,
                upload_bytes=sum(nbytes.get(k, 0) for k in (
                    "pseq", "counter", "index", "start_index",
                    "bucket_flagged")),
                device_bytes=sum(nbytes.values()),
            ))
        return out

    def _resident_bytes(self) -> int:
        """Bytes of device HBM held by the cached tables."""
        total = 0
        for entry in self._tables.values():
            for v in entry[1].values():
                total += int(np.prod(v.shape)) * v.dtype.itemsize
        return total

    def _build_single_device_table(self, genome: Genome, table: HashTable,
                                   pattern: SeedPattern, n_key_words: int,
                                   wide_kw: bool = False):
        """Upload one table within the HBM budget, degrading gracefully.

        Ladder (round-2 verdict next #1/#3): full table + uniq run index ->
        full table + word-0 key words (no uniq; the entry-space search and
        slab admission still run fully on device) -> HbmBudgetError (the
        driver maps on the exact host path instead of crashing).
        """
        from walt_tpu import perf
        from walt_tpu.ops.device_index import (
            build_key_words_device, build_uniq_device,
        )

        # int32 entry-index invariant (ops/pipeline worklist): a single
        # device-local CSR must stay below 2^31 entries; larger genomes
        # (hg19 ~3.1 Gbp) must run tp-sharded (see walt_tpu.hbm_plan)
        pipeline.check_entry_limit(
            int(table.index.shape[0]), "single-device table"
        )
        budget = self._hbm_budget()
        free = (None if budget is None
                else budget - self.HBM_RESERVE - self._resident_bytes())
        if free is not None and self.table_budget_hint:
            remaining = max(1, self.table_budget_hint - len(self._tables))
            free = free // remaining
        # the base footprint is computable from the raw table -- check it
        # BEFORE the host prep so a deterministic over-budget failure costs
        # nothing and every subsequent batch short-circuits instantly
        nb1 = int(table.counter.shape[0])
        base = (len(genome.seq) // 4 + 268 + 4 * nb1 + table.index.nbytes
                + genome.start_index.nbytes + (nb1 - 1))
        if free is not None and base > free:
            raise HbmBudgetError(
                f"table needs {base / 2**30:.2f} GB but only "
                f"{max(free, 0) / 2**30:.2f} GB of the "
                f"{budget / 2**30:.0f} GB HBM budget is free "
                f"(set WALTX_HBM_GB to override)"
            )
        with perf.stage("table_host_prep"):
            perf.note(f"table {genome.strand}: host prep "
                      f"({table.index.nbytes / 2**30:.2f} GB index)")
            dt = build_device_table(genome, table, pattern)
        base = (dt.pseq.nbytes + dt.counter.nbytes + dt.index.nbytes
                + dt.start_index.nbytes + dt.bucket_flagged.nbytes)
        with perf.stage("table_upload"):
            perf.note(f"table {genome.strand}: uploading "
                      f"{base / 2**30:.2f} GB to device")
            dev = dict(
                pseq=jnp.asarray(dt.pseq),
                counter=jnp.asarray(dt.counter),
                index=_upload_pieces(dt.index, f"table {genome.strand} index"),
                start_index=jnp.asarray(dt.start_index),
                bucket_flagged=jnp.asarray(dt.bucket_flagged),
            )
        n = int(dt.index.shape[0])
        # word-0 run dedup, computed from the resident arrays: the fast
        # path searches runs (uniq_bits <= max_bucket_bits probes) and
        # needs no per-slot membership gathers at all.  Its exact size is
        # known only after the count pass, so give it the remaining budget
        # and fall back to plain word-0 key words when it does not fit.
        uniq_max = None if free is None else free - base - dt.counter.nbytes
        uniq = None
        # skip the count pass outright when even an optimistic run count
        # (U = 0.875n; measured U/n is ~0.93 on repeat-heavy genomes) cannot
        # fit -- the count pass is a full pass over the index.
        # WALTX_KEY_RUNG (uniq|word0|key16) pins the ladder to one rung for
        # throughput A/B runs.
        rung = os.environ.get("WALTX_KEY_RUNG", "")
        skip_uniq = (uniq_max is not None and 7 * n > uniq_max) \
            or rung in ("word0", "key16")
        if skip_uniq:
            perf.note(f"table {genome.strand}: uniq "
                      + (f"pinned off (WALTX_KEY_RUNG={rung})" if rung else
                         f"cannot fit {uniq_max / 2**30:.2f} GB")
                      + ", using a key-word rung")
        try:
            if not skip_uniq:
                with perf.stage("table_uniq_build"):
                    perf.note(f"table {genome.strand}: uniq run index build")
                    uniq = build_uniq_device(
                        dev["pseq"], dev["index"], dev["counter"], pattern,
                        counter_np=dt.counter, max_bytes=uniq_max,
                    )
        except Exception as e:  # RESOURCE_EXHAUSTED etc.: degrade
            from walt_tpu.core.errors import is_oom_error

            if not is_oom_error(e):
                raise
            perf.note(f"table {genome.strand}: uniq build OOM, degrading")
        uniq_bytes = 0
        if uniq is not None:
            (dev["uniq_words"], dev["uniq_off"], dev["uniq_counter"],
             dt.uniq_bits) = uniq
            uniq_bytes = sum(
                int(np.prod(a.shape)) * a.dtype.itemsize for a in uniq[:3]
            )
        else:
            dt.uniq_bits = 0
            dev["uniq_words"] = jnp.zeros((1,), dtype=jnp.uint32)
            dev["uniq_off"] = jnp.zeros((2,), dtype=jnp.uint32)
            dev["uniq_counter"] = jnp.zeros((2,), dtype=jnp.uint32)
        need_kw = max(n_key_words, 0 if dt.uniq_bits else 1)
        if need_kw >= 3 or (need_kw and not dt.uniq_bits):
            # packed lookup keys from the uploaded genome: saves the
            # 48-gather host pass and a 12-bytes/entry transfer.  The
            # exact_b path (b below the verify slabs) needs all 3 u32
            # words.  A uniq-less fast-path table stores ONE word:
            #  - full u32 word 0 (4 bytes/entry): refines to the exact
            #    word-0 run -- a 28-cared-base effective seed; ~0%
            #    host-fallback on se_xl_768M;
            #  - 16-bit prefix (2 bytes/entry, build_key16_device): 8
            #    cared bases beyond the hash key; the coarser run group
            #    overflows the verify slab far more often (se_xl_768M:
            #    39.5% host-fallback).
            # Rung ORDER: with the native host replay present, SE tries
            # key16 first -- the replay of its larger overflow runs
            # concurrently with the next batch's device time, and key16
            # keeps half the key bytes of word0.  This order is a
            # hypothesis until an end-to-end A/B on the GPU decides it
            # (ROADMAP A3).  Without the native library the replay is slow
            # Python, so the wider word (less fallback) goes first.
            from walt_tpu import native as _native

            k16_first = _native.get_lib() is not None and not wide_kw
            kw_modes = ([(need_kw, 4 * need_kw * n, "3-word")]
                        if need_kw >= 3 else
                        [(0, 2 * n, "key16"), (1, 4 * n, "u32 word0")]
                        if k16_first else
                        [(1, 4 * n, "u32 word0"), (0, 2 * n, "key16")])
            if need_kw < 3 and rung == "word0":
                kw_modes = [m for m in kw_modes if m[0] == 1]
            elif need_kw < 3 and rung == "key16":
                kw_modes = [m for m in kw_modes if m[0] == 0]
            chosen = None
            for mode, kw_bytes, label in kw_modes:
                if free is None or base + uniq_bytes + kw_bytes <= free:
                    chosen = (mode, kw_bytes, label)
                    break
            if chosen is None:
                raise HbmBudgetError(
                    f"key words need {kw_modes[-1][1] / 2**30:.2f} GB on top "
                    f"of {(base + uniq_bytes) / 2**30:.2f} GB of tables; "
                    f"budget is {budget / 2**30:.0f} GB "
                    f"(set WALTX_HBM_GB to override)"
                )
            mode, kw_bytes, label = chosen
            from walt_tpu.core.errors import is_oom_error
            from walt_tpu.ops.device_index import build_key16_device

            def build_kw(m):
                if m >= 1:
                    return build_key_words_device(
                        dev["pseq"], dt.index, pattern, n_key_words=m,
                    )
                return build_key16_device(dev["pseq"], dt.index, pattern)

            with perf.stage("table_key_words"):
                perf.note(f"table {genome.strand}: building {label} "
                          f"key table ({kw_bytes / 2**30:.2f} GB)")
                try:
                    dev["key_words"] = build_kw(mode)
                except Exception as e:
                    # the static budget passed but the REAL allocator did
                    # not (fragmentation, runtime reserve): degrade to the
                    # next rung once instead of retrying -- and thrashing
                    # re-uploads -- every batch
                    if not is_oom_error(e) or mode < 1:
                        raise
                    perf.note(f"table {genome.strand}: {label} build hit "
                              f"device OOM, degrading to key16")
                    # release the failed attempt's buffers BEFORE retrying:
                    # the word0 OOM leaves multi-GB donated temporaries
                    # whose refs die with the unwound trace -- without a
                    # collect + device sync the key16 retry can race them
                    # and OOM too, demoting the whole run to the host path
                    import gc as _gc

                    _gc.collect()
                    try:
                        np.asarray(dev["counter"][:1])  # device fence
                    except Exception:
                        pass
                    try:
                        dev["key_words"] = build_kw(0)
                    except Exception as e2:
                        if not is_oom_error(e2):
                            raise
                        raise HbmBudgetError(
                            "key-word build exhausted device memory on "
                            "every rung; mapping on the exact host path"
                        ) from e2
        else:
            dev["key_words"] = jnp.zeros((1, 1), dtype=jnp.uint32)
        perf.note(f"table {genome.strand}: ready (uniq_bits={dt.uniq_bits})")
        return dt, dev

    @staticmethod
    def _full_mask(lens_: np.ndarray, pattern: SeedPattern) -> bool:
        """True when every mappable read in the slice compares a full first
        packed key word (seed_len >= key_weight + 16) -- the uniq path then
        needs no upper-bound probe chain (ops/pipeline full_mask)."""
        ok = lens_ >= pattern.min_read_len
        if not ok.any():
            return True
        sl = np.asarray(pattern.seed_len_for_len(lens_[ok]))
        return bool(sl.min() >= pattern.key_weight + 16)

    def _needed_key_words(self, b: int) -> int:
        """1 word when no tier can take the exact_b path, else all 3."""
        return 1 if b >= max(512, self.verify_slab, self.verify_slab_t1) else 3

    def _chunks(self, codes: np.ndarray, lens: np.ndarray,
                pattern: SeedPattern, chunk: int | None = None):
        """Pack reads and lazily yield fixed-shape (preads, lens) chunks.

        A short ladder of chunk shapes (small_chunk, intermediate steps,
        chunk) keeps the compile set tiny while neither revisit phases on a
        few hundred reads nor batch tails pay a full-size chunk of (heavily
        per-op-overhead-bound) device time; tiers with a large verify slab
        pass an explicit small ``chunk``.

        This is a GENERATOR on purpose: eagerly uploading every chunk
        before the first dispatch would put all of the batch's H2D ahead
        of all compute.  Yielding lazily lets the caller dispatch chunk i
        before chunk i+1 is uploaded -- the upload then rides under the
        device time.
        """
        n = codes.shape[0]
        Lmax = _round_up(max(int(codes.shape[1]), pattern.min_read_len),
                         self.len_pad)
        W = Lmax // 16
        packed = packing.pack_codes_np(
            np.pad(codes, ((0, 0), (0, Lmax - codes.shape[1])))
        )
        ladder = [self.small_chunk]
        while ladder[-1] * 4 < self.chunk:
            ladder.append(ladder[-1] * 4)
        if self.chunk // 2 > ladder[-1]:
            # keep the top gap at 2x: a tail (or batch) just over half the
            # full chunk must not pay a 2x-padded full-size program
            ladder.append(self.chunk // 2)
        ladder.append(self.chunk)
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            import jax

            # chunk shapes must tile the dp axis
            ladder = [_round_up(c, self._dp) for c in ladder]
            shard_r = NamedSharding(self.mesh, P("dp", None))
            shard_l = NamedSharding(self.mesh, P("dp"))
            put = jax.device_put
        a = 0
        while a < n:
            if chunk is not None:
                c = _round_up(chunk, self._dp)
            else:
                c = next((s for s in ladder if n - a <= s), ladder[-1])
            z = min(a + c, n)
            pc = np.zeros((c, W), dtype=np.uint32)
            pc[: z - a] = packed[a:z]
            pl = np.zeros(c, dtype=np.int32)
            pl[: z - a] = lens[a:z]
            if self.mesh is not None:
                yield a, z, put(pc, shard_r), put(pl, shard_l)
            else:
                yield a, z, jnp.asarray(pc), jnp.asarray(pl)
            a = z

    def map_single_end(self, codes: np.ndarray, lens: np.ndarray, tables,
                       b: int, max_mismatches: int, pattern: SeedPattern,
                       ag_wildcard: bool = False):
        """Full SE step on device for both strand tables ('+' then '-').

        ``tables``: [(genome, hash_table), (genome, hash_table)].
        Returns (pos (n,) uint32, times (n,) int32, minus (n,) bool,
        mismatch (n,) int32, fallback (n,) bool).
        """
        n = codes.shape[0]
        devs, bits, ubits = [], [], []
        nkw = self._needed_key_words(b)
        for g, ht in tables:
            dt, dev = self._device_table(g, ht, pattern, nkw)
            devs.append(dev)
            bits.append(dt.max_bucket_bits)
            ubits.append(dt.uniq_bits)

        def run(codes_, lens_, seeds, slab, cand_slab=None, chunk=None,
                wl_factor=pipeline.WL_FACTOR):
            m = codes_.shape[0]
            results = []
            for a, z, pc, pl in self._chunks(codes_, lens_, pattern, chunk):
                fm = self._full_mask(lens_[a:z], pattern)
                if self.mesh is not None:
                    from walt_tpu.parallel import map_single_end_sharded

                    r = map_single_end_sharded(
                        pc, pl, jnp.int32(b), jnp.int32(max_mismatches),
                        tuple(devs), mesh=self.mesh,
                        pattern_name=pattern.name, ag_wildcard=ag_wildcard,
                        search_bits=tuple(bits), verify_slab=slab,
                        cand_slab=cand_slab or self.cand_slab, seeds=seeds,
                        wl_factor=wl_factor, exact_b=b < slab,
                        uniq_bits=tuple(ubits), full_mask=fm,
                    )
                else:
                    r = se_fold.map_single_end_device(
                        pc, pl, jnp.int32(b), jnp.int32(max_mismatches),
                        tuple(devs), pattern_name=pattern.name,
                        ag_wildcard=ag_wildcard, search_bits=tuple(bits),
                        verify_slab=slab,
                        cand_slab=cand_slab or self.cand_slab,
                        seeds=seeds, wl_factor=wl_factor, exact_b=b < slab,
                        uniq_bits=tuple(ubits), full_mask=fm,
                    )
                results.append((a, z, r))
            out = [np.empty(m, t) for t in
                   (np.uint32, np.int32, bool, np.int32, bool)]
            for _, _, r in results:
                # starting all copies first overlaps their latencies
                r.copy_to_host_async()
            for a, z, r in results:
                vals = se_fold.unpack_se_result(np.asarray(r)[: z - a])
                for o, x in zip(out, vals):
                    o[a:z] = x
            return out

        def merge(into, idx, vals):
            for o, v in zip(into, vals):
                o[idx] = v

        # Phase A: seed 0 only, both strands.  A read whose best hit has 0
        # mismatches is FINAL here: the early-exit gate (mapping.cpp:248-263)
        # skips seeds 1..2 on both strand passes, so the reference's fold
        # state equals phase A's fold state exactly.  Whether it pays depends
        # on the error profile of the workload (for the reference's datasets
        # ~80% of mapped reads resolve at seed 0, Table S13; for high-error
        # input it is pure overhead), so the observed resolve rate decides.
        if self._seed0_rate is None or self._seed0_rate >= 0.5:
            out = run(codes, lens, (0,), self.verify_slab_t1,
                      wl_factor=self._wl1)
            pos, times, minus, mm, fb = out
            resolved = (mm == 0) & ~fb
            rate = float(resolved.mean()) if n else 1.0
            self._seed0_rate = rate if self._seed0_rate is None else (
                0.5 * self._seed0_rate + 0.5 * rate
            )
            # Phase B: full seed schedule for unresolved reads.
            todo = np.flatnonzero(~resolved)
            if todo.size:
                merge(out, todo,
                      run(codes[todo], lens[todo], None, self.verify_slab_t1,
                          wl_factor=self._wl1))
        else:
            out = run(codes, lens, None, self.verify_slab_t1,
                      wl_factor=self._wl1)
            pos, times, minus, mm, fb = out
        if self._wl1 < pipeline.WL_FACTOR and n and fb.mean() > 0.05:
            # dense-candidate workload: widen future batches' worklists
            self._wl1 = pipeline.WL_FACTOR
        # Tier 2: larger verify slab for reads whose refined run (or
        # worklist share) overflowed tier 1.  When the NATIVE exact
        # enumerator is available, EVERY overflow read on a single device
        # goes straight to the host replay: the driver replays host
        # fallbacks concurrently with the next batch's device time
        # (core/single_end.py pipeline), while each tier chunk adds a
        # dispatch plus a padded worklist program ON the critical path.
        # Whether that holds on the GPU is open (ROADMAP A2).  The tiers
        # below only run on a mesh or when there is no native library (the
        # pure-Python replay really is slower than device re-runs).
        from walt_tpu import native as _native

        have_native = _native.get_lib() is not None
        if have_native and self.mesh is None:
            self.total_reads += n
            self.fallback_reads += int(fb.sum())
            return pos, times, minus, mm, fb
        # On a MESH the device tiers run even with the native library: a tp
        # mesh on the key16 rung (the hg19 deployment) overflows the tier-1
        # slab on the majority of reads (60% host fallback at tp=4 on a
        # 3.1 Gbp synthetic genome) -- replaying most of the workload on
        # one host would leave the cards idle.  Tier
        # re-runs keep the overflow on device; only the residue (flagged
        # buckets, runs > 512) goes to the host replay.
        todo = np.flatnonzero(fb)
        if todo.size > max(256, n // 128):
            # chunk bounded so the worklist (wl_factor x chunk rows) keeps
            # the tier-2 program's HLO temps ~100 MB: at full 131k chunks
            # the 25M-row window machinery compiled to a 12 GB temp (XLA
            # pads degenerate-dim iotas 16x) and OOMed at compile time
            merge(out, todo,
                  run(codes[todo], lens[todo], None, self.verify_slab,
                      chunk=8192, wl_factor=3 * self.verify_slab))
            # Tier 3: highly repetitive reads (runs up to 512, e.g.
            # transposon prefixes); small chunks keep the padded work
            # bounded.
            todo = np.flatnonzero(fb)
            if todo.size > max(256, n // 128):
                merge(out, todo,
                      run(codes[todo], lens[todo], None, 512, cand_slab=512,
                          chunk=256, wl_factor=3 * 512))
            # Tier 4: the deep-repeat tail (key16 run GROUPS up to 4096 --
            # an hg19-density key16 mesh still had 14.2% of reads past
            # tier 3).  Whatever still falls back (flagged
            # buckets, runs > 4096) is for the host.
            todo = np.flatnonzero(fb)
            if todo.size > max(256, n // 128):
                merge(out, todo,
                      run(codes[todo], lens[todo], None, 4096,
                          cand_slab=512, chunk=64, wl_factor=3 * 4096))
        self.total_reads += n
        self.fallback_reads += int(fb.sum())
        return pos, times, minus, mm, fb

    def map_strand_slabs(self, codes: np.ndarray, lens: np.ndarray,
                         genome: Genome, table: HashTable, ag_wildcard: bool,
                         b: int, max_mismatches: int, pattern: SeedPattern):
        """Candidate slabs for a batch against one table, slab-tiered.

        Returns (cand_seed (n,C) int8, cand_pos (n,C) uint32,
        cand_mm (n,C) int32, cand_cnt (n,) int32, fallback (n,) bool).
        """
        n = codes.shape[0]
        dt, dev = self._device_table(genome, table, pattern,
                                     self._needed_key_words(b),
                                     wide_kw=True)
        C = self.cand_slab

        def run(codes_, lens_, slab, chunk=None,
                wl_factor=pipeline.WL_FACTOR):
            m = codes_.shape[0]
            results = []
            for a, z, pc, pl in self._chunks(codes_, lens_, pattern, chunk):
                fm = self._full_mask(lens_[a:z], pattern)
                if self.mesh is not None:
                    from walt_tpu.parallel import map_strand_sharded

                    r = map_strand_sharded(
                        pc, pl, jnp.int32(b), jnp.int32(max_mismatches),
                        dev["key_base"], dev["counter"], dev["index"],
                        dev["key_words"], dev["bucket_flagged"], dev["pseq"],
                        dev["start_index"], mesh=self.mesh,
                        pattern_name=pattern.name, ag_wildcard=ag_wildcard,
                        search_bits=dt.max_bucket_bits, verify_slab=slab,
                        cand_slab=C, wl_factor=wl_factor, exact_b=b < slab,
                        uniq_counter=dev["uniq_counter"],
                        uniq_words=dev["uniq_words"],
                        uniq_off=dev["uniq_off"],
                        uniq_bits=dt.uniq_bits, full_mask=fm,
                    )
                else:
                    r = pipeline.map_strand_device(
                        pc, pl, jnp.int32(b), jnp.int32(max_mismatches),
                        pattern_name=pattern.name, ag_wildcard=ag_wildcard,
                        search_bits=dt.max_bucket_bits,
                        verify_slab=slab, cand_slab=C, wl_factor=wl_factor,
                        exact_b=b < slab, uniq_bits=dt.uniq_bits,
                        full_mask=fm, **dev,
                    )
                results.append((a, z, r))
            out = (
                np.empty((m, C), dtype=np.int8),
                np.empty((m, C), dtype=np.uint32),
                np.empty((m, C), dtype=np.int32),
                np.empty(m, dtype=np.int32),
                np.empty(m, dtype=bool),
            )
            for _, _, r in results:
                for x in r:
                    x.copy_to_host_async()
            for a, z, r in results:
                for o, x in zip(out, r):
                    o[a:z] = np.asarray(x)[: z - a]
            return out

        out = run(codes, lens, self.verify_slab_t1)
        # chunks bounded so the tier worklists (wl_factor x chunk rows)
        # keep HLO temps small -- at full-size chunks the 25M-row window
        # machinery compiled to a 12 GB padded temp and OOMed (see
        # map_single_end's tier comment)
        for slab, chunk in ((self.verify_slab, 8192), (512, 256)):
            todo = np.flatnonzero(out[4])
            if not todo.size:
                break
            vals = run(codes[todo], lens[todo], slab, chunk,
                       wl_factor=3 * slab)
            for o, v in zip(out, vals):
                o[todo] = v
        self.total_reads += n
        self.fallback_reads += int(out[4].sum())
        return out

    def _dispatch_mate(self, codes, lens, devs, bits, ubits, ag_wildcard,
                       b, max_mismatches, pattern, slab, wl_factor,
                       flat_factor, chunk=None):
        """Dispatch the fused both-strand mate program over chunks; no fetch."""
        from walt_tpu.ops import pe_map

        results = []
        for a, z, pc, pl in self._chunks(codes, lens, pattern, chunk):
            kw = dict(
                pattern_name=pattern.name, ag_wildcard=ag_wildcard,
                search_bits=tuple(bits), verify_slab=slab,
                cand_slab=self.cand_slab, wl_factor=wl_factor,
                exact_b=b < slab,
                flat_factor=flat_factor,
                uniq_bits=tuple(ubits),
                full_mask=self._full_mask(lens[a:z], pattern),
            )
            if self.mesh is not None:
                from walt_tpu.parallel import map_mate_sharded

                r = map_mate_sharded(
                    pc, pl, jnp.int32(b), jnp.int32(max_mismatches),
                    tuple(devs), mesh=self.mesh, **kw,
                )
            else:
                r = pe_map.map_mate_device(
                    pc, pl, jnp.int32(b), jnp.int32(max_mismatches),
                    tuple(devs), **kw,
                )
            results.append((a, z, r))
        for _, _, (meta, flat) in results:
            meta.copy_to_host_async()
            flat.copy_to_host_async()
        return results

    def map_mate_slabs_begin(self, codes: np.ndarray, lens: np.ndarray,
                             tables, ag_wildcard: bool, b: int,
                             max_mismatches: int, pattern: SeedPattern):
        """Dispatch one mate's fused strand programs; do not fetch.

        Returns an opaque handle for :meth:`map_mate_slabs_finish`.  Keeping
        dispatch and fetch separate lets the PE driver put BOTH mates'
        programs in flight before blocking on either one's D2H copies.
        """
        from walt_tpu.ops import pe_map

        n = codes.shape[0]
        devs, bits, ubits = [], [], []
        nkw = self._needed_key_words(b)
        for g, ht in tables:
            dt, dev = self._device_table(g, ht, pattern, nkw, wide_kw=True)
            devs.append(dev)
            bits.append(dt.max_bucket_bits)
            ubits.append(dt.uniq_bits)

        results = self._dispatch_mate(
            codes, lens, devs, bits, ubits, ag_wildcard, b, max_mismatches,
            pattern,
            self.pe_verify_slab or self.verify_slab_t1,
            self.pe_wl or self._wl1,
            self.pe_flat_factor or pe_map.FLAT_FACTOR,
        )
        return n, results

    def _decode_mate(self, results, n: int):
        """Fetch + decode flat-compacted mate results into slab streams.

        Single-device results are (meta (B,), flat (M, 2)); tp-sharded
        results (parallel.map_mate_sharded) are (meta (T, B),
        flat (T, M, 2)) -- one compacted stream per tp table shard.  A
        (read, seed) bucket lives wholly on one shard, so for T > 1 the
        shard entries are interleaved back into examination order (seed
        asc, shard order irrelevant within a seed) with one lexsort over
        the ~2-4 real candidates/read -- the host-side half of the flat
        tp exchange that replaced the 156 ms/table device slab merge.
        """
        C = self.cand_slab
        streams = [
            dict(seed=np.zeros((n, C), dtype=np.int8),
                 pos=np.zeros((n, C), dtype=np.uint32),
                 mm=np.zeros((n, C), dtype=np.int32),
                 cnt=np.zeros(n, dtype=np.int32))
            for _ in range(2)
        ]
        fallback = np.zeros(n, dtype=bool)
        cnt_acc = np.zeros((2, n), dtype=np.int64)
        pend = []  # cross-shard entries awaiting the seed-order merge
        for a, z, (meta_d, flat_d) in results:
            meta_c = np.asarray(meta_d)
            flat_c = np.asarray(flat_d)
            if meta_c.ndim == 1:
                meta_c, flat_c = meta_c[None], flat_c[None]
            T = meta_c.shape[0]
            for t in range(T):
                meta_t, flat_t = meta_c[t], flat_c[t]
                # the flat compaction is dp-local: one read-major segment
                # per dp shard (a single segment when unsharded)
                seg_reads = meta_t.shape[0] // self._dp
                seg_M = flat_t.shape[0] // self._dp
                for g in range(self._dp):
                    a0 = a + g * seg_reads
                    if a0 >= z:
                        break
                    z0 = min(a0 + seg_reads, z)
                    meta = meta_t[g * seg_reads : g * seg_reads + (z0 - a0)]
                    flat = flat_t[g * seg_M : (g + 1) * seg_M]
                    cnt0 = (meta & 0xFF).astype(np.int64)
                    cnt1 = ((meta >> 8) & 0xFF).astype(np.int64)
                    fallback[a0:z0] |= ((meta >> 16) & 1).astype(bool)
                    cnt_acc[0, a0:z0] += cnt0
                    cnt_acc[1, a0:z0] += cnt1
                    total = cnt0 + cnt1
                    m = int(total.sum())
                    if not m:
                        continue
                    ends = np.cumsum(total)
                    rid = np.repeat(np.arange(z0 - a0), total)
                    within = np.arange(m) - (ends - total)[rid]
                    w1 = flat[:m, 1]
                    strand = ((w1 >> 1) & 1).astype(np.int64)
                    col = np.where(strand == 0, within, within - cnt0[rid])
                    if T == 1:
                        for s, st in enumerate(streams):
                            sel = strand == s
                            r, c = rid[sel] + a0, col[sel]
                            st["seed"][r, c] = (
                                (w1[sel] >> 2) & 0x3F).astype(np.int8)
                            st["pos"][r, c] = flat[:m, 0][sel]
                            st["mm"][r, c] = (w1[sel] >> 8).astype(np.int32)
                    else:
                        pend.append((
                            rid + a0, strand,
                            ((w1 >> 2) & 0x3F).astype(np.int64),
                            flat[:m, 0], (w1 >> 8).astype(np.int64),
                            np.full(m, t, dtype=np.int64), col,
                        ))
        if pend:
            rid, strand, seed, pos, mm, shard, col = (
                np.concatenate([p[k] for p in pend]) for k in range(7)
            )
            # examination order: seed asc (one shard per (read, seed)),
            # then within-shard stream order; (shard, col) keeps the sort
            # stable where a masked short-read prefix could ever straddle
            order = np.lexsort((col, shard, seed, strand, rid))
            rid, strand, seed, pos, mm = (
                x[order] for x in (rid, strand, seed, pos, mm)
            )
            grp = np.empty(rid.shape[0], dtype=bool)
            grp[0] = True
            grp[1:] = (rid[1:] != rid[:-1]) | (strand[1:] != strand[:-1])
            gstart = np.maximum.accumulate(
                np.where(grp, np.arange(rid.shape[0]), 0)
            )
            newcol = np.arange(rid.shape[0]) - gstart
            ok = newcol < C  # overflow reads fall back via cnt_acc below
            r, c, s = rid[ok], newcol[ok], strand[ok]
            for sv in range(2):
                sel = s == sv
                streams[sv]["seed"][r[sel], c[sel]] = seed[ok][sel]
                streams[sv]["pos"][r[sel], c[sel]] = pos[ok][sel]
                streams[sv]["mm"][r[sel], c[sel]] = mm[ok][sel]
        for s in range(2):
            streams[s]["cnt"][:] = np.minimum(cnt_acc[s], C)
        fallback |= (cnt_acc > C).any(axis=0)
        return streams, fallback

    def map_mate_slabs_finish(self, handle):
        """Fetch + decode a :meth:`map_mate_slabs_begin` handle.

        Overflow reads go straight to the native host replay: it runs
        CONCURRENTLY with the next batch's device time in the pipelined PE
        driver (off the critical path), while a device tier re-run adds
        dispatches ON the critical path; a slab-64/slab-512 tier ladder
        here would cut the fallback rate from 22.8% to 3.4% on the 256 Mbp
        repeat-structured genome, and is worth an A/B on the GPU
        (ROADMAP A2).  (Without the native library the PE driver takes
        the map_strand path, whose slab tiers in :meth:`map_strand_slabs`
        play this role.)
        """
        n, results = handle
        streams, fallback = self._decode_mate(results, n)
        self.total_reads += n
        self.fallback_reads += int(fallback.sum())
        return streams, fallback

    def map_mate_slabs(self, codes: np.ndarray, lens: np.ndarray, tables,
                       ag_wildcard: bool, b: int, max_mismatches: int,
                       pattern: SeedPattern):
        """Both strand tables of one mate, fused (ops/pe_map) -- one
        dispatch and a flat-compacted fetch per chunk instead of two slab
        dispatches with ~9C bytes/read of D2H.

        ``tables``: [(genome, hash_table), (genome, hash_table)] '+' first.
        Returns ([dict(seed, pos, mm, cnt) per strand], fallback (n,) bool);
        slab arrays are (n, cand_slab), C-contiguous, ready for
        native.pe_finalize.  Reads flagged fallback (pipeline overflow or
        flat spill) carry no usable slab entries -- the driver routes them
        to the exact host path.
        """
        return self.map_mate_slabs_finish(
            self.map_mate_slabs_begin(
                codes, lens, tables, ag_wildcard, b, max_mismatches, pattern
            )
        )

    def map_strand(self, codes: np.ndarray, lens: np.ndarray, genome: Genome,
                   table: HashTable, ag_wildcard: bool, b: int,
                   max_mismatches: int, pattern: SeedPattern) -> list:
        """Per-read ordered candidate lists (exact; slabs + host fallback)."""
        n = codes.shape[0]
        if n == 0:
            return []
        cand_seed, cand_pos, cand_mm, cand_cnt, fallback = self.map_strand_slabs(
            codes, lens, genome, table, ag_wildcard, b, max_mismatches, pattern
        )
        out = []
        seq_padded = None
        for i in range(n):
            if fallback[i]:
                if seq_padded is None:
                    seq_padded = refmap.padded_seq(genome, pattern)
                out.append(
                    list(
                        refmap.enumerate_candidates(
                            codes[i, : int(lens[i])], genome, table,
                            ag_wildcard, b, max_mismatches, pattern,
                            seq_padded=seq_padded,
                        )
                    )
                )
            else:
                c = int(cand_cnt[i])
                out.append(
                    list(
                        zip(
                            cand_seed[i, :c].tolist(),
                            cand_pos[i, :c].tolist(),
                            cand_mm[i, :c].tolist(),
                        )
                    )
                )
        return out
