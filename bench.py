"""Throughput benchmarks: end-to-end mapping on one card.

Configs (all full product path: FASTQ parse -> device seed/refine/verify ->
on-device fold / native PE finalize -> host fallback replay -> MR emission):

- se_small: 4 Mbp uniform genome, 1M x 100bp reads.  Cheapest config; runs
  FIRST so a fresh number is banked within minutes.
- se_large (HEADLINE): 512 Mbp repeat-structured genome (human chr1+chr2
  scale, SINE/LINE/microsatellite/alpha-satellite families -- see
  walt_tpu.synth.make_genome_repetitive), 2M x 100bp bisulfite reads,
  single-end.  This is the honest stand-in for the reference's hg19 runs:
  bisulfite conversion leaves 3^12 = 531k usable hash keys, so buckets
  average ~1000 entries and the refine/verify tiering faces a real
  repeat tail (supplement Table S2), including >=500k bucket erasure.
- pe_mid: 256 Mbp repetitive genome, 300k x 100bp read pairs, paired-end
  (4 resident tables).
- se_xl: 768 Mbp repetitive genome, 2M x 100bp reads.

Baselines (BASELINE.md): the reference maps 50M x ~100bp reads (hg19) SE in
0.71 h = ~19.6k reads/s, PE in 2.43 h = ~5.7k pairs/s, on one 2.4 GHz Xeon
thread.  vs_baseline is measured/against-those.

Robustness (the harness must ALWAYS leave a parseable headline on stdout):

1. A provisional headline from an existing BENCH_DETAIL.json is printed
   BEFORE any config runs, marked ``"stale": true``.  The last stdout JSON
   line is the result, so fresh numbers printed later replace it.
2. Configs run cheapest-first; the headline is the highest-PRIORITY config
   that has succeeded so far and is re-printed after every config.
3. All configs run in a worker thread; the main thread enforces a hard
   deadline at 0.92 x WALTX_BENCH_BUDGET_S (default 1650 s) and on expiry
   flushes the current headline + detail and exits rc=0.  This cannot be
   blocked by a wedged device call.
4. Per-config detail (or failure) is merged into BENCH_DETAIL.json
   IMMEDIATELY after the config, never only at exit.
5. A config that would start after the deadline is skipped and recorded
   as such.

Prepared genome/index caches live in a repo-local ``bench_cache/``
directory (gitignored; override with WALTX_BENCH_CACHE).  The XLA compile
cache follows JAX_COMPILATION_CACHE_DIR, else bench_cache/jaxcache
(walt_tpu.core.jax_backend.enable_compile_cache).
"""

from __future__ import annotations

import gc
import json
import os
import sys
import threading
import time
import traceback

os.environ.setdefault("WALTX_PROGRESS", "1")

BASE_SE = 50_000_000 / (0.71 * 3600)  # Table S6, SRR1532534 SE
BASE_PE = 50_000_000 / (2.43 * 3600)  # Table S7, SRR1532534 PE

_HERE = os.path.dirname(os.path.abspath(__file__))
CACHE_ROOT = os.environ.get(
    "WALTX_BENCH_CACHE", os.path.join(_HERE, "bench_cache")
)
DETAIL_PATH = os.path.join(_HERE, "BENCH_DETAIL.json")

T_START = time.monotonic()
BUDGET_S = float(os.environ.get("WALTX_BENCH_BUDGET_S", "1650"))
DEADLINE_S = 0.92 * BUDGET_S


CACHE = os.path.join(CACHE_ROOT, "se_small")
CACHE_LARGE = os.path.join(CACHE_ROOT, "se_large")
CACHE_PE = os.path.join(CACHE_ROOT, "pe_mid")
CACHE_XL = os.path.join(CACHE_ROOT, "se_xl")


def _note(msg: str):
    print(f"[bench +{time.monotonic() - T_START:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _prepare(cache: str, n_bases: int, n_reads: int, read_len: int,
             repetitive: bool, paired: bool, version: str):
    """Build (once, cached) genome + index + reads for one config."""
    os.makedirs(cache, exist_ok=True)
    index = os.path.join(cache, "bench.dbindex")
    fq1 = os.path.join(cache, "reads_1.fastq")
    fq2 = os.path.join(cache, "reads_2.fastq")
    stamp = os.path.join(
        cache, f"{version}_{n_bases}_{n_reads}_{read_len}.ok"
    )
    if not os.path.exists(stamp):
        from walt_tpu.index.build import build_all_tables
        from walt_tpu.index.io_walt import write_index
        from walt_tpu.synth import (
            codes_to_fastq, make_genome, make_genome_repetitive, sample_pairs,
            sample_reads, write_genome_fasta,
        )

        _note(f"prepare: generating {n_bases / 1e6:.0f} Mbp genome + "
              f"{n_reads} reads")
        t0 = time.time()
        mk = make_genome_repetitive if repetitive else make_genome
        genome = mk(n_bases, n_chroms=2, seed=42)
        fasta = os.path.join(cache, "genome.fa")
        write_genome_fasta(genome, fasta)
        if paired:
            c1, l1, c2, l2 = sample_pairs(genome, n_reads, read_len, seed=7)
            codes_to_fastq(c1, l1, fq1)
            codes_to_fastq(c2, l2, fq2)
        else:
            codes, lens, _ = sample_reads(genome, n_reads, read_len, seed=7)
            codes_to_fastq(codes, lens, fq1)
        del genome
        gen_s = time.time() - t0
        # index build proper: FASTA load -> 4 tables -> 5-file walt index
        # (what the reference's makedb wall time covers)
        _note(f"prepare: index build ({gen_s:.0f}s datagen)")
        t0 = time.time()
        g, tables = build_all_tables([fasta], verbose=False)
        write_index(index, g, tables)
        build_s = time.time() - t0
        del g, tables
        gc.collect()
        _note(f"prepare: index built in {build_s:.0f}s")
        with open(stamp, "w") as f:
            json.dump({"index_build_s": round(build_s, 1),
                       "datagen_s": round(gen_s, 1)}, f)
    meta = json.load(open(stamp))
    return index, fq1, (fq2 if paired else None), meta


def _rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS"):
                return int(line.split()[1]) / 2**20
    return 0.0


def _run_se(index, fastq, out, batch, backend):
    from walt_tpu.core.single_end import process_single_end

    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    t0 = time.perf_counter()
    stat = process_single_end(index, fastq, out, batch_size=batch,
                              max_mismatches=6, backend=backend)
    return time.perf_counter() - t0, stat


def _run_pe(index, fq1, fq2, out, batch, backend):
    from walt_tpu.core.paired_end import process_paired_end

    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    t0 = time.perf_counter()
    stat = process_paired_end(index, fq1, fq2, out, batch_size=batch,
                              max_mismatches=6, backend=backend)
    return time.perf_counter() - t0, stat


def _free_host_caches():
    """Drop host-side table caches between configs (multi-GB residents)."""
    from walt_tpu.index import io_walt

    io_walt._table_cache.clear()
    gc.collect()


def _bench_config(name, cache, n_bases, n_reads, read_len, repetitive,
                  paired, batch, repeats=3, version="v2"):
    """One config: prepare, warm up (compiles + table upload), best-of-N."""
    import numpy as np

    from walt_tpu.core.backends import get_backend

    index, fq1, fq2, meta = _prepare(
        cache, n_bases, n_reads, read_len, repetitive, paired, version
    )
    backend = get_backend("jax")
    out = os.path.join(cache, "out.mr")

    runner = (
        (lambda: _run_pe(index, fq1, fq2, out, batch, backend)) if paired
        else (lambda: _run_se(index, fq1, out, batch, backend))
    )
    _note(f"{name}: warmup (table upload + uniq build + compiles)")
    wt, _ = runner()  # warmup: compiles, device tables, heuristics
    _note(f"{name}: warmup run {wt:.1f}s; timing {repeats} repeats")
    # best of N (ROADMAP A0 replaces it with the median and quartiles)
    best = None
    for i in range(repeats):
        r = runner()
        _note(f"{name}: run {i + 1}/{repeats}: {r[0]:.2f}s "
              f"({n_reads / r[0] / 1e3:.1f}k/s)")
        if best is None or r[0] < best[0]:
            best = r
    dt, stat = best

    table_bytes = sum(
        sum(int(np.size(v)) * v.dtype.itemsize for v in entry[1].values())
        for entry in backend._tables.values()
    )
    detail = {
        "config": name,
        "value": round(n_reads / dt, 1),
        "unit": "pairs/s" if paired else "reads/s",
        "seconds": round(dt, 2),
        "n": n_reads,
        "genome_bp": n_bases,
        "read_len": read_len,
        "vs_baseline": round(n_reads / dt / (BASE_PE if paired else BASE_SE), 3),
        "fallback_pct": round(
            100 * backend.fallback_reads / max(1, backend.total_reads), 3
        ),
        "host_rss_gb": round(_rss_gb(), 2),
        "device_table_gb": round(table_bytes / 2**30, 2),
        "warmup_s": round(wt, 1),
        "index_build_s": meta.get("index_build_s"),
        "mapstats": {
            k: int(getattr(stat, k))
            for k in ("unique", "ambiguous", "unmapped")
            if hasattr(stat, k)
        } | (
            {"unique_pairs": int(stat.unique_pairs)}
            if hasattr(stat, "unique_pairs") else {}
        ),
    }
    # free device tables + host caches before the next config (HBM budget)
    backend.free_tables()
    _free_host_caches()
    return detail


# --------------------------------------------------------------------------
# configs: run order is cheapest-first (a fresh number is banked early);
# PRIORITY decides which successful config is the stdout headline
# (0 = highest).
CONFIGS = [
    dict(name="se_small_4M", cache=CACHE, n_bases=4_000_000,
         n_reads=1_000_000, read_len=100, repetitive=False, paired=False,
         batch=500_000, priority=3),
    dict(name="se_large_512M", cache=CACHE_LARGE, n_bases=512_000_000,
         n_reads=2_000_000, read_len=100, repetitive=True, paired=False,
         batch=500_000, repeats=4, priority=0),
    dict(name="pe_mid_256M", cache=CACHE_PE, n_bases=256_000_000,
         n_reads=300_000, read_len=100, repetitive=True, paired=True,
         batch=150_000, priority=1),
    dict(name="se_xl_768M", cache=CACHE_XL,
         n_bases=768_000_000, n_reads=2_000_000, read_len=100,
         repetitive=True, paired=False, batch=500_000, repeats=2,
         priority=2),
]


def _headline_json(d: dict, stale: bool = False) -> str:
    h = {
        "metric": f"{d['config']}_{d['unit'].replace('/', '_per_')}_1chip",
        "value": d["value"],
        "unit": d["unit"],
        "vs_baseline": d["vs_baseline"],
    }
    if stale:
        h["stale"] = True
    return json.dumps(h)


def _load_detail() -> list:
    try:
        with open(DETAIL_PATH) as f:
            data = json.load(f)
        return [d for d in data if isinstance(d, dict) and "config" in d]
    except Exception:
        return []


class State:
    """Shared between the worker thread and the watchdog main thread."""

    def __init__(self):
        self.lock = threading.Lock()
        self.headline = None  # (priority, json_line)
        self.details = {}  # config -> detail dict (this run)
        self.failures = []
        self.rc = None

    def bank(self, priority: int, detail: dict):
        with self.lock:
            self.details[detail["config"]] = detail
            if self.headline is None or priority < self.headline[0]:
                self.headline = (priority, _headline_json(detail))
            self.flush_detail()

    def fail(self, config: str, err: str):
        with self.lock:
            self.failures.append({"config": config, "error": err[:500]})
            self.flush_detail()

    def flush_detail(self):
        """Merge this run's details over the committed file, immediately.

        Caller holds the lock.  Partial runs update their configs in place
        instead of clobbering the other configs' numbers.
        """
        old = {d["config"]: d for d in _load_detail()}
        old.update(self.details)
        order = [c["name"] for c in CONFIGS]
        merged = sorted(
            (d for d in old.values() if d["config"] in order),
            key=lambda d: order.index(d["config"]),
        )
        if self.failures:
            merged = merged + [{"failures": list(self.failures)}]
        tmp = DETAIL_PATH + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1)
        os.replace(tmp, DETAIL_PATH)

    def print_headline(self):
        with self.lock:
            if self.headline is not None:
                print(self.headline[1], flush=True)


def _worker(state: State, only: str):
    from walt_tpu.hostmem import prefault

    prefault()
    prio = {c["name"]: c["priority"] for c in CONFIGS}
    for cfg in CONFIGS:
        cfg = dict(cfg)
        cfg.pop("priority")
        if only and only != cfg["name"]:
            continue
        elapsed = time.monotonic() - T_START
        if not only and elapsed >= DEADLINE_S:
            _note(f"budget: {elapsed:.0f}s elapsed >= {DEADLINE_S:.0f}s "
                  f"deadline; skipping {cfg['name']}")
            state.fail(cfg["name"], "skipped: budget")
            continue
        _note(f"=== config {cfg['name']} ===")
        try:
            d = _bench_config(**cfg)
            # stderr detail behind a prefix: must never parse as the metric
            _note("detail " + json.dumps(d))
            state.bank(prio[d["config"]], d)
        except Exception as e:
            _note(f"{cfg['name']} FAILED: {e!r}")
            traceback.print_exc()
            state.fail(cfg["name"], repr(e))
            _free_host_caches()
        # (re-)emit the headline after EVERY config: an external kill
        # during a later config cannot lose the round's number, and the
        # last parseable stdout line is always the headline
        state.print_headline()
    state.rc = 0 if state.details else 1


def main() -> int:
    only = os.environ.get("WALTX_BENCH_ONLY", "")
    state = State()

    # provisional headline from the committed detail file, marked stale --
    # if everything below dies the round still has a parseable number
    committed = {d["config"]: d for d in _load_detail()}
    prio = {c["name"]: c["priority"] for c in CONFIGS}
    stale = sorted(
        (d for d in committed.values() if d["config"] in prio),
        key=lambda d: prio[d["config"]],
    )
    if stale and not only:
        print(_headline_json(stale[0], stale=True), flush=True)
        _note(f"provisional (stale) headline: {stale[0]['config']}")

    worker = threading.Thread(target=_worker, args=(state, only), daemon=True)
    worker.start()
    worker.join(max(DEADLINE_S - (time.monotonic() - T_START), 1.0))
    if worker.is_alive():
        _note(f"deadline: {DEADLINE_S:.0f}s reached with a config still "
              "running; flushing headline and exiting")
        with state.lock:
            state.failures.append(
                {"config": "deadline", "error": "watchdog flush"})
            state.flush_detail()
        state.print_headline()
        if state.headline is None and stale:
            print(_headline_json(stale[0], stale=True), flush=True)
        sys.stdout.flush()
        os._exit(0)  # worker may be wedged in a device call; hard-exit
    state.print_headline()
    if state.headline is None:
        if stale:
            print(_headline_json(stale[0], stale=True), flush=True)
            return 0
        _note("no config succeeded and no stale headline")
        print(json.dumps({
            "metric": "bench_failed", "value": 0, "unit": "reads/s",
            "vs_baseline": 0,
            "error": (state.failures or [{}])[0].get("error", ""),
        }))
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
