"""Per-stage device-time breakdown of the jitted mapping pipeline.

Times stage-TRUNCATED compilations of the production program (the
``stage_out`` hook in ops/pipeline.py returns a tiny checksum right after a
stage; XLA dead-code-eliminates everything downstream), so the difference
between consecutive stages is that stage's cost in the real compiled
pipeline.  Also measures dispatch+fetch round-trip latency (``rtt``) and the
full fused SE program, all with ``block_until_ready`` on resident inputs --
pure device time, no host pipeline effects.

Usage:
    python tools/device_profile.py [index_prefix] [fastq] [chunk]

Defaults to bench.py's se_large cache (bench_cache/se_large).  Writes
DEVPROF.json at the repo root and a human table to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np


def _time(fn, reps=5):
    fn()  # compile + warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    import jax
    import jax.numpy as jnp

    from walt_tpu.constants import get_pattern
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.host.fastq import FgetsLines, load_batch
    from walt_tpu.index import io_walt
    from walt_tpu.ops import packing, pipeline, se_fold

    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "bench_cache", "se_large")
    index = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        cache, "bench.dbindex")
    fastq = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        cache, "reads_1.fastq")
    chunk = int(sys.argv[3]) if len(sys.argv) > 3 else 65536

    pattern = get_pattern("3")
    genome_meta, _ = io_walt.read_head(index)
    suf = ("_CT00",) if os.environ.get("WALTX_PROF_ONE") else (
        "_CT00", "_CT01")
    tables = [io_walt.read_table_cached(index + s, genome_meta)
              for s in suf]

    backend = JaxBackend()
    backend.table_budget_hint = 2  # what the SE driver sets (2 tables)
    devs, bits, ubits = [], [], []
    for g, ht in tables:
        dt, dev = backend._device_table(g, ht, pattern, 1)
        devs.append(dev)
        bits.append(dt.max_bucket_bits)
        ubits.append(dt.uniq_bits)
    if os.environ.get("WALTX_PROF_NOUNIQ"):
        # legacy entry-space search path, for A/B against the uniq run path
        ubits = [0 for _ in ubits]

    batch = load_batch(FgetsLines(fastq), chunk, b"")
    codes, lens = batch.packed()
    Lmax = ((max(int(codes.shape[1]), pattern.min_read_len) + 15) // 16) * 16
    W = Lmax // 16
    packed = packing.pack_codes_np(
        np.pad(codes, ((0, 0), (0, Lmax - codes.shape[1]))))
    pc = jnp.asarray(packed[:chunk])
    pl = jnp.asarray(lens[:chunk])
    b = jnp.int32(5000)
    mm = jnp.int32(6)

    # production tier-1 settings (jax_backend.map_single_end phase A/B)
    fm = JaxBackend._full_mask(lens[:chunk], pattern)
    kw = dict(pattern_name="3", ag_wildcard=False,
              verify_slab=pipeline.VERIFY_SLAB_T1,
              wl_factor=float(os.environ.get("WALTX_PROF_WL", "1.5")),
              exact_b=False, full_mask=fm)
    t0dev = devs[0]
    args0 = (pc, pl, b, mm, t0dev["pseq"], t0dev["counter"], t0dev["index"],
             t0dev["key_words"], t0dev["start_index"], t0dev["bucket_flagged"])
    ukw0 = dict(
        uniq_words=t0dev["uniq_words"], uniq_off=t0dev["uniq_off"],
        uniq_counter=t0dev["uniq_counter"], uniq_bits=ubits[0],
    ) if ubits[0] else {}

    results = {}
    # dispatch + D2H fetch round trip of a trivial program
    triv = jax.jit(lambda x: x[:1, :1])
    results["rtt"] = _time(lambda: np.asarray(triv(pc)))

    stages = [] if os.environ.get("WALTX_PROF_QUICK") else [
        "keys", "search", "membership", "worklist", "verify"]
    for st in stages:
        results[st] = _time(lambda st=st: np.asarray(
            pipeline.map_strand_stage(
                *args0, search_bits=bits[0], stage_out=st, **ukw0, **kw)))
    # one full strand (compaction included)
    if stages:
        results["strand"] = _time(lambda: jax.block_until_ready(
            pipeline.map_strand_device(
                *args0, search_bits=bits[0], **ukw0, **kw)))
    # the full fused SE program (both strands + device fold), phase-B shape
    if len(devs) < 2:
        out = {
            "chunk": chunk, "W": W, "search_bits": bits, "uniq_bits": ubits,
            "full_mask": fm, "device": str(jax.devices()[0].device_kind),
            "seconds": {k: round(v, 5) for k, v in results.items()},
        }
        diffs, prev = {}, results["rtt"]
        for st in stages + ["strand"]:
            diffs[st] = round(results[st] - prev, 5)
            prev = results[st]
        out["stage_delta_s"] = diffs
        print(json.dumps(out, indent=1), file=sys.stderr)
        print(json.dumps({"strand_s": results.get("strand")}))
        return 0
    results["full_se"] = _time(lambda: np.asarray(
        se_fold.map_single_end_device(
            pc, pl, b, mm, tuple(devs), search_bits=tuple(bits),
            uniq_bits=tuple(ubits), **kw)))
    # phase A (seed 0 only), the first-pass shape
    results["full_se_seed0"] = _time(lambda: np.asarray(
        se_fold.map_single_end_device(
            pc, pl, b, mm, tuple(devs), search_bits=tuple(bits),
            uniq_bits=tuple(ubits), seeds=(0,), **kw)))

    out = {
        "chunk": chunk,
        "W": W,
        "search_bits": bits,
        "uniq_bits": ubits,
        "full_mask": fm,
        "device": str(jax.devices()[0].device_kind),
        "seconds": {k: round(v, 5) for k, v in results.items()},
    }
    # differential per-stage costs for one strand pass
    if stages:
        diffs, prev = {}, results["rtt"]
        for st in stages + ["strand"]:
            diffs[st] = round(results[st] - prev, 5)
            prev = results[st]
        out["stage_delta_s"] = diffs
    out["us_per_read_full_se"] = round(1e6 * results["full_se"] / chunk, 3)

    print(json.dumps(out, indent=1), file=sys.stderr)
    if stages:  # quick chunk-scaling runs don't clobber the full breakdown
        here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(here, "DEVPROF.json"), "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({"us_per_read_full_se": out["us_per_read_full_se"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
