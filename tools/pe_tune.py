"""Tune the PE mate-program shapes on one card.

PE candidate density is higher than SE's (no 0/1-mismatch early exit; every
candidate <= -m feeds the top-k heaps), so the SE-tuned tier-1 shapes spill
more.  This sweeps (verify_slab, wl_factor, flat_factor) for the fused mate
program with the tables uploaded ONCE, reporting pairs/s + fallback per
setting, and prints the winner to set as defaults.

Usage: python tools/pe_tune.py [n_pairs]   (uses the pe_mid bench cache)
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("WALTX_PROGRESS", "1")

import numpy as np  # noqa: E402


def main() -> int:
    n_pairs = int(sys.argv[1]) if len(sys.argv) > 1 else 300_000
    cache = os.path.join(REPO, "bench_cache", "pe_mid")

    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.core.paired_end import process_paired_end

    index = os.path.join(cache, "bench.dbindex")
    fq1 = os.path.join(cache, "reads_1.fastq")
    fq2 = os.path.join(cache, "reads_2.fastq")
    out = os.path.join(cache, "out_tune.mr")

    backend = JaxBackend()
    results = []
    golden = None
    # (pe_verify_slab, pe_wl, pe_flat_factor)
    settings = [
        (8, 2.0, 8),    # round-3 defaults
        (8, 1.5, 8),    # SE-tuned wl
        (16, 2.5, 10),  # wider slab: longer runs stay on device
        (16, 3.0, 12),
        (24, 3.0, 12),
    ]
    for slab, wl, flat in settings:
        backend.pe_verify_slab, backend.pe_wl, backend.pe_flat_factor = (
            slab, wl, flat
        )
        backend.fallback_reads = backend.total_reads = 0
        open(out, "w").close()
        open(out + ".mapstats", "w").close()
        t0 = time.perf_counter()
        process_paired_end(index, fq1, fq2, out, batch_size=150_000,
                           max_mismatches=6, backend=backend)
        warm = time.perf_counter() - t0
        # timed repeat (compiles + uploads now warm)
        backend.fallback_reads = backend.total_reads = 0
        open(out, "w").close()
        open(out + ".mapstats", "w").close()
        t0 = time.perf_counter()
        process_paired_end(index, fq1, fq2, out, batch_size=150_000,
                           max_mismatches=6, backend=backend)
        dt = time.perf_counter() - t0
        blob = open(out, "rb").read()
        if golden is None:
            golden = blob
        row = dict(
            slab=slab, wl=wl, flat=flat,
            pairs_per_s=round(n_pairs / dt, 1), seconds=round(dt, 2),
            warm_s=round(warm, 2),
            fallback_pct=round(
                100 * backend.fallback_reads / max(1, backend.total_reads), 2
            ),
            bytes_identical=(blob == golden),
        )
        results.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    best = max(results, key=lambda r: r["pairs_per_s"])
    print(json.dumps({"results": results, "best": best}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
