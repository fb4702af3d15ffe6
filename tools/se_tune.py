"""Tune SE tier-1 shapes end-to-end on one card.

A wider tier-1 verify slab keeps longer runs on device (less host replay)
at some device-time cost; this sweeps the trade with tables uploaded once.

Usage: python tools/se_tune.py [n_reads]   (uses the se_large bench cache)
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("WALTX_PROGRESS", "1")


def main() -> int:
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 2_000_000
    cache = os.path.join(REPO, "bench_cache", "se_large")

    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.core.single_end import process_single_end

    index = os.path.join(cache, "bench.dbindex")
    fq = os.path.join(cache, "reads_1.fastq")
    out = os.path.join(cache, "out_tune.mr")

    backend = JaxBackend()
    results = []
    golden = None
    settings = [  # (verify_slab_t1, wl1)
        (8, 1.5),   # round-4 defaults
        (12, 2.0),
        (16, 2.5),
        (8, 1.25),
    ]
    for slab, wl in settings:
        backend.verify_slab_t1 = slab
        backend.reset_adaptive()
        backend._wl1 = wl
        best = None
        for rep in range(3):
            backend.fallback_reads = backend.total_reads = 0
            open(out, "w").close()
            open(out + ".mapstats", "w").close()
            t0 = time.perf_counter()
            process_single_end(index, fq, out, batch_size=500_000,
                               max_mismatches=6, backend=backend)
            dt = time.perf_counter() - t0
            fb = 100 * backend.fallback_reads / max(1, backend.total_reads)
            if best is None or dt < best[0]:
                best = (dt, fb)
        blob = open(out, "rb").read()
        if golden is None:
            golden = blob
        row = dict(
            slab=slab, wl=wl, reads_per_s=round(n_reads / best[0], 1),
            seconds=round(best[0], 2), fallback_pct=round(best[1], 2),
            bytes_identical=(blob == golden),
        )
        results.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)

    best = max(results, key=lambda r: r["reads_per_s"])
    print(json.dumps({"results": results, "best": best}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
