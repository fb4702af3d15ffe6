"""End-to-end smoke run of waltx on GPUs, through the drivers users call.

    python chip_smoke.py          # one card: phases (a)-(e) below
    python chip_smoke.py --mesh   # four cards: the mesh phase only

Data (fixed seeds, ``walt_tpu.synth``): a 256 Mbp repeat-structured genome
and its 4-table walt index, cached under ``bench_cache/chip_smoke/`` keyed
by size and seed; 500k x 100 bp single-end reads and 150k x 100 bp pairs.

One card:

(a) platform: a GPU, ``nvidia-smi`` name and power limit, the JAX version,
    the allocator's ``bytes_limit``, and the native host library loaded;
(b) SE: ``process_single_end`` (jax backend, -m 6, default -b) over every
    read, warm-up then timed: rungs, upload rate, compile time, reads/s,
    fallback share, peak device memory;
(c) SE correctness: every read's (pos, times, strand, mm) equals
    ``native.se_exact``; MR and mapstats bytes of the first 10k reads equal
    the ``numpy`` backend's;
(d) PE: (b) and the byte comparison of (c) with ``process_paired_end``
    over the pairs (first 5k pairs against ``numpy``);
(e) the ``gpu``-marked tests, in this process (one JAX process per card).

Four cards (``--mesh``): SE on the CLI's auto mesh (dp=4), then SE and PE on
dp=2 x tp=2, each byte-equal to the ``numpy`` backend on the subsets, with
every card's peak memory printed.

Every check raises; the script exits non-zero and prints no result line
unless all of them pass.  The last stdout line is the result JSON.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(REPO, "bench_cache", "chip_smoke")

GENOME_BP = 256_000_000
SE_READS = 500_000
PAIRS = 150_000
READ_LEN = 100
SE_SUBSET = 10_000
PE_SUBSET = 5_000
SEED = 42
MAX_MM = 6


class Failed(RuntimeError):
    """A smoke check did not hold."""


def check(cond, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


class CompileClock:
    """Seconds and programs of XLA backend compiles since the last take()."""

    EVENT = "/jax/core/compile/backend_compile_duration"

    def __init__(self):
        import jax

        self.secs = 0.0
        self.compiles = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event == self.EVENT:
            self.secs += duration
            self.compiles += 1

    def take(self):
        got = (self.secs, self.compiles)
        self.secs, self.compiles = 0.0, 0
        return got


# --------------------------------------------------------------------------
# data


def prepare(root: str, genome_bp: int, n_se: int, n_pairs: int,
            seed: int = SEED) -> dict:
    """Genome index + FASTQ files (full sets and subsets), cached."""
    from walt_tpu.synth import (
        codes_to_fastq, make_genome_repetitive, sample_pairs, sample_reads,
        write_genome_fasta,
    )

    d = os.path.join(root, f"g{genome_bp}_s{seed}")
    os.makedirs(d, exist_ok=True)
    paths = dict(
        index=os.path.join(d, "genome.dbindex"),
        se=os.path.join(d, f"se_{n_se}.fq"),
        se_sub=os.path.join(d, f"se_{n_se}_first.fq"),
        pe1=os.path.join(d, f"pe_{n_pairs}_1.fq"),
        pe2=os.path.join(d, f"pe_{n_pairs}_2.fq"),
        pe1_sub=os.path.join(d, f"pe_{n_pairs}_first_1.fq"),
        pe2_sub=os.path.join(d, f"pe_{n_pairs}_first_2.fq"),
        out=os.path.join(d, "out"),
    )
    os.makedirs(paths["out"], exist_ok=True)
    index_ok = os.path.join(d, "index.ok")
    reads_ok = os.path.join(d, f"reads_{n_se}_{n_pairs}.ok")
    if os.path.exists(index_ok) and os.path.exists(reads_ok):
        return paths
    t0 = time.perf_counter()
    genome = make_genome_repetitive(genome_bp, n_chroms=2, seed=seed)
    if not os.path.exists(index_ok):
        from walt_tpu.index.build import build_all_tables
        from walt_tpu.index.io_walt import write_index

        fasta = os.path.join(d, "genome.fa")
        write_genome_fasta(genome, fasta)
        t1 = time.perf_counter()
        g, tables = build_all_tables([fasta], verbose=False)
        write_index(paths["index"], g, tables)
        del g, tables
        os.remove(fasta)
        say(f"index: {genome_bp / 1e6:.0f} Mbp, 4 tables built in "
            f"{time.perf_counter() - t1:.1f} s")
        open(index_ok, "w").close()
    codes, lens, _ = sample_reads(genome, n_se, READ_LEN, seed=seed + 1)
    codes_to_fastq(codes, lens, paths["se"])
    codes_to_fastq(codes[:SE_SUBSET], lens[:SE_SUBSET], paths["se_sub"])
    c1, l1, c2, l2 = sample_pairs(genome, n_pairs, READ_LEN, seed=seed + 2)
    codes_to_fastq(c1, l1, paths["pe1"])
    codes_to_fastq(c2, l2, paths["pe2"])
    codes_to_fastq(c1[:PE_SUBSET], l1[:PE_SUBSET], paths["pe1_sub"])
    codes_to_fastq(c2[:PE_SUBSET], l2[:PE_SUBSET], paths["pe2_sub"])
    open(reads_ok, "w").close()
    say(f"data: ready in {time.perf_counter() - t0:.1f} s ({n_se} SE "
        f"reads, {n_pairs} pairs)")
    return paths


# --------------------------------------------------------------------------
# drivers


def _fresh(out: str) -> str:
    for p in (out, out + ".mapstats"):
        open(p, "w").close()
    return out


def run_se(backend, index: str, fastq: str, out: str) -> float:
    from walt_tpu.core.single_end import process_single_end

    t0 = time.perf_counter()
    process_single_end(index, fastq, _fresh(out), max_mismatches=MAX_MM,
                       backend=backend)
    return time.perf_counter() - t0


def run_pe(backend, index: str, fq1: str, fq2: str, out: str) -> float:
    from walt_tpu.core.paired_end import process_paired_end

    t0 = time.perf_counter()
    process_paired_end(index, fq1, fq2, _fresh(out), max_mismatches=MAX_MM,
                       backend=backend)
    return time.perf_counter() - t0


def same_bytes(a: str, b: str, what: str) -> None:
    for suf in ("", ".mapstats"):
        check(filecmp.cmp(a + suf, b + suf, shallow=False),
              f"{what}: {a + suf} differs from {b + suf}")
        check(os.path.getsize(b + suf) > 0, f"{what}: {b + suf} is empty")


def numpy_refs(data: dict) -> dict:
    """Exact host-path outputs of the SE and PE subsets."""
    from walt_tpu.core.backends import get_backend

    out = data["out"]
    ref = dict(se=os.path.join(out, "se_sub_numpy.mr"),
               pe=os.path.join(out, "pe_sub_numpy.mr"))
    npb = get_backend("numpy")
    t_se = run_se(npb, data["index"], data["se_sub"], ref["se"])
    t_pe = run_pe(npb, data["index"], data["pe1_sub"], data["pe2_sub"],
                  ref["pe"])
    say(f"numpy backend: SE subset {t_se:.1f} s, PE subset {t_pe:.1f} s")
    return ref


def _count_reads(fastq: str) -> int:
    with open(fastq, "rb") as f:
        return sum(1 for _ in f) // 4


def _load_reads(fastq: str):
    from walt_tpu.host.fastq import FgetsLines, load_batch

    lines = FgetsLines(fastq)
    try:
        return load_batch(lines, 1 << 30, b"").packed()
    finally:
        lines.close()


def _timed_job(label: str, backend, clock, job, n: int, unit: str) -> dict:
    """Warm-up then timed run of one driver job on a single card.

    Warm-up repeats (at most 3 runs) until a run compiles nothing: the
    backend's adaptive worklist sizing can pick a new shape after the
    first batch, and the timed window must hold no compile."""
    import jax

    from walt_tpu import perf

    perf.reset()
    clock.take()
    n_old = len(backend.table_report())
    t_warm = job()
    c_secs, c_n = clock.take()
    up_s = perf.snapshot().get("table_upload", 0.0)
    report = backend.table_report()
    up_b = sum(t["upload_bytes"] for t in report[n_old:])
    rungs = ", ".join(f"{t['strand']}:{t['rung']}" for t in report)
    say(f"{label} warm-up: {t_warm:.2f} s, of which compile {c_secs:.2f} s "
        f"({c_n} programs); tables {rungs}; upload {up_b / 2**20:.0f} MB "
        f"in {up_s:.2f} s ({up_b / 2**20 / max(up_s, 1e-9):.0f} MB/s)")
    for _ in range(2):
        if not c_n:
            break
        t_more = job()
        c_secs, c_n = clock.take()
        say(f"{label} warm-up again: {t_more:.2f} s, compile {c_secs:.2f} s "
            f"({c_n} programs)")
    backend.fallback_reads = backend.total_reads = 0
    perf.reset()
    t = job()
    c_secs, c_n = clock.take()
    stages = ", ".join(f"{k} {v:.3f} s" for k, v in perf.snapshot().items())
    fb = backend.fallback_reads / max(1, backend.total_reads)
    stats = jax.devices()[0].memory_stats() or {}
    peak = int(stats.get("peak_bytes_in_use", 0))
    resident = sum(t["device_bytes"] for t in report)
    say(f"{label} timed: {t:.3f} s, {n / t:.1f} {unit}/s, host fallback "
        f"{100 * fb:.3f}% of mapped reads, compile in window {c_secs:.2f} s "
        f"({c_n} programs)")
    say(f"{label} timed stages (the mapper thread overlaps the host ones): "
        f"{stages}")
    say(f"{label} memory: peak_bytes_in_use {peak} "
        f"({peak / 2**30:.2f} GiB), resident tables {resident} "
        f"({resident / 2**30:.2f} GiB), working set {peak - resident} "
        f"({(peak - resident) / 2**30:.2f} GiB)")
    check(backend.device_oom_batches == 0,
          f"{label}: {backend.device_oom_batches} batches took the "
          f"device-OOM host path")
    return dict(seconds=t, fallback=fb, peak=peak, resident=resident)


# --------------------------------------------------------------------------
# phases


def phase_platform(n_cards: int):
    """(a) a GPU (n_cards of them), its name/power limit, native library."""
    import jax

    from walt_tpu import native

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX runs on {devs[0].platform}")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        say(line.strip())
    say(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    for d in devs[:n_cards]:
        say(f"device {d.id}: bytes_limit "
            f"{int(d.memory_stats()['bytes_limit'])}")
    check(native.get_lib() is not None,
          f"native host library missing: {native.build_error}")
    say("native host library: loaded")
    return devs


def phase_se(backend, data: dict, clock, ref: str) -> dict:
    """(b) + (c): SE throughput, per-read exactness, subset bytes."""
    import numpy as np

    from walt_tpu import native
    from walt_tpu.constants import get_pattern
    from walt_tpu.index import io_walt

    out = data["out"]
    n = _count_reads(data["se"])
    res = _timed_job(
        "SE", backend, clock,
        lambda: run_se(backend, data["index"], data["se"],
                       os.path.join(out, "se_jax.mr")),
        n, "reads",
    )
    # (c) per read: the device program (fallback reads replayed exactly,
    # as the driver does) against the native exact mapper on every read
    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(data["index"])
    tables = [io_walt.read_table_cached(data["index"] + s, gm)
              for s in ("_CT00", "_CT01")]
    codes, lens = _load_reads(data["se"])
    dev = backend.map_single_end(codes, lens, tables, 5000, MAX_MM, pattern)
    fb = dev[4]
    exact = native.se_exact(codes, lens, tables, False, 5000, MAX_MM,
                            pattern)
    mappable = lens >= pattern.min_read_len
    for name, d, e in zip(("pos", "times", "strand", "mm"), dev[:4], exact):
        d = np.array(d)
        d[fb] = e[fb]
        bad = np.flatnonzero((d != e) & mappable)
        check(bad.size == 0,
              f"SE per-read {name}: {bad.size} reads differ from "
              f"native.se_exact (first {bad[:5].tolist()})")
    check(mappable.all(), f"{int((~mappable).sum())} reads too short")
    say(f"SE per-read: all {n} reads equal native.se_exact "
        f"({n - int(fb.sum())} resolved on the device, {int(fb.sum())} "
        f"replayed on the host)")
    got = os.path.join(out, "se_sub_jax.mr")
    run_se(backend, data["index"], data["se_sub"], got)
    same_bytes(ref, got, "SE subset MR/mapstats vs numpy")
    say(f"SE bytes: MR and mapstats of the first {SE_SUBSET} reads equal "
        f"the numpy backend's")
    return res


def phase_pe(backend, data: dict, clock, ref: str) -> dict:
    """(d): PE throughput and subset bytes."""
    out = data["out"]
    n = _count_reads(data["pe1"])
    res = _timed_job(
        "PE", backend, clock,
        lambda: run_pe(backend, data["index"], data["pe1"], data["pe2"],
                       os.path.join(out, "pe_jax.mr")),
        n, "pairs",
    )
    got = os.path.join(out, "pe_sub_jax.mr")
    run_pe(backend, data["index"], data["pe1_sub"], data["pe2_sub"], got)
    same_bytes(ref, got, "PE subset MR/mapstats vs numpy")
    say(f"PE bytes: MR and mapstats of the first {PE_SUBSET} pairs equal "
        f"the numpy backend's")
    return res


def phase_gpu_tests() -> None:
    """(e) the gpu-marked tests, in this process."""
    import pytest

    class Tally:
        passed = failed = 0

        def pytest_runtest_logreport(self, report):
            if report.failed:
                self.failed += 1
            elif report.when == "call" and report.passed:
                self.passed += 1

    tally = Tally()
    # the backend is already up; keep the test conftest from asking for cpu
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[tally])
    check(rc == 0 and tally.passed > 0 and tally.failed == 0,
          f"gpu tests: rc={rc}, {tally.passed} passed, {tally.failed} failed")
    say(f"gpu tests: {tally.passed} passed")


def phase_mesh(data: dict, ref: dict) -> None:
    """SE at dp=4, SE and PE at dp=2 x tp=2, against the numpy backend."""
    import jax

    from walt_tpu.core.backends import get_backend

    out = data["out"]
    for tp, jobs in ((1, ("se",)), (2, ("se", "pe"))):
        backend = get_backend("jax", mesh="auto", tp=tp)
        dp = int(backend.mesh.shape["dp"])
        for job in jobs:
            got = os.path.join(out, f"{job}_sub_dp{dp}_tp{tp}.mr")
            backend.fallback_reads = backend.total_reads = 0
            t0 = time.perf_counter()
            if job == "se":
                run_se(backend, data["index"], data["se_sub"], got)
            else:
                run_pe(backend, data["index"], data["pe1_sub"],
                       data["pe2_sub"], got)
            dt = time.perf_counter() - t0
            same_bytes(ref[job], got, f"{job} dp={dp} tp={tp} vs numpy")
            check(backend.device_oom_batches == 0,
                  f"{job} dp={dp} tp={tp}: device-OOM host path taken")
            fb = backend.fallback_reads / max(1, backend.total_reads)
            say(f"mesh dp={dp} tp={tp} {job.upper()}: MR and mapstats "
                f"equal the numpy backend's ({dt:.1f} s with compiles, "
                f"host fallback {100 * fb:.3f}%)")
        peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
                 for d in jax.devices()]
        say(f"mesh dp={dp} tp={tp} peak_bytes_in_use per card: {peaks}")
        backend.free_tables()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", action="store_true",
                    help="four cards: mesh phase only")
    args = ap.parse_args(argv)

    from walt_tpu.core.jax_backend import enable_compile_cache

    enable_compile_cache()
    devs = phase_platform(4 if args.mesh else 1)
    data = prepare(CACHE, GENOME_BP, SE_READS, PAIRS)
    ref = numpy_refs(data)
    if args.mesh:
        phase_mesh(data, ref)
    else:
        from walt_tpu.core.backends import get_backend

        clock = CompileClock()
        backend = get_backend("jax")  # one card, even on a larger host
        phase_se(backend, data, clock, ref["se"])
        phase_pe(backend, data, clock, ref["pe"])
        backend.free_tables()
        phase_gpu_tests()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
