"""Device pipeline correctness: differential vs the exact host enumerator,
and end-to-end golden equivalence through the JAX backend."""

import filecmp
import os
import subprocess

import numpy as np
import pytest

from walt_tpu.constants import get_pattern
from walt_tpu.index import io_walt


def _streams_equal(a, b):
    return [(int(x), int(y), int(z)) for x, y, z in a] == [
        (int(x), int(y), int(z)) for x, y, z in b
    ]


@pytest.fixture(scope="module")
def table(my_index):
    genome_meta, _ = io_walt.read_head(my_index)
    return io_walt.read_table(my_index + "_CT00", genome_meta)


@pytest.mark.parametrize("ag_wildcard", [False, True])
@pytest.mark.parametrize("b,max_mm", [(5000, 6), (3, 6), (5000, 0)])
def test_differential_vs_oracle(work, my_index, table, se_fastq, ag_wildcard,
                                b, max_mm):
    from walt_tpu.core.backends import NumpyBackend
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.host.fastq import FgetsLines, load_batch

    g, ht = table
    pattern = get_pattern("3")
    batch = load_batch(FgetsLines(se_fastq), 10**6)
    codes, lens = batch.packed()
    ref = NumpyBackend().map_strand(codes, lens, g, ht, ag_wildcard, b, max_mm, pattern)
    got = JaxBackend().map_strand(codes, lens, g, ht, ag_wildcard, b, max_mm, pattern)
    bad = [i for i in range(len(ref)) if not _streams_equal(ref[i], got[i])]
    assert not bad, f"{len(bad)} reads diverge, first: {bad[:5]}"


def test_small_slabs_force_fallback(work, my_index, table, se_fastq):
    """Tiny device slabs must still give exact results via fallback."""
    from walt_tpu.core.backends import NumpyBackend
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.host.fastq import FgetsLines, load_batch

    g, ht = table
    pattern = get_pattern("3")
    batch = load_batch(FgetsLines(se_fastq), 10**6)
    codes, lens = batch.packed()
    ref = NumpyBackend().map_strand(codes, lens, g, ht, False, 5000, 6, pattern)
    jb = JaxBackend(verify_slab=2, cand_slab=2)
    got = jb.map_strand(codes, lens, g, ht, False, 5000, 6, pattern)
    assert all(_streams_equal(r, o) for r, o in zip(ref, got))
    assert jb.fallback_reads > 0  # the tiny slabs actually overflowed


def test_golden_jax_backend(work, ref_walt, ref_index, se_fastq, pe_fastq):
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.core.paired_end import process_paired_end
    from walt_tpu.core.single_end import process_single_end

    be = JaxBackend()
    ref_out = str(work / "ref_jx.out")
    my_out = str(work / "my_jx.out")
    for out in (ref_out, my_out):
        open(out, "w").close()
        open(out + ".mapstats", "w").close()
    subprocess.run(
        [ref_walt, "-i", ref_index, "-r", se_fastq, "-1", pe_fastq[0],
         # small -N: the reference preallocates O(N) strings/heaps per batch
         # (paired.cpp:598-607) -- minutes of page faults at the 10M default
         "-2", pe_fastq[1], "-o", ref_out, "-sam", "-N", "100000"],
        check=True, capture_output=True,
    )
    process_single_end(ref_index, se_fastq, my_out, sam=True, backend=be)
    process_paired_end(ref_index, pe_fastq[0], pe_fastq[1], my_out, sam=True,
                       backend=be)
    for suf in ("", ".mapstats"):
        assert filecmp.cmp(ref_out + suf, my_out + suf, shallow=False), suf


def _se_device_vs_se_exact(my_index, se_fastq):
    """Per-read (pos, times, strand, mm) of the SE device program equal
    native.se_exact on every mappable read the device resolved (the
    drivers never map reads shorter than the seed pattern)."""
    from walt_tpu import native
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.host.fastq import FgetsLines, load_batch

    pattern = get_pattern("3")
    gm, _ = io_walt.read_head(my_index)
    tables = [io_walt.read_table_cached(my_index + s, gm)
              for s in ("_CT00", "_CT01")]
    codes, lens = load_batch(FgetsLines(se_fastq), 10**6).packed()
    if native.get_lib() is None:
        pytest.skip(f"native library unavailable: {native.build_error}")
    pos, times, minus, mm, fb = JaxBackend().map_single_end(
        codes, lens, tables, 5000, 6, pattern)
    exact = native.se_exact(codes, lens, tables, False, 5000, 6, pattern)
    ok = ~fb & (lens >= pattern.min_read_len)
    assert ok.sum() > len(lens) // 2  # most reads resolve on the device
    for got, want in zip((pos, times, minus, mm), exact):
        np.testing.assert_array_equal(np.asarray(got)[ok], want[ok])


def test_se_device_equals_se_exact(my_index, se_fastq):
    _se_device_vs_se_exact(my_index, se_fastq)


@pytest.mark.gpu
def test_se_device_equals_se_exact_on_gpu(gpu_device, my_index, se_fastq):
    import jax

    assert jax.devices()[0] == gpu_device
    _se_device_vs_se_exact(my_index, se_fastq)


def test_pe_flat_spill_byte_identical(tmp_path, monkeypatch):
    """A flat stream too small for a chunk's candidates (WALTX_PE_FLAT=1 on
    a repeat-rich genome) spills: the spilled pairs ride the fallback bit
    to the exact host path and the output stays byte-identical to the
    numpy backend."""
    from walt_tpu.core.backends import get_backend
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.core.paired_end import process_paired_end
    from walt_tpu.index.build import build_all_tables
    from walt_tpu.index.io_walt import write_index
    from walt_tpu.synth import (
        codes_to_fastq, make_genome_repetitive, sample_pairs,
        write_genome_fasta,
    )

    genome = make_genome_repetitive(200_000, n_chroms=2, seed=5)
    write_genome_fasta(genome, str(tmp_path / "g.fa"))
    g, tables = build_all_tables([str(tmp_path / "g.fa")], verbose=False)
    index = str(tmp_path / "g.dbindex")
    write_index(index, g, tables)
    c1, l1, c2, l2 = sample_pairs(genome, 256, 80, seed=6)
    fq = (str(tmp_path / "p1.fq"), str(tmp_path / "p2.fq"))
    codes_to_fastq(c1, l1, fq[0])
    codes_to_fastq(c2, l2, fq[1])

    def run(backend, name):
        out = str(tmp_path / name)
        open(out, "w").close()
        open(out + ".mapstats", "w").close()
        process_paired_end(index, *fq, out, max_mismatches=6,
                           backend=backend)
        return out

    ref = run(get_backend("numpy"), "ref.mr")
    monkeypatch.setenv("WALTX_PE_FLAT", "1")
    jb = JaxBackend(chunk=256, small_chunk=256)
    assert jb.pe_flat_factor == 1
    got = run(jb, "spill.mr")
    assert jb.fallback_reads > 0
    for suf in ("", ".mapstats"):
        assert filecmp.cmp(ref + suf, got + suf, shallow=False), suf
