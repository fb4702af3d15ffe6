"""Shared fixtures: CPU device mesh, tiny genome, reference binaries/outputs.

JAX runs on an 8-device virtual CPU mesh in tests (unless JAX_PLATFORMS
says otherwise) so multi-device sharding is exercised without several
cards.  Tests marked ``gpu`` take the ``gpu_device`` fixture and skip
without a card.  Golden tests compare against the reference binaries built
from /root/reference when present (skipped otherwise).
"""

import os

# Must happen before jax initializes a backend.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from walt_tpu.hostmem import prefault

# test workloads are small; a modest pre-fault keeps demand faults off the
# mapping loop (see walt_tpu/hostmem.py)
prefault(512 << 20)

import shutil
import subprocess

import numpy as np
import pytest

REFERENCE = "/root/reference"
REFBUILD = "/tmp/refbuild"


def _reference_bin(name: str):
    path = os.path.join(REFBUILD, "src", "walt", name)
    if os.path.isfile(path):
        return path
    if not os.path.isdir(REFERENCE):
        return None
    shutil.copytree(REFERENCE, REFBUILD, dirs_exist_ok=True)
    subprocess.run(["make", "all"], cwd=REFBUILD, capture_output=True)
    return path if os.path.isfile(path) else None


@pytest.fixture(scope="session")
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def ref_walt():
    path = _reference_bin("walt")
    if path is None:
        pytest.skip("reference binaries unavailable")
    return path


@pytest.fixture(scope="session")
def ref_makedb():
    path = _reference_bin("makedb")
    if path is None:
        pytest.skip("reference binaries unavailable")
    return path


def _write_genome(path, chroms, rng):
    bases = np.array(list("ACGT"))
    with open(path, "w") as f:
        for name, n in chroms:
            seq = "".join(bases[rng.integers(0, 4, n)])
            f.write(f">{name} descr\n")
            for i in range(0, n, 70):
                f.write(seq[i : i + 70] + "\n")


def simulate_reads(genome, rng, n, length, err=0.02, bis=0.75, n_rate=0.01,
                   name_prefix="read"):
    """Bisulfite SE reads from both strands with errors and Ns."""
    bases = np.array(list("ACGT"))
    recs = []
    for i in range(n):
        chrom = int(rng.integers(0, genome.n_chroms))
        lo = int(genome.start_index[chrom])
        hi = int(genome.start_index[chrom + 1]) - length
        start = lo + int(rng.integers(0, max(1, hi - lo)))
        codes = genome.seq[start : start + length].copy()
        if rng.integers(0, 2):
            codes = (3 - codes)[::-1]
        cs = np.flatnonzero(codes == 1)
        codes[cs[rng.random(cs.size) < bis]] = 3
        errs = np.flatnonzero(rng.random(length) < err)
        codes[errs] = (codes[errs] + rng.integers(1, 4, errs.size)) % 4
        seq = list("".join(bases[codes]))
        for p in np.flatnonzero(rng.random(length) < n_rate):
            seq[p] = "N"
        qual = "".join(chr(33 + int(q)) for q in rng.integers(20, 40, length))
        recs.append((f"{name_prefix}{i} x", "".join(seq), qual))
    return recs


def simulate_pairs(genome, rng, n, length, frag_lo=120, frag_hi=400, err=0.02,
                   bis=0.75, n_rate=0.01):
    bases = np.array(list("ACGT"))
    out1, out2 = [], []
    for i in range(n):
        chrom = int(rng.integers(0, genome.n_chroms))
        frag_n = int(rng.integers(frag_lo, frag_hi))
        lo = int(genome.start_index[chrom])
        hi = int(genome.start_index[chrom + 1]) - frag_n
        start = lo + int(rng.integers(0, max(1, hi - lo)))
        frag = genome.seq[start : start + frag_n].copy()
        cs = np.flatnonzero(frag == 1)
        frag[cs[rng.random(cs.size) < bis]] = 3

        def finish(codes):
            codes = codes.copy()
            errs = np.flatnonzero(rng.random(length) < err)
            codes[errs] = (codes[errs] + rng.integers(1, 4, errs.size)) % 4
            seq = list("".join(bases[codes]))
            for p in np.flatnonzero(rng.random(length) < n_rate):
                seq[p] = "N"
            qual = "".join(chr(33 + int(q)) for q in rng.integers(20, 40, length))
            return "".join(seq), qual

        s1, q1 = finish(frag[:length])
        s2, q2 = finish((3 - frag[-length:])[::-1])
        out1.append((f"pair{i} m1", s1, q1))
        out2.append((f"pair{i} m2", s2, q2))
    return out1, out2


def write_fastq(path, recs):
    with open(path, "w") as f:
        for name, seq, qual in recs:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")


@pytest.fixture(scope="session")
def work(tmp_path_factory):
    """Session dir with genome, reads, and (lazily) indexes."""
    d = tmp_path_factory.mktemp("waltx")
    rng = np.random.default_rng(20260816)
    _write_genome(d / "genome.fa", [("chr1", 9001), ("chrM", 3203)], rng)
    return d


@pytest.fixture(scope="session")
def my_index(work):
    from walt_tpu.index.build import build_all_tables
    from walt_tpu.index.io_walt import write_index

    prefix = str(work / "my.dbindex")
    if not os.path.exists(prefix):
        genome, tables = build_all_tables([str(work / "genome.fa")], verbose=False)
        write_index(prefix, genome, tables)
    return prefix


@pytest.fixture(scope="session")
def ref_index(work, ref_makedb):
    prefix = str(work / "ref.dbindex")
    if not os.path.exists(prefix):
        subprocess.run(
            [ref_makedb, "-c", str(work / "genome.fa"), "-o", prefix],
            check=True, capture_output=True,
        )
    return prefix


@pytest.fixture(scope="session")
def se_fastq(work):
    from walt_tpu.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    rng = np.random.default_rng(7)
    recs = simulate_reads(g, rng, 150, 80)
    recs += simulate_reads(g, rng, 10, 45, name_prefix="s")
    recs.append(("tiny", "ACGTACGT", "IIIIIIII"))
    path = work / "se.fq"
    write_fastq(path, recs)
    return str(path)


@pytest.fixture(scope="session")
def se_fastq_clippable(work):
    """SE reads all >= 14bp, some ending in adaptor sequence.

    The reference segfaults when clipping reads shorter than its 14-byte
    head window (size_t underflow in util.hpp:204), so the adaptor golden
    test avoids them.
    """
    from walt_tpu.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    rng = np.random.default_rng(13)
    recs = simulate_reads(g, rng, 80, 80)
    adaptor = "AGATCGGAAGAGC"
    clipped = []
    for i, (name, seq, qual) in enumerate(recs):
        if i % 3 == 0:  # adaptor read-through at a random offset
            cut = int(rng.integers(40, 75))
            seq = (seq[:cut] + adaptor * 6)[:80]
        clipped.append((name, seq, qual))
    path = work / "se_clip.fq"
    write_fastq(path, clipped)
    return str(path)


@pytest.fixture(scope="session")
def pe_fastq(work):
    from walt_tpu.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    rng = np.random.default_rng(11)
    r1, r2 = simulate_pairs(g, rng, 120, 75)
    bases = np.array(list("ACGT"))
    for i in range(10):  # unmappable pairs
        r1.append((f"rand{i}", "".join(bases[rng.integers(0, 4, 75)]), "I" * 75))
        r2.append((f"rand{i}", "".join(bases[rng.integers(0, 4, 75)]), "I" * 75))
    p1, p2 = work / "pe_1.fq", work / "pe_2.fq"
    write_fastq(p1, r1)
    write_fastq(p2, r2)
    return str(p1), str(p2)
