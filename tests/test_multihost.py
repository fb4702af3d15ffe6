"""Multi-host glue: file sharding, mapstats merge, --multihost CLI."""

import os

import pytest

from walt_tpu.parallel.multihost import merge_mapstats, shard_round_robin


def test_shard_round_robin():
    files = [f"f{i}" for i in range(7)]
    shards = [shard_round_robin(files, p, 3) for p in range(3)]
    assert sorted(sum(shards, [])) == sorted(files)
    assert shards[0] == ["f0", "f3", "f6"]
    assert shards[2] == ["f2", "f5"]


def _run_se(index, fastq, out):
    from walt_tpu.cli import main_map

    main_map(["-i", index, "-r", fastq, "-o", out, "--backend", "numpy"])


def _clean_fastq(work, tmp_path, n, seed):
    """N-free reads: split-run equality requires no rand() consumption,
    because srand(0) is per batch (mapping.cpp:73) -- with Ns present,
    different file splits legitimately randomize differently (true of the
    reference as well)."""
    import numpy as np

    from tests.conftest import simulate_reads, write_fastq
    from walt_tpu.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    recs = simulate_reads(g, np.random.default_rng(seed), n, 80, n_rate=0.0)
    path = tmp_path / f"clean{seed}.fastq"
    write_fastq(path, recs)
    return str(path)


def test_merge_mapstats_se(tmp_path, work, my_index):
    """Merged per-part stats == stats of one run over the whole input."""
    se_fastq = _clean_fastq(work, tmp_path, 64, 3)
    # split the fastq in two parts at a record boundary
    recs = open(se_fastq).read().split("\n")
    n_lines = len([x for x in recs if x]) // 4 * 4
    cut = (n_lines // 8) * 4  # a record boundary
    p1, p2 = tmp_path / "p1.fastq", tmp_path / "p2.fastq"
    p1.write_text("\n".join(recs[:cut]) + "\n")
    p2.write_text("\n".join(recs[cut:]))

    _run_se(my_index, se_fastq, str(tmp_path / "all.mr"))
    _run_se(my_index, str(p1), str(tmp_path / "o1.mr"))
    _run_se(my_index, str(p2), str(tmp_path / "o2.mr"))
    merged = str(tmp_path / "merged.mapstats")
    merge_mapstats(
        [str(tmp_path / "o1.mr.mapstats"), str(tmp_path / "o2.mr.mapstats")],
        merged,
    )
    assert open(merged).read() == open(str(tmp_path / "all.mr.mapstats")).read()
    # and the concatenated MR output matches the single run (order preserved)
    cat = open(str(tmp_path / "o1.mr")).read() + open(str(tmp_path / "o2.mr")).read()
    assert cat == open(str(tmp_path / "all.mr")).read()


def test_merge_mapstats_pe(tmp_path, work, my_index):
    import numpy as np

    from tests.conftest import simulate_pairs, write_fastq
    from walt_tpu.cli import main_map
    from walt_tpu.genome import load_genome

    g = load_genome([str(work / "genome.fa")])
    r1, r2 = simulate_pairs(g, np.random.default_rng(9), 64, 75, n_rate=0.0)
    p1, p2 = str(tmp_path / "pe1.fastq"), str(tmp_path / "pe2.fastq")
    write_fastq(p1, r1)
    write_fastq(p2, r2)

    def halves(path, name):
        recs = open(path).read().rstrip("\n").split("\n")
        cut = (len(recs) // 8) * 4
        a, b = tmp_path / f"{name}a.fastq", tmp_path / f"{name}b.fastq"
        a.write_text("\n".join(recs[:cut]) + "\n")
        b.write_text("\n".join(recs[cut:]) + "\n")
        return str(a), str(b)

    a1, b1 = halves(p1, "m1")
    a2, b2 = halves(p2, "m2")
    main_map(["-i", my_index, "-1", p1, "-2", p2,
              "-o", str(tmp_path / "all.mr"), "--backend", "numpy"])
    main_map(["-i", my_index, "-1", a1, "-2", a2,
              "-o", str(tmp_path / "oa.mr"), "--backend", "numpy"])
    main_map(["-i", my_index, "-1", b1, "-2", b2,
              "-o", str(tmp_path / "ob.mr"), "--backend", "numpy"])
    merged = str(tmp_path / "merged.mapstats")
    merge_mapstats(
        [str(tmp_path / "oa.mr.mapstats"), str(tmp_path / "ob.mr.mapstats")],
        merged,
    )
    assert open(merged).read() == open(str(tmp_path / "all.mr.mapstats")).read()


def test_multihost_single_process_cli(tmp_path, my_index, se_fastq):
    """--multihost with one process maps every file, identically."""
    from walt_tpu.cli import main_map

    out_m = str(tmp_path / "m.mr")
    out_s = str(tmp_path / "s.mr")
    main_map(["-i", my_index, "-r", se_fastq, "-o", out_m,
              "--backend", "numpy", "--multihost"])
    main_map(["-i", my_index, "-r", se_fastq, "-o", out_s,
              "--backend", "numpy"])
    assert open(out_m).read() == open(out_s).read()
    assert open(out_m + ".mapstats").read() == open(out_s + ".mapstats").read()


def test_multihost_requires_one_output_per_input(tmp_path, my_index, se_fastq):
    from walt_tpu.cli import main_map

    with pytest.raises(SystemExit):
        main_map(["-i", my_index, "-r", f"{se_fastq},{se_fastq}",
                  "-o", str(tmp_path / "one.mr"), "--backend", "numpy",
                  "--multihost"])


def test_multihost_two_processes_filesplit(tmp_path, work, my_index):
    """Two real jax.distributed processes split two files; outputs match
    single-host runs byte for byte."""
    import subprocess
    import sys

    f1 = _clean_fastq(work, tmp_path, 24, 11)
    f2 = _clean_fastq(work, tmp_path, 24, 12)
    o1, o2 = str(tmp_path / "h1.mr"), str(tmp_path / "h2.mr")
    env_base = dict(
        os.environ, JAX_PLATFORMS="cpu",
        WALTX_COORDINATOR="127.0.0.1:29741", WALTX_NUM_HOSTS="2",
        WALTX_PREFAULT_MB="32",  # concurrent multi-GB prefault is slow here
    )
    procs = []
    for pid in range(2):
        env = dict(env_base, WALTX_HOST_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "walt_tpu.cli", "-i", my_index,
             "-r", f"{f1},{f2}", "-o", f"{o1},{o2}",
             "--backend", "numpy", "--multihost"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out.decode()

    from walt_tpu.cli import main_map

    s1, s2 = str(tmp_path / "s1.mr"), str(tmp_path / "s2.mr")
    main_map(["-i", my_index, "-r", f1, "-o", s1, "--backend", "numpy"])
    main_map(["-i", my_index, "-r", f2, "-o", s2, "--backend", "numpy"])
    assert open(o1).read() == open(s1).read()
    assert open(o2).read() == open(s2).read()
    assert open(o1 + ".mapstats").read() == open(s1 + ".mapstats").read()
    assert open(o2 + ".mapstats").read() == open(s2 + ".mapstats").read()


def test_multihost_two_processes(tmp_path, work, my_index):
    """Two REAL coordinated processes (jax.distributed, localhost
    coordinator): round-robin file assignment, per-file outputs
    byte-identical to a single-host run, merged mapstats correct."""
    import socket
    import subprocess
    import sys

    f1 = _clean_fastq(work, tmp_path, 48, 21)
    f2 = _clean_fastq(work, tmp_path, 32, 22)
    o1, o2 = str(tmp_path / "mh1.mr"), str(tmp_path / "mh2.mr")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    procs = []
    for pid in range(2):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            WALTX_COORDINATOR=f"127.0.0.1:{port}",
            WALTX_NUM_HOSTS="2",
            WALTX_HOST_ID=str(pid),
        )
        code = (
            "import jax; jax.config.update('jax_platforms', 'cpu')\n"
            "from walt_tpu.cli import main_map\n"
            f"main_map(['-i', {my_index!r}, '-r', {f1!r} + ',' + {f2!r}, "
            f"'-o', {o1!r} + ',' + {o2!r}, '--backend', 'numpy', "
            "'--multihost'])\n"
        )
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err.decode()[-2000:]

    # single-host reference runs
    s1, s2 = str(tmp_path / "sh1.mr"), str(tmp_path / "sh2.mr")
    _run_se(my_index, f1, s1)
    _run_se(my_index, f2, s2)
    for mh, sh in ((o1, s1), (o2, s2)):
        assert open(mh).read() == open(sh).read()
        assert open(mh + ".mapstats").read() == open(sh + ".mapstats").read()

    merged = str(tmp_path / "mh_merged.mapstats")
    merge_mapstats([o1 + ".mapstats", o2 + ".mapstats"], merged)
    both = str(tmp_path / "both.fastq")
    with open(both, "w") as f:
        f.write(open(f1).read() + open(f2).read())
    _run_se(my_index, both, str(tmp_path / "both.mr"))
    assert open(merged).read() == open(
        str(tmp_path / "both.mr.mapstats")
    ).read()
