"""bench.py orchestration: early headline, failure isolation, budget skip.

The bench is the round's deliverable artifact; its control flow (stale
headline up front, priority headline on stdout, per-config failure
isolation, immediate detail flush, wall-clock budget) is tested here with
the heavy per-config work stubbed out.
"""

import importlib
import json
import sys


def _load_bench():
    sys.modules.pop("bench", None)
    return importlib.import_module("bench")


def _setup(monkeypatch, bench, results, tmp_path, deadline=None):
    if tmp_path is not None:
        monkeypatch.setattr(
            bench, "DETAIL_PATH", str(tmp_path / "BENCH_DETAIL.json")
        )
    if deadline is not None:
        monkeypatch.setattr(bench, "DEADLINE_S", deadline)

    calls = []

    def fake_config(name, **kw):
        calls.append(name)
        r = results[name]
        if isinstance(r, Exception):
            raise r
        return dict(r)

    monkeypatch.setattr(bench, "_bench_config", fake_config)
    monkeypatch.setattr(bench, "_free_host_caches", lambda: None)
    monkeypatch.setattr("walt_tpu.hostmem.prefault", lambda *a, **k: True)
    return calls


def _run_main(monkeypatch, capsys, results, tmp_path, deadline=None):
    """Run bench.main() with _bench_config stubbed to yield ``results``.

    ``results``: dict config-name -> detail dict or Exception.
    Returns (rc, stdout lines as parsed json, stderr text).
    """
    bench = _load_bench()
    _setup(monkeypatch, bench, results, tmp_path, deadline)
    rc = bench.main()
    cap = capsys.readouterr()
    out = [json.loads(line) for line in cap.out.splitlines() if line.strip()]
    return rc, out, cap.err


def _detail(name, value=1000.0, unit="reads/s"):
    return {"config": name, "value": value, "unit": unit,
            "vs_baseline": 1.0}


ALL = {
    "se_large_512M": _detail("se_large_512M", 140000.0),
    "pe_mid_256M": _detail("pe_mid_256M", 50000.0, "pairs/s"),
    "se_small_4M": _detail("se_small_4M", 250000.0),
    "se_xl_768M": _detail("se_xl_768M", 110000.0),
}


def test_priority_headline_wins_and_all_stdout_lines_are_headlines(
        monkeypatch, capsys, tmp_path):
    rc, out, _ = _run_main(monkeypatch, capsys, dict(ALL), tmp_path)
    assert rc == 0
    # every stdout JSON line is a headline (the driver parses the last one)
    assert out and all(
        set(o) >= {"metric", "value", "unit", "vs_baseline"} for o in out
    )
    # se_small runs first (banked early) but se_large has headline priority
    assert out[-1]["metric"] == "se_large_512M_reads_per_s_1chip"
    assert out[-1]["value"] == 140000.0
    assert not out[-1].get("stale")


def test_failed_headline_falls_through_to_next_priority(monkeypatch, capsys,
                                                        tmp_path):
    results = dict(ALL)
    results["se_large_512M"] = RuntimeError("RESOURCE_EXHAUSTED boom")
    rc, out, err = _run_main(monkeypatch, capsys, results, tmp_path)
    assert rc == 0  # one config failing does not fail the bench
    assert out[-1]["metric"] == "pe_mid_256M_pairs_per_s_1chip"
    assert "FAILED" in err
    # the failure is recorded in the detail file immediately, not at exit
    detail = json.load(open(tmp_path / "BENCH_DETAIL.json"))
    fails = [d for d in detail if "failures" in d]
    assert fails and any(
        f["config"] == "se_large_512M" for f in fails[0]["failures"]
    )


def test_all_failed_reports_nonzero(monkeypatch, capsys, tmp_path):
    results = {k: RuntimeError("x") for k in ALL}
    rc, out, _ = _run_main(monkeypatch, capsys, results, tmp_path)
    assert rc == 1
    assert out[-1]["metric"] == "bench_failed"


def test_stale_headline_survives_total_failure(monkeypatch, capsys,
                                               tmp_path):
    """A committed BENCH_DETAIL.json yields a stale headline printed before
    any config runs, so the round keeps a parseable number even if every
    fresh config dies (the round-4 failure mode)."""
    bench = _load_bench()
    path = tmp_path / "BENCH_DETAIL.json"
    path.write_text(json.dumps([_detail("se_large_512M", 123456.0)]))
    results = {k: RuntimeError("x") for k in ALL}
    _setup(monkeypatch, bench, results, tmp_path)
    rc = bench.main()
    cap = capsys.readouterr()
    out = [json.loads(x) for x in cap.out.splitlines() if x.strip()]
    assert rc == 0
    assert out[0].get("stale") is True
    assert out[-1].get("stale") is True
    assert out[-1]["value"] == 123456.0


def test_budget_skips_every_config(monkeypatch, capsys, tmp_path):
    """Past the deadline no config starts, the first one included: each is
    skipped and recorded, and with nothing run the bench reports rc=1."""
    bench = _load_bench()
    calls = _setup(monkeypatch, bench, dict(ALL), tmp_path, deadline=-1.0)
    rc = bench.main()
    cap = capsys.readouterr()
    assert calls == []
    assert rc == 1  # nothing ran and no stale headline existed
    assert cap.err.count("skipping") == len(ALL)
    detail = json.load(open(tmp_path / "BENCH_DETAIL.json"))
    skipped = [f["config"] for d in detail if "failures" in d
               for f in d["failures"] if f["error"] == "skipped: budget"]
    assert sorted(skipped) == sorted(ALL)


def test_detail_lines_are_not_parseable_json(monkeypatch, capsys, tmp_path):
    """Per-config detail must not be a bare JSON line anywhere: the round-3
    driver parsed the LAST JSON-looking line of merged output and recorded
    a detail dict instead of the headline (BENCH_r03.json)."""
    rc, out, err = _run_main(monkeypatch, capsys, dict(ALL), tmp_path)
    assert rc == 0
    for line in err.splitlines():
        assert not line.lstrip().startswith("{")
    assert out[-1]["metric"] == "se_large_512M_reads_per_s_1chip"
