"""chip_smoke.py: refuses a CPU platform, and its phases hold on a tiny
workload on the CPU (the card run uses the same functions at full size)."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_phases_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from walt_tpu.core.backends import get_backend

    monkeypatch.setattr(cs, "SE_SUBSET", 300)
    monkeypatch.setattr(cs, "PE_SUBSET", 100)
    data = cs.prepare(str(tmp_path), 300_000, 600, 200)
    ref = cs.numpy_refs(data)
    backend = get_backend("jax", chunk=512, small_chunk=128)
    clock = cs.CompileClock()
    se = cs.phase_se(backend, data, clock, ref["se"])
    pe = cs.phase_pe(backend, data, clock, ref["pe"])
    out = capsys.readouterr().out
    assert "SE per-read: all 600 reads equal native.se_exact" in out
    assert "PE bytes: MR and mapstats" in out
    assert se["seconds"] > 0 and pe["seconds"] > 0
    assert 0 <= se["fallback"] < 0.5 and 0 <= pe["fallback"] < 0.5
    assert not any(line.lstrip().startswith("{") for line in out.splitlines())
    with pytest.raises(cs.Failed):
        cs.same_bytes(ref["se"], ref["pe"], "different jobs")
