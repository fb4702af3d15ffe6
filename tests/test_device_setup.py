"""Device set-up policy: where the compile cache goes, and the memory budget
the table ladder plans against."""

import os

import pytest

from walt_tpu.core import jax_backend


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, name, value):
        self.calls.append((name, value))


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: JAX owns the placement, code sets
    nothing."""
    import jax

    rec = _Recorder()
    monkeypatch.setattr(jax.config, "update", rec)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax_backend.enable_compile_cache()
    assert rec.calls == []


def test_compile_cache_defaults_into_checkout(monkeypatch):
    """Unset: the cache lands at <checkout>/bench_cache/jaxcache."""
    import jax

    rec = _Recorder()
    monkeypatch.setattr(jax.config, "update", rec)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax_backend.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(repo, "bench_cache", "jaxcache")
    assert ("jax_compilation_cache_dir", want) in rec.calls
    assert jax_backend.COMPILE_CACHE_DIR == want


class _FakeDevice:
    def __init__(self, platform, stats):
        self.platform = platform
        self.device_kind = "fake"
        self._stats = stats

    def memory_stats(self):
        return self._stats


def _budget_with(monkeypatch, dev):
    import jax

    monkeypatch.delenv("WALTX_HBM_GB", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])
    return jax_backend.JaxBackend._hbm_budget(None)


def test_hbm_budget_cpu_is_unconstrained(monkeypatch):
    assert _budget_with(monkeypatch, _FakeDevice("cpu", None)) is None


@pytest.mark.parametrize("stats", [None, {}, {"bytes_limit": 0}])
def test_hbm_budget_accelerator_without_limit_raises(monkeypatch, stats):
    with pytest.raises(RuntimeError, match="bytes_limit"):
        _budget_with(monkeypatch, _FakeDevice("gpu", stats))


def test_hbm_budget_is_the_allocator_limit(monkeypatch):
    dev = _FakeDevice("gpu", {"bytes_limit": 61 << 30})
    assert _budget_with(monkeypatch, dev) == 61 << 30


def test_hbm_budget_env_override(monkeypatch):
    import jax

    monkeypatch.setenv("WALTX_HBM_GB", "2.5")
    monkeypatch.setattr(jax, "devices", lambda *a, **k: 1 / 0)
    assert jax_backend.JaxBackend._hbm_budget(None) == int(2.5 * (1 << 30))
