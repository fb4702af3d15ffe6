"""Crash-safety under device memory exhaustion (round-2 verdict next #9).

An OOM raised by the device backend mid-run must degrade to the exact host
path with byte-identical output, not kill the process.  A table over the
HBM budget must degrade first to a uniq-less table, then word-0 key words,
then (only when nothing fits) raise HbmBudgetError -- which the drivers
also catch and survive.
"""

import pytest


def _run_se(index, fastq, out, backend):
    from walt_tpu.core.single_end import process_single_end

    open(out, "w").close()
    open(out + ".mapstats", "w").close()
    return process_single_end(index, fastq, out, batch_size=64,
                              max_mismatches=6, backend=backend)


def test_se_injected_oom_byte_identical(tmp_path, my_index, se_fastq):
    from walt_tpu.core.jax_backend import JaxBackend

    ok = str(tmp_path / "ok.mr")
    _run_se(my_index, se_fastq, ok, JaxBackend(chunk=256, small_chunk=64))

    class OomOnce(JaxBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.bombs = 2

        def map_single_end(self, *a, **kw):
            if self.bombs:
                self.bombs -= 1
                raise RuntimeError(
                    "RESOURCE_EXHAUSTED: device error (injected)"
                )
            return super().map_single_end(*a, **kw)

    oom = str(tmp_path / "oom.mr")
    bomb = OomOnce(chunk=256, small_chunk=64)
    _run_se(my_index, se_fastq, oom, bomb)
    assert bomb.device_oom_batches == 2  # the host path is counted
    assert open(oom).read() == open(ok).read()
    assert open(oom + ".mapstats").read() == open(ok + ".mapstats").read()


def test_pe_injected_oom_byte_identical(tmp_path, my_index, pe_fastq):
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.core.paired_end import process_paired_end

    fq1, fq2 = pe_fastq

    def run(out, backend):
        open(out, "w").close()
        open(out + ".mapstats", "w").close()
        return process_paired_end(my_index, fq1, fq2, out, batch_size=32,
                                  max_mismatches=6, backend=backend)

    ok = str(tmp_path / "ok.mr")
    run(ok, JaxBackend(chunk=256, small_chunk=64))

    class OomOnce(JaxBackend):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.bombs = 1

        def map_mate_slabs_begin(self, *a, **kw):
            if self.bombs:
                self.bombs -= 1
                raise RuntimeError(
                    "RESOURCE_EXHAUSTED: device error (injected)"
                )
            return super().map_mate_slabs_begin(*a, **kw)

    oom = str(tmp_path / "oom.mr")
    bomb = OomOnce(chunk=256, small_chunk=64)
    run(oom, bomb)
    assert bomb.device_oom_batches == 1
    assert open(oom).read() == open(ok).read()
    assert open(oom + ".mapstats").read() == open(ok + ".mapstats").read()


def test_no_uniq_degrade_identical(tmp_path, my_index, se_fastq, monkeypatch):
    """A table built without the uniq run index maps identically."""
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.ops import device_index

    ok = str(tmp_path / "ok.mr")
    _run_se(my_index, se_fastq, ok, JaxBackend(chunk=256, small_chunk=64))

    real = device_index.build_uniq_device
    monkeypatch.setattr(
        device_index, "build_uniq_device",
        lambda *a, **kw: real(*a, **dict(kw, max_bytes=8)),
    )
    nu = str(tmp_path / "nouniq.mr")
    backend = JaxBackend(chunk=256, small_chunk=64)
    _run_se(my_index, se_fastq, nu, backend)
    # the degrade actually happened: no table carries a uniq index, and
    # with the native library present the ladder takes key16 first (its
    # overflow replays concurrently); without it the wider word (less
    # Python-replay fallback) goes first
    assert all(entry[0].uniq_bits == 0 for entry in backend._tables.values())
    import jax.numpy as jnp

    from walt_tpu import native as _native

    if _native.get_lib() is not None:
        assert all(entry[1]["key_words"].dtype == jnp.uint16
                   and entry[1]["key_words"].ndim == 1
                   for entry in backend._tables.values())
    else:
        assert all(entry[1]["key_words"].dtype == jnp.uint32
                   and entry[1]["key_words"].ndim == 2
                   for entry in backend._tables.values())
    assert open(nu).read() == open(ok).read()


def test_key16_rung_identical(tmp_path, my_index, se_fastq, monkeypatch):
    """A budget fitting 2n (key16) but not 4n (u32 word0) of key bytes
    takes the key16 rung and still maps byte-identically."""
    from walt_tpu.core.jax_backend import JaxBackend
    from walt_tpu.index import io_walt
    from walt_tpu.ops import device_index

    ok = str(tmp_path / "ok.mr")
    _run_se(my_index, se_fastq, ok, JaxBackend(chunk=256, small_chunk=64))

    # uniq never fits; per-table key-word budget sits between 2n (key16)
    # and 4n (u32 word0).  base is computed exactly as the backend's
    # post-prep check does (from the built DeviceTable array sizes).
    from walt_tpu.constants import get_pattern
    from walt_tpu.ops.device_index import build_device_table

    gm, _ = io_walt.read_head(my_index)
    g0, ht = io_walt.read_table(my_index + "_CT00", gm)
    n = int(ht.index.shape[0])
    dt = build_device_table(g0, ht, get_pattern("3"))
    base = (dt.pseq.nbytes + dt.counter.nbytes + dt.index.nbytes
            + dt.start_index.nbytes + dt.bucket_flagged.nbytes)
    backend = JaxBackend(chunk=256, small_chunk=64)
    # driver sets hint=2: table 1 gets (budget-reserve)/2 = base + 2.5n,
    # table 2 gets the remainder (~base + 3n) -- both fit 2n, neither 4n
    budget = 2 * base + 5 * n + backend.HBM_RESERVE
    monkeypatch.setenv("WALTX_HBM_GB", repr(budget / 2**30))
    real = device_index.build_uniq_device
    monkeypatch.setattr(
        device_index, "build_uniq_device",
        lambda *a, **kw: real(*a, **dict(kw, max_bytes=8)),
    )
    k16 = str(tmp_path / "k16.mr")
    _run_se(my_index, se_fastq, k16, backend)
    import jax.numpy as jnp

    kws = [entry[1]["key_words"] for entry in backend._tables.values()]
    assert kws and all(k.dtype == jnp.uint16 for k in kws)
    assert open(k16).read() == open(ok).read()


def test_hbm_budget_error_degrades_to_host(tmp_path, my_index, se_fastq,
                                           monkeypatch):
    """A table that cannot fit at all -> HbmBudgetError -> host path."""
    monkeypatch.setenv("WALTX_HBM_GB", "0.0001")  # ~100 KB: nothing fits
    from walt_tpu.core.backends import get_backend
    from walt_tpu.core.errors import HbmBudgetError
    from walt_tpu.core.jax_backend import JaxBackend

    backend = JaxBackend(chunk=256, small_chunk=64)
    with pytest.raises(HbmBudgetError):
        from walt_tpu.constants import get_pattern
        from walt_tpu.index import io_walt

        gm, _ = io_walt.read_head(my_index)
        g, ht = io_walt.read_table(my_index + "_CT00", gm)
        backend._device_table(g, ht, get_pattern("3"))

    # and the driver survives it (maps on host, identical output)
    ok = str(tmp_path / "ok.mr")
    _run_se(my_index, se_fastq, ok, get_backend("numpy"))
    deg = str(tmp_path / "deg.mr")
    degraded = JaxBackend(chunk=256, small_chunk=64)
    _run_se(my_index, se_fastq, deg, degraded)
    assert degraded.device_oom_batches > 0
    assert open(deg).read() == open(ok).read()
