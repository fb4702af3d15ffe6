"""The verify formulation (packing.verify_words): aligned genome window,
XOR, 2-bit OR-fold and popcount under the read-length mask, against a
per-base numpy mismatch count, and end to end against the numpy backend."""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest

from walt_tpu.ops import packing


def _case(rng, M, W, genome_bp=4096):
    genome = rng.integers(0, 4, genome_bp, dtype=np.uint8)
    pseq = packing.pack_genome_np(genome)
    gpos = rng.integers(0, genome_bp - 16 * W, M).astype(np.uint32)
    reads = rng.integers(0, 4, (M, 16 * W), dtype=np.uint8)
    # most reads copy their window with a few substitutions
    for m in range(M):
        if m % 4:
            reads[m] = genome[gpos[m]:gpos[m] + 16 * W]
            sub = rng.random(16 * W) < 0.05
            reads[m, sub] = (reads[m, sub] + 1) % 4
    lens = rng.integers(1, 16 * W + 1, M).astype(np.int32)
    return genome, pseq, gpos, reads, lens


def _per_base(genome, gpos, reads, lens):
    out = np.zeros(len(lens), dtype=np.int32)
    for m, (g, n) in enumerate(zip(gpos, lens)):
        out[m] = int(np.sum(genome[g:g + n] != reads[m, :n]))
    return out


@pytest.mark.parametrize("M,W", [(384, 7), (5, 3), (64, 13), (1000, 9)])
def test_verify_words_matches_per_base_count(M, W):
    rng = np.random.default_rng(42 + M)
    genome, pseq, gpos, reads, lens = _case(rng, M, W)
    conv = packing.pack_codes_np(reads)
    lane = packing.len_lane_masks(jnp.asarray(lens), W)
    mm, win = packing.verify_words(jnp.asarray(pseq), jnp.asarray(gpos),
                                   jnp.asarray(conv), lane, W)
    np.testing.assert_array_equal(np.asarray(mm),
                                  _per_base(genome, gpos, reads, lens))
    # the window is the genome's own bases at gpos, packed
    want = packing.pack_codes_np(
        np.stack([genome[g:g + 16 * W] for g in gpos]))
    np.testing.assert_array_equal(np.asarray(win), want)


def test_verify_end_to_end_matches_numpy_backend(tmp_path, my_index,
                                                 se_fastq):
    """The SE driver on the device program equals the exact host path."""
    from walt_tpu.core.backends import get_backend
    from walt_tpu.core.single_end import process_single_end

    outs = []
    for name in ("numpy", "jax"):
        out = str(tmp_path / f"{name}.mr")
        open(out, "w").close()
        open(out + ".mapstats", "w").close()
        process_single_end(my_index, se_fastq, out, max_mismatches=6,
                           backend=get_backend(name))
        outs.append(out)
    for suf in ("", ".mapstats"):
        assert filecmp.cmp(outs[0] + suf, outs[1] + suf, shallow=False)
