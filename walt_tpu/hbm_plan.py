"""Device-memory table planning: what fits on a card, and how hg19 deploys.

The reference documents its host-RAM model for hg19 (~15 GB SE / ~17 GB PE,
README.md:135-152) and streams tables from disk per batch
(mapping.cpp:491-492).  This design keeps tables DEVICE-resident, so the
planning question becomes: given a genome size and a card's memory, how
many cards (tp width) and which per-table acceleration structures (uniq run
index, packed key words) fit?

:func:`plan_tables` is the calculator; :class:`TablePlan` the result.  The
runtime ladder in ``core/jax_backend._build_single_device_table`` makes the
same choices dynamically (with the real post-count uniq size); this module
is the ahead-of-time view used for capacity decisions and asserted by
``tests/test_hbm_plan.py``.

Byte model per converted-genome table (n = genome_bp entries, u32
positions; reference.cpp:302-322 is the on-disk equivalent):

- packed genome ``pseq``: n/4 bytes (2-bit codes, 16/word) -- replicated
  across tp shards (every shard verifies windows anywhere in the genome)
- CSR ``counter``: 4 * (4^12 + 1) bytes -- tp-sharded by bucket range
- ``index``: 4n bytes -- tp-sharded
- uniq run index: 8U + 67 MB, U = word-0 runs (U/n is about 0.93 on the
  512 Mbp repeat-structured genome; worst case 1.0) -- tp-sharded
- key16 prefix table: 2n (the top 8 cared bases of word 0; the window
  cared check verifies the rest) or 12n full key words (only needed when
  -b < verify slab) -- tp-sharded; not needed when the uniq index is built

:data:`HBM_RESERVE` is kept free on each card for the mapping working set
(read chunks, worklists, gather windows, XLA temporaries, allocator
fragmentation) on top of the resident tables.
"""

from __future__ import annotations

import dataclasses

NB1 = 4**12 + 1  # CSR counter entries (pattern 3 key weight 12)

#: device bytes kept free for the mapping working set (see module docstring):
#: the largest working set measured on an H100 (peak_bytes_in_use minus the
#: resident tables: 1.22 GiB for PE, 1.19 GiB for SE, 256 Mbp genome,
#: 131072-read chunks; PERF.md) plus a 0.78 GiB margin for allocator
#: fragmentation and the uniq build's chunk temporaries on larger tables
HBM_RESERVE = 2 << 30


@dataclasses.dataclass
class TablePlan:
    genome_bp: int
    n_tables: int          # resident tables (2 SE, 4 PE)
    tp: int                # table shards (chips) the plan needs
    uniq: bool             # word-0 run index built?
    key_words: int         # packed key words stored (0 when uniq)
    per_table_base: int    # bytes: pseq + counter + index + flags
    per_table_accel: int   # bytes: uniq or key words
    per_chip_bytes: int    # resident bytes on each chip
    hbm_bytes: int
    reserve: int

    def fits(self) -> bool:
        return self.per_chip_bytes <= self.hbm_bytes - self.reserve


def table_bytes(genome_bp: int, uniq_ratio: float = 1.0):
    """(base, uniq, key16) byte sizes for one table."""
    n = genome_bp
    pseq = n // 4 + 272  # + packed tail words
    counter = 4 * NB1
    index = 4 * n
    flagged = NB1 - 1
    base = pseq + counter + index + flagged
    uniq = int(8 * n * uniq_ratio) + 4 * NB1
    kw16 = 2 * n
    return base, uniq, kw16


def plan_tables(genome_bp: int, n_tables: int, hbm_bytes: int,
                reserve: int = HBM_RESERVE, uniq_ratio: float = 1.0,
                b_small: bool = False, max_tp: int = 64) -> TablePlan:
    """Smallest tp width (power of two) that fits, preferring uniq.

    ``hbm_bytes``: the card's device-memory budget (what its allocator
    reports as ``bytes_limit``).

    ``b_small``: the run uses -b below the verify slabs, so the exact_b
    path needs all 3 packed key words (12n/table) regardless of uniq.
    """
    base, uniq, kw16 = table_bytes(genome_bp, uniq_ratio)
    budget = hbm_bytes - reserve
    pseq = genome_bp // 4 + 272
    repl = n_tables * pseq  # replicated on every shard
    # -b below the verify slabs additionally needs the full 3-word (12n)
    # key tables for the exact_b path
    extra_kw = 12 * genome_bp if b_small else 0

    tp = 1
    while tp <= max_tp:
        shardable_uniq = n_tables * (base - pseq + uniq + extra_kw)
        shardable_kw16 = n_tables * (base - pseq + kw16 + extra_kw)
        per_chip_uniq = repl + shardable_uniq // tp
        per_chip_kw16 = repl + shardable_kw16 // tp
        if per_chip_uniq <= budget:
            return TablePlan(genome_bp, n_tables, tp, True, 3 if b_small else 0,
                             base, uniq, per_chip_uniq, hbm_bytes, reserve)
        if per_chip_kw16 <= budget:
            return TablePlan(genome_bp, n_tables, tp, False,
                             3 if b_small else 1, base, kw16,
                             per_chip_kw16, hbm_bytes, reserve)
        tp *= 2
    raise ValueError(
        f"{genome_bp} bp x {n_tables} tables does not fit {max_tp} shards"
    )


def describe(plan: TablePlan) -> str:
    g = 1 << 30
    return (
        f"{plan.genome_bp / 1e9:.2f} Gbp x {plan.n_tables} tables: "
        f"tp={plan.tp}, {'uniq run index' if plan.uniq else 'key16 prefix'}, "
        f"base {plan.per_table_base / g:.2f} GB + accel "
        f"{plan.per_table_accel / g:.2f} GB per table, "
        f"{plan.per_chip_bytes / g:.2f} GB/chip of "
        f"{(plan.hbm_bytes - plan.reserve) / g:.2f} GB budget"
    )


if __name__ == "__main__":
    import sys

    hbm = int(float(sys.argv[1]) * (1 << 30)) if len(sys.argv) > 1 else None
    if hbm is None:
        raise SystemExit("usage: python -m walt_tpu.hbm_plan <card GiB>")
    for bp, nt, label in ((512_000_000, 2, "bench se_large"),
                          (768_000_000, 2, "bench se_xl"),
                          (3_100_000_000, 2, "hg19 SE"),
                          (3_100_000_000, 4, "hg19 PE")):
        print(f"{label:>14}: "
              f"{describe(plan_tables(bp, nt, hbm, uniq_ratio=0.93))}")
