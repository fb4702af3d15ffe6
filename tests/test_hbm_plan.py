"""Device-memory capacity planning on an H100 budget.

H100 is the allocator's ``bytes_limit`` on an NVIDIA H100 80GB HBM3 with
JAX's default 75% memory fraction (63,763,120,128 B = 59.38 GiB); minus
HBM_RESERVE (2 GiB) the tables get 57.38 GiB per card.  Per table of n bp
(hbm_plan.table_bytes): base = n/4 + 4n + 2 * 4 * 4^12 bytes, uniq =
8 * 0.93n + 4 * (4^12 + 1), key16 = 2n.
"""

from walt_tpu.hbm_plan import HBM_RESERVE, plan_tables, table_bytes

G = 1 << 30
H100 = 63_763_120_128
BUDGET = H100 - HBM_RESERVE


def test_bench_se_large_fits_one_chip_with_uniq():
    # 2 x (2.10 + 3.61) GiB = 11.43 GiB
    p = plan_tables(512_000_000, 2, H100, uniq_ratio=0.93)
    assert p.tp == 1 and p.uniq
    assert p.fits() and p.hbm_bytes - p.reserve == BUDGET
    assert abs(p.per_table_base / G - 2.10) < 0.05
    assert abs(p.per_table_accel / G - 3.61) < 0.1


def test_bench_se_xl_768M_fits_one_chip_key16():
    """768 Mbp SE fits one card; on an H100 budget even with the uniq
    index: 2 x (3.12 + 5.38) GiB = 17.00 GiB <= 57.38 GiB, so the key16
    rung is not needed."""
    p = plan_tables(768_000_000, 2, H100, uniq_ratio=0.93)
    assert p.tp == 1 and p.uniq
    assert p.fits()
    assert abs(p.per_chip_bytes / G - 17.00) < 0.05


def test_one_gbp_needs_two_chips():
    """1 Gbp x 2 tables: one H100 holds it with the uniq index
    (2 x (4.04 + 6.99) GiB = 22.06 GiB).  Two cards are needed only below
    the one-card key16 size, 2 x (4.04 + 1.86) = 11.80 GiB: with 10 GiB of
    budget tp=2 holds 2 x 0.23 + 2 x (3.80 + 1.86) / 2 = 6.13 GiB."""
    p = plan_tables(1_000_000_000, 2, H100, uniq_ratio=0.93)
    assert p.tp == 1 and p.uniq
    assert abs(p.per_chip_bytes / G - 22.06) < 0.05
    small = plan_tables(1_000_000_000, 2, 10 * G + HBM_RESERVE,
                        uniq_ratio=0.93)
    assert small.tp == 2 and not small.uniq and small.fits()
    assert abs(small.per_chip_bytes / G - 6.13) < 0.05


def test_hg19_se_plan():
    """hg19 (3.1 Gbp) SE: uniq needs 2 x (12.35 + 21.5) GiB > 57.38, so
    one card takes key16 prefix tables: 2 x (12.35 + 5.77) = 36.24 GiB."""
    p = plan_tables(3_100_000_000, 2, H100, uniq_ratio=0.93)
    assert p.tp == 1 and not p.uniq
    assert p.fits()
    assert abs(p.per_chip_bytes / G - 36.24) < 0.05
    base, _, kw16 = table_bytes(3_100_000_000)
    assert abs(base / G - 12.35) < 0.1      # pseq+counter+index+flags
    assert abs(kw16 / G - 5.77) < 0.1       # 2 bytes/entry key16 prefix


def test_hg19_pe_plan():
    """hg19 PE (4 resident tables): key16 at tp=1 needs 72.5 GiB; tp=2
    keeps the four packed genomes replicated (4 x 0.72 GiB) and halves the
    rest: 2.89 + 4 x (11.63 + 5.77) / 2 = 37.69 GiB per card."""
    p = plan_tables(3_100_000_000, 4, H100, uniq_ratio=0.93)
    assert p.tp == 2 and not p.uniq
    assert p.fits()
    assert abs(p.per_chip_bytes / G - 37.69) < 0.05


def test_small_b_needs_full_key_words():
    """-b below the verify slabs adds 12n bytes of 3-word key tables per
    table: 2 x (2.10 + 3.61 + 5.72) GiB = 22.87 GiB, still one card."""
    p = plan_tables(512_000_000, 2, H100, uniq_ratio=0.93, b_small=True)
    assert p.key_words == 3
    assert p.tp == 1 and p.uniq
    assert abs(p.per_chip_bytes / G - 22.87) < 0.05
