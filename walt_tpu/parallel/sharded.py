"""Sharded mapping step: reads over ``dp``, hash table over ``tp``.

Table sharding is by contiguous bucket-key range: shard ``s`` of ``T`` owns
buckets ``[s*nb/T, (s+1)*nb/T)`` with a localized CSR (counter rebased to the
shard's first entry, index/key_words sliced and padded to the max shard
size).  A bucket lives wholly on one shard, so for a given (read, seed) at
most one shard produces candidates; the cross-shard merge is an
``all_gather`` over ``tp`` followed by a per-read stable ordering on
(seed asc, within-shard arrival order), which reproduces the examination
order of the unsharded pipeline exactly (see walt_tpu.ops.pipeline).

The packed genome is replicated (hg19: ~0.8 GB); the index + packed lookup
keys are the HBM hog (~36 GB/table for hg19), which is what ``tp`` divides.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from walt_tpu.ops import pipeline
from walt_tpu.ops.device_index import DeviceTable


@dataclasses.dataclass
class ShardedTables:
    """Per-shard stacked table arrays (leading axis = tp shards)."""

    key_base: np.ndarray  # uint32 (T,) first bucket of each shard
    counter: np.ndarray  # uint32 (T, nb/T + 1) localized CSR offsets
    index: np.ndarray  # uint32 (T, max_len) padded position slices
    key_words: np.ndarray  # uint32 (T, max_len, 3)
    bucket_flagged: np.ndarray  # uint8 bit mask (T, nb/T)
    pseq: np.ndarray  # uint32, replicated packed converted genome words
    start_index: np.ndarray  # uint32, replicated
    max_bucket_bits: int
    # word-0 run dedup (ops/device_index.build_uniq_host), localized per
    # shard: counter over runs, run key words, run start entry offsets
    uniq_counter: np.ndarray  # uint32 (T, nb/T + 1)
    uniq_words: np.ndarray  # uint32 (T, max_ulen)
    uniq_off: np.ndarray  # uint32 (T, max_ulen + 1)
    uniq_bits: int


def shard_device_table(dt: DeviceTable, n_shards: int,
                       accel: str = "uniq",
                       free_input: bool = False) -> ShardedTables:
    """Split one DeviceTable into ``n_shards`` bucket-range shards.

    ``accel`` selects the per-shard refinement structure (the tp analog of
    the single-chip HBM ladder in core/jax_backend):

    - "uniq": word-0 run index (8 bytes/run) + the stored key words.  The
      fast path searches run space; the key words are only consulted by the
      ``exact_b`` path (small ``-b``), so a word0-only ``dt.key_words`` is
      fine for default runs.
    - "key16": 16-bit prefix key table (2 bytes/entry) and NO uniq/full key
      words -- the hg19-class rung (hbm_plan: 3.1 Gbp x 2 tables need tp=4
      with key16; uniq would need tp=8).  Requires word 0 in
      ``dt.key_words``; incompatible with ``exact_b`` runs.

    ``free_input``: drop ``dt.key_words`` as soon as the accel structure is
    derived from it (12 GB of host RAM at hg19 scale, released before the
    padded shard arrays are allocated).
    """
    if dt.key_words is None:
        raise ValueError(
            "shard_device_table needs host key_words; build the table with "
            "build_device_table(..., with_key_words=True or 'word0')"
        )
    if accel not in ("uniq", "key16"):
        raise ValueError(f"unknown accel {accel!r}")
    nb = dt.counter.shape[0] - 1
    if nb % n_shards:
        raise ValueError(f"{nb} buckets not divisible by {n_shards} shards")
    nbl = nb // n_shards
    bounds = dt.counter[:: nbl][: n_shards + 1].astype(np.int64)
    max_len = max(1, int(np.diff(bounds).max()))
    # int32 entry-index invariant: the pipeline's per-device lo/hi bounds
    # and worklist slots are int32, valid only while every device-local CSR
    # holds < 2^31 entries (the reason hg19-scale tables MUST be sharded)
    pipeline.check_entry_limit(max_len, f"shard_device_table(tp={n_shards})")

    counter = np.zeros((n_shards, nbl + 1), dtype=np.uint32)
    index = np.zeros((n_shards, max_len), dtype=np.uint32)
    nw = dt.key_words.shape[1]
    if accel == "key16":
        key16_full = (dt.key_words[:, 0] >> np.uint32(16)).astype(np.uint16)
        if free_input:
            dt.key_words = None
        key_words = np.zeros((n_shards, max_len), dtype=np.uint16)
    else:
        key_words = np.zeros((n_shards, max_len, nw), dtype=np.uint32)
    flagged = np.zeros((n_shards, nbl), dtype=bool)

    from walt_tpu.ops.device_index import build_uniq_host

    if accel == "uniq":
        g_uw, g_uo, g_uc, uniq_bits = build_uniq_host(
            dt.key_words[:, 0], dt.counter
        )
        # (dt.key_words stays: the uniq-mode shard loop still copies it)
        u_bounds = g_uc[::nbl][: n_shards + 1].astype(np.int64)
        max_ulen = max(1, int(np.diff(u_bounds).max()))
    else:
        g_uw = g_uo = g_uc = None
        u_bounds = np.zeros(n_shards + 1, dtype=np.int64)
        max_ulen, uniq_bits = 1, 0
    uniq_counter = np.zeros((n_shards, nbl + 1), dtype=np.uint32)
    uniq_words = np.zeros((n_shards, max_ulen), dtype=np.uint32)
    uniq_off = np.zeros((n_shards, max_ulen + 1), dtype=np.uint32)
    for s in range(n_shards):
        a, b = int(bounds[s]), int(bounds[s + 1])
        counter[s] = dt.counter[s * nbl : (s + 1) * nbl + 1] - dt.counter[s * nbl]
        index[s, : b - a] = dt.index[a:b]
        if accel == "key16":
            key_words[s, : b - a] = key16_full[a:b]
        else:
            key_words[s, : b - a] = dt.key_words[a:b]
        flagged[s] = dt.bucket_flagged[s * nbl : (s + 1) * nbl]
        if accel != "uniq":
            continue
        au, bu = int(u_bounds[s]), int(u_bounds[s + 1])
        uniq_counter[s] = g_uc[s * nbl : (s + 1) * nbl + 1] - np.uint32(au)
        uniq_words[s, : bu - au] = g_uw[au:bu]
        # run starts rebased to the shard's first entry; g_uo[bu] is the
        # next shard's first entry == this shard's entry count
        uniq_off[s, : bu - au + 1] = g_uo[au : bu + 1] - np.uint32(a)
    return ShardedTables(
        key_base=(np.arange(n_shards, dtype=np.uint32) * np.uint32(nbl)),
        counter=counter,
        index=index,
        key_words=key_words,
        bucket_flagged=flagged,
        pseq=dt.pseq,
        start_index=dt.start_index,
        max_bucket_bits=dt.max_bucket_bits,
        uniq_counter=uniq_counter,
        uniq_words=uniq_words,
        uniq_off=uniq_off,
        uniq_bits=uniq_bits,
    )


def _place_rows(mesh: Mesh, slices, max_len: int, dtype,
                tail_shape=()) -> jax.Array:
    """Place a (T, max_len, *tail) P('tp')-sharded array one ROW at a time.

    ``slices``: T host arrays (row t's first ``len(slices[t])`` entries;
    the rest is zero padding).  Materializes only one padded row (plus its
    device copy) at a time instead of the whole (T, max_len) host array --
    at hg19 scale the difference is ~18 GB of peak RSS per array.
    """
    from jax.sharding import NamedSharding

    T = len(slices)
    shape = (T, max_len) + tail_shape
    sh = NamedSharding(mesh, P("tp", *([None] * (len(shape) - 1))))
    grid = mesh.devices  # (dp, tp)
    assert grid.shape[1] == T, "one row per tp shard"
    bufs = []
    for t in range(T):
        row = np.zeros((1, max_len) + tail_shape, dtype=dtype)
        n = slices[t].shape[0]
        row[0, :n] = slices[t]
        for d in range(grid.shape[0]):  # dp-replicated copies
            bufs.append(jax.device_put(row, grid[d, t]))
        del row
    out = jax.make_array_from_single_device_arrays(shape, sh, bufs)
    jax.block_until_ready(out)
    return out


def shard_and_place(dt: DeviceTable, mesh: Mesh, accel: str = "uniq",
                    free_input: bool = True):
    """Shard one DeviceTable over the mesh's tp axis with bounded peak RSS.

    Functional equivalent of ``shard_device_table`` + ``place_sharded_table``
    (same bucket-range layout, same dev dict), but the multi-GB arrays
    (index, key words, uniq runs) are placed one shard-row at a time so the
    host never holds a full padded (T, max_len) copy next to its device
    buffers -- the difference between fitting and OOM for hg19-scale tables
    on a single-host virtual mesh.  Returns (dev dict, uniq_bits).
    """
    from jax.sharding import NamedSharding

    if dt.key_words is None:
        raise ValueError("shard_and_place needs host key_words")
    if accel not in ("uniq", "key16"):
        raise ValueError(f"unknown accel {accel!r}")
    tp = int(mesh.shape["tp"])
    nb = dt.counter.shape[0] - 1
    if nb % tp:
        raise ValueError(f"{nb} buckets not divisible by {tp} shards")
    nbl = nb // tp
    bounds = dt.counter[::nbl][: tp + 1].astype(np.int64)
    max_len = max(1, int(np.diff(bounds).max()))
    pipeline.check_entry_limit(max_len, f"shard_and_place(tp={tp})")

    def rows(full):
        for s in range(tp):
            a, b = int(bounds[s]), int(bounds[s + 1])
            yield full[a:b]

    dev = {}
    rep = NamedSharding(mesh, P())
    dev["pseq"] = jax.device_put(jnp.asarray(dt.pseq), rep)
    dev["start_index"] = jax.device_put(jnp.asarray(dt.start_index), rep)
    dev["key_base"] = jax.device_put(
        jnp.asarray(np.arange(tp, dtype=np.uint32) * np.uint32(nbl)),
        NamedSharding(mesh, P("tp")),
    )
    counter = np.stack([
        dt.counter[s * nbl : (s + 1) * nbl + 1] - dt.counter[s * nbl]
        for s in range(tp)
    ])
    dev["counter"] = jax.device_put(
        jnp.asarray(counter), NamedSharding(mesh, P("tp", None))
    )
    del counter
    dev["bucket_flagged"] = jax.device_put(
        jnp.asarray(dt.bucket_flagged.reshape(tp, nbl)),
        NamedSharding(mesh, P("tp", None)),
    )

    if accel == "key16":
        key16_full = (dt.key_words[:, 0] >> np.uint32(16)).astype(np.uint16)
        if free_input:
            dt.key_words = None
        dev["index"] = _place_rows(mesh, list(rows(dt.index)), max_len,
                                   np.uint32)
        dev["key_words"] = _place_rows(mesh, list(rows(key16_full)), max_len,
                                       np.uint16)
        del key16_full
        uniq_bits = 0
        for k, dt_ in (("uniq_counter", np.uint32), ("uniq_words", np.uint32),
                       ("uniq_off", np.uint32)):
            dev[k] = jax.device_put(
                jnp.zeros((tp, 2), dtype=dt_),
                NamedSharding(mesh, P("tp", None)),
            )
    else:
        from walt_tpu.ops.device_index import build_uniq_host

        nw = dt.key_words.shape[1]
        g_uw, g_uo, g_uc, uniq_bits = build_uniq_host(
            dt.key_words[:, 0], dt.counter
        )
        dev["index"] = _place_rows(mesh, list(rows(dt.index)), max_len,
                                   np.uint32)
        dev["key_words"] = _place_rows(
            mesh,
            [dt.key_words[int(bounds[s]) : int(bounds[s + 1])]
             for s in range(tp)],
            max_len, np.uint32, tail_shape=(nw,),
        )
        if free_input:
            dt.key_words = None
        u_bounds = g_uc[::nbl][: tp + 1].astype(np.int64)
        max_ulen = max(1, int(np.diff(u_bounds).max()))
        uc = np.stack([
            g_uc[s * nbl : (s + 1) * nbl + 1]
            - np.uint32(int(u_bounds[s]))
            for s in range(tp)
        ])
        dev["uniq_counter"] = jax.device_put(
            jnp.asarray(uc), NamedSharding(mesh, P("tp", None))
        )
        del uc
        dev["uniq_words"] = _place_rows(
            mesh,
            [g_uw[int(u_bounds[s]) : int(u_bounds[s + 1])]
             for s in range(tp)],
            max_ulen, np.uint32,
        )
        # run starts rebased to the shard's first entry; the slice runs one
        # past the shard's last run (the next shard's first entry == this
        # shard's entry count)
        dev["uniq_off"] = _place_rows(
            mesh,
            [g_uo[int(u_bounds[s]) : int(u_bounds[s + 1]) + 1]
             - np.uint32(int(bounds[s]))
             for s in range(tp)],
            max_ulen + 1, np.uint32,
        )
    return dev, uniq_bits


def make_mesh(devices=None, tp: int | None = None) -> Mesh:
    """A ('dp', 'tp') mesh over the given (default: all) devices."""
    devices = list(jax.devices() if devices is None else devices)
    n = len(devices)
    if tp is None:
        tp = 2 if n % 2 == 0 and n > 1 else 1
    return Mesh(np.asarray(devices).reshape(n // tp, tp), ("dp", "tp"))


_MAX_SHIFT = 8  # seed shifts are < pattern_len <= 7 for patterns 3/5/7


def _merge_tp(cs, cp, cm, fb, cand_slab: int, n_seeds: int = _MAX_SHIFT):
    """Merge per-tp-shard candidate slabs back into reference order.

    Inside a shard_map body with a 'tp' axis: all_gather the (B_l, C) slabs
    from every table shard and re-order per read on (seed asc, shard asc,
    within-shard arrival order).  A bucket lives wholly on one shard, so
    for a given (read, seed) at most one shard contributes and the merged
    order equals the unsharded pipeline's examination order exactly.

    Each shard's slab is already seed-major ordered, so the merge is a
    seed-GROUP CONCATENATION, computed with rank arithmetic + one scatter:
    dest(slot t,j) = (candidates of smaller seeds, all shards)
                   + (same-seed candidates of earlier shards)
                   + (within-shard rank inside the seed group).
    The previous argsort formulation cost 58% of the whole tp=2 device
    program (SCALING.json round 3, tp_merge_share).
    """
    cs_g = jax.lax.all_gather(cs, "tp")  # (T, B_l, C)
    cp_g = jax.lax.all_gather(cp, "tp")
    cm_g = jax.lax.all_gather(cm, "tp")
    fb_any = jax.lax.all_gather(fb, "tp").any(axis=0)
    return merge_gathered(cs_g, cp_g, cm_g, fb_any, cand_slab, n_seeds)


def merge_gathered(cs_g, cp_g, cm_g, fb_any, cand_slab: int,
                   n_seeds: int = _MAX_SHIFT):
    """Post-all_gather merge math of :func:`_merge_tp` (factored so the
    exact production trace can be compiled standalone)."""
    Bl = cs_g.shape[1]
    C = cand_slab
    valid = cs_g >= 0  # (T, Bl, C)
    seeds = jnp.clip(cs_g.astype(jnp.int32), 0, n_seeds - 1)
    onehot = (
        (jnp.arange(n_seeds, dtype=jnp.int32)[None, None, None, :]
         == seeds[..., None])
        & valid[..., None]
    )
    c_ts = jnp.sum(onehot, axis=2, dtype=jnp.int32)  # (T, Bl, S)
    # within-shard exclusive seed-group starts, gathered per slot
    off_ts = jnp.cumsum(c_ts, axis=-1) - c_ts
    off_slot = jnp.take_along_axis(off_ts, seeds, axis=2)  # (T, Bl, C)
    rank = jnp.arange(C, dtype=jnp.int32)[None, None, :] - off_slot
    # global exclusive base: smaller seeds across ALL shards, plus the
    # same seed on earlier shards (vacuous when buckets are disjoint,
    # kept for safety)
    tot_s = jnp.sum(c_ts, axis=0)  # (Bl, S)
    g_s = jnp.cumsum(tot_s, axis=-1) - tot_s
    prior_t = jnp.cumsum(c_ts, axis=0) - c_ts  # (T, Bl, S)
    base_slot = jnp.take_along_axis(g_s[None] + prior_t, seeds, axis=2)
    dest = jnp.where(valid, base_slot + rank, C)  # >= C drops

    b_idx = jnp.broadcast_to(jnp.arange(Bl, dtype=jnp.int32)[None, :, None],
                             dest.shape)
    m_seed = jnp.full((Bl, C), -1, dtype=cs_g.dtype).at[b_idx, dest].set(
        cs_g, mode="drop")
    m_pos = jnp.zeros((Bl, C), dtype=cp_g.dtype).at[b_idx, dest].set(
        cp_g, mode="drop")
    m_mm = jnp.zeros((Bl, C), dtype=cm_g.dtype).at[b_idx, dest].set(
        cm_g, mode="drop")
    total = jnp.sum(valid, axis=(0, 2), dtype=jnp.int32)
    fb_any = fb_any | (total > C)
    return m_seed, m_pos, m_mm, jnp.minimum(total, C), fb_any


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "pattern_name", "ag_wildcard", "search_bits",
                     "verify_slab", "cand_slab", "seeds", "wl_factor",
                     "exact_b", "uniq_bits", "full_mask"),
)
def map_strand_sharded(preads, lens, b, max_mm, key_base, counter, index,
                       key_words, bucket_flagged, pseq, start_index, *,
                       mesh: Mesh, pattern_name: str, ag_wildcard: bool,
                       search_bits: int,
                       verify_slab: int = pipeline.VERIFY_SLAB,
                       cand_slab: int = pipeline.CAND_SLAB,
                       seeds: tuple | None = None,
                       wl_factor: int = pipeline.WL_FACTOR,
                       exact_b: bool = False,
                       uniq_counter=None, uniq_words=None, uniq_off=None,
                       uniq_bits: int = 0, full_mask: bool = False):
    """Sharded equivalent of ``map_strand_device``.

    preads: (B, W) uint32 packed reads; B must divide by the ``dp`` size.
    Table args come from a ShardedTables whose T equals the ``tp`` size.
    Returns the same (cand_seed, cand_pos, cand_mm, cand_cnt, fallback).
    """
    have_uniq = uniq_words is not None

    def body(preads, lens, b, max_mm, key_base, counter, index, key_words,
             bucket_flagged, pseq, start_index, uniq_counter, uniq_words,
             uniq_off):
        cs, cp, cm, cc, fb = pipeline.map_strand_core(
            preads, lens, b, max_mm, pseq, counter[0], index[0], key_words[0],
            start_index, bucket_flagged[0], pattern_name=pattern_name,
            ag_wildcard=ag_wildcard, search_bits=search_bits,
            verify_slab=verify_slab, cand_slab=cand_slab,
            key_base=key_base[0], seeds=seeds, wl_factor=wl_factor,
            exact_b=exact_b,
            uniq_counter=uniq_counter[0] if have_uniq else None,
            uniq_words=uniq_words[0] if have_uniq else None,
            uniq_off=uniq_off[0] if have_uniq else None,
            uniq_bits=uniq_bits, full_mask=full_mask,
            tp_route=int(mesh.shape["tp"]),
        )
        from walt_tpu.constants import get_pattern

        return _merge_tp(cs, cp, cm, fb, cand_slab,
                         get_pattern(pattern_name).pattern_len)

    uspec = P("tp") if have_uniq else P()
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("dp"), P("dp"), P(), P(),  # reads, lens, b, max_mm
            P("tp"), P("tp"), P("tp"), P("tp"), P("tp"),  # table shards
            P(), P(),  # seq, start_index replicated
            uspec, uspec, uspec,
        ),
        out_specs=(P("dp"), P("dp"), P("dp"), P("dp"), P("dp")),
        check_vma=False,
    )(preads, lens, b, max_mm, key_base, counter, index, key_words,
      bucket_flagged, pseq, start_index, uniq_counter, uniq_words, uniq_off)


#: pytree spec of one sharded table dict, as passed to the fused SE step
_TABLE_SPEC = dict(
    key_base=P("tp"), counter=P("tp"), index=P("tp"), key_words=P("tp"),
    bucket_flagged=P("tp"), pseq=P(), start_index=P(),
    uniq_counter=P("tp"), uniq_words=P("tp"), uniq_off=P("tp"),
)


def _uniq_kw(t: dict) -> dict:
    """Per-shard uniq arrays of one sharded table dict (or Nones)."""
    out = {}
    for k in ("uniq_words", "uniq_off", "uniq_counter"):
        v = t.get(k)
        out[k] = v[0] if v is not None else None
    return out


def place_sharded_table(st: ShardedTables, mesh: Mesh,
                        free_host: bool = False) -> dict:
    """Device-put one ShardedTables onto the mesh (tp-sharded + replicated).

    Returns the dict consumed by :func:`map_single_end_sharded` /
    :func:`map_strand_sharded` (key_base/counter/index/key_words/
    bucket_flagged sharded over tp; pseq/start_index replicated).

    ``free_host``: drop each host array from ``st`` right after its device
    copy lands, so peak RSS holds at most one array twice (the sharded
    index alone is ~12 GB at hg19 scale).
    """
    from jax.sharding import NamedSharding

    out = {}
    for name, spec in _TABLE_SPEC.items():
        out[name] = jax.device_put(
            jnp.asarray(getattr(st, name)), NamedSharding(mesh, spec)
        )
        if free_host:
            jax.block_until_ready(out[name])
            setattr(st, name, None)
    return out


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "pattern_name", "ag_wildcard", "search_bits",
                     "verify_slab", "cand_slab", "seeds", "wl_factor",
                     "exact_b", "uniq_bits", "full_mask"),
)
def map_single_end_sharded(preads, lens, b, max_mm, tables, *, mesh: Mesh,
                           pattern_name: str, ag_wildcard: bool,
                           search_bits: tuple,
                           verify_slab: int = pipeline.VERIFY_SLAB,
                           cand_slab: int = pipeline.CAND_SLAB,
                           seeds: tuple | None = None,
                           wl_factor: int = pipeline.WL_FACTOR,
                           exact_b: bool = False,
                           uniq_bits: tuple = (0, 0),
                           full_mask: bool = False):
    """Sharded equivalent of ``se_fold.map_single_end_device``.

    One XLA program over the ('dp','tp') mesh: each of the two strand
    tables is mapped against its tp shards, candidate slabs are merged back
    into examination order with an all_gather over tp, and the per-read
    BestMatch fold runs dp-locally.  This is the production multi-chip
    replacement for the reference's OpenMP read fan-out
    (src/walt/mapping.cpp:477-499).

    ``tables``: tuple of two dicts from :func:`place_sharded_table`
    ('+' strand table first).  Returns the (B, 3) packed result of
    ``se_fold`` semantics, sharded over dp.
    """
    from walt_tpu.constants import get_pattern
    from walt_tpu.ops import se_fold

    pattern = get_pattern(pattern_name)

    def body(preads, lens, b, max_mm, tables):
        summaries = []
        fallback = None
        for t, bits, ubits in zip(tables, search_bits, uniq_bits):
            cs, cp, cm, cc, fb = pipeline.map_strand_core(
                preads, lens, b, max_mm, t["pseq"], t["counter"][0],
                t["index"][0], t["key_words"][0], t["start_index"],
                t["bucket_flagged"][0], pattern_name=pattern_name,
                ag_wildcard=ag_wildcard, search_bits=bits,
                verify_slab=verify_slab, cand_slab=cand_slab,
                key_base=t["key_base"][0], seeds=seeds, wl_factor=wl_factor,
                exact_b=exact_b, uniq_bits=ubits, full_mask=full_mask,
                tp_route=int(mesh.shape["tp"]), **_uniq_kw(t),
            )
            # tp exchange is SUMMARIES, not slabs: a (read, seed) bucket
            # lives wholly on one shard, so the BestMatch fold only needs
            # each shard's per-segment (seg_min, transitions, first/last
            # position, has) -- five (B_l, S) arrays and a select-combine.
            # The full-slab merge (_merge_tp) would scatter (T, B_l, C)
            # slabs instead.
            summ = se_fold.segment_summaries(cs, cp, cm, pattern)
            gathered = {
                k: jax.lax.all_gather(v, "tp") for k, v in summ.items()
            }
            summaries.append(se_fold.combine_summaries(
                [{k: v[i] for k, v in gathered.items()}
                 for i in range(gathered["has"].shape[0])]
            ))
            fb_any = jax.lax.all_gather(fb, "tp").any(axis=0)
            fallback = fb_any if fallback is None else (fallback | fb_any)
        pos, times, minus, mm = se_fold.fold_summaries(
            summaries, max_mm, pattern
        )
        flags = (
            (mm.astype(jnp.uint32) << 2)
            | (minus.astype(jnp.uint32) << 1)
            | fallback.astype(jnp.uint32)
        )
        return jnp.stack([pos, times.astype(jnp.uint32), flags], axis=1)

    spec = {k: _TABLE_SPEC[k] for k in tables[0]}
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P(), P(), (spec, spec)),
        out_specs=P("dp"),
        check_vma=False,
    )(preads, lens, b, max_mm, tables)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "pattern_name", "ag_wildcard", "search_bits",
                     "verify_slab", "cand_slab", "wl_factor", "exact_b",
                     "flat_factor", "uniq_bits", "full_mask"),
)
def map_mate_sharded(preads, lens, b, max_mm, tables, *, mesh: Mesh,
                     pattern_name: str, ag_wildcard: bool,
                     search_bits: tuple,
                     verify_slab: int = pipeline.VERIFY_SLAB_T1,
                     cand_slab: int = pipeline.CAND_SLAB,
                     wl_factor: int = pipeline.WL_FACTOR,
                     exact_b: bool = False, flat_factor: int = 8,
                     uniq_bits: tuple = (0, 0), full_mask: bool = False):
    """Sharded equivalent of ``pe_map.map_mate_device``.

    The tp exchange is FLAT STREAMS, not candidate slabs: each tp shard
    flat-compacts its own (strand '+', strand '-') slabs locally -- a
    (read, seed) bucket lives wholly on one shard, so the union of the
    shard streams IS the candidate set -- and the all_gather moves
    ~16-40 B/read of compacted stream per shard instead of (T, B_l, C)
    padded slabs.  The stream gather replaces the slab merge's
    (``_merge_tp``) scatter entirely and the examination-
    order interleave (seed asc across shards) moves to the host decode
    (jax_backend._decode_mate), where it is a numpy lexsort over the ~2-4
    real candidates/read.

    Returns (meta (T, B) uint32, flat (T, dp*M_l, 2) uint32) where row t is
    shard t's dp-segmented stream (M_l = flat_factor * B/dp rows per dp
    segment), exactly the per-shard layout of the single-device program.
    """

    def body(preads, lens, b, max_mm, tables):
        from walt_tpu.ops import pe_map

        wls, cnts = [], []
        fallback = None
        for t, bits, ubits in zip(tables, search_bits, uniq_bits):
            wl, cnt, fb = pipeline.map_strand_core(
                preads, lens, b, max_mm, t["pseq"], t["counter"][0],
                t["index"][0], t["key_words"][0], t["start_index"],
                t["bucket_flagged"][0], pattern_name=pattern_name,
                ag_wildcard=ag_wildcard, search_bits=bits,
                verify_slab=verify_slab, cand_slab=cand_slab,
                key_base=t["key_base"][0], wl_factor=wl_factor,
                exact_b=exact_b, uniq_bits=ubits, full_mask=full_mask,
                tp_route=int(mesh.shape["tp"]), emit_wl=True,
                **_uniq_kw(t),
            )
            wls.append(wl)
            cnts.append(cnt)
            fallback = fb if fallback is None else (fallback | fb)
        meta_l, flat_l = pe_map.flat_from_wl(wls, cnts, fallback,
                                             flat_factor, cand_slab)
        return (jax.lax.all_gather(meta_l, "tp"),
                jax.lax.all_gather(flat_l, "tp"))

    spec = {k: _TABLE_SPEC[k] for k in tables[0]}
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("dp"), P("dp"), P(), P(), (spec, spec)),
        out_specs=(P(None, "dp"), P(None, "dp", None)),
        check_vma=False,
    )(preads, lens, b, max_mm, tables)
