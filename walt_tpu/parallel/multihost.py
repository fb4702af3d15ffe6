"""Multi-host execution glue: process init, input sharding, stats merge.

The reference is strictly single-process (SURVEY.md section 2.3: no
MPI/sockets anywhere).  The multi-host equivalent runs one waltx process
per host: `jax.distributed` provides the coordination
plane, read FILES are data-parallel round-robin across processes (the
mapper's per-file loop, walt.cpp:254-270, is embarrassingly parallel and
file-granular sharding keeps every output byte-identical to a single-host
run of the same file), and each host maps its files against its local
devices (optionally tp-sharding the index across them, see
walt_tpu.parallel.sharded).

For workloads that arrive as one giant FASTQ, split it (any record-aligned
splitter) and pass the parts as a comma list -- each part's MR/SAM output
is then bit-reproducible independent of host count.  ``merge_mapstats``
folds the per-part `.mapstats` files into one, byte-formatted like a
single run's.
"""

from __future__ import annotations

import re


def initialize(**kwargs) -> tuple:
    """jax.distributed.initialize passthrough (idempotent).

    Pass coordinator_address/num_processes/process_id or set
    WALTX_COORDINATOR / WALTX_NUM_HOSTS / WALTX_HOST_ID.  Returns
    (process_index, process_count).
    """
    import os

    import jax

    if not kwargs and os.environ.get("WALTX_COORDINATOR"):
        kwargs = dict(
            coordinator_address=os.environ["WALTX_COORDINATOR"],
            num_processes=int(os.environ["WALTX_NUM_HOSTS"]),
            process_id=int(os.environ["WALTX_HOST_ID"]),
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # already initialized, or single-process with no coordinator in the
        # environment -- jax.process_* then report the 1-process defaults
        pass
    return jax.process_index(), jax.process_count()


def shard_round_robin(items: list, pid: int, n: int) -> list:
    """This process's share of a work list (file-granular data parallism)."""
    return list(items[pid::n])


def barrier(name: str = "waltx") -> None:
    """Block until every process reaches this point (no-op single-process)."""
    import jax

    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)


_INT_LINE = re.compile(r"^(\s*)([a-z_0-9]+): (-?[\d.]+(?:e[+-]?\d+)?|-?nan|-?inf)$")


def _parse_mapstats(text: str) -> list:
    """[(indent, key, value_str)] per line; non-numeric lines kept verbatim."""
    out = []
    for line in text.rstrip("\n").split("\n"):
        m = _INT_LINE.match(line)
        if m:
            out.append((m.group(1), m.group(2), m.group(3)))
        else:
            out.append(line)
    return out


def merge_mapstats(paths: list, out_path: str) -> None:
    """Sum N single-run `.mapstats` files into one, byte-formatted the same.

    Counter lines (total_reads, unique, ambiguous, unmapped, too_short,
    frag_len buckets, ...) are summed; derived lines (percent_unique,
    frag_len_mean) are recomputed with the emitters' formatting
    (emit.fmt_double / pct); min_read_length must agree across parts.
    All parts must be the same shape (all SE or all PE, same frag_range).
    """
    from walt_tpu.host.emit import fmt_double, pct

    parsed = [_parse_mapstats(open(p).read()) for p in paths]
    base = parsed[0]
    for other in parsed[1:]:
        assert len(other) == len(base), "mapstats shape mismatch"

    sums: dict = {}
    for li, item in enumerate(base):
        if not isinstance(item, tuple):
            continue
        _, key, _ = item
        if key in ("percent_unique", "frag_len_mean"):
            continue
        if key == "min_read_length":
            vals = {p[li][2] for p in parsed}
            assert len(vals) == 1, "min_read_length differs between parts"
            continue
        sums[li] = sum(int(p[li][2]) for p in parsed)

    # reconstruct, recomputing the derived lines from the summed section
    lines = []
    ctx: dict = {}
    for li, item in enumerate(base):
        if not isinstance(item, tuple):
            lines.append(item)
            continue
        indent, key, val = item
        if li in sums:
            v = sums[li]
            lines.append(f"{indent}{key}: {v}")
            ctx[key] = v  # last-seen wins; derived lines follow their inputs
            if key.isdigit():  # frag_len histogram bucket
                ctx.setdefault("_hist_total", 0)
                ctx.setdefault("_hist_wsum", 0)
                ctx["_hist_total"] += v
                ctx["_hist_wsum"] += int(key) * v
        elif key == "percent_unique":
            total = ctx.get("total_reads", ctx.get("total_read_pairs", 0))
            lines.append(
                f"{indent}{key}: {fmt_double(pct(ctx.get('unique', 0), total))}"
            )
        elif key == "frag_len_mean":
            denom = float(ctx.get("_hist_total", 0))
            wsum = float(ctx.get("_hist_wsum", 0))
            if denom != 0:
                mean = wsum / denom
            elif wsum == 0:
                mean = float("nan")
            else:
                mean = float("inf")
            lines.append(f"{indent}{key}: {fmt_double(mean)}")
        else:  # min_read_length (validated identical)
            lines.append(f"{indent}{key}: {val}")
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
