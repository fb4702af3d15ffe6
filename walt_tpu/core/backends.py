"""Mapping backends: produce candidate streams for a batch against one table.

A backend maps a packed read batch against one converted-genome table and
returns, per read, the ordered candidate stream consumed by
``walt_tpu.host.replay``.  Two implementations:

- ``NumpyBackend``: exact host-side enumeration (walt_tpu.core.refmap); the
  oracle, and the fallback for reads the device slabs cannot hold.
- ``JaxBackend`` (walt_tpu.core.jax_backend): batched XLA pipeline on the
  accelerator; falls back to NumpyBackend per read when a fixed shape overflows.
"""

from __future__ import annotations

import numpy as np

from walt_tpu.constants import SeedPattern
from walt_tpu.core import refmap
from walt_tpu.genome import Genome
from walt_tpu.index.build import HashTable


class NumpyBackend:
    """Exact, host-only enumeration (the executable spec)."""

    name = "numpy"

    def map_strand(self, codes: np.ndarray, lens: np.ndarray, genome: Genome,
                   table: HashTable, ag_wildcard: bool, b: int,
                   max_mismatches: int, pattern: SeedPattern) -> list:
        from walt_tpu.host import replay

        seq_padded = refmap.padded_seq(genome, pattern)

        def one(i):
            return list(
                refmap.enumerate_candidates(
                    codes[i, : int(lens[i])], genome, table, ag_wildcard, b,
                    max_mismatches, pattern, seq_padded=seq_padded,
                )
            )

        return replay.host_map(one, range(codes.shape[0]))


def get_backend(name: str, **kwargs):
    if name == "numpy":
        return NumpyBackend()
    if name == "jax":
        from walt_tpu.core.jax_backend import JaxBackend

        return JaxBackend(**kwargs)
    raise ValueError(f"unknown backend {name!r}")
