"""walt_tpu: a JAX-native bisulfite-sequencing read mapper.

A from-scratch reimplementation of the capabilities of WALT (smithlabcode/walt,
reference layout documented in SURVEY.md) designed for an accelerator
(an NVIDIA H100 today) driven through JAX/XLA:

- the genome hash index lives on device as packed integer arrays,
- seeding / sorted-bucket refinement / candidate verification run as batched
  fixed-shape JAX (XLA) programs (2-bit packed words, masked popcounts,
  slab-tiered fixed shapes),
- reads are mapped data-parallel across a ``jax.sharding.Mesh`` of cards,
  with an optional bucket-range-sharded table (walt_tpu.parallel),
- single-end best-hit folding happens on device; the paired-end top-k heap
  and pair join are finalized by a native C++ library (walt_tpu.native,
  Python fallback) so output is bit-identical to the reference.

Reference behavior citations use ``path:line`` into the upstream repo, e.g.
``src/walt/mapping.cpp:224``.
"""

__version__ = "0.1.0"

from walt_tpu.hostmem import tune_malloc as _tune_malloc

_tune_malloc()

from walt_tpu.constants import SeedPattern, get_pattern  # noqa: F401
