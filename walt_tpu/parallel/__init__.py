"""Multi-chip parallel mapping: device meshes, sharded tables, collectives.

The reference's only parallelism is an OpenMP parallel-for over reads in a
batch (src/walt/mapping.cpp:494, src/walt/paired.cpp:664).  The device
equivalent is a 2-D device mesh:

- ``dp`` (data parallel): read batches sharded across chips, the direct
  analog of the OpenMP loop;
- ``tp`` (table parallel): the CSR hash table sharded by bucket-key range,
  so genomes whose index exceeds one chip's HBM (hg19: ~12 GB/table,
  SURVEY.md section 7.3) spread across chips; candidates are merged with an
  ``all_gather`` between the cards (NVLink on one host).
"""

from walt_tpu.parallel.sharded import (  # noqa: F401
    ShardedTables,
    make_mesh,
    map_mate_sharded,
    map_single_end_sharded,
    map_strand_sharded,
    place_sharded_table,
    shard_and_place,
    shard_device_table,
)
