"""Multi-device paths on ``torch.distributed`` (counterpart of
``vgan_tpu.parallel``): device meshes, the data-parallel fit, the ring and
feature-sharded MMD.

SPMD with one process per device: a process group (NCCL on cards, gloo on
the CPU) and a ``DeviceMesh`` with the dims ``("data", "model")``
(:func:`make_mesh`). Every rank calls the same entry points with the same
arguments and gets replicated outputs, equal to the single-device call's up
to the order of sums.

- **data parallel**: batch rows split over 'data'; each rank runs the
  networks on its rows, the MMD runs on the gathered batch
  (:mod:`vgan_tpu_torch.parallel.dp`);
- **sample-parallel ring**: the Gram's quadrant sums over row-sharded
  samples by P - 1 ring exchanges, no rank holding the whole sample set
  (:mod:`vgan_tpu_torch.parallel.ring`);
- **feature sharding**: squared distances add over features, so d-sharded
  operands need one sum of the partial distances
  (:func:`~vgan_tpu_torch.parallel.ring.mmd2_feature_sharded`); the
  dataset's columns shard over 'model' (``shard_features``).

The subspace ensemble shards its masks over 'data', and the streaming GoF
test its permutation rows (``mesh=`` on ``SubspaceEnsemble`` and on the
tiled tests).
"""

from vgan_tpu_torch.parallel.dp import kl_fit_program_dp, no_kl_fit_program_dp
from vgan_tpu_torch.parallel.input import process_row_range, shard_dataset
from vgan_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated
from vgan_tpu_torch.parallel.ring import (
    mmd2_feature_sharded,
    mmd2_ring_rowsharded,
    ring_quadrant_sums,
)

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "ring_quadrant_sums",
    "mmd2_ring_rowsharded",
    "mmd2_feature_sharded",
    "no_kl_fit_program_dp",
    "kl_fit_program_dp",
    "shard_dataset",
    "process_row_range",
]
