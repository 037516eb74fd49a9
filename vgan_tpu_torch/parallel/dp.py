"""Data-parallel fits over a mesh (counterpart of ``vgan_tpu.parallel.dp``).

The math is the single-device fit's (:mod:`vgan_tpu_torch.train.steps`):
the same global permutation and noise (drawn alike on every rank from the
replicated state's generator, or injected with ``rng=(perm, noise)``), the
same losses. Only the work is split, by :class:`MeshBatches`:

- the dataset stays sharded (:func:`~vgan_tpu_torch.parallel.input.shard_dataset`):
  each batch is assembled from the ranks' blocks, one sum over 'data' of
  each rank's own rows (exact: the other rows are zeros), then, under
  ``shard_features``, one all-gather of the column blocks over 'model';
- each 'data' rank runs the generator (and, for kl, the detector) on its
  rows of the batch; the rows of the MMD's operands are gathered, so the
  MMD, its bandwidth and the coverage penalty are the whole batch's and
  take the kernel route (:mod:`vgan_tpu_torch.ops.cuda.mmd_gram`) where the
  single-device fit would: K2 at the no-kl stress shape, K1 and K3 on kl
  encodings. This is what XLA's GSPMD program does in the JAX package,
  which hands the Pallas call whole operands;
- the reconstruction means are the whole batch's (a sum over 'data');
- the gradients are summed over 'data' with one all-reduce each, not
  averaged: the loss is global, not a mean of local losses;
- Adadelta, its weight decay included, then runs once on every rank on the
  replicated state, which stays equal on every rank.

'model' ranks of one 'data' coordinate hold the same rows and do the same
full-width work: ``shard_features`` splits only the dataset's storage. In
a world of one every collective is over one rank and the fit is
the single-device fit's to the bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vgan_tpu_torch.parallel.mesh import axis_size
from vgan_tpu_torch.parallel.ring import gather_rows, global_sum, row_split
from vgan_tpu_torch.train.steps import (
    TrainConfig,
    init_kl_state,
    init_no_kl_state,
    kl_train_epochs,
    no_kl_train_epochs,
)


class MeshBatches:
    """The layout of a training step over a mesh, with ``x`` this rank's
    block of the dataset (the hooks of
    :class:`vgan_tpu_torch.train.steps.WholeBatch`)."""

    def __init__(self, mesh, batch_size: int, shard_features: bool = False):
        self.data = mesh.get_group("data")
        self.model = mesh.get_group("model") if shard_features else None
        self.p = axis_size(mesh, "data")
        self.r = mesh.get_local_rank("data")
        self.batch_size = batch_size
        self.lo, self.hi, _ = row_split(batch_size, self.data)

    def n_rows(self, x: torch.Tensor) -> int:
        return x.shape[0] * self.p

    def batch_source(self, x: torch.Tensor, perm: torch.Tensor, batch_size: int):
        n = self.n_rows(x)
        if n < batch_size:
            raise ValueError(
                f"dataset has {n} rows < batch_size {batch_size}: drop-last "
                "batching would train zero batches (losses would be NaN)"
            )
        n_local, first = x.shape[0], self.r * x.shape[0]

        def batch(b: int) -> torch.Tensor:
            idx = perm[b * batch_size:(b + 1) * batch_size]
            own = (idx >= first) & (idx < first + n_local)
            part = x[(idx - first).clamp(0, n_local - 1)].masked_fill_(~own[:, None], 0.0)
            dist.all_reduce(part, group=self.data)
            if self.model is None:
                return part
            cols = [torch.empty_like(part) for _ in range(dist.get_world_size(self.model))]
            dist.all_gather(cols, part, group=self.model)
            return torch.cat(cols, dim=1)

        return batch

    def rows(self, t: torch.Tensor) -> torch.Tensor:
        return t[self.lo:self.hi]

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_rows(t, self.data, self.batch_size)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        # each rank's mean weighted by its share of the rows: a factor of
        # exactly 1 in a world of one, so the single-device bits stay
        local = torch.mean(t) if t.numel() else t.new_zeros(())
        return global_sum(local * (t.shape[0] / self.batch_size), self.data)

    def reduce_grads(self, grads):
        for g in grads:
            dist.all_reduce(g, group=self.data)
        return grads


def no_kl_fit_program_dp(x, seed: int, config: TrainConfig, epochs: int, mesh,
                         shard_features: bool = False):
    """Data-parallel no-kl fit: init from ``seed`` (the same on every rank),
    then ``epochs`` epochs. ``x`` is this rank's block
    (:func:`~vgan_tpu_torch.parallel.input.shard_dataset`). Returns
    ``(final_state, per_epoch_losses)``, replicated."""
    state = init_no_kl_state(config, seed, x.device, x.dtype)
    layout = MeshBatches(mesh, config.batch_size, shard_features)
    return no_kl_train_epochs(state, x, config, epochs, layout=layout)


def kl_fit_program_dp(x, seed: int, phases, config: TrainConfig, mesh,
                      shard_features: bool = False):
    """Data-parallel kl fit (generator against detector) over a mesh; ``x``
    is this rank's block. Returns ``(state, detector_history,
    generator_history)``, replicated."""
    state = init_kl_state(config, seed, x.device, x.dtype)
    layout = MeshBatches(mesh, config.batch_size, shard_features)
    return kl_train_epochs(state, x, phases, config, layout=layout)
