"""Per-rank input: this rank's block of a mesh-sharded dataset (counterpart
of ``vgan_tpu.parallel.input``).

Rows split over the mesh's 'data' axis, and columns over 'model' when
asked. Each rank holds only its block; :mod:`vgan_tpu_torch.parallel.dp`
assembles each batch from the blocks. A loader that reads only its own rows
(:func:`process_row_range`) passes them with ``n_total``, the global row
count.

Constraint, as in the JAX package (whose ``NamedSharding`` needs it): the
global row count must divide evenly by the 'data' size (and the column count
by the 'model' size under ``shard_features``); a ragged split raises
``ValueError``. Pad or drop rows to a multiple upstream; the ceil split of
:func:`process_row_range` then gives every rank the same row count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from vgan_tpu_torch.parallel.mesh import axis_size


def process_row_range(n_total: int) -> tuple[int, int]:
    """``[start, end)`` of the rows this process should load: a contiguous
    ceil split of ``n_total`` over the world (the whole range without a
    process group)."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = -(-n_total // p)
    return min(i * per, n_total), min((i + 1) * per, n_total)


def _even(total: int, parts: int, what: str) -> int:
    if total % parts:
        raise ValueError(
            f"the global {what} count {total} does not divide evenly by the mesh's "
            f"{parts} shards; pad or drop {what}s to a multiple of {parts} upstream"
        )
    return total // parts


def _gather_process_rows(x_local: torch.Tensor, n_total: int) -> torch.Tensor:
    """The full (n_total, d) array from every process's :func:`process_row_range`
    rows (an all-gather over the world, padded to the ceil split)."""
    world = dist.get_world_size()
    per = -(-n_total // world)
    buf = torch.zeros((per, *x_local.shape[1:]), dtype=x_local.dtype, device=x_local.device)
    buf[: x_local.shape[0]] = x_local
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    return torch.cat(parts)[:n_total]


def shard_dataset(
    x_local,
    mesh,
    shard_features: bool = False,
    n_total: Optional[int] = None,
) -> torch.Tensor:
    """This rank's block of the mesh-sharded dataset, on the mesh's device.

    ``x_local`` is the full array, or with ``n_total`` (the global row count)
    this process's :func:`process_row_range` rows. Rows shard over 'data';
    columns over 'model' with ``shard_features``. The dtype is kept.
    """
    device = torch.device(mesh.device_type)  # bare cuda: this rank's card
    if not isinstance(x_local, torch.Tensor):
        x_local = torch.from_numpy(np.ascontiguousarray(x_local))
    x = x_local
    p, r = axis_size(mesh, "data"), mesh.get_local_rank("data")
    rows = _even(x.shape[0] if n_total is None else n_total, p, "row")
    if n_total is None:
        block = x[r * rows:(r + 1) * rows]
    else:
        start, end = process_row_range(n_total)
        if x.shape[0] != end - start:
            raise ValueError(
                f"x_local has {x.shape[0]} rows; process_row_range({n_total}) gives this "
                f"process {end - start}"
            )
        block = x
        if (start, end) != (r * rows, (r + 1) * rows):
            # the process split is not this rank's 'data' block (a mesh
            # with a 'model' axis): assemble the rows, keep the block
            block = _gather_process_rows(x.to(device), n_total)[r * rows:(r + 1) * rows]
    if shard_features:
        q, c = axis_size(mesh, "model"), mesh.get_local_rank("model")
        cols = _even(block.shape[1], q, "column")
        block = block[:, c * cols:(c + 1) * cols]
    return block.to(device).contiguous()
