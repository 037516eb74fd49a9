"""Sharded MMD over a process group: a ring over row shards, one sum over
feature shards (counterpart of ``vgan_tpu.parallel.ring``).

The same biased MMD^2 as :func:`vgan_tpu_torch.ops.mmd.mmd2_biased_stateful`,
over samples that no rank holds whole:

- **row-sharded (ring)**: each rank of the group owns a row block (x_p,
  y_p). The quadrant sums decompose over block pairs; P - 1 exchanges pass
  the partner blocks around the ring, so a rank holds two blocks at a time,
  and one sum over the group assembles the global sums.
- **feature-sharded**: squared distances add over features, so d-sharded
  operands need one sum of the partial (m, m) distance matrix; the exp and
  the reductions then run whole on every rank.

Autograd runs through the exchanges. The contract (the JAX package's
``test_ring_mmd_gradients_match``): every rank's loss is the global loss,
and backward gives each rank's block exactly its rows of the single-device
gradient. So the differentiable collectives here are not those of
``torch.distributed.nn``: a global sum passes its gradient through
unchanged (every rank holds the same loss, whose gradient with respect to
the sum is the same everywhere), an all-gather gives each rank its own rows
of the incoming gradient (``torch.distributed.nn.functional.all_gather``
sums the P identical copies instead: P times the gradient), and the ring's
exchange sends the gradient back around the ring the other way.

The block Gram sums are plain torch (``torch.matmul``), as they are plain
``jnp`` outside any Pallas kernel in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from vgan_tpu_torch.ops.mmd import bandwidth_multipliers, multi_rbf_gram


def _rank_size(group) -> Tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


class _GlobalSum(torch.autograd.Function):
    """Sum over the group; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def global_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``sum_p t_p`` over the group on every rank, differentiable: each rank's
    ``t`` gets the gradient of the (global) loss with respect to the sum."""
    return _GlobalSum.apply(t, group)


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 (blocks padded to ``per`` rows); the gradient
    is this rank's rows of the incoming one."""

    @staticmethod
    def forward(ctx, t, group, per, total):
        rank, size = _rank_size(group)
        ctx.rows = (rank * per, rank * per + t.shape[0])
        buf = t.new_zeros((per, *t.shape[1:]))
        buf[: t.shape[0]] = t
        parts = [torch.empty_like(buf) for _ in range(size)]
        dist.all_gather(parts, buf.contiguous(), group=group)
        return torch.cat(parts)[:total]

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.rows
        return g[lo:hi], None, None, None


def row_split(total: int, group) -> Tuple[int, int, int]:
    """``(lo, hi, per)``: this rank's rows ``[lo, hi)`` of ``total`` rows in
    the ceil split over the group, ``per`` rows a rank."""
    rank, size = _rank_size(group)
    per = -(-total // size)
    return min(rank * per, total), min((rank + 1) * per, total), per


def gather_rows(t: torch.Tensor, group, total: int) -> torch.Tensor:
    """Every rank's block of the ceil split of ``total`` rows (:func:`row_split`),
    concatenated in rank order on every rank; differentiable, each rank's
    block getting its own rows of the gradient."""
    _, size = _rank_size(group)
    if size == 1:
        return t
    return _GatherRows.apply(t, group, -(-total // size), total)


class _RingShift(torch.autograd.Function):
    """Send to the next rank of the ring, receive from the previous; the
    gradient travels the other way."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _shift(t, group, +1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _shift(t: torch.Tensor, group, step: int) -> torch.Tensor:
    rank, size = _rank_size(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    dst = dist.get_global_rank(group, (rank + step) % size)
    src = dist.get_global_rank(group, (rank - step) % size)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, t, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for req in reqs:
        req.wait()
    return out


def _block_gram_sum(a, b, bw, mults) -> torch.Tensor:
    """``sum_ij K(a_i, b_j)`` for one block pair (multi-bandwidth RBF)."""
    an = torch.sum(a * a, dim=-1)
    bn = torch.sum(b * b, dim=-1)
    d2 = torch.clamp_min(an[:, None] + bn[None, :] - 2.0 * (a @ b.T), 0.0)
    return torch.sum(multi_rbf_gram(d2, bw, mults))


def _global_candidate_bandwidth(x_loc, y_loc, group) -> torch.Tensor:
    """Row-sharded :func:`vgan_tpu_torch.ops.mmd.candidate_bandwidth`: the
    centered closed form with the mean and the centered square sum each
    summed over the group; detached."""
    with torch.no_grad():
        z_loc = torch.cat([x_loc, y_loc], dim=0)
        m = z_loc.shape[0] * dist.get_world_size(group)
        total = torch.sum(z_loc, dim=0)
        dist.all_reduce(total, group=group)
        zc = z_loc - total / m
        sq = torch.sum(zc * zc)
        dist.all_reduce(sq, group=group)
        return 2.0 * m * sq / (m * m - m)


def ring_quadrant_sums(x_loc, y_loc, bw, group, mults=bandwidth_multipliers()):
    """Global ``(sum Kxx, sum Kxy, sum Kyy)`` over row-sharded samples: the
    local pair, then P - 1 ring exchanges of the stacked partner block
    (one message a step), then one sum over the group."""
    _, p = _rank_size(group)
    bx = x_loc.shape[0]
    sxx = _block_gram_sum(x_loc, x_loc, bw, mults)
    sxy = _block_gram_sum(x_loc, y_loc, bw, mults)
    syy = _block_gram_sum(y_loc, y_loc, bw, mults)
    zb = torch.cat([x_loc, y_loc], dim=0)
    for _ in range(p - 1):
        zb = _RingShift.apply(zb, group)
        xb, yb = zb[:bx], zb[bx:]
        sxx = sxx + _block_gram_sum(x_loc, xb, bw, mults)
        sxy = sxy + _block_gram_sum(x_loc, yb, bw, mults)
        syy = syy + _block_gram_sum(y_loc, yb, bw, mults)
    sums = global_sum(torch.stack([sxx, sxy, syy]), group)
    return sums[0], sums[1], sums[2]


def mmd2_ring_rowsharded(x_loc, y_loc, bw_value, bw_is_set, group,
                         mults=bandwidth_multipliers()):
    """Row-sharded stateful biased MMD^2, ``(mmd2, bandwidth_used)``: the
    contract of the single-device op, over the group's row blocks (equal
    row counts on every rank)."""
    _, p = _rank_size(group)
    n1, n2 = x_loc.shape[0] * p, y_loc.shape[0] * p
    candidate = _global_candidate_bandwidth(x_loc, y_loc, group)
    bw = torch.where(bw_is_set, bw_value, candidate).to(x_loc.dtype)
    sxx, sxy, syy = ring_quadrant_sums(x_loc, y_loc, bw, group, mults)
    return sxx / (n1 * n1) - 2.0 * sxy / (n1 * n2) + syy / (n2 * n2), bw


def mmd_loss_ring_rowsharded(x_loc, y_loc, u_loc, weight, bw_value, bw_is_set, group,
                             mults=bandwidth_multipliers()):
    """Row-sharded constrained MMD loss with the global coverage penalty: the
    column max runs over every rank's masks (gathered, so the gradient
    reaches the rank that holds the maximum)."""
    mmd2, bw = mmd2_ring_rowsharded(x_loc, y_loc, bw_value, bw_is_set, group, mults)
    _, p = _rank_size(group)
    local_max = torch.amax(u_loc, dim=0, keepdim=True)
    col_max = torch.amax(gather_rows(local_max, group, p), dim=0)
    return mmd2 + weight * torch.mean(1.0 - col_max), bw


def mmd2_feature_sharded(x_loc, y_loc, bw_value, bw_is_set, group,
                         mults=bandwidth_multipliers()):
    """Feature-sharded stateful biased MMD^2: ``x_loc`` / ``y_loc`` hold
    every row and a slice of the features; the partial squared distances
    are summed over the group once. The candidate bandwidth is the centered
    closed form with its square sum summed over the group."""
    n1 = x_loc.shape[0]
    z = torch.cat([x_loc, y_loc], dim=0)
    zn = torch.sum(z * z, dim=-1)
    partial = zn[:, None] + zn[None, :] - 2.0 * (z @ z.T)
    d2 = torch.clamp_min(global_sum(partial, group), 0.0)
    m = z.shape[0]
    with torch.no_grad():
        zc = z - torch.mean(z, dim=0, keepdim=True)
        sq = torch.sum(zc * zc)
        dist.all_reduce(sq, group=group)
        candidate = 2.0 * m * sq / (m * m - m)
    bw = torch.where(bw_is_set, bw_value, candidate).to(x_loc.dtype)
    k = multi_rbf_gram(d2, bw, mults)
    mmd2 = (torch.mean(k[:n1, :n1]) - 2.0 * torch.mean(k[:n1, n1:])
            + torch.mean(k[n1:, n1:]))
    return mmd2, bw
