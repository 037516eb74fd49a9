"""Subspace-ensemble outlier detection (counterpart of ``vgan_tpu.ensemble.od``).

The V-GAN paper's downstream use: sample subspace masks from a fitted model,
score the data in each subspace with a base detector, and combine the
scores. Masked distances use the expansion

    d2_m(a, b) = (a*a) @ m + (b*b) @ m - 2 (a .* m) @ b^T

so each subspace's distance matrix is one matrix product. On the card, and
wherever :func:`~vgan_tpu_torch.ops.cuda.knn_score.knn_kernel_supported`
holds, a whole ``knn`` / ``knn_mean`` ``decision_function`` is the fused KNN
kernel (K6 or K7), then the z-score and the aggregation on the device, and
one host fetch of the (nt,) scores. Every other native base, and the knn
bases past those shapes, score a ``(c, d)`` chunk of masks in one batched
call per chunk, as the JAX package vmaps each chunk.

Every base of the JAX package is here: the neighbour family (``knn``,
``knn_mean``, ``lof``, ``abod``, ``cof``, and ``sod``), ``iforest``
(:mod:`vgan_tpu_torch.ensemble.iforest`), ``mahalanobis``, the
dimension-decomposable ``copod`` / ``hbos`` / ``ecod``, whose per-dimension
score planes are shared by every mask, and the parametric bases with the
knobs only they read: ``mcd``, ``pca``, ``kpca``, ``cblof``, ``gmm``,
``kde``, ``loda``, ``inne``, ``sampling``, ``lmdd``, ``ocsvm``, ``sos``,
``ae`` and ``dsvdd``. A pyod-style detector instance runs the CPU loop over
subspaces.

With ``mesh=`` the mask axis splits over the mesh's 'data' ranks: each rank
scores its shard (K6 / K7 on its masks on the knn kernel route, its mask
chunks on the generic route), one all-reduce combines the shards (a sum
for 'average', a max for 'max', padding masks never winning), and the raw
per-subspace scores are all-gathered in mask order. Every rank calls with
the same arguments and gets the same scores.
"""

from __future__ import annotations

import contextlib
import functools
import math
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device
from vgan_tpu_torch.ensemble.chi2 import chi2_cdf, chi2_ppf
from vgan_tpu_torch.ensemble.iforest import DEFAULT_PSI, draw_iforest, iforest_scores_masked
from vgan_tpu_torch.ops.cuda.knn_score import (
    count_generic,
    knn_kernel_supported,
    knn_scores_all_masks,
)
from vgan_tpu_torch.parallel.mesh import check_mesh_device
from vgan_tpu_torch.utils.profiling import annotate, span


def _as_batch(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (d,) mask or a (c, d) chunk of masks as a (c, d) chunk in ``like``'s dtype."""
    mask = mask.to(device=like.device, dtype=like.dtype)
    return mask[None] if mask.ndim == 1 else mask


def _masked_sq_dists(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(nt, ntr) squared distances restricted to masked features, or
    (c, nt, ntr) for a (c, d) chunk of masks."""
    m = _as_batch(mask, a)
    an = ((a * a) @ m.T).T
    bn = ((b * b) @ m.T).T
    cross = (a[None] * m[:, None, :]) @ b.T
    d2 = torch.clamp_min(an[:, :, None] + bn[:, None, :] - 2.0 * cross, 0.0)
    return d2[0] if mask.ndim == 1 else d2


def _mask_diagonal(d2: torch.Tensor) -> torch.Tensor:
    """Exclude self-pairs: +big on d2[..., i, i]. Valid when query row i IS
    train row i (pyod's unsupplied-X ``kneighbors()`` semantics)."""
    n = min(d2.shape[-2], d2.shape[-1])
    idx = torch.arange(n, device=d2.device)
    d2 = d2.clone()
    d2[..., idx, idx] = torch.finfo(d2.dtype).max / 4
    return d2


# Beyond this train-set size the neighbor scorers stream the train axis in
# blocks (running exact k-smallest merge) instead of materializing the
# (nt, ntr) distance matrix: unbounded n_train at O(nt x block) memory.
STREAM_NTR = 16384
_STREAM_BLOCK = 8192
# The streamed per-mask (nt, block) distance tile stays under
# _STREAM_TILE_BUDGET elements, and the masks in flight are clamped so that
# chunk x nt x block stays under _STREAM_CHUNK_BUDGET elements.
_STREAM_TILE_BUDGET = 2**26
_STREAM_CHUNK_BUDGET = 2**27
# The chunk's masked query rows (chunk, nt, d) and its distances (chunk, nt,
# ntr or block) exist at once in eager torch; they stay under this many
# elements (the JAX package leaves that buffer to XLA's fusion).
_CHUNK_ELEMS_BUDGET = 2**27
# Merge-bound streaming: the knn merge streams narrower train blocks than an
# elementwise consumer would.
_MERGE_BLOCK = 2048
_KPASS_MAX_K = 128
# Mahalanobis holds a (d, d) masked covariance and its Cholesky factor per
# mask in flight: chunk x d^2 stays under this many elements.
_MAHA_CHUNK_BUDGET = 2**26
# abod and cof gather an (n, k, d) neighbour-difference block per mask in
# flight: chunk x n x k x d stays under this many elements.
_ABOD_CHUNK_BUDGET = 2**26
# test_chunk zscore: the moments pass's raw (n_subspaces, nt) scores stay on
# the host up to this many elements (1 GB of f32); past it they are scored
# again in the second pass.
_TEST_CHUNK_CACHE_ELEMS = 2**28

# Query-count stand-in where nt is the symbolic batch dimension of a
# ``torch.export`` trace (vgan_tpu_torch.serving): the streamed tiles are
# sized as if nt were this bound, so an exported program stays within its
# memory budgets for serving batches up to it.
_EXPORT_NT_HINT = 4096


def _concrete_nt(nt) -> int:
    """``nt``, or :data:`_EXPORT_NT_HINT` for a symbolic batch dimension."""
    return _EXPORT_NT_HINT if isinstance(nt, torch.SymInt) else nt


def _fixed_loop(n: int, body, carry: tuple) -> tuple:
    """``carry = body(i, *carry)`` for i = 0..n-1. Eagerly a Python loop
    (``i`` an int); under ``torch.export`` one ``while_loop`` (``i`` a 0-d
    int64 tensor), so the exported graph holds the body once, not n
    times."""
    if not torch.compiler.is_exporting():
        for i in range(n):
            carry = body(i, *carry)
        return carry
    from torch._higher_order_ops import while_loop

    i0 = torch.zeros((), dtype=torch.int64, device=carry[0].device)
    out = while_loop(lambda i, *c: i < n, lambda i, *c: (i + 1, *body(i, *c)),
                     (i0, *(c.clone() for c in carry)))
    return tuple(out[1:])


def _loop_table(values, dtype: torch.dtype, device):
    """``lookup(i)``: step i's constant of a :func:`_fixed_loop` body, the
    Python value eagerly, a 0-d tensor of ``dtype`` under export."""
    if not torch.compiler.is_exporting():
        return values.__getitem__
    table = torch.tensor(values, dtype=dtype, device=device)
    return lambda i: torch.index_select(table, 0, i.reshape(1))[0]


def _stream_block(nt: int) -> int:
    """Train-block length for the streaming scorers at ``nt`` query rows."""
    nt = _concrete_nt(nt)
    cap = max(512, (_STREAM_TILE_BUDGET // max(nt, 1)) // 128 * 128)
    return min(_STREAM_BLOCK, cap)


def _stream_chunk(chunk: int, nt: int, blk: int) -> int:
    """Clamp the mask chunk so the streaming tiles fit memory."""
    nt = _concrete_nt(nt)
    return max(1, min(chunk, _STREAM_CHUNK_BUDGET // max(nt * blk, 1)))


def _effective_chunk(base, chunk: int, nt: int, ntr: int, d: int, k: int = 0, *,
                     n_clusters: int = 8, gmm_covariance: str = "diag", n_trees: int = 100,
                     inne_psi: int = 8, kpca_sampling: bool = False, subset_size: int = 20,
                     mcd_starts: int = 8, ae_hidden: tuple = (64, 32),
                     sod_ref_set: int = 10) -> int:
    """Memory governor for the mask chunk of the generic path: the JAX
    package's governor for the native bases, then the eager-torch buffers.
    ``k`` is the base's k (the tree count for iforest). The serving
    exporters pass their ``max_batch`` as ``nt``; a symbolic ``nt`` counts
    as :data:`_EXPORT_NT_HINT`."""
    nt = _concrete_nt(nt)
    # the rows a chunk's distances are formed for: lof and cof also search
    # the train rows' own neighbours
    rows = max(nt, ntr) if base in ("lof", "cof") else nt
    width = ntr
    if base in ("knn", "knn_mean", "lof", "abod", "cof", "kde") and ntr > STREAM_NTR:
        # kde's logsumexp streams wider blocks than the knn merge
        width = _stream_block(rows)
        if base != "kde":
            width = min(width, _MERGE_BLOCK)
        chunk = _stream_chunk(chunk, rows, width)
    if base in ("abod", "cof"):
        chunk = min(chunk, _ABOD_CHUNK_BUDGET // max(rows * max(k, 2) * d, 1))
    if base == "mahalanobis":
        return max(1, min(chunk, _MAHA_CHUNK_BUDGET // max(d * d, 1)))
    # the parametric bases: the JAX package's per-mask element counts under
    # _MAHA_CHUNK_BUDGET (inne: the masked centres and the (nt, T psi)
    # coverage plane; pca: the standardized train copy and its projections,
    # the (d, d) covariance and eigenvectors, the query projections; kpca:
    # the (n, n) kernel, its centred copy and the eigh workspace, the (nt, n)
    # planes; mcd: the masked train copy, per start the centred and weighted
    # copies and the (d, d) covariance and factor; sod: the train and query
    # distance, indicator and SNN planes and the (nt, ref_set, d) reference
    # rows; ae / dsvdd: weights and Adam state, the layers' activations and
    # their gradients; ocsvm: the train and test kernels and the masked train
    # copy; sos: the train distance, shifted and kernel planes and the test
    # binding planes; lmdd: the masked copies and aad's (block, nt, d) plane;
    # cblof / gmm: the masked train copy and the (ntr, C) assignments, the
    # per-component residuals and covariances under 'full'), plus what eager
    # torch holds beyond them
    per_mask = None
    if base == "inne":
        per_mask = n_trees * inne_psi * (d + nt)
    elif base == "pca":
        per_mask = 2 * ntr * d + 2 * d * d + nt * d
    elif base == "kpca":
        n = min(ntr, max(2, subset_size)) if kpca_sampling else ntr
        per_mask = 4 * n * n + 3 * nt * n
    elif base == "mcd":
        per_mask = ntr * d + mcd_starts * (2 * ntr * d + 2 * d * d) + nt * d
    elif base == "sod":
        # and the stable sorts' values and int64 indices over the train and
        # query rows
        per_mask = 2 * ntr * ntr + 3 * nt * ntr + nt * sod_ref_set * d + 3 * (ntr + nt) * ntr
    elif base in ("ae", "dsvdd"):
        # and autograd's saved activations: each layer's output and its
        # ReLU's over the train rows
        h_sum = sum(ae_hidden)
        w = 2 * (d * ae_hidden[0] + sum(a * b for a, b in zip(ae_hidden[:-1], ae_hidden[1:])))
        per_mask = 6 * w + 6 * ntr * (d + h_sum) + nt * (d + h_sum)
    elif base == "ocsvm":
        per_mask = 2 * ntr * ntr + nt * ntr + ntr * d
    elif base == "sos":
        per_mask = 4 * ntr * ntr + 3 * ntr * nt
    elif base == "lmdd":
        per_mask = ntr * d + 3 * nt * d + _LMDD_BLOCK * nt * d
    elif base in ("cblof", "gmm"):
        c = max(n_clusters, 1)
        per_mask = ntr * (d + c)
        if base == "gmm" and gmm_covariance == "full":
            per_mask = max(per_mask, c * ntr * d + c * d * d)
    if per_mask is not None:
        return max(1, min(chunk, _MAHA_CHUNK_BUDGET // max(per_mask, 1)))
    if base == "iforest":
        # the (chunk, trees, rows) node ids, gathered values and path lengths
        per_mask = 4 * k * max(nt, DEFAULT_PSI)
    elif base in ("lof", "abod", "cof"):
        # the masked query rows, the distances, and the stable sort's values
        # and int64 indices of the (value, index) neighbour selection
        per_mask = rows * (d + 4 * width)
    else:
        per_mask = nt * (d + width)
    return max(1, min(chunk, _CHUNK_ELEMS_BUDGET // max(per_mask, 1)))


def _k_smallest_by_index(d2: torch.Tensor, k: int):
    """``(vals, idx)`` of the k smallest entries of each row in
    ``(value, index)`` order: ties break by the smaller index, as the JAX
    package's streamed k-pass merge does (its dense ``approx_min_k`` leaves
    the order of ties unspecified). A stable sort keeps equal values in
    index order."""
    if k > d2.shape[-1]:
        raise ValueError(f"k={k} neighbours requested from {d2.shape[-1]} candidates")
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _masked_knn_streaming(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                          k: int, exclude_self: bool):
    """Exact ``(d2_vals, train_idx)`` of the k smallest masked squared
    distances in ``(value, index)`` order, with the train axis streamed in
    blocks: (nt, k) each, or (c, nt, k) for a (c, d) chunk of masks.

    The running k smallest values and indices are carried across blocks;
    each block merges into the carry by a stable sort of [carry | block].
    The carry is already in (value, index) order, every carry index is below
    every index of the block, and the block is in index order, so the stable
    sort's first k are the k smallest by (value, index): the JAX package's
    lexicographic k-pass merge, ties included. The (nt, ntr) matrix never
    exists, so n_train is unbounded at O(nt x block) memory per mask.
    """
    if k > _KPASS_MAX_K:
        warnings.warn(
            f"streaming kNN merge with k={k} > {_KPASS_MAX_K}: every streamed block "
            "selects k of k + block candidates per row, so large-k neighbor bases on "
            "streamed train sets (n_train > STREAM_NTR) are a slow regime; see "
            "docs/SCALING.md",
            RuntimeWarning,
            stacklevel=2,
        )
    nt = x_test.shape[0]
    ntr = x_train.shape[0]
    m = _as_batch(mask, x_test)
    c = m.shape[0]
    big = torch.finfo(x_test.dtype).max / 4
    blk = min(_stream_block(nt), _MERGE_BLOCK)
    an = ((x_test * x_test) @ m.T).T[:, :, None]
    xm = x_test[None] * m[:, None, :]
    rows = torch.arange(nt, device=x_test.device)[:, None]
    vals = torch.full((c, nt, k), big, dtype=x_test.dtype, device=x_test.device)
    idx = torch.full((c, nt, k), -1, dtype=torch.int64, device=x_test.device)
    for b0 in range(0, ntr, blk):
        xb = x_train[b0:b0 + blk]
        bn = ((xb * xb) @ m.T).T[:, None, :]
        d2 = torch.clamp_min(an + bn - 2.0 * (xm @ xb.T), 0.0)
        cols = torch.arange(b0, b0 + xb.shape[0], device=x_test.device)[None, :]
        if exclude_self:
            d2 = torch.where(rows == cols, big, d2)
        cand_idx = torch.cat([idx, cols.expand(c, nt, -1)], dim=2)
        vals, pos = _k_smallest_by_index(torch.cat([vals, d2], dim=2), k)
        idx = torch.gather(cand_idx, 2, pos)
    return (vals[0], idx[0]) if mask.ndim == 1 else (vals, idx)


def _masked_knn_vals_idx(x_test, x_train, mask, k: int, exclude_self: bool):
    """``(d2, train_idx)`` of the k nearest masked neighbours in ``(value,
    index)`` order: dense below ``STREAM_NTR``, streamed past it. The one
    neighbour search of the bases that read indices (abod, cof)."""
    if x_train.shape[0] > STREAM_NTR:
        return _masked_knn_streaming(x_test, x_train, mask, k, exclude_self)
    d2 = _masked_sq_dists(x_test, x_train, mask)
    if exclude_self:
        d2 = _mask_diagonal(d2)
    return _k_smallest_by_index(d2, k)


def _k_smallest(x_test, x_train, mask, k: int, exclude_self: bool) -> torch.Tensor:
    """The k smallest masked squared distances of each query row, ascending."""
    if x_train.shape[0] > STREAM_NTR:
        vals, _ = _masked_knn_streaming(x_test, x_train, mask, k, exclude_self)
        return vals
    d2 = _masked_sq_dists(x_test, x_train, mask)
    if exclude_self:
        d2 = _mask_diagonal(d2)
    return torch.topk(d2, k, dim=-1, largest=False, sorted=True).values


def knn_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor, k: int,
                      exclude_self: bool = False) -> torch.Tensor:
    """k-th nearest-neighbor distance in the masked space (pyod KNN
    'largest' semantics): (nt,) for a (d,) mask, (c, nt) for a (c, d) chunk.
    ``exclude_self`` drops the (i, i) pair: use it when the leading query
    rows are the training rows themselves. Train sets past ``STREAM_NTR``
    stream in blocks (unbounded n_train)."""
    return torch.sqrt(_k_smallest(x_test, x_train, mask, k, exclude_self)[..., -1])


def mean_dist_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                            k: int, exclude_self: bool = False) -> torch.Tensor:
    """Mean distance to the k nearest neighbors (pyod KNN 'mean')."""
    return torch.mean(torch.sqrt(_k_smallest(x_test, x_train, mask, k, exclude_self)), dim=-1)


def _gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b, i, j]]`` for a (c, n) table and (c, nq, k) indices."""
    c, nq, k = idx.shape
    return torch.gather(table, 1, idx.reshape(c, nq * k)).reshape(c, nq, k)


def lof_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor, k: int,
                      exclude_self: bool = False) -> torch.Tensor:
    """Local outlier factor in the masked space, novelty-style (test rows
    scored against the train set, as sklearn / pyod ``LOF(novelty=True)``):
    (nt,) for a (d,) mask, (c, nt) for a (c, d) chunk.

    Dense, the neighbours are selected on the distance ``sqrt(d2)``, the
    train rows' own pairs set to ``finfo.max / 4`` after the square root;
    streamed (past ``STREAM_NTR``), on d2, with the square root after. Both
    as the JAX package does, so ties made by rounding in the square root
    break the same way."""
    eps = 1e-12
    m = _as_batch(mask, x_train)
    n_tr = x_train.shape[0]
    if n_tr > STREAM_NTR:
        d2_tr, nbr_tr = _masked_knn_streaming(x_train, x_train, m, k, exclude_self=True)
        knn_d_tr = torch.sqrt(d2_tr)
        d2_te, nbr_te = _masked_knn_streaming(x_test, x_train, m, k, exclude_self=exclude_self)
        knn_d_te = torch.sqrt(d2_te)
    else:
        big = torch.finfo(x_train.dtype).max / 4
        d_tr = torch.sqrt(_masked_sq_dists(x_train, x_train, m))
        diag = torch.arange(n_tr, device=x_train.device)
        d_tr[:, diag, diag] = big
        knn_d_tr, nbr_tr = _k_smallest_by_index(d_tr, k)
        d2_te = _masked_sq_dists(x_test, x_train, m)
        if exclude_self:
            d2_te = _mask_diagonal(d2_te)
        knn_d_te, nbr_te = _k_smallest_by_index(torch.sqrt(d2_te), k)
    kdist_tr = knn_d_tr[..., -1]  # (c, ntr)
    reach_tr = torch.maximum(_gather_rows(kdist_tr, nbr_tr), knn_d_tr)
    lrd_tr = 1.0 / (torch.mean(reach_tr, dim=-1) + eps)
    reach_te = torch.maximum(_gather_rows(kdist_tr, nbr_te), knn_d_te)
    lrd_te = 1.0 / (torch.mean(reach_te, dim=-1) + eps)
    out = torch.mean(_gather_rows(lrd_tr, nbr_te), dim=-1) / (lrd_te + eps)
    return out[0] if mask.ndim == 1 else out


def _neighbor_diff_gram(x: torch.Tensor, x_train: torch.Tensor, m: torch.Tensor,
                        idx: torch.Tensor):
    """``(dots, sq)`` of the masked neighbour differences of a (c, d) chunk:
    for query row x_i with neighbours a_1..a_k (``idx`` (c, n, k)),
    ``dots[b, i]`` is the (k, k) Gram of (a_j - x_i) on mask b's dimensions
    and ``sq[b, i]`` its diagonal, the squared neighbour distances formed
    directly (the expansion used to select them cancels for close pairs).
    Shared by the abod and cof bases."""
    diffs = x_train[idx] * m[:, None, None, :] - (x[None] * m[:, None, :])[:, :, None, :]
    dots = diffs @ diffs.transpose(-1, -2)
    return dots, torch.diagonal(dots, dim1=-2, dim2=-1)


def abod_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor, k: int,
                       exclude_self: bool = False) -> torch.Tensor:
    """Negated angle-based outlier factor in the masked subspace (FastABOD,
    Kriegel et al. 2008; pyod ``ABOD(method='fast')``): over the k nearest
    masked neighbours a_1..a_k of each test row x, the population variance
    over pairs i < j of <a_i - x, a_j - x> / (|a_i - x|^2 |a_j - x|^2),
    negated so that higher is more outlying. Coincident points get an
    eps-guarded denominator (0, not NaN)."""
    if k < 2:
        raise ValueError(
            f"abod needs k >= 2 (the angle variance is over neighbor PAIRS); got k={k}"
        )
    eps = 1e-12
    m = _as_batch(mask, x_train)
    _, idx = _masked_knn_vals_idx(x_test, x_train, m, k, exclude_self)
    dots, sq = _neighbor_diff_gram(x_test, x_train, m, idx)
    wcos = dots / (sq[..., :, None] * sq[..., None, :] + eps)
    pair = torch.triu(torch.ones((k, k), dtype=x_train.dtype, device=x_train.device), 1)
    n_pairs = k * (k - 1) // 2
    mean = torch.sum(wcos * pair, dim=(-2, -1)) / n_pairs
    var = torch.sum((wcos - mean[..., None, None]) ** 2 * pair, dim=(-2, -1)) / n_pairs
    return -var[0] if mask.ndim == 1 else -var


def _cof_ac_dist(x: torch.Tensor, x_train: torch.Tensor, m: torch.Tensor, idx: torch.Tensor,
                 k: int) -> torch.Tensor:
    """(c, n) average chaining distance of each query row through its k
    nearest masked train neighbours, in ``idx``'s (value, index) order with
    the query as the chain's root: neighbour j costs its least masked
    distance to the prefix {root, n_1..n_{j-1}}, weighted 2 (k + 1 - j) /
    ((k + 1) k) (pyod COF's set-based nearest path, chained by distance from
    the root). The pair distances come from the difference Gram,
    |a_i - a_j|^2 = |a_i - x|^2 + |a_j - x|^2 - 2 <a_i - x, a_j - x>, which
    cancels in float32 for neighbours much closer to each other than to the
    root (as in the JAX package)."""
    dots, sq = _neighbor_diff_gram(x, x_train, m, idx)
    root_d = torch.sqrt(torch.clamp_min(sq, 0.0))
    pair_d = torch.sqrt(torch.clamp_min(sq[..., :, None] + sq[..., None, :] - 2.0 * dots, 0.0))
    big = torch.finfo(x.dtype).max / 4
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool, device=x.device), -1)
    # least distance to the strictly earlier neighbours (none for j = 1: big)
    prefix_min = torch.amin(torch.where(earlier, pair_d, big), dim=-1)
    cost = torch.minimum(root_d, prefix_min)
    j = torch.arange(1, k + 1, dtype=x.dtype, device=x.device)
    return torch.sum(cost * (2.0 * (k + 1 - j) / ((k + 1) * k)), dim=-1)


def cof_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor, k: int,
                      exclude_self: bool = False) -> torch.Tensor:
    """Connectivity-based outlier factor in the masked subspace (Tang et al.
    2002; pyod ``COF``): ``COF(x) = k ac(x) / sum_{o in kNN(x)} ac(o)`` with
    ``ac`` the average chaining distance (:func:`_cof_ac_dist`). The train
    rows' chains always leave out the row itself; ``exclude_self`` does the
    same for the query rows. Neighbour ties break by the smaller index; an
    all-duplicate neighbourhood (0/0) scores 0 through an eps-guarded
    denominator."""
    if k < 1:
        raise ValueError(f"cof needs k >= 1 (the chaining set); got k={k}")
    if k >= x_train.shape[0]:
        raise ValueError(
            f"cof needs k < n_train (self excluded from the train chain); "
            f"got k={k}, n_train={x_train.shape[0]}"
        )
    eps = 1e-12
    m = _as_batch(mask, x_train)
    _, idx_tr = _masked_knn_vals_idx(x_train, x_train, m, k, exclude_self=True)
    ac_tr = _cof_ac_dist(x_train, x_train, m, idx_tr, k)
    _, idx_te = _masked_knn_vals_idx(x_test, x_train, m, k, exclude_self=exclude_self)
    ac_te = _cof_ac_dist(x_test, x_train, m, idx_te, k)
    out = ac_te * k / (torch.sum(_gather_rows(ac_tr, idx_te), dim=-1) + eps)
    return out[0] if mask.ndim == 1 else out


def mahalanobis_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                              k: int = 0) -> torch.Tensor:
    """Squared Mahalanobis distance to the train distribution in the masked
    subspace (the PCA / MCD family with every component kept): (nt,) for a
    (d,) mask, (c, nt) for a (c, d) chunk.

    Centering commutes with masking, so each mask's covariance is the
    Hadamard-masked full covariance ``(m m^T) .* cov``. Unmasked dimensions
    get an identity diagonal (their residual is 0), masked ones a ridge of
    ``max(1e-6 trace / d_sub, 1e-12)``. The chunk's (c, d, d) matrices are
    factored in one batched Cholesky that does not sync the host; a failed
    factorization gives NaN scores, as the JAX package's Cholesky does. ``k``
    is ignored."""
    del k
    m = _as_batch(mask, x_train)
    n = x_train.shape[0]
    mu = torch.mean(x_train, dim=0)
    xc = x_train - mu
    cov = (xc.T @ xc) / max(n - 1, 1)
    cov_m = cov * (m[:, :, None] * m[:, None, :])
    d_sub = torch.clamp_min(torch.sum(m, dim=1), 1.0)
    trace = torch.diagonal(cov_m, dim1=-2, dim2=-1).sum(-1)
    ridge = torch.clamp_min(1e-6 * trace / d_sub, 1e-12)
    cov_m = cov_m + torch.diag_embed(m * ridge[:, None] + (1.0 - m))
    z = (x_test - mu)[None] * m[:, None, :]
    chol, info = torch.linalg.cholesky_ex(cov_m)
    chol = torch.where((info == 0)[:, None, None], chol, torch.nan)
    w = torch.cholesky_solve(z.transpose(-1, -2), chol)  # (c, d, nt)
    out = torch.sum(z * w.transpose(-1, -2), dim=-1)
    return out[0] if mask.ndim == 1 else out


def _iforest_adapter(x_test, x_train, mask, k, draws=None):
    """The ensemble's scorer signature for iforest (k is the tree count)."""
    return iforest_scores_masked(x_test, x_train, mask, n_trees=k, draws=draws)


# ---------------------------------------------------------------------------
# parametric bases: covariance and spectral (pca, kpca, mcd), clustering
# (cblof, gmm) and density (kde). Each scores a (c, d) chunk of masks with
# leading batch dimensions and Python loops over fixed iteration counts.
# ---------------------------------------------------------------------------


def _eigh_descending(a: torch.Tensor):
    """``(evals, evecs)`` of the symmetrized ``a``, largest first, the
    eigenvalues clipped at 0 (``jnp.linalg.eigh`` symmetrizes its input)."""
    evals, evecs = torch.linalg.eigh(0.5 * (a + a.mT))
    return torch.clamp_min(evals.flip(-1), 0.0), evecs.flip(-1)


def _leading_valid(evals: torch.Tensor) -> torch.Tensor:
    """Eigenvalues above ``1e-5 * lambda_max`` (and the dtype's tiny), the
    numerically zero directions excluded."""
    tiny = torch.finfo(evals.dtype).tiny
    return evals > torch.clamp_min(evals[..., :1] * 1e-5, tiny)


def _masked_standardize(x_test: torch.Tensor, x_train: torch.Tensor, m: torch.Tensor):
    """(c, ntr, d) and (c, nt, d) rows standardized by each mask's masked
    train columns (StandardScaler: ddof-0 std, a constant column scale 1;
    unmasked columns come out exactly 0). Shared by pca, ae and dsvdd."""
    xm_tr = x_train[None] * m[:, None, :]
    mu = torch.mean(xm_tr, dim=1, keepdim=True)
    scale = torch.sqrt(torch.mean((xm_tr - mu) ** 2, dim=1, keepdim=True))
    scale = torch.where(scale > 0.0, scale, 1.0)
    return (xm_tr - mu) / scale, (x_test[None] * m[:, None, :] - mu) / scale


def pca_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                      k: int = 0, *, n_components: int = 0, n_selected: int = 0,
                      standardize: bool = True, weighted: bool = True,
                      margins: Optional[list] = None) -> torch.Tensor:
    """pyod's PCA detector in the masked subspace: ``sum_j ||z - v_j|| /
    w_j`` over the selected components ``v_j`` (explained-variance ratio
    ``w_j``; unweighted when ``weighted=False``), z the query standardized by
    the train columns (ddof 0, a constant column scale 1) but not centred by
    PCA's own mean. Components follow sklearn's ``svd_flip`` sign rule (the
    largest-magnitude coefficient positive, the first row winning a tie);
    eigenvalues at or below ``1e-5 * lambda_max`` are excluded;
    ``n_selected`` takes components from the smallest-variance end of the
    kept ``n_components`` (0 means all, pyod's None). The counts stay
    tensors per mask: no host sync. ``margins`` (a list) receives each
    mask's least relative gap between a selected component's two largest
    coefficient magnitudes (the sign decision). ``k`` is ignored."""
    del k
    ntr, d = x_train.shape
    if ntr < 2:
        raise ValueError(
            f"pca needs at least 2 train rows to define a covariance; got n_train={ntr}"
        )
    m = _as_batch(mask, x_train)
    if standardize:
        z_tr, z_te = _masked_standardize(x_test, x_train, m)
    else:
        z_tr, z_te = x_train[None] * m[:, None, :], x_test[None] * m[:, None, :]
    z_trc = z_tr - torch.mean(z_tr, dim=1, keepdim=True)
    # unmasked dimensions are zero rows and columns of the covariance; give
    # them distinct negative eigenvalues (clipped to 0, so excluded, and the
    # masked block's eigenpairs unchanged): float32 eigh can fail to
    # converge on the many repeated zeros
    dead = (1.0 - m) * (1.0 + torch.arange(d, dtype=m.dtype, device=m.device) / d)
    evals, v = _eigh_descending(z_trc.mT @ z_trc / max(ntr - 1, 1) - torch.diag_embed(dead))
    i_star = torch.argmax(torch.abs(v), dim=-2, keepdim=True)
    sgn = torch.sign(torch.gather(v, -2, i_star))
    v = v * torch.where(sgn == 0.0, 1.0, sgn)
    valid = _leading_valid(evals)
    r = torch.sum(valid, dim=-1, keepdim=True)
    n_comp = torch.clamp_max(r, n_components) if n_components > 0 else r
    n_sel = torch.clamp_max(n_comp, n_selected) if n_selected > 0 else n_comp
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    selected = valid & (rank >= n_comp - n_sel) & (rank < n_comp)
    if margins is not None and d > 1:
        top = torch.topk(torch.abs(v), 2, dim=-2).values
        gap = (top[:, 0] - top[:, 1]) / torch.clamp_min(top[:, 0], 1e-30)
        margins.append(torch.amin(torch.where(selected, gap, torch.inf), dim=-1))
    coeff = selected.to(x_train.dtype)
    if weighted:
        tiny = torch.finfo(evals.dtype).tiny
        ratio = evals / torch.clamp_min(torch.sum(evals, dim=-1, keepdim=True), tiny)
        coeff = coeff / torch.clamp_min(ratio, 1e-12)
    sq = torch.sum(z_te * z_te, dim=-1, keepdim=True)
    dist = torch.sqrt(torch.clamp_min(sq + 1.0 - 2.0 * (z_te @ v), 0.0))
    out = (dist @ coeff[..., None])[..., 0]
    return out[0] if mask.ndim == 1 else out


def _kde_log_kernel_sum(x_test: torch.Tensor, x_train: torch.Tensor, m: torch.Tensor,
                        bandwidth: float, exclude_self: bool) -> torch.Tensor:
    """(c, nt) ``logsumexp_j(-d2_m(test_i, train_j) / (2 h^2))``, the train
    axis streamed in ``_stream_block(nt)`` blocks past ``STREAM_NTR`` with a
    running maximum and a rescaled sum of exponentials."""
    inv = 1.0 / (2.0 * bandwidth * bandwidth)
    ntr = x_train.shape[0]
    if ntr <= STREAM_NTR:
        d2 = _masked_sq_dists(x_test, x_train, m)
        if exclude_self:
            d2 = _mask_diagonal(d2)
        return torch.logsumexp(-d2 * inv, dim=-1)
    nt = x_test.shape[0]
    blk = _stream_block(nt)
    rows = torch.arange(nt, device=x_test.device)[:, None]
    m_run = torch.full((m.shape[0], nt), -torch.inf, dtype=x_test.dtype, device=x_test.device)
    s_run = torch.zeros_like(m_run)
    for b0 in range(0, ntr, blk):
        logk = -_masked_sq_dists(x_test, x_train[b0:b0 + blk], m) * inv
        if exclude_self:
            cols = torch.arange(b0, b0 + logk.shape[-1], device=x_test.device)[None, :]
            logk = torch.where(rows == cols, -torch.inf, logk)
        # the first block holds a column other than the row itself, so the
        # running maximum is finite from it on
        m_new = torch.maximum(m_run, torch.amax(logk, dim=-1))
        s_run = s_run * torch.exp(m_run - m_new) + torch.sum(torch.exp(logk - m_new[..., None]),
                                                             dim=-1)
        m_run = m_new
    return m_run + torch.log(s_run)


def kde_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                      k: int = 0, *, bandwidth: float = 1.0,
                      exclude_self: bool = False) -> torch.Tensor:
    """Negative Gaussian-KDE log-density in the masked subspace:
    ``-(logsumexp_j(-d2_m / (2 h^2)) - log n - (d_sub / 2) log(2 pi h^2))``,
    sklearn ``KernelDensity`` for an all-column mask. ``exclude_self`` drops
    the positional (i, i) pair and divides by n - 1. ``k`` is ignored."""
    del k
    m = _as_batch(mask, x_train)
    ntr = x_train.shape[0]
    ll = _kde_log_kernel_sum(x_test, x_train, m, bandwidth, exclude_self)
    n_eff = max(ntr - 1, 1) if exclude_self else ntr
    log_norm = math.log(n_eff) + 0.5 * torch.sum(m, dim=1) * math.log(
        2.0 * math.pi * bandwidth * bandwidth)
    out = log_norm[:, None] - ll
    return out[0] if mask.ndim == 1 else out


def _bin_index(x: torch.Tensor, lo: torch.Tensor, width: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Equal-width histogram bin numbers from ``lo``, clipped to [0, n_bins):
    clamped before the cast so that far values cannot overflow int64, and
    truncated toward zero by it, as the JAX package's ``astype`` does.
    Shared by hbos and loda."""
    b = torch.clamp((x - lo) / width, -1.0, float(n_bins)).to(torch.int64)
    return torch.clamp(b, 0, n_bins - 1)


@functools.lru_cache(maxsize=None)
def draw_loda_directions(d: int, n_projections: int, seed: int, device=None,
                         dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """loda's (d, n_projections) N(0, 1) directions: drawn in float64 from a
    CPU ``torch.Generator`` seeded with ``seed``, then cast and moved once per
    (device, dtype) and shared by every chunk and mask. (The JAX package draws
    from ``PRNGKey(seed)``, which torch cannot reproduce.)"""
    g = torch.Generator().manual_seed(int(seed))
    w = torch.randn((int(d), int(n_projections)), generator=g, dtype=torch.float64)
    return w.to(device=device, dtype=dtype)


def loda_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                       k: int = 0, *, n_projections: int = 100, n_bins: int = 10, seed: int = 0,
                       directions: Optional[torch.Tensor] = None,
                       margins: Optional[list] = None) -> torch.Tensor:
    """LODA (Pevny 2016; pyod LODA) in the masked subspace: the mean over
    the masked directions ``W .* m`` of the negative log density of each
    query's bin in an equal-width ``n_bins`` histogram of the train
    projections. Dense directions (not pyod's sqrt(d)-sparse ones), shared
    by every mask: ``directions`` (d, n_projections), else
    :func:`draw_loda_directions` of ``seed``. Bin numbers truncate toward
    zero and clip to the histogram; a query outside the train range gets
    density 0 (score ``-log(1e-12)``). The lookup is ``n_bins`` compare
    passes, no scatter. ``margins`` (a list) receives each (mask, query)'s
    least distance, over the directions, from its projection to a bin edge
    (the range's ends included), relative to the projections' magnitude
    ``sum_j |x_j w_j|``. ``k`` is ignored."""
    del k
    eps = 1e-12
    ntr, d = x_train.shape
    if directions is None:
        directions = draw_loda_directions(d, n_projections, seed, x_train.device, x_train.dtype)
    m = _as_batch(mask, x_train)
    wm = directions.to(device=x_train.device, dtype=x_train.dtype)[None] * m[:, :, None]
    z_tr, z_te = x_train @ wm, x_test @ wm  # (c, rows, P)
    lo = torch.amin(z_tr, dim=1, keepdim=True)
    hi = torch.amax(z_tr, dim=1, keepdim=True)
    width = torch.clamp_min((hi - lo) / n_bins, eps)
    idx_tr, idx_te = _bin_index(z_tr, lo, width, n_bins), _bin_index(z_te, lo, width, n_bins)
    density = torch.zeros_like(z_te)
    for b in range(n_bins):
        count = torch.sum(idx_tr == b, dim=1, keepdim=True).to(x_train.dtype)
        density = density + torch.where(idx_te == b, count / (ntr * width), 0.0)
    in_range = (z_te >= lo) & (z_te <= hi)
    if margins is not None:
        aw = torch.abs(wm)
        scale = torch.abs(x_test) @ aw + torch.amax(torch.abs(x_train) @ aw, dim=1, keepdim=True)
        edges = lo[..., None] + width[..., None] * torch.arange(
            n_bins + 1, dtype=x_train.dtype, device=x_train.device)  # (c, 1, P, B + 1)
        rel = torch.amin(torch.abs(z_te[..., None] - edges), dim=-1) / scale
        # 0 / 0: no masked column, every projection exactly 0
        margins.append(torch.amin(torch.nan_to_num(rel, nan=torch.inf), dim=-1))
    out = torch.mean(-torch.log(torch.where(in_range, density, 0.0) + eps), dim=-1)
    return out[0] if mask.ndim == 1 else out


@functools.lru_cache(maxsize=None)
def _inne_centres(ntr: int, psi: int, n_estimators: int, seed: int) -> np.ndarray:
    """(T, psi) train rows of the INNE members, ``psi`` without replacement
    a member from one ``np.random.default_rng(seed)``: the JAX package's
    draws."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(ntr, size=psi, replace=False) for _ in range(n_estimators)])


def inne_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                       k: int = 0, *, n_estimators: int = 100, psi: int = 8,
                       seed: int = 0, margins: Optional[list] = None) -> torch.Tensor:
    """INNE (Bandaragoda et al. 2018; pyod INNE) in the masked subspace, all
    distances squared: each member's ``psi`` centres
    (:func:`_inne_centres`, shared by every mask) get the squared distance
    to their nearest fellow centre as radius and ``1 - r2[nn(c)] /
    max(r2[c], 1e-30)`` as isolation ratio; a query takes the ratio of the
    smallest ball covering it (ties to the lowest index) and 1 where none
    does, averaged over members. ``psi`` clamps to n_train. ``margins`` (a
    list) receives each mask's least gap between a centre's two nearest
    fellows of other radii, and each (mask, query)'s least gap between its
    distance to a centre and that radius and between the smallest covering
    radius and another of another ratio, each relative to the two rows'
    squared norms. ``k`` is ignored."""
    del k
    ntr, d = x_train.shape
    psi_eff = min(int(psi), int(ntr))
    if psi_eff < 2:
        raise ValueError(
            f"inne needs at least 2 train rows to define ball radii; got n_train={ntr} "
            f"(psi={psi})"
        )
    t = int(n_estimators)
    idx = torch.as_tensor(_inne_centres(ntr, psi_eff, t, int(seed)).reshape(-1),
                          device=x_train.device)
    m = _as_batch(mask, x_test)
    c, nt = m.shape[0], x_test.shape[0]
    cm = x_train[idx][None] * m[:, None, :]  # (c, T psi, d)
    sq_c = torch.sum(cm * cm, dim=-1)
    cm_t, sq_t = cm.view(c, t, psi_eff, d), sq_c.view(c, t, psi_eff)
    d2_cc = torch.clamp_min(sq_t[..., :, None] + sq_t[..., None, :] - 2.0 * (cm_t @ cm_t.mT), 0.0)
    big = torch.finfo(x_test.dtype).max / 4
    d2_cc = torch.where(torch.eye(psi_eff, dtype=torch.bool, device=x_test.device), big, d2_cc)
    r2, nn = torch.min(d2_cc, dim=-1)  # (c, T, psi); ties to the first index
    ratio = 1.0 - torch.gather(r2, -1, nn) / torch.clamp_min(r2, 1e-30)
    # x . (m .* c) == (m .* x) . (m .* c) for a 0/1 mask
    sq_x = ((x_test * x_test) @ m.T).T
    d2_q = torch.clamp_min(sq_x[:, :, None] + sq_c[:, None, :] - 2.0 * (x_test @ cm.mT), 0.0)
    d2_q = d2_q.view(c, nt, t, psi_eff)
    covered = d2_q <= r2[:, None]
    sel = torch.argmin(torch.where(covered, r2[:, None], big), dim=-1, keepdim=True)
    ratio_sel = torch.gather(ratio[:, None].expand(c, nt, t, psi_eff), -1, sel)[..., 0]
    if margins is not None:
        norms = sq_t[..., :, None] + sq_t[..., None, :]
        two = torch.topk(d2_cc, 2, dim=-1, largest=False)
        r2_two = torch.gather(r2[..., None, :].expand(*d2_cc.shape), -1, two.indices)
        nn_gap = torch.where(r2_two[..., 0] == r2_two[..., 1], torch.inf,
                             (two.values[..., 1] - two.values[..., 0])
                             / torch.gather(norms, -1, two.indices[..., :1])[..., 0])
        margins.append(torch.amin(nn_gap, dim=(1, 2)))
        q_norms = (sq_x[:, :, None] + sq_c[:, None, :]).view(c, nt, t, psi_eff)
        r2_sel = torch.gather(r2[:, None].expand(c, nt, t, psi_eff), -1, sel)
        other = covered & (torch.abs(ratio[:, None] - ratio_sel[..., None]) > 1e-6)
        gap = torch.minimum(torch.abs(d2_q - r2[:, None]),
                            torch.where(other, r2[:, None] - r2_sel, torch.inf)) / q_norms
        # 0 / 0: a query and a centre of no masked norm, whose distances are exact
        margins.append(torch.amin(torch.nan_to_num(gap, nan=torch.inf), dim=(2, 3)))
    out = torch.mean(torch.where(covered.any(dim=-1), ratio_sel, 1.0), dim=-1)
    return out[0] if mask.ndim == 1 else out


@functools.lru_cache(maxsize=None)
def _mcd_tables(ntr: int, d: int, support_fraction: float):
    """Per active dimension count p = 1..d (float64 numpy): the support
    size h, the raw consistency factor ``c(p, h / n)``, ``chi2.ppf(0.975,
    p)`` and ``c(p, 0.975)``, with sklearn's ``c(p, a) = a / chi2.cdf(
    chi2.ppf(a, p), p + 2)`` (``a`` where the quantile is infinite)."""
    dofs = np.arange(1, d + 1)

    def consistency(alpha):
        q = chi2_ppf(np.clip(alpha, 0.0, 1.0), dofs)
        with np.errstate(invalid="ignore", divide="ignore"):
            return alpha / np.where(np.isfinite(q), chi2_cdf(q, dofs + 2), 1.0)

    if support_fraction > 0.0:
        h = np.full(d, int(support_fraction * ntr))
    else:
        h = np.minimum(np.ceil(0.5 * (ntr + dofs + 1)).astype(np.int64), ntr)
    return (h, consistency(h / ntr), chi2_ppf(np.full(d, 0.975), dofs),
            consistency(np.full(d, 0.975)))


@functools.lru_cache(maxsize=None)
def _mcd_start_ranks(ntr: int, n_starts: int, seed: int) -> np.ndarray:
    """(n_starts, ntr) rank of each train row in each start's permutation,
    one ``np.random.default_rng(seed).permutation(ntr)`` a start: the JAX
    package's draws, shared by every mask and chunk."""
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(ntr) for _ in range(n_starts)])
    return np.argsort(perms, axis=1)


def _h_smallest(d2: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """0/1 weights of exactly the ``h`` smallest entries of each row, ties
    to the smaller index (a stable argsort, then its inverse permutation)."""
    order = torch.argsort(d2, dim=-1, stable=True)
    ranks = torch.arange(d2.shape[-1], device=d2.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, ranks)
    return (rank < h[..., None]).to(d2.dtype)


def mcd_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                      k: int = 0, *, support_fraction: float = 0.0, n_starts: int = 8,
                      c_steps: int = 15, seed: int = 0,
                      margins: Optional[list] = None) -> torch.Tensor:
    """Minimum Covariance Determinant (FastMCD; sklearn ``MinCovDet`` under
    pyod's MCD) in the masked subspace: squared Mahalanobis distance of the
    queries to the reweighted robust estimate.

    Support size ``h = min(ceil((n + p + 1) / 2), n)`` with p the mask's
    active dimensions (``int(support_fraction * n)`` when it is > 0);
    ``n_starts`` starts, each the first p + 1 rows of a seeded permutation,
    run ``c_steps`` c-steps (the biased mean and covariance of the current h
    rows, then the h smallest Mahalanobis distances, ties to the smaller
    index); the start with the least masked log-determinant wins. The raw
    estimate's distances are divided by ``c(p, h / n)``, rows below
    ``chi2.ppf(0.975, p)`` are kept, and the queries' distances to their
    biased covariance are divided by ``c(p, 0.975)``. Covariances are the
    Hadamard-masked full ones with an identity diagonal on unmasked
    dimensions and the mahalanobis base's ridge; a failed factorization
    gives NaN, with no host sync. The chunk's masks and the starts share one
    leading batch dimension. ``margins`` (a list) receives each mask's least
    relative gap at the winning start's h-subset boundaries and at the
    reweighting threshold. ``k`` is ignored."""
    del k
    ntr, d = x_train.shape
    if ntr < 2:
        raise ValueError(
            f"mcd needs at least 2 train rows to define a covariance; got n_train={ntr}"
        )
    dt, dev = x_train.dtype, x_train.device
    h_tab, corr_raw, chi2_rw, c_alpha = (
        torch.as_tensor(t, device=dev) for t in _mcd_tables(ntr, d, float(support_fraction)))
    m = _as_batch(mask, x_train)
    c = m.shape[0]
    xm = x_train[None] * m[:, None, :]  # (c, ntr, d)
    pop = torch.sum(m, dim=1)
    p_sub = torch.clamp_min(pop, 1.0)
    p_idx = torch.clamp(pop.to(torch.int64) - 1, 0, d - 1)
    h = h_tab[p_idx]
    fix = torch.diag_embed(1.0 - m)
    mm = m[:, :, None] * m[:, None, :]

    def robust_cov(w, lead):
        """Mean, Cholesky factor and masked log-determinant of the biased
        weighted covariance; ``w`` is (c, *lead, ntr)."""
        view = (c,) + (1,) * len(lead)
        xb, mb = xm.view(view + (ntr, d)), m.view(view + (d,))
        sw = torch.clamp_min(torch.sum(w, dim=-1), 1.0)
        mu = (w[..., None, :] @ xb)[..., 0, :] / sw[..., None]
        xc = xb - mu[..., None, :]
        cov = (w[..., :, None] * xc).mT @ xc / sw[..., None, None] * mm.view(view + (d, d))
        ridge = torch.clamp_min(
            1e-6 * torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1) / p_sub.view(view), 1e-12)
        cov = cov + fix.view(view + (d, d)) + torch.diag_embed(ridge[..., None] * mb)
        chol, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where((info == 0)[..., None, None], chol, torch.nan)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)) * mb, dim=-1)
        return mu, chol, logdet

    def maha(chol, mu, x):
        """(c, *lead, rows) squared distances of ``x``'s masked rows."""
        lead = mu.shape[1:-1]
        z = x[None] * m[:, None, :]
        z = z.view((c,) + (1,) * len(lead) + z.shape[1:]) - mu[..., None, :]
        y = torch.linalg.solve_triangular(chol, z.mT, upper=False)
        return torch.sum(y * y, dim=-2)

    ranks = torch.as_tensor(_mcd_start_ranks(ntr, int(n_starts), int(seed)), device=dev)
    first = torch.clamp_max(pop.to(torch.int64) + 1, ntr)
    w = (ranks[None] < first[:, None, None]).to(dt)  # (c, S, ntr)
    lead = (int(n_starts),)
    gaps = torch.full(w.shape[:2], torch.inf, dtype=dt, device=dev)
    for _ in range(int(c_steps)):
        mu, chol, _ = robust_cov(w, lead)
        d2 = maha(chol, mu, x_train)
        w = _h_smallest(d2, h[:, None])
        if margins is not None:
            vals = torch.sort(d2, dim=-1).values
            at = torch.clamp(h, 1, ntr - 1)[:, None, None].expand(c, int(n_starts), 1)
            gap = (torch.gather(vals, -1, at) - torch.gather(vals, -1, at - 1))[..., 0]
            gap = gap / torch.clamp_min(torch.gather(vals, -1, at)[..., 0], 1e-30)
            gaps = torch.minimum(gaps, torch.where((h < ntr)[:, None], gap, torch.inf))
    logdet = robust_cov(w, lead)[2]
    best = torch.argmin(logdet, dim=1)
    w_raw = torch.gather(w, 1, best[:, None, None].expand(c, 1, ntr))[:, 0]
    mu, chol, _ = robust_cov(w_raw, ())
    d2 = maha(chol, mu, x_train) / torch.clamp_min(corr_raw[p_idx], 1e-30).to(dt)[:, None]
    thr = chi2_rw[p_idx].to(dt)[:, None]
    w_rw = (d2 < thr).to(dt)
    if margins is not None:
        margins.append(torch.minimum(
            torch.gather(gaps, 1, best[:, None])[:, 0],
            torch.amin(torch.abs(d2 - thr), dim=-1) / thr[:, 0]))
    mu, chol, _ = robust_cov(w_rw, ())
    out = maha(chol, mu, x_test) / torch.clamp_min(c_alpha[p_idx], 1e-30).to(dt)[:, None]
    return out[0] if mask.ndim == 1 else out


@functools.lru_cache(maxsize=None)
def _subsample_rows(ntr: int, size: int, seed: int) -> np.ndarray:
    """The train subsample of sampling and of ``kpca_sampling``: the JAX
    package's host draw ``np.random.default_rng(seed).choice(ntr, size,
    replace=False)``, shared by every mask."""
    return np.random.default_rng(seed).choice(ntr, size=size, replace=False)


def sampling_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                           k: int = 0, *, subset_size: int = 20, seed: int = 0) -> torch.Tensor:
    """Sampling outlier detector (Sugiyama & Borgwardt 2013; pyod Sampling)
    in the masked subspace: the distance to the nearest of ``subset_size``
    train rows drawn by :func:`_subsample_rows` (clamped to n_train, where
    pyod raises). ``k`` is ignored."""
    del k
    ntr = x_train.shape[0]
    if ntr < 1:
        raise ValueError(f"sampling needs at least 1 train row; got {ntr}")
    size = max(1, min(int(subset_size), int(ntr)))
    idx = torch.as_tensor(_subsample_rows(ntr, size, int(seed)), device=x_train.device)
    return torch.sqrt(torch.amin(_masked_sq_dists(x_test, x_train[idx], mask), dim=-1))


def sod_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                      k: int = 20, *, ref_set: int = 10, alpha: float = 0.8,
                      exclude_self: bool = False,
                      margins: Optional[list] = None) -> torch.Tensor:
    """Subspace Outlier Detection (Kriegel et al. 2009; pyod SOD) in the
    masked subspace, novelty-style: each query's reference set is the
    ``ref_set`` train rows sharing most of its k nearest neighbours (the
    train rows' lists leave themselves out; the query's only under
    ``exclude_self``, which also drops the (i, i) pair from the reference
    set), ties to the lowest index; the relevant dimensions are the mask's
    whose reference variance is below ``alpha`` times the mean over the
    mask's dimensions; the score is ``sqrt(sum_rel (x - mean)^2 / n_rel)``,
    0 with none relevant. Neighbours in ``(value, index)`` order; the SNN
    counts are one product of 0/1 neighbour indicators. ``margins`` (a list)
    receives each (mask, query)'s least relative gap at a decision: between
    its k-th and (k + 1)-th neighbour, the same for each train row whose
    k-th or (k + 1)-th neighbour is among the query's (the SNN count could
    change), both relative to the rows' squared norms, and between a
    dimension's reference variance and its threshold, relative to their
    sum."""
    ntr, d = x_train.shape
    if int(k) < 1 or int(k) >= ntr:
        raise ValueError(
            f"sod needs 1 <= k < n_train neighbors (pyod clamps the same way); got k={k} "
            f"with n_train={ntr}"
        )
    r_eff = min(int(ref_set), ntr)
    if r_eff < 1:
        raise ValueError(f"ref_set must be >= 1; got {ref_set!r}")
    m = _as_batch(mask, x_train)
    c, nt = m.shape[0], x_test.shape[0]
    # with margins, one neighbour more: the (k + 1)-th bounds the k-th's place
    kk = min(k + 1, ntr - 1) if margins is not None else k
    d2_tr, idx_tr = _k_smallest_by_index(
        _mask_diagonal(_masked_sq_dists(x_train, x_train, m)), kk)
    d2_te = _masked_sq_dists(x_test, x_train, m)
    if exclude_self:
        d2_te = _mask_diagonal(d2_te)
    d2_te, idx_te = _k_smallest_by_index(d2_te, kk)
    t_ind = torch.zeros((c, ntr, ntr), dtype=x_train.dtype, device=x_train.device)
    q_ind = torch.zeros((c, nt, ntr), dtype=x_train.dtype, device=x_train.device)
    q_ind.scatter_(-1, idx_te[..., :k], 1.0)
    snn = q_ind @ t_ind.scatter_(-1, idx_tr[..., :k], 1.0).mT
    del t_ind
    if margins is not None:
        tr_norm = ((x_train * x_train) @ m.T).T

        def boundary_gap(d2, idx, q_norm):
            """(c, rows) gap between the k-th and (k + 1)-th neighbours."""
            if kk == k:  # every other train row is a neighbour
                return torch.full(d2.shape[:-1], torch.inf, dtype=d2.dtype, device=d2.device)
            b_norm = torch.gather(tr_norm[:, None, :].expand(-1, d2.shape[1], -1), -1,
                                  idx[..., k - 1:k + 1]).amax(dim=-1)
            # 0 / 0: rows of no masked norm, whose distances are exact
            return torch.nan_to_num((d2[..., k] - d2[..., k - 1]) / (q_norm + b_norm),
                                    nan=torch.inf)

        list_gap = boundary_gap(d2_te, idx_te, ((x_test * x_test) @ m.T).T)
        if kk > k:  # train row j's count changes only if a boundary neighbour is the query's
            gap_tr = boundary_gap(d2_tr, idx_tr, tr_norm)
            hit = sum(torch.gather(q_ind, -1, idx_tr[:, None, :, i].expand(c, nt, ntr))
                      for i in (k - 1, k)) > 0
            list_gap = torch.minimum(list_gap, torch.amin(
                torch.where(hit, gap_tr[:, None, :], torch.inf), dim=-1))
    del q_ind, d2_tr, d2_te
    if exclude_self:
        snn = -_mask_diagonal(-snn)
    # SNN counts are small integers: the -index / (2 ntr) bias (below the
    # count gap of 1) makes every key distinct, the lowest index first
    snn = snn - torch.arange(ntr, dtype=x_train.dtype, device=x_train.device) * (0.5 / ntr)
    ref_idx = torch.topk(snn, r_eff, dim=-1).indices  # (c, nt, R)
    xm = x_train[None] * m[:, None, :]
    ref = xm[torch.arange(c, device=x_train.device)[:, None, None], ref_idx]  # (c, nt, R, d)
    means = torch.mean(ref, dim=2)
    var = torch.mean((ref - means[:, :, None]) ** 2, dim=2)
    d_sub = torch.clamp_min(torch.sum(m, dim=1), 1.0)[:, None, None]
    thr = alpha * torch.sum(var, dim=-1, keepdim=True) / d_sub
    ind = ((var < thr) & (m[:, None, :] > 0)).to(x_train.dtype)
    if margins is not None:
        var_gap = torch.where(m[:, None, :] > 0,
                              torch.nan_to_num(torch.abs(var - thr) / (var + thr), nan=torch.inf),
                              torch.inf)
        margins.append(torch.minimum(list_gap, torch.amin(var_gap, dim=-1)))
    rel = torch.sum(ind, dim=-1)
    dev = torch.sum(ind * (x_test[None] * m[:, None, :] - means) ** 2, dim=-1)
    out = torch.where(rel > 0, torch.sqrt(dev / torch.clamp_min(rel, 1.0)), 0.0)
    return out[0] if mask.ndim == 1 else out


def kpca_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                       k: int = 0, *, n_components: int = 0, gamma: float = 0.0,
                       sampling: bool = False, subset_size: int = 20,
                       seed: int = 0) -> torch.Tensor:
    """Kernel-PCA novelty score (Hoffmann 2007; pyod KPCA) with an RBF
    kernel in the masked subspace: the spherical potential ``1 - 2
    mean_j k(x, x_j) + mean_ij k(x_i, x_j)`` minus the squared projections
    onto the double-centred train kernel's components, each divided by its
    eigenvalue. ``gamma = 0`` means ``1 / popcount(mask)``; components at or
    below ``1e-5 * lambda_max`` are excluded and ``n_components = 0`` keeps
    every other one. ``sampling=True`` fits on ``subset_size`` train rows
    drawn by ``np.random.default_rng(seed)``, shared by every mask. One
    (n, n) ``eigh`` a mask. ``k`` is ignored."""
    del k
    ntr = x_train.shape[0]
    if sampling:
        size = max(2, min(int(subset_size), int(ntr)))
        idx = torch.as_tensor(_subsample_rows(ntr, size, int(seed)), device=x_train.device)
        x_fit = x_train[idx]
    else:
        x_fit = x_train
    n = x_fit.shape[0]
    if n < 2:
        raise ValueError(
            f"kpca needs at least 2 fit rows to define a kernel spectrum; got n_train={n}"
        )
    m = _as_batch(mask, x_fit)
    g = gamma if gamma > 0.0 else (1.0 / torch.clamp_min(torch.sum(m, dim=1), 1.0))[:, None, None]
    k_tr = torch.exp(-g * _masked_sq_dists(x_fit, x_fit, m))
    k_te = torch.exp(-g * _masked_sq_dists(x_test, x_fit, m))
    col_mean = torch.mean(k_tr, dim=-2)  # (c, n)
    all_mean = torch.mean(col_mean, dim=-1)[:, None, None]
    evals, alphas = _eigh_descending(k_tr - col_mean[:, None, :] - col_mean[:, :, None]
                                     + all_mean)
    valid = _leading_valid(evals)
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    selected = valid & (rank < n_components) if n_components > 0 else valid
    te_mean = torch.mean(k_te, dim=-1, keepdim=True)
    proj = (k_te - te_mean - col_mean[:, None, :] + all_mean) @ alphas
    tiny = torch.finfo(evals.dtype).tiny
    proj_sq = torch.where(selected[:, None, :], proj * proj
                          / torch.clamp_min(evals, tiny)[:, None, :], 0.0)
    out = 1.0 - 2.0 * te_mean[..., 0] + all_mean[..., 0] - torch.sum(proj_sq, dim=-1)
    return out[0] if mask.ndim == 1 else out


def _as_numpy_dtype(dtype: torch.dtype):
    return np.float32 if dtype == torch.float32 else np.float64


@functools.lru_cache(maxsize=None)
def _fista_momenta(iters: int, np_dtype) -> tuple:
    """FISTA's momentum coefficients ``(t - 1) / t_new``, ``t_new = (1 +
    sqrt(1 + 4 t^2)) / 2`` from t = 1, in ``np_dtype`` arithmetic as the JAX
    package's scan carries t in the rows' dtype."""
    one, t, out = np_dtype(1.0), np_dtype(1.0), []
    for _ in range(iters):
        t_new = np_dtype(0.5) * (one + np.sqrt(one + np_dtype(4.0) * t * t))
        out.append(float((t - one) / t_new))
        t = t_new
    return tuple(out)


def ocsvm_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                        k: int = 0, *, nu: float = 0.5, gamma: float = 0.0,
                        iters: int = 300) -> torch.Tensor:
    """One-class SVM (Schölkopf et al. 2001; pyod OCSVM over sklearn's
    OneClassSVM) in the masked subspace, RBF kernel: the libsvm dual ``min
    a^T K a / 2`` over the capped simplex ``0 <= a <= 1 / (nu n)``, ``sum a
    = 1``, by ``iters`` projected FISTA steps of size ``1 / (1.02
    lambda_max)`` (30 power steps from a uniform start), each projection a
    60-step bisection on the shift from ``(min v - C, max v)``. ``rho`` is
    the mean of ``K a`` over the margin support vectors (tolerance ``1e-3
    C``), else over all of them; the score is ``(rho - K_test a) nu n``,
    sklearn's negated decision function. ``gamma = 0`` means ``1 /
    popcount(mask)``. The chunk's masks are one batch in every step (a few
    hundred launches a step on the card). ``k`` is ignored."""
    del k
    ntr = x_train.shape[0]
    if ntr < 2:
        raise ValueError(f"ocsvm needs at least 2 train rows; got n_train={ntr}")
    if not 0.0 < nu <= 1.0:
        raise ValueError(
            f"nu must be in (0, 1] (Schölkopf's outlier-fraction bound); got {nu!r}"
        )
    dt = x_train.dtype
    m = _as_batch(mask, x_train)
    g = gamma if gamma > 0.0 else (1.0 / torch.clamp_min(torch.sum(m, dim=1), 1.0))[:, None, None]
    k_tr = torch.exp(-g * _masked_sq_dists(x_train, x_train, m))  # (c, n, n)
    k_te = torch.exp(-g * _masked_sq_dists(x_test, x_train, m))
    cap = 1.0 / (nu * ntr)
    tiny = torch.finfo(dt).tiny

    def k_times(v):
        return (k_tr @ v[..., None])[..., 0]

    def power_step(i, b):
        b = k_times(b)
        return (b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + tiny),)

    b = torch.full((m.shape[0], ntr), 1.0 / math.sqrt(ntr), dtype=dt, device=x_train.device)
    (b,) = _fixed_loop(30, power_step, (b,))
    step = (1.0 / (torch.sum(b * k_times(b), dim=-1) * 1.02 + tiny))[:, None]

    def project(v):
        def bisect(i, lo, hi):
            mid = 0.5 * (lo + hi)
            above = torch.sum(torch.clamp(v - mid, 0.0, cap), dim=-1, keepdim=True) > 1.0
            return torch.where(above, mid, lo), torch.where(above, hi, mid)

        lo, hi = _fixed_loop(60, bisect, (torch.amin(v, dim=-1, keepdim=True) - cap,
                                          torch.amax(v, dim=-1, keepdim=True)))
        return torch.clamp(v - 0.5 * (lo + hi), 0.0, cap)

    momentum = _loop_table(_fista_momenta(int(iters), _as_numpy_dtype(dt)), dt, x_train.device)

    def fista_step(i, a, y):
        a_new = project(y - step * k_times(y))
        return a_new, a_new + momentum(i) * (a_new - a)

    a = torch.full_like(b, 1.0 / ntr)
    a, _ = _fixed_loop(int(iters), fista_step, (a, a))
    f_tr = k_times(a)
    tol = cap * 1e-3
    margin = (a > tol) & (a < cap - tol)
    sv = a > tol
    n_margin = torch.sum(margin, dim=-1).to(dt)
    rho_margin = torch.sum(torch.where(margin, f_tr, 0.0), dim=-1) / torch.clamp_min(n_margin, 1.0)
    rho_sv = (torch.sum(torch.where(sv, f_tr, 0.0), dim=-1)
              / torch.clamp_min(torch.sum(sv, dim=-1).to(dt), 1.0))
    rho = torch.where(n_margin > 0, rho_margin, rho_sv)
    out = (rho[:, None] - (k_te @ a[..., None])[..., 0]) * (nu * ntr)
    return out[0] if mask.ndim == 1 else out


def sos_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                      k: int = 0, *, perplexity: float = 4.5, iters: int = 64,
                      exclude_self: bool = False) -> torch.Tensor:
    """Stochastic Outlier Selection (Janssens et al. 2012; pyod SOS) in the
    masked subspace: each train row's affinities ``exp(-beta_i d2_ij)``,
    ``beta_i`` from ``iters`` bisection steps (from 1, doubling while the
    upper bound is open, halving while the lower is 0) toward binding
    entropy ``log(perplexity)``, on the kernel shifted by the row's
    off-diagonal minimum. A query's score is ``prod_i (1 - b_i(x))``, the
    binding probabilities formed in log space: a novel query joins row i's
    denominator, with the betas frozen at their train values; under
    ``exclude_self`` the leading ``n_train`` queries are the train rows
    themselves and take the transductive formula without the (t, t) pair.
    The guard ``perplexity < n_train`` is the JAX package's (a perplexity in
    [n_train - 1, n_train) cannot be reached: the bisection halves beta
    ``iters`` times). ``k`` is ignored."""
    del k
    n_tr = x_train.shape[0]
    if n_tr < 2:
        raise ValueError(
            f"sos needs at least 2 train rows (the binding distribution is over the other "
            f"points); got {n_tr}"
        )
    if not perplexity < n_tr:
        raise ValueError(
            f"sos needs perplexity < n_train (scikit-sos's constraint); got "
            f"perplexity={perplexity} with n_train={n_tr}"
        )
    dt = x_train.dtype
    m = _as_batch(mask, x_train)
    diag = torch.eye(n_tr, dtype=torch.bool, device=x_train.device)
    dshift = _masked_sq_dists(x_train, x_train, m)
    dmin = torch.amin(dshift.masked_fill(diag, torch.inf), dim=-1)
    dshift.sub_(dmin[..., None])  # >= 0 off the diagonal
    log_u = math.log(perplexity)
    tiny = torch.finfo(dt).tiny

    def entropy_sumq(beta):
        q = torch.exp(-dshift * beta[..., None]).masked_fill_(diag, 0.0)
        sumq = torch.clamp_min(torch.sum(q, dim=-1), tiny)
        return torch.log(sumq) + beta * torch.sum(dshift * q, dim=-1) / sumq, sumq

    def bisect(i, beta, lo, hi):
        too_spread = entropy_sumq(beta)[0] > log_u  # raise beta to sharpen
        lo = torch.where(too_spread, beta, lo)
        hi = torch.where(too_spread, hi, beta)
        half = 0.5 * (lo + hi)
        beta = torch.where(too_spread, torch.where(torch.isinf(hi), beta * 2.0, half),
                           torch.where(lo == 0.0, beta * 0.5, half))
        return beta, lo, hi

    beta = torch.ones(dmin.shape, dtype=dt, device=x_train.device)
    beta, _, _ = _fixed_loop(int(iters), bisect,
                             (beta, torch.zeros_like(beta), torch.full_like(beta, torch.inf)))
    sumq = entropy_sumq(beta)[1]
    del dshift
    log_sum_a = (-beta * dmin + torch.log(sumq))[..., None]  # log sum_{j != i} a_ij
    log_a_te = -beta[..., None] * _masked_sq_dists(x_train, x_test, m)  # (c, n_tr, nt)
    novel = log_a_te - torch.logaddexp(log_sum_a, log_a_te)
    if exclude_self:
        cols = torch.arange(x_test.shape[0], device=x_train.device)
        rows = torch.arange(n_tr, device=x_train.device)[:, None]
        b = torch.exp(torch.where(cols < n_tr, log_a_te - log_sum_a, novel))
        b = torch.where(rows == cols, 0.0, b)
    else:
        b = torch.exp(novel)
    out = torch.exp(torch.sum(torch.log1p(-torch.clamp(b, 0.0, 1.0)), dim=-2))
    return out[0] if mask.ndim == 1 else out


_LMDD_BLOCK = 256  # train-row block of the aad deviation plane


def lmdd_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                       k: int = 0, *, dis_measure: str = "var",
                       exclude_self: bool = False) -> torch.Tensor:
    """Deviation-based outlier detection (Arning, Agrawal & Raghavan 1996;
    the pyod lmdd family) in the masked subspace, singleton exception sets
    in closed form: a novel row scores ``n max(D(X + x) - D(X), 0)``; under
    ``exclude_self`` the leading ``n`` rows are the train rows and score
    ``(n - 1) max(D(X) - D(X \\ x), 0)``. ``dis_measure`` 'var' (mean
    per-dimension variance over the mask's dimensions) uses the exact update
    and downdate identities; 'aad' (mean absolute deviation) accumulates the
    per-element deviation differences over ``_LMDD_BLOCK`` train rows at a
    time. Neither forms ``D_eff - D_full`` of two rounded sums. ``k`` is
    ignored."""
    del k
    if dis_measure not in ("var", "aad"):
        raise ValueError(
            f"unknown dis_measure={dis_measure!r}: expected 'var' or 'aad' ('iqr' is not "
            "offered — see the docstring)"
        )
    n = x_train.shape[0]
    if n < 2:
        raise ValueError(
            f"lmdd needs at least 2 train rows (leave-one-out dissimilarity); got {n}"
        )
    m = _as_batch(mask, x_train)
    mc = m[:, None, :]
    d_act = torch.clamp_min(torch.sum(m, dim=1), 1.0)[:, None]
    xm_tr = x_train[None] * mc
    xm_te = x_test[None] * mc
    s1 = torch.sum(xm_tr, dim=1, keepdim=True)  # (c, 1, d)
    nf = float(n)
    mu = s1 / nf
    is_self = torch.arange(x_test.shape[0], device=x_train.device) < (n if exclude_self else 0)
    self_f = is_self.to(x_train.dtype)
    c_eff = (nf + 1.0) - 2.0 * self_f  # the count after the move: n + 1 or n - 1
    if dis_measure == "var":
        #   add x:    var' - var = (n (x-m)^2 / (n+1) - v) / (n+1)
        #   remove x: var - var' = (n (x-m)^2 / (n-1) - v) / (n-1)
        v = torch.sum(torch.square(xm_tr - mu) * mc, dim=1, keepdim=True) / nf
        dev = (xm_te - mu) * mc
        sf = torch.sum((nf * torch.square(dev) / c_eff[:, None] - v) * mc, dim=-1) \
            / (c_eff * d_act)
    else:
        #   add:    D' - D = (n dlt + n own - S) / (n (n+1) d_act)
        #   remove: D - D' = (-n dlt + n own - S) / (n (n-1) d_act)
        # with dlt = sum_i (|x_i - mu_eff| - |x_i - mu|), own = |x - mu_eff|
        mu_eff = torch.where(is_self[:, None], s1 - xm_te, s1 + xm_te) / c_eff[:, None]
        dlt = torch.zeros(xm_te.shape[:2], dtype=x_train.dtype, device=x_train.device)
        s_full = torch.zeros((m.shape[0], 1), dtype=x_train.dtype, device=x_train.device)
        for b0 in range(0, n, _LMDD_BLOCK):
            xb = xm_tr[:, b0:b0 + _LMDD_BLOCK]  # (c, blk, d)
            full = torch.abs(xb - mu)
            diff = torch.abs(xb[:, :, None, :] - mu_eff[:, None]).sub_(full[:, :, None])
            dlt += torch.sum(diff.mul_(mc[:, None]), dim=(1, 3))
            s_full += torch.sum(full * mc, dim=(1, 2))[:, None]
        own = torch.sum(torch.abs(xm_te - mu_eff) * mc, dim=-1)
        sf = (torch.where(is_self, -dlt, dlt) * nf + nf * own - s_full) / (nf * c_eff * d_act)
    out = torch.clamp_min(sf, 0.0) * (nf - self_f)
    return out[0] if mask.ndim == 1 else out


class CentroidDraws(NamedTuple):
    """The random draws of ``_init_centroids``, shared by every mask.

    'rows': ``rows`` (C,) int64 distinct train rows. 'kmeans++': ``first``
    the first centroid's train row (a 0-d int64) and ``gumbel`` (C - 1, n)
    Gumbel noise, one row a later centroid, which is ``argmax(log(mind2 +
    1e-12) + gumbel[i])`` (the Gumbel-max form of a categorical draw)."""

    rows: Optional[torch.Tensor] = None
    first: Optional[torch.Tensor] = None
    gumbel: Optional[torch.Tensor] = None


@functools.lru_cache(maxsize=None)
def draw_centroids(n: int, n_clusters: int, method: str, seed: int) -> CentroidDraws:
    """The centroid init's draws on the CPU, from a CPU ``torch.Generator``
    seeded with ``seed``: C distinct rows for 'rows'; for 'kmeans++' the
    first row and float64 Gumbel noise ``-log(-log(u))``."""
    if method not in ("rows", "kmeans++"):
        raise ValueError(f"unknown cluster_init={method!r}: expected 'rows' or 'kmeans++'")
    g = torch.Generator().manual_seed(int(seed))
    if method == "rows":
        return CentroidDraws(rows=torch.randperm(int(n), generator=g)[:n_clusters])
    first = torch.randint(0, int(n), (), generator=g)
    u = torch.rand((n_clusters - 1, int(n)), generator=g, dtype=torch.float64)
    tiny = torch.finfo(torch.float64).tiny
    return CentroidDraws(first=first, gumbel=-torch.log(-torch.log(torch.clamp(u, tiny, 1.0))))


def _init_centroids(xm: torch.Tensor, n_clusters: int, method: str,
                    draws: CentroidDraws) -> torch.Tensor:
    """(c, C, d) initial centroids of the (c, n, d) masked train rows: the
    drawn rows, or D^2-weighted k-means++ seeding, each mask with its own
    distances and the shared Gumbel noise."""
    if method == "rows":
        return xm[:, draws.rows.to(xm.device)]
    if method != "kmeans++":
        raise ValueError(f"unknown cluster_init={method!r}: expected 'rows' or 'kmeans++'")
    c, n, _ = xm.shape
    batch = torch.arange(c, device=xm.device)
    gumbel = draws.gumbel.to(device=xm.device, dtype=xm.dtype)
    cen = [xm[:, int(draws.first)]]
    x_sq = torch.sum(xm * xm, dim=-1)
    mind2 = torch.full((c, n), torch.finfo(xm.dtype).max / 4, dtype=xm.dtype, device=xm.device)
    for i in range(1, n_clusters):
        last = cen[-1]
        d2 = torch.clamp_min(x_sq - 2.0 * (xm @ last[..., None])[..., 0]
                             + torch.sum(last * last, dim=-1, keepdim=True), 0.0)
        mind2 = torch.minimum(mind2, d2)
        nxt = torch.argmax(torch.log(mind2 + 1e-12) + gumbel[i - 1], dim=-1)
        cen.append(xm[batch, nxt])
    return torch.stack(cen, dim=1)


def _centroid_d2(x_sq: torch.Tensor, x: torch.Tensor, cen: torch.Tensor) -> torch.Tensor:
    """(c, n, C) squared distances of (c, n, d) rows to (c, C, d) centroids."""
    c_sq = torch.sum(cen * cen, dim=-1)
    return torch.clamp_min(x_sq[..., None] + c_sq[:, None, :] - 2.0 * (x @ cen.mT), 0.0)


def _cblof_large_mask(counts: torch.Tensor, n_tr: int, alpha: float, beta: float) -> torch.Tensor:
    """(c, C) pyod CBLOF large clusters from (c, C) sizes: over the clusters
    sorted by size (a stable sort, equal sizes in index order), the first
    boundary i = 1..C-1 where the top-i sizes cover ``alpha * n`` and the
    ratio across it is at least ``beta``, else the first alpha boundary,
    else the first beta one, else every cluster (where pyod raises). An
    empty cluster is never large."""
    n_clusters = counts.shape[-1]
    order = torch.argsort(counts, dim=-1, descending=True, stable=True)
    sizes = torch.gather(counts, -1, order)
    alpha_ok = torch.cumsum(sizes, dim=-1)[..., :-1] >= alpha * n_tr
    beta_ok = sizes[..., :-1] >= beta * torch.clamp_min(sizes[..., 1:], 1e-9)

    def first_boundary(ok):
        return torch.where(ok.any(dim=-1), torch.argmax(ok.to(torch.int64), dim=-1) + 1,
                           n_clusters)

    both = alpha_ok & beta_ok
    thr = torch.where(both.any(dim=-1), first_boundary(both),
                      torch.where(alpha_ok.any(dim=-1), first_boundary(alpha_ok),
                                  first_boundary(beta_ok)))
    large_sorted = (torch.arange(n_clusters, device=counts.device) < thr[..., None]) & (sizes > 0)
    return torch.zeros_like(large_sorted).scatter_(-1, order, large_sorted)


def _cluster_checks(name: str, what: str, n_clusters: int, lowest: int, n_tr: int) -> None:
    if n_clusters < lowest:
        raise ValueError(f"{name} needs {what} >= {lowest}; got {n_clusters}")
    if n_clusters > n_tr:
        raise ValueError(
            f"{name} needs {what} <= n_train; got {n_clusters} for {n_tr} train rows"
        )


def cblof_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                        k: int = 0, *, n_clusters: int = 8, alpha: float = 0.9,
                        beta: float = 5.0, kmeans_iter: int = 30, cluster_seed: int = 0,
                        init: str = "rows", draws: Optional[CentroidDraws] = None,
                        margins: Optional[list] = None) -> torch.Tensor:
    """Cluster-based local outlier factor (He, Xu & Deng 2003; pyod CBLOF,
    ``use_weights=False``) in the masked subspace: ``kmeans_iter`` fixed
    Lloyd iterations from :func:`_init_centroids` (an empty cluster keeps
    its centroid; ``argmin`` ties to the first centroid), pyod's large /
    small split (:func:`_cblof_large_mask`), then a query's distance to its
    own centroid if that cluster is large, else to the nearest large
    centroid. ``draws`` default to :func:`draw_centroids` of
    ``cluster_seed``. ``margins`` (a list) receives each mask's least gap
    between a train row's two nearest centroids, relative to ``|x|^2 +
    max |c|^2``, over every assignment. ``k`` is ignored."""
    del k
    n_tr = x_train.shape[0]
    _cluster_checks("cblof", "n_clusters", n_clusters, 2, n_tr)
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"cblof needs alpha in (0, 1]; got {alpha!r}")
    if not beta >= 1.0:
        raise ValueError(f"cblof needs beta >= 1; got {beta!r}")
    if draws is None:
        draws = draw_centroids(n_tr, n_clusters, init, cluster_seed)
    m = _as_batch(mask, x_train)
    xm_tr = x_train[None] * m[:, None, :]
    xm_te = x_test[None] * m[:, None, :]
    cen = _init_centroids(xm_tr, n_clusters, init, draws)
    tr_sq = torch.sum(xm_tr * xm_tr, dim=-1)

    def assign(cen):
        d2 = _centroid_d2(tr_sq, xm_tr, cen)
        if margins is not None:
            two = torch.topk(d2, 2, dim=-1, largest=False).values
            scale = tr_sq + torch.amax(torch.sum(cen * cen, dim=-1), dim=-1, keepdim=True)
            margins.append(torch.amin((two[..., 1] - two[..., 0])
                                      / torch.clamp_min(scale, 1e-30), dim=-1))
        return torch.argmin(d2, dim=-1)

    for _ in range(int(kmeans_iter)):
        one = torch.nn.functional.one_hot(assign(cen), n_clusters).to(x_train.dtype)
        counts = torch.sum(one, dim=1)[..., None]
        cen = torch.where(counts > 0, (one.mT @ xm_tr) / torch.clamp_min(counts, 1.0), cen)
    lab_tr = assign(cen)
    counts = torch.nn.functional.one_hot(lab_tr, n_clusters).sum(dim=1).to(x_train.dtype)
    large = _cblof_large_mask(counts, n_tr, alpha, beta)
    d2_te = _centroid_d2(torch.sum(xm_te * xm_te, dim=-1), xm_te, cen)
    lab_te = torch.argmin(d2_te, dim=-1, keepdim=True)
    own = torch.sqrt(torch.gather(d2_te, -1, lab_te)[..., 0])
    big = torch.finfo(x_test.dtype).max / 4
    nearest_large = torch.sqrt(torch.amin(torch.where(large[:, None, :], d2_te, big), dim=-1))
    in_large = torch.gather(large, -1, lab_te[..., 0])
    out = torch.where(in_large, own, nearest_large)
    return out[0] if mask.ndim == 1 else out


def _gmm_full_nll(xm_te, xm_tr, m, mu, n_components, em_iter, reg_covar, d_sub, log2pi):
    """Full-covariance EM of :func:`gmm_scores_masked`: per-component (d, d)
    covariances masked as ``(m m^T) .* Sigma`` plus an identity diagonal on
    unmasked dimensions (which add 0 to the log-determinant and the
    quadratic form), ``cholesky_ex`` and ``cholesky_solve``; a failed
    factorization gives NaN."""
    ntr = xm_tr.shape[1]
    mm = (m[:, :, None] * m[:, None, :])[:, None]
    fix = torch.diag_embed(m * reg_covar + (1.0 - m))[:, None]
    xc0 = xm_tr - torch.mean(xm_tr, dim=1, keepdim=True)
    cov = (xc0.mT @ xc0 / max(ntr - 1, 1))[:, None] * mm + fix
    cov = cov.expand(-1, n_components, -1, -1)
    logw = torch.full(mu.shape[:2], -math.log(n_components), dtype=xm_tr.dtype,
                      device=xm_tr.device)

    def log_prob(x, mu, cov, logw):
        chol, info = torch.linalg.cholesky_ex(cov)
        chol = torch.where((info == 0)[..., None, None], chol, torch.nan)
        z = (x[:, None] - mu[:, :, None, :]) * m[:, None, None, :]  # (c, C, n, d)
        w = torch.cholesky_solve(z.mT, chol)
        quad = torch.sum(z * w.mT, dim=-1)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        return logw[:, None, :] - 0.5 * ((quad + logdet[..., None]).mT
                                         + d_sub[:, None, None] * log2pi)

    for _ in range(int(em_iter)):
        resp = torch.softmax(log_prob(xm_tr, mu, cov, logw), dim=-1)
        nc = torch.sum(resp, dim=1) + 1e-12
        mu = resp.mT @ xm_tr / nc[..., None]
        z = xm_tr[:, None] - mu[:, :, None, :]
        cov = (z.mT * resp.mT[:, :, None, :]) @ z / nc[..., None, None] * mm + fix
        logw = torch.log(nc / torch.sum(nc, dim=-1, keepdim=True))
    return -torch.logsumexp(log_prob(xm_te, mu, cov, logw), dim=-1)


def gmm_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                      k: int = 0, *, n_components: int = 4, em_iter: int = 30,
                      component_seed: int = 0, reg_covar: float = 1e-6, init: str = "rows",
                      covariance: str = "diag",
                      draws: Optional[CentroidDraws] = None) -> torch.Tensor:
    """Negative Gaussian-mixture log-likelihood in the masked subspace (pyod
    GMM: ``-score_samples``): ``em_iter`` fixed EM iterations from
    :func:`_init_centroids` means (``draws`` default to
    :func:`draw_centroids` of ``component_seed``), the train variance as
    every component's start. 'diag' keeps each E / M step matmul-shaped,
    the variances floored at ``reg_covar``; 'full' is
    :func:`_gmm_full_nll`. ``k`` is ignored."""
    del k
    n_tr = x_train.shape[0]
    _cluster_checks("gmm", "n_components", n_components, 1, n_tr)
    if covariance not in ("diag", "full"):
        raise ValueError(f"unknown covariance={covariance!r}: expected 'diag' or 'full'")
    if draws is None:
        draws = draw_centroids(n_tr, n_components, init, component_seed)
    m = _as_batch(mask, x_train)
    xm_tr = x_train[None] * m[:, None, :]
    xm_te = x_test[None] * m[:, None, :]
    d_sub = torch.sum(m, dim=1)
    mu = _init_centroids(xm_tr, n_components, init, draws)
    log2pi = math.log(2.0 * math.pi)
    if covariance == "full":
        out = _gmm_full_nll(xm_te, xm_tr, m, mu, n_components, em_iter, reg_covar, d_sub,
                            log2pi)
        return out[0] if mask.ndim == 1 else out
    mc = m[:, None, :]
    var = torch.clamp_min(torch.var(xm_tr, dim=1, correction=0), reg_covar)[:, None, :] * mc \
        + (1.0 - mc)
    var = var.expand(-1, n_components, -1)
    logw = torch.full(mu.shape[:2], -math.log(n_components), dtype=x_train.dtype,
                      device=x_train.device)
    sq_tr = xm_tr * xm_tr

    def log_prob(x, x_sq, mu, var, logw):
        inv = mc / var  # (c, C, d), zero on unmasked dimensions
        quad = x_sq @ inv.mT - 2.0 * (x @ (mu * inv).mT) + torch.sum(mu * mu * inv, dim=-1)[:, None]
        logdet = torch.sum(mc * torch.log(var), dim=-1)
        return logw[:, None, :] - 0.5 * (quad + logdet[:, None, :] + d_sub[:, None, None] * log2pi)

    for _ in range(int(em_iter)):
        resp = torch.softmax(log_prob(xm_tr, sq_tr, mu, var, logw), dim=-1)
        nc = (torch.sum(resp, dim=1) + 1e-12)[..., None]
        mu = resp.mT @ xm_tr / nc
        var = (torch.clamp_min(resp.mT @ sq_tr / nc - mu * mu, 0.0) + reg_covar) * mc + (1.0 - mc)
        logw = torch.log(nc[..., 0] / torch.sum(nc[..., 0], dim=-1, keepdim=True))
    out = -torch.logsumexp(log_prob(xm_te, xm_te * xm_te, mu, var, logw), dim=-1)
    return out[0] if mask.ndim == 1 else out


def _adam_train(grad_fn, params: list, epochs: int, lr: float) -> list:
    """Full-batch Adam on ``params``, the JAX package's step ``p - lr sqrt(1
    - b2^t) / (1 - b1^t) m / (sqrt(v) + eps)`` with eps 1e-8 on the raw
    ``sqrt(v)`` (``torch.optim.Adam`` puts eps elsewhere, and the two drift
    apart over tens of epochs). The step size is formed in the parameters'
    dtype. ``grad_fn(params)`` gives the gradients of a sum of independent
    per-mask losses, so each mask's gradient is its own, written out as
    autograd forms them (:func:`_mlp_backward`): ``torch.export`` traces
    neither ``torch.autograd.grad`` nor ``torch.func.grad``, so the live
    call and an exported program run the same ops. The update is
    multi-tensor (a few launches a step for every tensor) on new tensors.
    Returns the trained parameters."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    np_dt = _as_numpy_dtype(params[0].dtype)
    one = np_dt(1.0)
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    for t in range(int(epochs)):
        tf = np_dt(t + 1)
        size = float(np_dt(lr) * np.sqrt(one - np_dt(b2) ** tf) / (one - np_dt(b1) ** tf))
        grads = grad_fn(params)
        m = torch._foreach_add(torch._foreach_mul(m, b1), torch._foreach_mul(grads, 1 - b1))
        v = torch._foreach_add(torch._foreach_mul(v, b2),
                               torch._foreach_mul(torch._foreach_mul(grads, 1 - b2), grads))
        denom = torch._foreach_add(torch._foreach_sqrt(v), eps)
        params = torch._foreach_sub(params, torch._foreach_div(torch._foreach_mul(m, size), denom))
    return params


@functools.lru_cache(maxsize=None)
def _glorot_weights(widths: tuple, seed: int) -> tuple:
    """(in, out) Glorot-uniform float64 weights of an MLP of ``widths``,
    layer by layer from one ``np.random.default_rng(seed)``: the JAX
    package's draws of ae and dsvdd, shared by every mask."""
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-math.sqrt(6.0 / (a + b)), math.sqrt(6.0 / (a + b)), (a, b))
                 for a, b in zip(widths[:-1], widths[1:]))


def _mask_weights(widths: tuple, seed: int, c: int, like: torch.Tensor) -> list:
    """(c, in, out) copies of :func:`_glorot_weights`, one a mask."""
    return [torch.as_tensor(w, dtype=like.dtype, device=like.device).expand(c, -1, -1).clone()
            for w in _glorot_weights(widths, int(seed))]


def _mlp(params: list, z: torch.Tensor, biases: bool, inputs: Optional[list] = None
         ) -> torch.Tensor:
    """The batched MLP ``(c, n, in) -> (c, n, out)``, ReLU between layers, a
    linear last layer; ``params`` alternate weight and bias when ``biases``.
    ``inputs`` (a list) receives each layer's input."""
    step = 2 if biases else 1
    n_layers = len(params) // step
    a = z
    for i in range(n_layers):
        if inputs is not None:
            inputs.append(a)
        a = a @ params[step * i]
        if biases:
            a = a + params[step * i + 1]
        if i < n_layers - 1:
            a = torch.relu(a)
    return a


def _mlp_backward(params: list, inputs: list, g: torch.Tensor, biases: bool) -> list:
    """The gradients of :func:`_mlp`'s ``params`` from ``g`` = d loss / d
    output and the layers' ``inputs``, by the ops autograd's backward runs:
    ``bmm`` with the transposed operand, the bias gradient summed over the
    rows, ReLU's gradient kept where its output is positive."""
    step = 2 if biases else 1
    grads = [None] * len(params)
    for i in reversed(range(len(params) // step)):
        if biases:
            grads[step * i + 1] = torch.sum(g, dim=1, keepdim=True)
        grads[step * i] = torch.bmm(inputs[i].mT, g)
        if i > 0:
            g = torch.where(inputs[i] > 0, torch.bmm(g, params[step * i].mT), 0.0)
    return grads


def ae_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                     k: int = 0, *, hidden: tuple = (64, 32), epochs: int = 50,
                     lr: float = 1e-3, seed: int = 0) -> torch.Tensor:
    """AutoEncoder reconstruction distance (pyod AutoEncoder) in the masked
    subspace: rows standardized by the mask's train columns, a symmetric MLP
    ``d -> hidden -> reversed(hidden) -> d`` (ReLU between layers, the output
    multiplied by the mask) trained per mask by ``epochs`` full-batch Adam
    steps (:func:`_adam_train`) on the masked MSE over ``ntr max(popcount,
    1)`` from :func:`_glorot_weights` of ``seed``; the score is the
    Euclidean distance from a standardized query to its reconstruction. The
    chunk's masks train as one batch of per-mask weights (c, in, out).
    ``k`` is ignored."""
    del k
    ntr, d = x_train.shape
    if ntr < 2:
        raise ValueError(f"ae needs at least 2 train rows to standardize; got n_train={ntr}")
    m = _as_batch(mask, x_train)
    c = m.shape[0]
    z_tr, z_te = _masked_standardize(x_test, x_train, m)
    norm = ntr * torch.clamp_min(torch.sum(m, dim=1), 1.0)
    hidden = tuple(int(h) for h in hidden)
    weights = _mask_weights((d, *hidden, *reversed(hidden[:-1]), d), seed, c, x_train)
    params = []
    for w in weights:
        params += [w, torch.zeros((c, 1, w.shape[-1]), dtype=w.dtype, device=w.device)]
    mc = m[:, None, :]

    def grad(ps):  # of sum((mlp(ps, z_tr) * mc - z_tr)^2 / norm)
        inputs = []
        r = _mlp(ps, z_tr, True, inputs) * mc - z_tr
        g = (torch.ones_like(norm) / norm)[:, None, None] * (2.0 * r) * mc
        return _mlp_backward(ps, inputs, g, True)

    params = _adam_train(grad, params, epochs, lr)
    out = torch.sqrt(torch.sum((_mlp(params, z_te, True) * mc - z_te) ** 2, dim=-1))
    return out[0] if mask.ndim == 1 else out


def dsvdd_scores_masked(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                        k: int = 0, *, hidden: tuple = (64, 32), epochs: int = 50,
                        lr: float = 1e-3, weight_decay: float = 1e-5,
                        seed: int = 0, margins: Optional[list] = None) -> torch.Tensor:
    """Deep SVDD (Ruff et al. 2018; pyod DeepSVDD) in the masked subspace:
    a bias-free MLP encoder ``d -> hidden`` on the standardized rows (as
    :func:`ae_scores_masked`), the centre the mean initial embedding of the
    train rows with coordinates below 0.1 in magnitude snapped to +-0.1,
    trained per mask by ``epochs`` Adam steps on the mean squared distance
    to the centre plus ``weight_decay`` times the squared weights; the score
    is the query embedding's squared distance to the centre. ``margins`` (a
    list) receives each mask's least distance of a centre coordinate from
    the snap's decisions (magnitude 0.1, and the sign below it; an exact 0
    is exact in any precision), relative to the mean magnitude of that
    coordinate's embeddings. ``k`` is ignored."""
    del k
    ntr, d = x_train.shape
    if ntr < 2:
        raise ValueError(f"dsvdd needs at least 2 train rows to standardize; got n_train={ntr}")
    m = _as_batch(mask, x_train)
    z_tr, z_te = _masked_standardize(x_test, x_train, m)
    params = _mask_weights((d, *(int(h) for h in hidden)), seed, m.shape[0], x_train)
    c0 = torch.mean(_mlp(params, z_tr, False), dim=1, keepdim=True)
    eps = torch.full_like(c0, 0.1)
    centre = torch.where(torch.abs(c0) < eps, torch.where(c0 < 0, -eps, eps), c0)
    if margins is not None:
        scale = torch.clamp_min(torch.mean(torch.abs(_mlp(params, z_tr, False)), dim=1,
                                           keepdim=True), 1e-30)
        sign = torch.where(c0 == 0, torch.inf, torch.abs(c0))
        margins.append(torch.amin(torch.minimum(torch.abs(torch.abs(c0) - 0.1), sign)
                                  / scale, dim=(1, 2)))

    def grad(ps):  # of sum(mean |mlp(ps, z_tr) - centre|^2 + weight_decay |ps|^2)
        inputs = []
        diff = _mlp(ps, z_tr, False, inputs) - centre
        inv_n = torch.ones((), dtype=diff.dtype, device=diff.device) / ntr
        gs = _mlp_backward(ps, inputs, inv_n * (2.0 * diff), False)
        # weight decay: w * w sends grad * w twice, before the network's term
        decay = [torch.full((), weight_decay, dtype=w.dtype, device=w.device) * w for w in ps]
        return [(dw + dw) + gw for dw, gw in zip(decay, gs)]

    params = _adam_train(grad, params, epochs, lr)
    out = torch.sum((_mlp(params, z_te, False) - centre) ** 2, dim=-1)
    return out[0] if mask.ndim == 1 else out


# ---------------------------------------------------------------------------
# dimension-decomposable bases: per-dimension score planes shared by every
# mask, so the whole ensemble is masked-sum matrix products
# ---------------------------------------------------------------------------


def _ecdf_tails(x_test: torch.Tensor, sorted_cols: torch.Tensor):
    """``(-log F(x), -log (1 - F(x^-)))``, (nt, d) each: the train columns'
    left and right empirical tails at each test value, floored at 1/n.
    ``sorted_cols`` is (d, ntr), each train column sorted."""
    n_tr = sorted_cols.shape[1]
    q = x_test.T.contiguous()
    left = torch.searchsorted(sorted_cols, q, right=True).to(x_test.dtype) / n_tr
    right = 1.0 - torch.searchsorted(sorted_cols, q, right=False).to(x_test.dtype) / n_tr
    floor = 1.0 / n_tr
    u_l = -torch.log(torch.clamp_min(left, floor))
    u_r = -torch.log(torch.clamp_min(right, floor))
    return u_l.T, u_r.T


def copod_dim_scores(x_test: torch.Tensor, x_train: torch.Tensor) -> torch.Tensor:
    """(nt, d) per-dimension two-sided ECDF tail scores, COPOD-style:
    ``max(-log F_left(x), -log F_right(x))`` from the train columns' empirical
    CDFs, tails floored at 1/n (no skewness correction, as in the JAX
    package). Every mask's score is a masked sum: ``O @ masks.T``."""
    u_l, u_r = _ecdf_tails(x_test, torch.sort(x_train.T, dim=1).values.contiguous())
    return torch.maximum(u_l, u_r)


def hbos_dim_scores(x_test: torch.Tensor, x_train: torch.Tensor, n_bins: int = 10) -> torch.Tensor:
    """(nt, d) per-dimension histogram tail scores, HBOS-style:
    ``-log(density(bin(x)) + eps)`` with ``n_bins`` equal-width bins over
    each train column's [min, max]. Bin numbers truncate toward zero; a test
    value outside the train range (the tests are inclusive) gets density 0,
    the largest score."""
    n_tr = x_train.shape[0]
    eps = 1e-12
    lo, hi = torch.amin(x_train, dim=0), torch.amax(x_train, dim=0)
    width = torch.clamp_min((hi - lo) / n_bins, eps)
    counts = torch.zeros((n_bins, x_train.shape[1]), dtype=x_train.dtype, device=x_train.device)
    counts.scatter_add_(0, _bin_index(x_train, lo, width, n_bins), torch.ones_like(x_train))
    density = counts / (n_tr * width)
    in_range = (x_test >= lo) & (x_test <= hi)
    dens_te = torch.gather(density, 0, _bin_index(x_test, lo, width, n_bins))
    return -torch.log(torch.where(in_range, dens_te, 0.0) + eps)


def ecod_dim_scores(x_test: torch.Tensor, x_train: torch.Tensor) -> torch.Tensor:
    """(nt, d, 3) per-dimension ECOD planes ``[U_left, U_right, U_auto]``
    (Li et al. 2022): the left and right ECDF tails as in
    :func:`copod_dim_scores`, and the auto plane taking the left tail where
    the train column is left-skewed (its skewness sign read from the
    standardized cube, which cannot overflow). The ensemble's score is the
    largest of the three planes' masked sums (inductive: train-column ECDFs
    only, as in the JAX package)."""
    sorted_cols = torch.sort(x_train.T, dim=1).values.contiguous()
    u_l, u_r = _ecdf_tails(x_test, sorted_cols)
    centered = sorted_cols - torch.mean(sorted_cols, dim=1, keepdim=True)
    std = torch.std(sorted_cols, dim=1, keepdim=True, correction=0)
    skew = torch.mean((centered / (std + 1e-30)) ** 3, dim=1)
    u_auto = torch.where(skew < 0, u_l, u_r)
    return torch.stack([u_l, u_r, u_auto], dim=-1)


def _dim_scores_impl(x_test: torch.Tensor, x_train: torch.Tensor, *, base: str,
                     n_bins: int) -> torch.Tensor:
    if base == "hbos":
        return hbos_dim_scores(x_test, x_train, n_bins=n_bins)
    if base == "ecod":
        return ecod_dim_scores(x_test, x_train)
    return copod_dim_scores(x_test, x_train)


def _dim_subspace_raw(dim_scores: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """Raw (n_masks, nt) scores from the per-dimension planes: one
    masked-sum product for copod / hbos; for ecod's (nt, d, 3) planes three,
    and the largest of the three sums."""
    if dim_scores.ndim == 3:
        return torch.amax(torch.einsum("tdp,md->mtp", dim_scores, masks), dim=-1)
    return (dim_scores @ masks.T).T


def _chunked_masks(subspaces, proba, chunk: int, n_shards: int = 1):
    """(n_chunks, chunk, d) masks + (n_chunks, chunk) proba, zero-padded so
    the subspace axis splits into whole chunks, and the chunks into
    ``n_shards`` equal groups. Padding rows carry proba == 0, which every
    aggregation honors (weight 0 for 'average', never the winner of
    'max')."""
    masks_np = np.asarray(subspaces, dtype=bool)
    proba_np = np.asarray(proba, dtype=np.float32)
    pad = (-len(masks_np)) % (chunk * n_shards)
    if pad:
        masks_np = np.concatenate([masks_np, np.zeros((pad, masks_np.shape[1]), bool)])
        proba_np = np.concatenate([proba_np, np.zeros((pad,), np.float32)])
    n_chunks = masks_np.shape[0] // chunk
    return masks_np.reshape(n_chunks, chunk, -1), proba_np.reshape(n_chunks, chunk)


def random_subspaces(d: int, n_subspaces: int, seed: int = 0, min_dims: Optional[int] = None,
                     max_dims: Optional[int] = None):
    """Feature-bagging mask pool: ``(masks (n, d) bool, uniform proba)``.

    The baseline the V-GAN paper compares its learned subspace distribution
    against (pyod's FeatureBagging convention): each member draws a subspace
    size uniformly in ``[d//2, d-1]`` (overridable via ``min_dims`` /
    ``max_dims``) and then that many distinct feature indices. Feed the
    result to :class:`SubspaceEnsemble` like a learned
    ``(model.subspaces, model.proba)`` pair.
    """
    if min_dims is None:
        min_dims = max(1, d // 2)
    if max_dims is None:
        max_dims = max(1, d - 1)
    if not 1 <= min_dims <= max_dims <= d:
        raise ValueError(
            f"need 1 <= min_dims <= max_dims <= d, got "
            f"min_dims={min_dims}, max_dims={max_dims}, d={d}"
        )
    rng = np.random.default_rng(seed)
    masks = np.zeros((n_subspaces, d), bool)
    sizes = rng.integers(min_dims, max_dims + 1, size=n_subspaces)
    for i, sz in enumerate(sizes):
        masks[i, rng.choice(d, size=sz, replace=False)] = True
    proba = np.full(n_subspaces, 1.0 / n_subspaces, np.float32)
    return masks, proba


def _proba_from_scores(train_scores: np.ndarray, test_scores: np.ndarray,
                       method: str) -> np.ndarray:
    """pyod ``predict_proba`` calibration: map raw outlier scores to (n, 2)
    probabilities using TRAIN-score statistics. 'linear' = min-max scaling
    by the train range; 'unify' = erf of the train-standardized score
    (Kriegel, Kroger, Schubert & Zimek 2011, as in pyod)."""
    tr = np.asarray(train_scores, np.float64)
    te = np.asarray(test_scores, np.float64)
    if method == "linear":
        lo, hi = tr.min(), tr.max()
        p = (te - lo) / max(hi - lo, 1e-12)
    elif method == "unify":
        mu, sd = tr.mean(), tr.std()
        z = (te - mu) / max(sd * math.sqrt(2.0), 1e-12)
        p = torch.special.erf(torch.from_numpy(z)).numpy()
    else:
        raise ValueError(f"unknown method={method!r}: expected 'linear' or 'unify'")
    p = np.clip(p, 0.0, 1.0)
    return np.stack([1.0 - p, p], axis=1).astype(np.float32)


class PyodSurfaceMixin:
    """pyod ``BaseDetector`` post-fit surface of :class:`SubspaceEnsemble`.

    Subclasses provide ``_train_matrix()`` (the fitted training data as
    numpy), ``decision_function``, ``contamination``, and the
    ``_decision_scores``/``_threshold`` slots.
    """

    def _train_matrix(self) -> np.ndarray:
        raise NotImplementedError

    @property
    def decision_scores_(self) -> np.ndarray:
        """Training-set outlier scores (pyod ``BaseDetector`` attribute),
        computed lazily on first access and cached (reset by ``fit``);
        self-pairs excluded for the neighbor bases, pyod's unsupplied-X
        kneighbors semantics."""
        x_train = self._train_matrix()
        if self._decision_scores is None:
            self._decision_scores = self.decision_function(x_train, exclude_self=True)
        return self._decision_scores

    @property
    def labels_(self) -> np.ndarray:
        """0/1 training labels at the (1 - contamination) quantile of
        ``decision_scores_``. Computing this SETS ``threshold_`` to that
        quantile, preserving pyod's invariant
        ``labels_ == decision_scores_ > threshold_`` (a later ``predict``
        call overwrites ``threshold_`` with its per-call batch quantile)."""
        scores = self.decision_scores_
        self._threshold = float(np.quantile(scores, 1.0 - self.contamination))
        return (scores > self._threshold).astype(np.int64)

    def _calibration_scores(self, x_test: np.ndarray):
        """(train_scores, test_scores) used by ``predict_proba``."""
        return self.decision_scores_, self.decision_function(np.asarray(x_test))

    def predict_proba(self, x_test: np.ndarray, method: str = "linear") -> np.ndarray:
        """(n, 2) outlier probabilities, pyod ``BaseDetector`` semantics.

        'linear' min-max-scales test scores by the TRAIN score range;
        'unify' is Kriegel et al.'s unification: erf of the train-
        standardized score. Column 1 is P(outlier), column 0 its
        complement."""
        tr, te = self._calibration_scores(x_test)
        return _proba_from_scores(tr, te, method)


def _zscore(s: torch.Tensor) -> torch.Tensor:
    """Per-subspace standardization over the test axis (suod-style;
    population standard deviation, as ``jnp.std``)."""
    mu = torch.mean(s, dim=1, keepdim=True)
    sd = torch.std(s, dim=1, keepdim=True, correction=0) + 1e-12
    return (s - mu) / sd


def _reduce(s: torch.Tensor, proba: torch.Tensor, aggregation: str) -> torch.Tensor:
    """'max' over the proba > 0 subspaces (zero-probability masks never
    win), else the proba-weighted sum."""
    if aggregation == "max":
        return torch.amax(torch.where(proba[:, None] > 0, s, -torch.inf), dim=0)
    return torch.sum(proba[:, None] * s, dim=0)


def _chunked_scores(x_test: torch.Tensor, x_train: torch.Tensor, masks: torch.Tensor,
                    proba: torch.Tensor, scorer, k: int, aggregation: str,
                    normalize: Optional[str]) -> torch.Tensor:
    """The generic path's (nt,) aggregated scores over ``(n_chunks, chunk,
    d)`` masks and ``(n_chunks, chunk)`` weights: each chunk scored in one
    batched call, z-scored under 'zscore', reduced by :func:`_reduce`, and
    the chunks summed ('average') or maxed ('max'). Shared by
    ``SubspaceEnsemble`` and the serving exporters (a program holds one
    copy of a chunk's graph a chunk)."""
    out = None
    for mk, pk in zip(masks, proba):
        s = scorer(x_test, x_train, mk, k)
        if normalize == "zscore":
            s = _zscore(s)
        part = _reduce(s, pk, aggregation)
        out = part if out is None else (torch.maximum(out, part) if aggregation == "max"
                                        else out + part)
    return out


def _chunked_raw(x_test: torch.Tensor, x_train: torch.Tensor, masks: torch.Tensor, scorer,
                 k: int) -> torch.Tensor:
    """The generic path's raw ``(n_chunks, chunk, nt)`` scores over ``(n_chunks,
    chunk, d)`` masks, one batched call a chunk (padding rows included)."""
    return torch.stack([scorer(x_test, x_train, mk, k) for mk in masks])


def _bucket_aggregate(s: np.ndarray, proba: np.ndarray, aggregation: str, n_buckets: int,
                      seed: int = 0):
    """AOM / MOA bucketed combination (the combo library's other two
    modes). Kept subspaces are SHUFFLED with a fixed seed before round-robin
    bucket assignment (V-GAN mask samples cluster similar masks adjacently,
    so striping in storage order could bias per-bucket maxima / averages).
    'aom' averages the per-bucket maxima, 'moa' takes the max of the
    per-bucket averages, 'median' is combo's median combination (no
    buckets). Zero-probability masks are dropped."""
    keep = np.asarray(proba) > 0
    s = s[keep]
    if aggregation == "median":
        return np.median(s, axis=0)
    n = s.shape[0]
    s = s[np.random.default_rng(seed).permutation(n)]
    n_buckets = max(1, min(n_buckets, n))
    idx = np.arange(n) % n_buckets
    if aggregation == "aom":
        return np.mean([s[idx == b].max(axis=0) for b in range(n_buckets)], axis=0)
    return np.max([s[idx == b].mean(axis=0) for b in range(n_buckets)], axis=0)


# The JAX package's string bases: the non-parametric scorers, the
# dimension-decomposable bases, and the parametric ones (each with knobs only
# it reads).
_BASE_SCORERS = {
    "knn": knn_scores_masked,
    "knn_mean": mean_dist_scores_masked,
    "lof": lof_scores_masked,
    "abod": abod_scores_masked,
    "cof": cof_scores_masked,
    "iforest": _iforest_adapter,
    "mahalanobis": mahalanobis_scores_masked,
}
_DIM_BASES = ("copod", "hbos", "ecod")
_PARAM_BASES = (
    "loda", "kde", "cblof", "gmm", "inne", "pca", "sampling", "kpca",
    "mcd", "ae", "dsvdd", "sod", "ocsvm", "sos", "lmdd",
)

# Neighbor-based bases: the k < n_train guards of exclude_self reach exactly
# these (sod is parametric but neighbor-semantic).
_NEIGHBOR_BASES = ("knn", "knn_mean", "lof", "abod", "cof", "sod")

# Bases for which exclude_self=True relies on positional test-row ==
# train-row alignment, so test chunking must be bypassed and
# decision_scores_ passes the flag: the k-neighbor bases plus sos and lmdd,
# which drop the self column positionally but have no k.
_POSITIONAL_EXCL_BASES = _NEIGHBOR_BASES + ("sos", "lmdd")

# The self-excluding scorers, for scoring the train set itself (pyod's
# unsupplied-X kneighbors semantics). iforest and mahalanobis are
# distribution-based: they include the point, as pyod's detectors do.
_BASE_SCORERS_EXCL = {
    name: (functools.partial(fn, exclude_self=True) if name in _NEIGHBOR_BASES else fn)
    for name, fn in _BASE_SCORERS.items()
}


def _scorer_and_k(base: str, *, k: int, n_trees: int = 100, n_projections: int = 100,
                  n_bins: int = 10, projection_seed: int = 0, kde_bandwidth: float = 1.0,
                  n_clusters: int = 8, cluster_alpha: float = 0.9, cluster_beta: float = 5.0,
                  kmeans_iter: int = 30, cluster_seed: int = 0, cluster_init: str = "rows",
                  gmm_covariance: str = "diag", inne_psi: int = 8, pca_n_components: int = 0,
                  pca_n_selected: int = 0, pca_standardize: bool = True,
                  pca_weighted: bool = True, subset_size: int = 20, kpca_n_components: int = 0,
                  kpca_gamma: float = 0.0, kpca_sampling: bool = False,
                  support_fraction: float = 0.0, mcd_starts: int = 8, mcd_steps: int = 15,
                  ae_hidden: tuple = (64, 32), ae_epochs: int = 50, ae_lr: float = 1e-3,
                  sod_ref_set: int = 10, sod_alpha: float = 0.8, ocsvm_nu: float = 0.5,
                  ocsvm_gamma: float = 0.0, ocsvm_iters: int = 300, sos_perplexity: float = 4.5,
                  sos_iters: int = 64, lmdd_dis: str = "var", exclude_self: bool = False):
    """Resolve a base name to its (scorer, k) pair, the knobs mapped as the
    JAX package maps them: iforest reads the tree count as its k, inne as
    its ensemble size; gmm reads ``n_clusters`` as its components and
    ``kmeans_iter`` as its EM iterations; loda, inne, sampling, mcd, kpca, ae
    and dsvdd read ``projection_seed``; dsvdd shares the ae knobs with
    weight decay 1e-5. ``exclude_self`` reaches the neighbour bases (sod
    with the ensemble's k) and sos and lmdd (k 0); kde in an ensemble keeps
    the point."""
    partial = functools.partial
    hidden = tuple(int(h) for h in ae_hidden)
    if base == "loda":
        return partial(loda_scores_masked, n_projections=int(n_projections), n_bins=int(n_bins),
                       seed=int(projection_seed)), 0
    if base == "inne":
        return partial(inne_scores_masked, n_estimators=int(n_trees), psi=int(inne_psi),
                       seed=int(projection_seed)), 0
    if base == "pca":
        return partial(pca_scores_masked, n_components=int(pca_n_components),
                       n_selected=int(pca_n_selected), standardize=bool(pca_standardize),
                       weighted=bool(pca_weighted)), 0
    if base == "sampling":
        return partial(sampling_scores_masked, subset_size=int(subset_size),
                       seed=int(projection_seed)), 0
    if base == "kpca":
        return partial(kpca_scores_masked, n_components=int(kpca_n_components),
                       gamma=float(kpca_gamma), sampling=bool(kpca_sampling),
                       subset_size=int(subset_size), seed=int(projection_seed)), 0
    if base == "mcd":
        return partial(mcd_scores_masked, support_fraction=float(support_fraction),
                       n_starts=int(mcd_starts), c_steps=int(mcd_steps),
                       seed=int(projection_seed)), 0
    if base == "ae":
        return partial(ae_scores_masked, hidden=hidden, epochs=int(ae_epochs), lr=float(ae_lr),
                       seed=int(projection_seed)), 0
    if base == "dsvdd":
        return partial(dsvdd_scores_masked, hidden=hidden, epochs=int(ae_epochs),
                       lr=float(ae_lr), weight_decay=1e-5, seed=int(projection_seed)), 0
    if base == "sod":
        return partial(sod_scores_masked, ref_set=int(sod_ref_set), alpha=float(sod_alpha),
                       exclude_self=bool(exclude_self)), k
    if base == "ocsvm":
        return partial(ocsvm_scores_masked, nu=float(ocsvm_nu), gamma=float(ocsvm_gamma),
                       iters=int(ocsvm_iters)), 0
    if base == "sos":
        return partial(sos_scores_masked, perplexity=float(sos_perplexity),
                       iters=int(sos_iters), exclude_self=bool(exclude_self)), 0
    if base == "lmdd":
        return partial(lmdd_scores_masked, dis_measure=str(lmdd_dis),
                       exclude_self=bool(exclude_self)), 0
    if base == "kde":
        return partial(kde_scores_masked, bandwidth=float(kde_bandwidth)), 0
    if base == "cblof":
        return partial(cblof_scores_masked, n_clusters=int(n_clusters), alpha=float(cluster_alpha),
                       beta=float(cluster_beta), kmeans_iter=int(kmeans_iter),
                       cluster_seed=int(cluster_seed), init=str(cluster_init)), 0
    if base == "gmm":
        return partial(gmm_scores_masked, n_components=int(n_clusters), em_iter=int(kmeans_iter),
                       component_seed=int(cluster_seed), init=str(cluster_init),
                       covariance=str(gmm_covariance)), 0
    scorers = _BASE_SCORERS_EXCL if exclude_self else _BASE_SCORERS
    return scorers[base], (n_trees if base == "iforest" else k)


def _scorer_with_draws(base: str, ntr: int, d: int, device, **params):
    """:func:`_scorer_and_k` with the base's seeded torch draws made now, on
    ``device``, and bound as arguments: iforest's forest, loda's directions,
    cblof's and gmm's centroid draws; the other bases draw with numpy, which
    a trace holds as constants. The serving exporters use it: under
    ``torch.export`` a draw from a ``torch.Generator`` inside the traced
    function is recorded as a random op (other values on every call of the
    program), and a cached draw first made under the trace would cache a
    traced tensor."""
    scorer, k = _scorer_and_k(base, **params)
    if base == "iforest":
        draws = draw_iforest(ntr, int(k)).to(device)
        return functools.partial(scorer, draws=draws), k
    if base == "loda":
        directions = draw_loda_directions(d, int(params["n_projections"]),
                                          int(params["projection_seed"]), device, torch.float32)
        return functools.partial(scorer, directions=directions), k
    if base in ("cblof", "gmm"):
        draws = draw_centroids(ntr, int(params["n_clusters"]), str(params["cluster_init"]),
                               int(params["cluster_seed"]))
        # copies: a slice of a larger draw would be saved with no whole tensor
        draws = CentroidDraws(*(None if t is None else t.to(device, copy=True) for t in draws))
        return functools.partial(scorer, draws=draws), k
    return scorer, k


# The constructor's knobs that the scorers read, in its order.
_SCORER_KNOBS = (
    "k", "n_trees", "n_bins", "n_projections", "projection_seed", "kde_bandwidth",
    "n_clusters", "cluster_alpha", "cluster_beta", "kmeans_iter", "cluster_seed",
    "cluster_init", "gmm_covariance", "inne_psi", "pca_n_components", "pca_n_selected",
    "pca_standardize", "pca_weighted", "subset_size", "kpca_n_components", "kpca_gamma",
    "kpca_sampling", "support_fraction", "mcd_starts", "mcd_steps", "ae_hidden", "ae_epochs",
    "ae_lr", "sod_ref_set", "sod_alpha", "ocsvm_nu", "ocsvm_gamma", "ocsvm_iters",
    "sos_perplexity", "sos_iters", "lmdd_dis",
)


def _scorer_params(ens) -> dict:
    """The base-scorer configuration an ensemble carries, as
    :func:`_scorer_and_k` keywords."""
    return {name: getattr(ens, name) for name in _SCORER_KNOBS}


def _is_int(val, lowest: int) -> bool:
    return isinstance(val, (int, np.integer)) and not isinstance(val, bool) and val >= lowest


def _is_real(val) -> bool:
    return isinstance(val, (int, float, np.floating)) and not isinstance(val, bool)


def _check_knobs(base, *, kde_bandwidth, n_clusters, cluster_alpha, cluster_beta, cluster_init,
                 gmm_covariance, inne_psi, subset_size, support_fraction, mcd_starts, mcd_steps,
                 sod_ref_set, sod_alpha, ocsvm_nu, ocsvm_gamma, ocsvm_iters, sos_perplexity,
                 sos_iters, lmdd_dis, ae_hidden, ae_epochs, ae_lr, kpca_n_components, kpca_gamma,
                 pca_n_components, pca_n_selected, **unguarded) -> None:
    """The JAX constructor's ``ValueError`` guards of the scorer knobs, in
    its order (``unguarded``: the knobs it does not check)."""
    if not kde_bandwidth > 0:
        raise ValueError(f"kde_bandwidth must be positive; got {kde_bandwidth!r} "
                         "(sklearn KernelDensity convention)")
    if not 0.0 < cluster_alpha <= 1.0:
        raise ValueError(f"cluster_alpha must be in (0, 1]; got {cluster_alpha!r} "
                         "(fraction of train rows the large clusters must cover)")
    if not cluster_beta >= 1.0:
        raise ValueError(f"cluster_beta must be >= 1; got {cluster_beta!r} (size ratio "
                         "across the large/small boundary)")
    if base == "cblof" and n_clusters < 2:
        raise ValueError(f"cblof needs n_clusters >= 2; got {n_clusters}")
    if base == "gmm" and n_clusters < 1:
        raise ValueError(f"gmm needs n_clusters >= 1 (mixture components); got {n_clusters}")
    if cluster_init not in ("rows", "kmeans++"):
        raise ValueError(f"unknown cluster_init={cluster_init!r}: expected 'rows' or "
                         "'kmeans++'")
    if gmm_covariance not in ("diag", "full"):
        raise ValueError(f"unknown gmm_covariance={gmm_covariance!r}: expected 'diag' or "
                         "'full'")
    if not _is_int(inne_psi, 2):
        raise ValueError(f"inne_psi must be an int >= 2 (hypersphere-center subsample size); "
                         f"got {inne_psi!r}")
    if not _is_int(subset_size, 1):
        raise ValueError(f"subset_size must be an int >= 1 (base='sampling' subsample "
                         f"size); got {subset_size!r}")
    if not (_is_real(support_fraction) and 0.0 <= support_fraction <= 1.0):
        raise ValueError(f"support_fraction must be in [0, 1] (0 = sklearn's None: h = "
                         f"ceil((n + p + 1)/2) per subspace); got {support_fraction!r}")
    for name, val in (("mcd_starts", mcd_starts), ("mcd_steps", mcd_steps)):
        if not _is_int(val, 1):
            raise ValueError(f"{name} must be an int >= 1; got {val!r}")
    if not _is_int(sod_ref_set, 1):
        raise ValueError(f"sod_ref_set must be an int >= 1 (pyod SOD's reference-set size); "
                         f"got {sod_ref_set!r}")
    if not (_is_real(sod_alpha) and sod_alpha > 0.0):
        raise ValueError(f"sod_alpha must be a float > 0 (variance-threshold coefficient); "
                         f"got {sod_alpha!r}")
    if not (_is_real(ocsvm_nu) and 0.0 < ocsvm_nu <= 1.0):
        raise ValueError(f"ocsvm_nu must be in (0, 1] (Schölkopf's outlier-fraction bound); "
                         f"got {ocsvm_nu!r}")
    if not (_is_real(ocsvm_gamma) and ocsvm_gamma >= 0.0):
        raise ValueError(f"ocsvm_gamma must be >= 0 (0 = pyod's 'auto': 1/n_active_features "
                         f"per subspace); got {ocsvm_gamma!r}")
    if not _is_int(ocsvm_iters, 1):
        raise ValueError(f"ocsvm_iters must be an int >= 1 (FISTA iteration budget); got "
                         f"{ocsvm_iters!r}")
    if not (_is_real(sos_perplexity) and sos_perplexity > 0.0):
        raise ValueError(f"sos_perplexity must be a float > 0 (target binding-distribution "
                         f"perplexity, paper default 4.5); got {sos_perplexity!r}")
    if not _is_int(sos_iters, 1):
        raise ValueError(f"sos_iters must be an int >= 1 (beta-bisection budget); got "
                         f"{sos_iters!r}")
    if lmdd_dis not in ("var", "aad"):
        raise ValueError(f"unknown lmdd_dis={lmdd_dis!r}: expected 'var' or 'aad' (the "
                         "leave-one-out-computable Arning dissimilarities)")
    if not (len(tuple(ae_hidden)) >= 1 and all(_is_int(h, 1) for h in tuple(ae_hidden))):
        raise ValueError(f"ae_hidden must be a non-empty tuple of ints >= 1 (encoder widths, "
                         f"mirrored for the decoder); got {ae_hidden!r}")
    if not _is_int(ae_epochs, 1):
        raise ValueError(f"ae_epochs must be an int >= 1; got {ae_epochs!r}")
    if not (_is_real(ae_lr) and ae_lr > 0.0):
        raise ValueError(f"ae_lr must be a float > 0; got {ae_lr!r}")
    if not _is_int(kpca_n_components, 0):
        raise ValueError(f"kpca_n_components must be an int >= 0 (0 = all valid "
                         f"components, pyod's None); got {kpca_n_components!r}")
    if not (_is_real(kpca_gamma) and kpca_gamma >= 0.0):
        raise ValueError(f"kpca_gamma must be a float >= 0 (0 = pyod's None: "
                         f"1/n_active_features per subspace); got {kpca_gamma!r}")
    for name, val in (("pca_n_components", pca_n_components),
                      ("pca_n_selected", pca_n_selected)):
        if not _is_int(val, 0):
            raise ValueError(f"{name} must be an int >= 0 (0 = all valid components, "
                             f"pyod's None); got {val!r}")


class SubspaceEnsemble(PyodSurfaceMixin):
    """Ensemble outlier detector over V-GAN subspaces.

    Parameters
    ----------
    subspaces, proba:
        Either explicit masks (n_subspaces, d) + probabilities, or a fitted
        ``VGAN``/``VGAN_no_kl`` via ``from_model``.
    base:
        'knn' (k-th NN distance), 'knn_mean' (mean distance to the k
        nearest), 'lof' (local outlier factor), 'abod' (negated angle-based
        outlier factor over the k nearest, FastABOD), 'cof'
        (connectivity-based outlier factor), 'iforest', 'mahalanobis'
        (squared Mahalanobis distance in the subspace), the
        dimension-decomposable 'copod', 'hbos' and 'ecod', the parametric
        'mcd' (Minimum Covariance Determinant), 'pca', 'kpca' (kernel PCA),
        'cblof' (cluster-based LOF), 'gmm' (Gaussian-mixture NLL), 'kde'
        (Gaussian-KDE NLL), 'loda' (random-projection histograms), 'inne'
        (isolation by nearest-neighbour hyperspheres), 'sampling' (distance
        to the nearest of ``subset_size`` drawn train rows), 'sod' (subspace
        outlier degree over shared-nearest-neighbour reference sets), 'lmdd'
        (deviation-based smoothing factor), 'ocsvm' (one-class SVM), 'sos'
        (stochastic outlier selection), 'ae' (autoencoder reconstruction
        distance) and 'dsvdd' (Deep SVDD), or a pyod-style detector instance
        (CPU loop; any object with sklearn-style
        get_params/fit/decision_function).
    k:
        neighborhood size for the neighbor bases (sod's n_neighbors).
    n_trees:
        forest size for base='iforest', ensemble size for base='inne'.
    aggregation:
        'average' (probability-weighted mean of per-subspace scores), 'max'
        (probability-ignoring maximum), the combo library's bucketed 'aom'
        (average of per-bucket maxima) / 'moa' (max of per-bucket averages;
        see ``n_buckets``) and 'median' (per-point median over the kept
        subspaces); 'weighted' (explicit per-mask ``weights`` instead of the
        pool probabilities) and 'vote' (each subspace member labels points
        at its own train-score contamination quantile over RAW scores;
        ``decision_function`` returns the weighted vote fraction in [0, 1]
        and ``predict`` applies the strict majority, ties inliers).
    weights:
        per-mask combination weights (non-negative; zero-probability masks
        still drop, then the rest renormalize). REQUIRED for 'weighted';
        optional for 'vote' (pool probabilities by default); ignored by the
        other aggregations.
    normalize:
        'zscore' standardizes each subspace's scores before aggregation
        (suod-style), None aggregates raw scores.
    chunk:
        masks scored at once on the generic path (a memory bound).
    mesh:
        a mesh (:func:`vgan_tpu_torch.parallel.make_mesh`) whose 'data'
        ranks split the mask axis; None scores every mask on this device.
        The dim route (copod, hbos, ecod) and pyod-style instances ignore
        it: their whole ensemble is a few masked sums or a host loop.
    n_buckets, bucket_seed:
        bucket count for 'aom'/'moa' (combo's default 5) and the seed of the
        shuffle that assigns subspaces to buckets.
    n_bins:
        histogram resolution for base='hbos' and base='loda'.
    n_projections, projection_seed:
        base='loda': the count of random directions, shared by every mask
        and drawn from a CPU ``torch.Generator`` seeded with
        ``projection_seed``. The seed also draws inne's centres, sampling's
        subsample, mcd's start permutations, kpca's fit subsample
        (``kpca_sampling``) and the initial weights of ae and dsvdd.
    kde_bandwidth:
        Gaussian kernel width for base='kde' (sklearn KernelDensity's 1.0).
    n_clusters, cluster_alpha, cluster_beta, kmeans_iter, cluster_seed, cluster_init:
        base='cblof': k-means clusters, pyod's large/small split rule
        (alpha, beta), fixed Lloyd iterations, the seed of the centroid
        init's draws and the init ('rows' or 'kmeans++'). base='gmm' reads
        ``n_clusters`` as its components, ``kmeans_iter`` as its EM
        iterations, and the seed and init.
    gmm_covariance:
        'diag' or 'full' component covariances for base='gmm'.
    inne_psi:
        base='inne': the centres a member draws (pyod INNE's max_samples;
        clamped to n_train).
    pca_n_components, pca_n_selected, pca_standardize, pca_weighted:
        pyod PCA's n_components, n_selected_components, standardization
        and weighted (0 means pyod's None; ``pca_n_selected`` takes
        components from the smallest-variance end of the kept list).
    subset_size:
        base='sampling''s subsample size (clamped to n_train), and kpca's
        fit subsample's size when ``kpca_sampling``.
    kpca_n_components, kpca_gamma, kpca_sampling:
        base='kpca': the components kept (0: every valid one), the RBF gamma
        (0: ``1 / popcount(mask)``), and whether to fit on a subsample.
    support_fraction, mcd_starts, mcd_steps:
        base='mcd': sklearn MinCovDet's support_fraction (0 is its None:
        ``h = ceil((n + p + 1) / 2)`` per subspace), the random starts and
        the c-steps each runs.
    ae_hidden, ae_epochs, ae_lr:
        base='ae': pyod AutoEncoder's encoder widths (the decoder mirrors
        them), full-batch Adam steps and learning rate, each mask training
        its own network. base='dsvdd' reads the same three (its encoder is
        ``ae_hidden``, without biases).
    sod_ref_set, sod_alpha:
        base='sod': pyod SOD's reference-set size and variance-threshold
        coefficient.
    ocsvm_nu, ocsvm_gamma, ocsvm_iters:
        base='ocsvm': sklearn OneClassSVM's nu and gamma (0: ``1 /
        popcount(mask)``) and the fixed FISTA iteration budget.
    sos_perplexity, sos_iters:
        base='sos': the binding distribution's perplexity (< n_train) and
        the fixed beta-bisection budget.
    lmdd_dis:
        base='lmdd': 'var' (mean per-dimension variance) or 'aad' (mean
        absolute deviation).
    contamination:
        expected outlier fraction; sets the ``predict`` threshold at the
        (1 - contamination) quantile of the train scores (pyod semantics).
    test_chunk:
        score ``decision_function`` test sets larger than this in
        ``test_chunk``-row slices. Exact (global zscore moments via a
        float64 accumulation pass); ``exclude_self`` calls (``predict``'s
        combined batch) bypass chunking since they rely on positional
        alignment. None (default) scores in one shot.
    jl_dim, jl_seed:
        optional Johnson-Lindenstrauss random projection (suod's
        per-detector dimensionality-reduction stage): ``fit`` draws a seeded
        Gaussian (d, jl_dim) matrix from ``np.random.default_rng(jl_seed)``
        and the member works in the projected space; ``subspaces`` must
        then have ``jl_dim`` columns, and every scoring entry point projects
        original-d inputs.
    device:
        where the training rows, masks and scores live: ``cuda`` when None
        (raises without a card); ``"cpu"`` only when asked for.

    As in the JAX package, ``predict`` recomputes ``threshold_`` on every
    call from the combined train+test batch, and with ``normalize='zscore'``
    the per-subspace statistics are over that batch (pyod fixes
    ``threshold_`` at fit time instead).
    """

    def __init__(
        self,
        subspaces: np.ndarray,
        proba: np.ndarray,
        base="knn",
        k: int = 10,
        aggregation: str = "average",
        weights: Optional[np.ndarray] = None,
        normalize: Optional[str] = "zscore",
        chunk: int = 128,
        mesh=None,
        n_trees: int = 100,
        n_buckets: int = 5,
        n_bins: int = 10,
        contamination: float = 0.1,
        bucket_seed: int = 0,
        n_projections: int = 100,
        projection_seed: int = 0,
        kde_bandwidth: float = 1.0,
        n_clusters: int = 8,
        cluster_alpha: float = 0.9,
        cluster_beta: float = 5.0,
        kmeans_iter: int = 30,
        cluster_seed: int = 0,
        cluster_init: str = "rows",
        gmm_covariance: str = "diag",
        inne_psi: int = 8,
        pca_n_components: int = 0,
        pca_n_selected: int = 0,
        pca_standardize: bool = True,
        pca_weighted: bool = True,
        subset_size: int = 20,
        kpca_n_components: int = 0,
        kpca_gamma: float = 0.0,
        kpca_sampling: bool = False,
        support_fraction: float = 0.0,
        mcd_starts: int = 8,
        mcd_steps: int = 15,
        ae_hidden: tuple = (64, 32),
        ae_epochs: int = 50,
        ae_lr: float = 1e-3,
        sod_ref_set: int = 10,
        sod_alpha: float = 0.8,
        ocsvm_nu: float = 0.5,
        ocsvm_gamma: float = 0.0,
        ocsvm_iters: int = 300,
        sos_perplexity: float = 4.5,
        sos_iters: int = 64,
        lmdd_dis: str = "var",
        test_chunk: Optional[int] = None,
        jl_dim: Optional[int] = None,
        jl_seed: int = 0,
        device=None,
    ):
        if aggregation not in ("average", "max", "aom", "moa", "median", "weighted", "vote"):
            raise ValueError(
                f"unknown aggregation={aggregation!r}: expected 'average', "
                "'max', 'aom', 'moa', 'median', 'weighted', or 'vote'"
            )
        if aggregation == "weighted" and weights is None:
            raise ValueError(
                "aggregation='weighted' needs explicit weights= (combo's "
                "weighted-average combinator); 'average' already weights "
                "by the pool probabilities"
            )
        if normalize not in (None, "zscore"):
            raise ValueError(f"unknown normalize={normalize!r}: expected 'zscore' or None")
        knobs = dict(
            n_projections=n_projections, projection_seed=projection_seed,
            kde_bandwidth=kde_bandwidth, n_clusters=n_clusters, cluster_alpha=cluster_alpha,
            cluster_beta=cluster_beta, kmeans_iter=kmeans_iter, cluster_seed=cluster_seed,
            cluster_init=cluster_init, gmm_covariance=gmm_covariance, inne_psi=inne_psi,
            pca_n_components=pca_n_components, pca_n_selected=pca_n_selected,
            pca_standardize=pca_standardize, pca_weighted=pca_weighted, subset_size=subset_size,
            kpca_n_components=kpca_n_components, kpca_gamma=kpca_gamma,
            kpca_sampling=kpca_sampling, support_fraction=support_fraction,
            mcd_starts=mcd_starts, mcd_steps=mcd_steps, ae_hidden=ae_hidden,
            ae_epochs=ae_epochs, ae_lr=ae_lr, sod_ref_set=sod_ref_set, sod_alpha=sod_alpha,
            ocsvm_nu=ocsvm_nu, ocsvm_gamma=ocsvm_gamma, ocsvm_iters=ocsvm_iters,
            sos_perplexity=sos_perplexity, sos_iters=sos_iters, lmdd_dis=lmdd_dis,
        )
        _check_knobs(base, **knobs)
        if test_chunk is not None and (
            not isinstance(test_chunk, (int, np.integer))
            or isinstance(test_chunk, bool)
            or test_chunk < 1
        ):
            raise ValueError(f"test_chunk must be a positive int or None; got {test_chunk!r}")
        if isinstance(base, str):
            if base not in (*_BASE_SCORERS, *_DIM_BASES, *_PARAM_BASES):
                raise ValueError(
                    f"unknown base={base!r}: expected one of "
                    f"{sorted(_BASE_SCORERS)} + {sorted(_DIM_BASES)} + "
                    f"{sorted(_PARAM_BASES)} or a pyod-style detector instance"
                )
        if jl_dim is not None:
            if not (isinstance(jl_dim, (int, np.integer)) and jl_dim >= 1):
                raise ValueError(f"jl_dim must be a positive int or None; got {jl_dim!r}")
            if np.asarray(subspaces).shape[1] != jl_dim:
                raise ValueError(
                    f"with jl_dim={jl_dim} the subspace masks live in the "
                    f"PROJECTED space and must have {jl_dim} columns; got "
                    f"{np.asarray(subspaces).shape[1]} (a full-projected-space "
                    "member passes np.ones((1, jl_dim)))"
                )
        self.jl_dim = jl_dim
        self.jl_seed = int(jl_seed)
        self._jl_R = None
        self.subspaces = np.asarray(subspaces, dtype=bool)
        proba = np.asarray(proba, dtype=np.float32)
        if len(proba) != len(self.subspaces):
            raise ValueError(
                f"subspaces and proba disagree: {len(self.subspaces)} masks "
                f"vs {len(proba)} probabilities"
            )
        self.proba = proba / proba.sum()
        if weights is not None:
            weights = np.asarray(weights, np.float32)
            if len(weights) != len(self.subspaces):
                raise ValueError(
                    f"weights and subspaces disagree: {len(weights)} weights "
                    f"vs {len(self.subspaces)} masks"
                )
            if np.any(weights < 0) or not (float((weights * (self.proba > 0)).sum()) > 0):
                raise ValueError(
                    "weights must be non-negative with a positive sum over "
                    "the proba > 0 masks (zero-probability masks are always "
                    "dropped before combining)"
                )
        self.weights = weights
        self.base = base
        self.k = k
        self.aggregation = aggregation
        self.normalize = normalize
        self.chunk = chunk
        self.n_trees = n_trees
        self.n_buckets = n_buckets
        self.n_bins = n_bins
        self.contamination = contamination
        self.bucket_seed = bucket_seed
        for name, val in knobs.items():
            setattr(self, name, val)
        self.ae_hidden = tuple(ae_hidden)
        self.test_chunk = test_chunk
        self.device = resolve_device(device)
        check_mesh_device(mesh, self.device)
        self.mesh = mesh
        self._x_train = None
        self._threshold = None
        self._decision_scores = None
        self._pool_dev = None
        self._vote_thr = None

    @classmethod
    def from_model(cls, model, subspace_count: int = 500, **kwargs):
        """Build from a fitted estimator via ``approx_subspace_dist``."""
        model.approx_subspace_dist(subspace_count)
        return cls(model.subspaces, model.proba, **kwargs)

    def fit(self, x_train: np.ndarray):
        x_train = np.asarray(x_train)
        if self.jl_dim is not None:
            d = x_train.shape[1]
            if not self.jl_dim < d:
                raise ValueError(
                    f"jl_dim={self.jl_dim} must be < the input dimension {d} "
                    "(JL projection reduces; equal or larger is a no-op that "
                    "breaks the projected/original shape dispatch)"
                )
            rng = np.random.default_rng(self.jl_seed)
            self._jl_R = torch.as_tensor(
                rng.normal(0.0, 1.0 / np.sqrt(self.jl_dim), size=(d, self.jl_dim)),
                dtype=torch.float32, device=self.device,
            )
        self._x_train = torch.as_tensor(self._project(x_train), dtype=torch.float32,
                                        device=self.device)
        self._threshold = None
        self._decision_scores = None
        self._vote_thr = None
        return self

    def _project(self, x):
        """JL-project ``x`` into the member's working space. Shape-dispatched:
        original-d inputs project, already-projected (jl_dim-column) inputs
        pass through (fit enforces jl_dim < d). numpy in -> numpy out."""
        if self._jl_R is None:
            return x
        d, m = self._jl_R.shape
        if x.shape[1] == m:
            return x
        if x.shape[1] != d:
            raise ValueError(
                f"input has {x.shape[1]} features; this JL member was fit on {d} "
                f"(projects to {m})"
            )
        out = torch.as_tensor(x, dtype=torch.float32, device=self.device) @ self._jl_R
        return out.cpu().numpy() if isinstance(x, np.ndarray) else out

    def _combining_weights(self) -> np.ndarray:
        """Per-mask combination weights: ``proba`` for 'average'/'vote' (or
        the user ``weights`` when given for 'vote'), the user ``weights`` for
        'weighted'. Zero-probability masks always drop, then renormalize."""
        if self.weights is None or self.aggregation not in ("weighted", "vote"):
            return self.proba
        w = self.weights * (self.proba > 0)
        return (w / w.sum()).astype(np.float32)

    @property
    def _reduce_aggregation(self) -> str:
        """'weighted' is 'average' over :meth:`_combining_weights`."""
        return "average" if self.aggregation == "weighted" else self.aggregation

    def _device_pool(self):
        """(masks float32, combining weights) on the device, uploaded once
        per instance."""
        if self._pool_dev is None:
            self._pool_dev = (
                torch.as_tensor(self.subspaces, dtype=torch.float32, device=self.device),
                torch.as_tensor(self._combining_weights(), dtype=torch.float32,
                                device=self.device),
            )
        return self._pool_dev

    def _require_fit(self) -> None:
        if self._x_train is None:
            raise RuntimeError("call fit(X_train) first")

    def _require_k_below_n_train(self, what: str) -> None:
        if isinstance(self.base, str) and self.base in _NEIGHBOR_BASES:
            if not self.k < self._x_train.shape[0]:
                raise ValueError(
                    f"{what} needs k < n_train (self-pairs are excluded, so only "
                    "n_train - 1 neighbors remain)"
                )

    def _vote_thresholds(self) -> np.ndarray:
        """Per-subspace thresholds for aggregation='vote': the
        (1 - contamination) quantile of each member's RAW scores on the TRAIN
        set (self-pairs excluded). Computed once per fit, cached."""
        if self._vote_thr is None:
            x_tr = self._train_matrix()
            excl = isinstance(self.base, str) and self.base in _POSITIONAL_EXCL_BASES
            self._require_k_below_n_train("vote thresholds")
            s_tr = self._raw_per_subspace(x_tr, exclude_self=excl)
            self._vote_thr = np.quantile(s_tr, 1.0 - self.contamination, axis=1)
        return self._vote_thr

    def _vote_scores(self, x_test: np.ndarray, exclude_self: bool = False) -> np.ndarray:
        """Weighted fraction of subspace members voting 'outlier'. Honors
        ``test_chunk`` (thresholds are train-derived constants, so slicing
        the test axis is exact); ``exclude_self`` calls bypass chunking."""
        thr = self._vote_thresholds()
        w = self._combining_weights().astype(np.float64)
        x_test = np.asarray(x_test, np.float32)
        tc = self.test_chunk if (self.test_chunk is not None and not exclude_self) else len(x_test)
        out = []
        for i in range(0, len(x_test), max(tc, 1)):
            s = self._raw_per_subspace(x_test[i:i + tc], exclude_self=exclude_self)
            out.append(w @ (s > thr[:, None]))
        return np.concatenate(out).astype(np.float32)

    def _train_matrix(self) -> np.ndarray:
        self._require_fit()
        return self._x_train.cpu().numpy()

    def _as_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=self.device)

    @annotate("vgan::decision_function")
    def decision_function(self, x_test: np.ndarray, exclude_self: bool = False) -> np.ndarray:
        """Aggregated outlier scores (higher = more outlying).

        ``exclude_self`` drops (i, i) distance pairs: set it when the
        leading rows of ``x_test`` ARE the training rows (pyod's
        unsupplied-X kneighbors semantics; ``predict`` uses this for its
        train-score threshold). pyod instances inherently include the point."""
        self._require_fit()
        x_test = self._project(np.asarray(x_test))
        positional_excl = exclude_self and isinstance(self.base, str) and (
            self.base in _POSITIONAL_EXCL_BASES
        )
        if positional_excl:
            self._require_k_below_n_train("exclude_self=True")
        if self.aggregation == "vote":
            return self._vote_scores(x_test, exclude_self=exclude_self)
        if self.test_chunk is not None and not positional_excl and len(x_test) > self.test_chunk:
            # exclude_self relies on positional (test row i == train row i)
            # alignment, which slicing would break, so the bases it reaches
            # (_POSITIONAL_EXCL_BASES) bypass chunking (predict's combined
            # batch); for any other base exclude_self=True is a no-op and
            # the call still honors the memory bound
            return self._test_chunked_scores(x_test)
        if self.aggregation in ("aom", "moa", "median"):
            s = self.per_subspace_scores(x_test, exclude_self=exclude_self)
            return _bucket_aggregate(s, self.proba, self.aggregation, self.n_buckets,
                                     seed=self.bucket_seed)
        if not isinstance(self.base, str):
            return self._pyod_decision_function(x_test)
        x_t = self._as_device(x_test)
        if self.base in _DIM_BASES:
            return self._dim_decision_function(x_t)
        return self._mask_scores(x_t, exclude_self, reduce=True).cpu().numpy()

    def _native_scores(self, x_test: torch.Tensor, exclude_self: bool, reduce: bool):
        """The generic path over the whole pool, a chunk of masks at a time
        (the knn bases' path off the kernel route).

        ``reduce=True`` applies the zscore and the 'average'/'max'
        aggregation per chunk and combines the chunks; ``reduce=False``
        returns the raw (n_chunks, chunk, nt) score blocks (padding rows
        included)."""
        return self._native_shard(x_test, exclude_self, reduce, 0, 1)

    def _native_shard(self, x_test: torch.Tensor, exclude_self: bool, reduce: bool,
                      shard: int, n_shards: int):
        """:meth:`_native_scores` over shard ``shard`` of ``n_shards`` equal
        groups of mask chunks (the masks zero-padded to ``chunk *
        n_shards``)."""
        scorer, k = _scorer_and_k(self.base, exclude_self=exclude_self, **_scorer_params(self))
        ntr, d = self._x_train.shape
        chunk = _effective_chunk(self.base, self.chunk, x_test.shape[0], ntr, d, k,
                                 n_clusters=self.n_clusters, gmm_covariance=self.gmm_covariance,
                                 n_trees=self.n_trees, inne_psi=self.inne_psi,
                                 kpca_sampling=self.kpca_sampling, subset_size=self.subset_size,
                                 mcd_starts=self.mcd_starts, ae_hidden=self.ae_hidden,
                                 sod_ref_set=self.sod_ref_set)
        masks_np, proba_np = _chunked_masks(self.subspaces, self._combining_weights(), chunk,
                                            n_shards)
        per = masks_np.shape[0] // n_shards
        part = slice(shard * per, (shard + 1) * per)
        masks = torch.as_tensor(masks_np[part], dtype=torch.float32, device=self.device)
        if not reduce:
            return _chunked_raw(x_test, self._x_train, masks, scorer, k)
        proba = torch.as_tensor(proba_np[part], device=self.device)
        return _chunked_scores(x_test, self._x_train, masks, proba, scorer, k,
                               self._reduce_aggregation, self.normalize)

    def _mask_shard(self, x_test: torch.Tensor, exclude_self: bool, shard: int, n_shards: int,
                    reduce: bool = True) -> torch.Tensor:
        """The scores of one shard of the mask axis (shard 0 of 1: the
        whole pool; under a mesh, a rank's work): on the knn kernel route
        K6 / K7 on masks ``[shard * per, (shard + 1) * per)`` (the pool
        zero-padded to ``per * n_shards`` masks), else :meth:`_native_shard`.
        ``reduce=True``: the shard's (nt,) partial aggregate, which the
        shards' sum ('average') or max ('max') combines into the whole
        call's; ``reduce=False``: its raw (rows, nt) scores, padding rows
        included, in mask order. A knn base's shard off the kernel route is
        counted (``knn_score.launch_counts()['knn_generic']``) and spanned
        (``vgan::knn.generic``)."""
        if not self._knn_kernel_route(x_test, exclude_self):
            knn = self.base in ("knn", "knn_mean")
            if knn:
                count_generic()
            with span("vgan::knn.generic") if knn else contextlib.nullcontext():
                out = self._native_shard(x_test, exclude_self, reduce, shard, n_shards)
            return out if reduce else out.reshape(-1, x_test.shape[0])
        masks, weights = self._device_pool()
        per = -(-masks.shape[0] // n_shards)
        pad = per * n_shards - masks.shape[0]
        if pad:
            masks = torch.cat([masks, masks.new_zeros((pad, masks.shape[1]))])
            weights = torch.cat([weights, weights.new_zeros(pad)])
        part = slice(shard * per, (shard + 1) * per)
        masks, weights = masks[part], weights[part]
        with span("vgan::knn"):
            s = knn_scores_all_masks(x_test, self._x_train, masks, self.k,
                                     mode="mean" if self.base == "knn_mean" else "kth",
                                     exclude_self=exclude_self)
        if not reduce:
            return s
        if self.normalize == "zscore":
            s = _zscore(s)
        return _reduce(s, weights, self._reduce_aggregation)

    def _mask_scores(self, x_test: torch.Tensor, exclude_self: bool, reduce: bool):
        """The native bases' scores (shared by ``decision_function`` and
        ``per_subspace_scores``): :meth:`_mask_shard` over the whole pool,
        or under a mesh on this rank's 'data' shard, then one collective
        over 'data': an all-reduce (sum or max) of the partial aggregates,
        or an all-gather of the raw rows in mask order (every rank's shard
        has the same row count)."""
        if self.mesh is None:
            return self._mask_shard(x_test, exclude_self, 0, 1, reduce)
        import torch.distributed as dist

        from vgan_tpu_torch.parallel.mesh import axis_size
        from vgan_tpu_torch.parallel.ring import gather_rows

        group = self.mesh.get_group("data")
        n_shards = axis_size(self.mesh, "data")
        local = self._mask_shard(x_test, exclude_self, self.mesh.get_local_rank("data"),
                                 n_shards, reduce)
        if reduce:
            op = dist.ReduceOp.MAX if self._reduce_aggregation == "max" else dist.ReduceOp.SUM
            dist.all_reduce(local, op=op, group=group)
            return local
        return gather_rows(local, group, local.shape[0] * n_shards)

    def _knn_kernel_route(self, x_test: torch.Tensor, exclude_self: bool) -> bool:
        """Do this base and these shapes take the fused KNN kernel (K6 or K7)?"""
        if self.base not in ("knn", "knn_mean"):
            return False
        nt, d = x_test.shape
        ntr = self._x_train.shape[0]
        return (knn_kernel_supported(nt, ntr, d, self.k, len(self.subspaces))
                and not (exclude_self and self.k >= ntr))

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        """0/1 outlier labels (pyod convention): threshold at the
        (1 - contamination) quantile of the TRAIN-set scores.

        Train and test rows are scored in ONE batch so per-subspace
        ``zscore`` statistics are shared, and the train rows' self-pairs
        are excluded (pyod's kneighbors semantics). ``threshold_`` is
        refreshed on every call."""
        if self.aggregation == "vote":
            # strict weighted majority of the per-subspace labels (combo's
            # majority_vote; ties are inliers)
            frac = self._vote_scores(x_test)
            self._threshold = 0.5
            return (frac > 0.5).astype(np.int64)
        x_train = self._train_matrix()
        x_test = np.asarray(self._project(np.asarray(x_test)))
        self._require_k_below_n_train("predict")
        both = np.concatenate([x_train, x_test], axis=0)
        scores = self.decision_function(both, exclude_self=True)
        n_tr = len(x_train)
        self._threshold = float(np.quantile(scores[:n_tr], 1.0 - self.contamination))
        return (scores[n_tr:] > self._threshold).astype(np.int64)

    @property
    def threshold_(self) -> Optional[float]:
        """Decision threshold once ``predict`` (or ``labels_``) has run (pyod name)."""
        return self._threshold

    def per_subspace_scores(self, x_test: np.ndarray, exclude_self: bool = False) -> np.ndarray:
        """Full (n_subspaces, nt) per-subspace score matrix, normalized per
        ``normalize``: the intermediate the bucketed aggregations combine.
        ``exclude_self`` as in ``decision_function``."""
        s = self._raw_per_subspace(x_test, exclude_self=exclude_self)
        if self.normalize == "zscore":
            s = _zscore(torch.from_numpy(s)).numpy()
        return s

    def _test_chunked_scores(self, x_test: np.ndarray) -> np.ndarray:
        """Aggregated scores for a test set scored in ``test_chunk``-row
        slices. Exact: 'zscore' uses GLOBAL per-subspace moments (one
        accumulation pass in float64, then a normalize+aggregate pass over
        the cached raw slices), and the bucketed aggregations reuse the same
        seeded bucket assignment per slice."""
        x_test = np.asarray(x_test, np.float32)
        nt = len(x_test)
        tc = self.test_chunk
        slices = [slice(i, min(i + tc, nt)) for i in range(0, nt, tc)]
        mu = sd = raw_cache = None
        if self.normalize == "zscore":
            # keep the moments pass's raw slices on the host when affordable,
            # so the second pass does not score again; a pyod instance always
            # keeps them (scoring again would refit stochastic detectors)
            if (len(self.subspaces) * nt <= _TEST_CHUNK_CACHE_ELEMS
                    or not isinstance(self.base, str)):
                raw_cache = []
            s1 = s2 = 0.0
            for sl in slices:
                s = self._raw_per_subspace(x_test[sl])
                if raw_cache is not None:
                    raw_cache.append(s)
                s64 = s.astype(np.float64)
                s1 = s1 + s64.sum(axis=1)
                s2 = s2 + (s64 * s64).sum(axis=1)
            mu = s1 / nt
            sd = np.sqrt(np.maximum(s2 / nt - mu * mu, 0.0)) + 1e-12
        out = []
        keep = np.asarray(self.proba) > 0
        for i, sl in enumerate(slices):
            s = raw_cache[i] if raw_cache is not None else self._raw_per_subspace(x_test[sl])
            if mu is not None:
                s = ((s.astype(np.float64) - mu[:, None]) / sd[:, None]).astype(np.float32)
            if self.aggregation in ("aom", "moa", "median"):
                out.append(_bucket_aggregate(s, self.proba, self.aggregation, self.n_buckets,
                                             seed=self.bucket_seed))
            elif self.aggregation == "max":
                out.append(s[keep].max(axis=0))
            else:
                out.append((self._combining_weights()[:, None] * s).sum(axis=0))
        return np.concatenate(out)

    def _raw_per_subspace(self, x_test: np.ndarray, exclude_self: bool = False) -> np.ndarray:
        """UN-normalized (n_subspaces, nt) matrix (the raw scores under
        ``per_subspace_scores``; the test-chunked paths normalize with
        GLOBAL moments instead of per-call batch moments)."""
        self._require_fit()
        x_test = self._project(np.asarray(x_test))
        if not isinstance(self.base, str):
            return self._pyod_per_subspace_raw(np.asarray(x_test))
        x_t = self._as_device(x_test)
        if self.base in _DIM_BASES:
            masks, _ = self._device_pool()
            return self._dim_raw(x_t, masks).cpu().numpy()
        raw = self._mask_scores(x_t, exclude_self, reduce=False)
        return raw[: len(self.subspaces)].cpu().numpy()

    def _dim_raw(self, x_test: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """Raw (n_masks, nt) scores of a dimension-decomposable base."""
        planes = _dim_scores_impl(x_test, self._x_train, base=self.base, n_bins=self.n_bins)
        return _dim_subspace_raw(planes, masks)

    def _dim_decision_function(self, x_test: torch.Tensor) -> np.ndarray:
        """The dimension-decomposable path (copod / hbos / ecod): the
        per-dimension planes once, every mask's score a masked sum. The pool
        probabilities weight the masks, under 'weighted' too, where
        ``weights=`` is not read: the JAX package's dim route does so
        (ROADMAP.md Queue 3)."""
        masks, _ = self._device_pool()
        s = self._dim_raw(x_test, masks)
        if self.normalize == "zscore":
            s = _zscore(s)
        proba = torch.as_tensor(self.proba, device=self.device)
        return _reduce(s, proba, self._reduce_aggregation).cpu().numpy()

    def _pyod_per_subspace_raw(self, x_test: np.ndarray) -> np.ndarray:
        """(n_subspaces, nt) raw scores from a pyod-style detector loop."""
        x_train = self._train_matrix()
        all_scores = []
        for mask in self.subspaces:
            det = self.base.__class__(**self.base.get_params())
            det.fit(x_train[:, mask])
            all_scores.append(det.decision_function(x_test[:, mask]))
        return np.stack(all_scores)

    def _pyod_decision_function(self, x_test) -> np.ndarray:
        """CPU loop over subspaces with a pyod-style detector (clone per
        subspace). Used for parity checks; requires the detector to expose
        sklearn-style get_params/fit/decision_function."""
        scores = self._pyod_per_subspace_raw(np.asarray(x_test))
        if self.normalize == "zscore":
            scores = _zscore(torch.from_numpy(scores)).numpy()
        if self.aggregation == "max":
            # zero-probability masks never win (consistent with every path)
            return np.where(self.proba[:, None] > 0, scores, -np.inf).max(axis=0)
        return (self._combining_weights()[:, None] * scores).sum(axis=0)
