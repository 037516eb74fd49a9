"""Subspace-ensemble outlier detection with the ``knn`` / ``knn_mean`` bases
(counterpart of ``vgan_tpu.ensemble.od``).

The V-GAN paper's downstream use: sample subspace masks from a fitted model,
score the data in each subspace with a base detector, and combine the
scores. Masked distances use the expansion

    d2_m(a, b) = (a*a) @ m + (b*b) @ m - 2 (a .* m) @ b^T

so each subspace's distance matrix is one matrix product. On the card, and
wherever :func:`~vgan_tpu_torch.ops.cuda.knn_score.knn_kernel_supported`
holds, a whole ``decision_function`` is the fused KNN kernel (K6 or K7), then
the z-score and the aggregation on the device, and one host fetch of the
(nt,) scores. Past those shapes (k > 64, very wide d) the generic torch path
scores a chunk of masks at a time, as the JAX package does on the TPU.

Only ``knn`` and ``knn_mean`` are ported; the package's other string bases
and ``mesh`` raise ``NotImplementedError`` naming ``ROADMAP.md``. A
pyod-style detector instance runs the CPU loop over subspaces.
"""

from __future__ import annotations

import functools
import math
import warnings
from typing import Optional

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device
from vgan_tpu_torch.ops.cuda.knn_score import knn_kernel_supported, knn_scores_all_masks


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
# test_chunk zscore: the moments pass's raw (n_subspaces, nt) scores stay on
# the host up to this many elements (1 GB of f32); past it they are scored
# again in the second pass.
_TEST_CHUNK_CACHE_ELEMS = 2**28


def _stream_block(nt: int) -> int:
    """Train-block length for the streaming scorers at ``nt`` query rows."""
    cap = max(512, (_STREAM_TILE_BUDGET // max(nt, 1)) // 128 * 128)
    return min(_STREAM_BLOCK, cap)


def _stream_chunk(chunk: int, nt: int, blk: int) -> int:
    """Clamp the mask chunk so the streaming tiles fit memory."""
    return max(1, min(chunk, _STREAM_CHUNK_BUDGET // max(nt * blk, 1)))


def _effective_chunk(base, chunk: int, nt: int, ntr: int, d: int) -> int:
    """Memory governor for the mask chunk of the generic path (the knn
    branch of the JAX package's governor, then the eager-torch buffers)."""
    width = ntr
    if base in ("knn", "knn_mean") and ntr > STREAM_NTR:
        width = min(_stream_block(nt), _MERGE_BLOCK)
        chunk = _stream_chunk(chunk, nt, width)
    return max(1, min(chunk, _CHUNK_ELEMS_BUDGET // max(nt * (d + width), 1)))


def _masked_knn_streaming(x_test: torch.Tensor, x_train: torch.Tensor, mask: torch.Tensor,
                          k: int, exclude_self: bool):
    """Exact ``(d2_vals, train_idx)`` of the k smallest masked squared
    distances, ascending, with the train axis streamed in blocks: (nt, k)
    each, or (c, nt, k) for a (c, d) chunk of masks.

    The running k smallest values and indices are carried across blocks; each
    block merges into the carry with ``torch.topk`` over [carry | block],
    which gives the same values as the JAX package's lexicographic k-pass
    merge (indices may order ties differently). The (nt, ntr) matrix never
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
        cand = torch.cat([vals, d2], dim=2)
        cand_idx = torch.cat([idx, cols.expand(c, nt, -1)], dim=2)
        vals, pos = torch.topk(cand, k, dim=2, largest=False, sorted=True)
        idx = torch.gather(cand_idx, 2, pos)
    return (vals[0], idx[0]) if mask.ndim == 1 else (vals, idx)


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


def _chunked_masks(subspaces, proba, chunk: int):
    """(n_chunks, chunk, d) masks + (n_chunks, chunk) proba, zero-padded so
    the subspace axis splits into whole chunks. Padding rows carry
    proba == 0, which every aggregation honors (weight 0 for 'average',
    never the winner of 'max')."""
    masks_np = np.asarray(subspaces, dtype=bool)
    proba_np = np.asarray(proba, dtype=np.float32)
    pad = (-len(masks_np)) % chunk
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


# The JAX package's base names: the ported ones and those still to port.
_PORTED_BASES = ("knn", "knn_mean")
_BASE_SCORERS = ("knn", "knn_mean", "lof", "abod", "cof", "iforest", "mahalanobis")
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


def _scorer_and_k(base: str, *, k: int, exclude_self: bool = False):
    """Resolve a base name to its (scorer, k) pair."""
    if base not in _PORTED_BASES:
        raise NotImplementedError(
            f"base={base!r} is not ported yet (only 'knn' and 'knn_mean' are); "
            "see ROADMAP.md Queue 1"
        )
    scorer = knn_scores_masked if base == "knn" else mean_dist_scores_masked
    return (functools.partial(scorer, exclude_self=True) if exclude_self else scorer), k


class SubspaceEnsemble(PyodSurfaceMixin):
    """Ensemble outlier detector over V-GAN subspaces.

    Parameters
    ----------
    subspaces, proba:
        Either explicit masks (n_subspaces, d) + probabilities, or a fitted
        ``VGAN``/``VGAN_no_kl`` via ``from_model``.
    base:
        'knn' (k-th NN distance) or 'knn_mean' (mean distance to the k
        nearest), or a pyod-style detector instance (CPU loop; any object
        with sklearn-style get_params/fit/decision_function). The JAX
        package's other base names raise ``NotImplementedError``.
    k:
        neighborhood size.
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
        not ported: anything but None raises ``NotImplementedError``.
    n_buckets, bucket_seed:
        bucket count for 'aom'/'moa' (combo's default 5) and the seed of the
        shuffle that assigns subspaces to buckets.
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
        n_buckets: int = 5,
        contamination: float = 0.1,
        bucket_seed: int = 0,
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
            _scorer_and_k(base, k=k)  # raises for the bases not ported yet
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (the mask axis sharded over devices) is not ported yet; "
                "see ROADMAP.md Queue 1"
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
        self.n_buckets = n_buckets
        self.contamination = contamination
        self.bucket_seed = bucket_seed
        self.test_chunk = test_chunk
        self.device = resolve_device(device)
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
        fused = self._knn_fused_decision_function(x_t, exclude_self=exclude_self)
        if fused is not None:
            return fused
        return self._native_scores(x_t, exclude_self, reduce=True).cpu().numpy()

    def _native_scores(self, x_test: torch.Tensor, exclude_self: bool, reduce: bool):
        """The generic path, a chunk of masks at a time (shared by
        ``decision_function`` and ``per_subspace_scores``).

        ``reduce=True`` applies the zscore and the 'average'/'max'
        aggregation per chunk and combines the chunks; ``reduce=False``
        returns the raw (n_chunks, chunk, nt) score blocks (padding rows
        included)."""
        scorer, k = _scorer_and_k(self.base, k=self.k, exclude_self=exclude_self)
        ntr, d = self._x_train.shape
        chunk = _effective_chunk(self.base, self.chunk, x_test.shape[0], ntr, d)
        masks_np, proba_np = _chunked_masks(self.subspaces, self._combining_weights(), chunk)
        masks = torch.as_tensor(masks_np, dtype=torch.float32, device=self.device)
        if not reduce:
            return torch.stack([scorer(x_test, self._x_train, mk, k) for mk in masks])
        proba = torch.as_tensor(proba_np, device=self.device)
        agg = self._reduce_aggregation
        out = None
        for mk, pk in zip(masks, proba):
            s = scorer(x_test, self._x_train, mk, k)
            if self.normalize == "zscore":
                s = _zscore(s)
            part = _reduce(s, pk, agg)
            out = part if out is None else (torch.maximum(out, part) if agg == "max"
                                            else out + part)
        return out

    def _knn_kernel_route(self, x_test: torch.Tensor, exclude_self: bool) -> bool:
        """Do these shapes take the fused KNN kernel (K6 or K7)?"""
        nt, d = x_test.shape
        ntr = self._x_train.shape[0]
        return knn_kernel_supported(nt, ntr, d, self.k) and not (exclude_self and self.k >= ntr)

    def _knn_scores_all_masks(self, x_test: torch.Tensor, exclude_self: bool) -> torch.Tensor:
        masks, _ = self._device_pool()
        return knn_scores_all_masks(x_test, self._x_train, masks, self.k,
                                    mode="mean" if self.base == "knn_mean" else "kth",
                                    exclude_self=exclude_self)

    def _knn_fused_decision_function(self, x_test: torch.Tensor, exclude_self: bool = False):
        """The fused path (counterpart of the JAX ``_fused_knn_ensemble_scores``):
        the kernel, then the zscore and the aggregation on the device, one
        host fetch of the (nt,) scores. None where the shapes do not take
        the kernel."""
        if not self._knn_kernel_route(x_test, exclude_self):
            return None
        s = self._knn_scores_all_masks(x_test, exclude_self)
        if self.normalize == "zscore":
            s = _zscore(s)
        _, proba = self._device_pool()
        return _reduce(s, proba, self._reduce_aggregation).cpu().numpy()

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
        if self._knn_kernel_route(x_t, exclude_self):
            return self._knn_scores_all_masks(x_t, exclude_self).cpu().numpy()
        raw = self._native_scores(x_t, exclude_self, reduce=False)
        return raw.reshape(-1, x_t.shape[0])[: len(self.subspaces)].cpu().numpy()

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
