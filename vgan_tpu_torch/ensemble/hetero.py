"""Heterogeneous detector combination over one subspace pool (suod-style).

Several :class:`~vgan_tpu_torch.ensemble.od.SubspaceEnsemble` members (each
its own base family and hyperparameters) score the same V-GAN subspace
pool; each member's aggregated scores are standardized over the test batch
(suod's score-alignment step: knn distances and -log ECDF tails live on
incomparable scales), and the standardized member scores combine by one of
combo's combinators. A member may work in its own JL-projected space
(``jl_dim=``), and :meth:`HeterogeneousEnsemble.distill` replaces members by
RFF-ridge regressors (:class:`~vgan_tpu_torch.ensemble.distill.ScoreDistiller`).

Every member rides its own route (the fused KNN kernel for knn / knn_mean,
the dim route, the generic chunked route); the standardization and the
combination run in float64 on the ensemble's device, in functions on
tensors (``_zscore``, :func:`_combine`) that a serving export can trace.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from vgan_tpu_torch._device import resolve_device
from vgan_tpu_torch.ensemble.distill import ScoreDistiller
from vgan_tpu_torch.ensemble.od import (
    _POSITIONAL_EXCL_BASES, PyodSurfaceMixin, SubspaceEnsemble, _zscore,
)

_COMBINATIONS = ("average", "max", "median", "select", "weighted", "vote")


def _combine(s: torch.Tensor, combination: str, weights=None):
    """Combine STANDARDIZED member scores ``s (n_members, nt)``.

    Returns ``(combined (nt,), weights_or_None)``: 'select' derives the
    consensus-correlation reliability weights (see the class docstring),
    'weighted' applies the user-supplied ``weights``, normalized here so
    callers can pass raw importances. No data-dependent Python control flow
    on tensor values, so the function traces. 'median' over an even member
    count is the mean of the middle two (``torch.quantile``'s linear rule),
    as ``np.median``; ``torch.median`` would return the lower one."""
    if combination == "max":
        return torch.amax(s, dim=0), None
    if combination == "median":
        return torch.quantile(s, 0.5, dim=0), None
    if combination == "weighted":
        w = torch.as_tensor(weights, dtype=s.dtype, device=s.device)
        w = w / torch.sum(w)
        return w @ s, w
    if combination == "select":
        consensus = torch.mean(s, dim=0)
        consensus = (consensus - torch.mean(consensus)) / (
            torch.std(consensus, correction=0) + 1e-12
        )
        corr = torch.mean(s * consensus[None, :], dim=1)
        w = torch.clamp(corr, min=0.0)
        total = torch.sum(w)
        n = s.shape[0]
        uniform = torch.full((n,), 1.0 / n, dtype=s.dtype, device=s.device)
        # anti-correlated members clip to 0; all-zero clips fall back to
        # uniform (== 'average')
        w = torch.where(total > 0, w / torch.clamp(total, min=1e-30), uniform)
        return w @ s, w
    return torch.mean(s, dim=0), None


def _positional(member: SubspaceEnsemble) -> bool:
    """Does ``exclude_self`` reach this member (a neighbour-semantic base)?"""
    return isinstance(member.base, str) and member.base in _POSITIONAL_EXCL_BASES


class HeterogeneousEnsemble(PyodSurfaceMixin):
    """Combine several base-detector families over one subspace pool.

    Parameters
    ----------
    subspaces, proba:
        the shared mask pool and probabilities (as for ``SubspaceEnsemble``).
    members:
        sequence of kwargs dicts, one per member: each builds a
        ``SubspaceEnsemble(subspaces, proba, **shared, **member)``, e.g.
        ``[{"base": "knn", "k": 10}, {"base": "lof", "k": 20},
        {"base": "ecod"}]``. A member dict may carry its OWN
        ``subspaces``/``proba`` (both) to score a different pool. A member
        with ``jl_dim=m`` works in its own JL-projected space; without an
        explicit pool it scores the full projected space.
    combination:
        'average' (mean of standardized member scores), 'max', 'median',
        'select' (members weighted by their correlation to the consensus,
        the mean of the standardized member scores, clipped at zero and
        renormalized; 'average' when every correlation clips; the weights
        of the last scoring call are ``member_weights_``), 'weighted'
        (explicit per-member ``weights``), or 'vote' (the weighted fraction
        of members whose own ``predict`` flags the point;
        ``predict`` is the strict-majority label).
    weights:
        per-member combination weights (non-negative, normalized
        internally). REQUIRED for 'weighted'; optional for 'vote' (uniform
        default); ignored by the other modes.
    contamination:
        expected outlier fraction for ``predict`` (pyod semantics, as in
        ``SubspaceEnsemble``).
    device:
        where the members, the combination and the distillers run:
        ``cuda`` when None (raises without a card); ``"cpu"`` only when
        asked for. Every member gets it unless its dict names another.
    **shared:
        kwargs applied to every member (e.g. ``mesh=``, ``aggregation=``,
        ``chunk=``, ``test_chunk=``); member dicts override. A ``mesh``
        shards each member's masks over its 'data' ranks; the
        standardization, the combination and the distillers then run alike
        on every rank.

    ``predict`` reads the original-space train matrix, so a JL member may
    come first (``vgan_tpu`` reads member 0's, projected, matrix there and
    raises; ROADMAP.md Queue 3).
    """

    def __init__(
        self,
        subspaces: np.ndarray,
        proba: np.ndarray,
        members: Sequence[dict] = (
            {"base": "knn"}, {"base": "lof"}, {"base": "ecod"},
        ),
        combination: str = "average",
        contamination: float = 0.1,
        weights: Optional[Sequence[float]] = None,
        device=None,
        **shared,
    ):
        if combination not in _COMBINATIONS:
            raise ValueError(
                f"unknown combination={combination!r}: expected 'average', "
                "'max', 'median', 'select', 'weighted', or 'vote'"
            )
        if not members:
            raise ValueError("members must be non-empty")
        if combination == "weighted" and weights is None:
            raise ValueError(
                "combination='weighted' needs explicit weights= (combo's "
                "weighted-average combinator); use 'average' for uniform "
                "or 'select' for data-derived weights"
            )
        if weights is not None:
            weights = np.asarray(weights, np.float64)
            if len(weights) != len(members):
                raise ValueError(
                    f"weights and members disagree: {len(weights)} weights "
                    f"vs {len(members)} members"
                )
            if np.any(weights < 0) or not weights.sum() > 0:
                raise ValueError(
                    "weights must be non-negative with a positive sum"
                )
        self.weights = weights
        self.device = resolve_device(device)
        self.members = []
        for m in members:
            kwargs = {"device": self.device, **shared, **m}
            # Pools come as a PAIR: one without the other would silently
            # pair masks with the shared pool's probabilities.
            if ("subspaces" in kwargs) != ("proba" in kwargs):
                raise ValueError(
                    "a member overriding the pool must carry BOTH "
                    f"'subspaces' and 'proba'; got only one in {m!r}"
                )
            if kwargs.get("jl_dim") is not None and "subspaces" not in kwargs:
                # suod's JL stage scores the full PROJECTED space: the
                # single all-ones mask over the projected dims
                kwargs["subspaces"] = np.ones((1, int(kwargs["jl_dim"])), bool)
                kwargs["proba"] = np.ones(1, np.float32)
            m_subs = kwargs.pop("subspaces", subspaces)
            m_proba = kwargs.pop("proba", proba)
            self.members.append(SubspaceEnsemble(m_subs, m_proba, **kwargs))
        self.combination = combination
        self.contamination = contamination
        self._threshold = None
        self._member_weights = None
        self._decision_scores = None
        self._x_train_orig = None
        self._distillers = {}

    @classmethod
    def from_model(cls, model, subspace_count: int = 500, **kwargs):
        """Build from a fitted estimator via ``approx_subspace_dist``."""
        model.approx_subspace_dist(subspace_count)
        return cls(model.subspaces, model.proba, **kwargs)

    def fit(self, x_train: np.ndarray):
        self._x_train_orig = np.asarray(x_train, np.float32)
        for m in self.members:
            m.fit(x_train)
        self._decision_scores = None
        self._distillers = {}
        return self

    def _train_matrix(self) -> np.ndarray:
        # the ORIGINAL-space train matrix: a member may work in its own
        # JL-projected space, so a member's own train matrix is no proxy
        if self._x_train_orig is None:
            raise RuntimeError("call fit(X_train) first")
        return self._x_train_orig

    def _calibration_scores(self, x_test: np.ndarray):
        """``predict_proba`` calibration via ONE combined train+test pass, so
        train and test share the member standardization (neighbour members
        exclude the train rows' self-pairs). 'vote' members threshold
        internally per ``predict`` call, so its fractions are per split."""
        x_train = self._train_matrix()
        x_test = np.asarray(x_test, np.float32)
        if self.combination == "vote":
            return self.decision_function(x_train), self.decision_function(x_test)
        n_tr = len(x_train)
        scores = self.decision_function(np.concatenate([x_train, x_test]), exclude_self=True)
        return scores[:n_tr], scores[n_tr:]

    def distill(self, members=None, n_features: int = 512, ridge="gcv", seed: int = 0):
        """suod's pseudo-supervised approximation stage: fit a
        :class:`ScoreDistiller` per member on ``(X_train -> member's train
        scores)`` and score through it instead of the detector.

        ``members`` selects which member indices to distill (default: all).
        Train scores are the member's own ``decision_function`` on the
        original-space train matrix with neighbour self-pairs excluded;
        member ``i``'s distiller draws with ``seed + i``. Call after
        ``fit``; refit clears distillers. Returns self."""
        x_tr = self._train_matrix()
        idxs = range(len(self.members)) if members is None else members
        for i in idxs:
            m = self.members[i]
            s_tr = np.asarray(m.decision_function(x_tr, exclude_self=_positional(m)), np.float64)
            self._distillers[int(i)] = ScoreDistiller(
                n_features=n_features, ridge=ridge, seed=seed + int(i), device=self.device,
            ).fit(x_tr, s_tr)
        return self

    @property
    def distilled_members_(self):
        """Sorted indices of the currently distilled members."""
        return sorted(self._distillers)

    def _member_scores(self, x_test: np.ndarray, exclude_self: bool = False) -> torch.Tensor:
        """(n_members, nt) standardized member scores, float32 on the device:
        each member's scores in float64, standardized, cast to float32."""
        rows = []
        for i, m in enumerate(self.members):
            if i in self._distillers:
                s = self._distillers[i].predict(np.asarray(x_test, np.float32))
            else:
                s = m.decision_function(x_test, exclude_self=exclude_self and _positional(m))
            rows.append(np.asarray(s, np.float64))
        return _zscore(torch.as_tensor(np.stack(rows), device=self.device)).float()

    def member_scores(self, x_test: np.ndarray, exclude_self: bool = False) -> np.ndarray:
        """(n_members, nt) standardized member scores. ``exclude_self``
        reaches the neighbour-based members only. Distilled members score
        through their regressor (original-space input, no self-pairs)."""
        return self._member_scores(x_test, exclude_self).cpu().numpy()

    def decision_function(self, x_test: np.ndarray, exclude_self: bool = False) -> np.ndarray:
        """Combined outlier scores (higher = more outlying).

        With ``combination='vote'`` the score is the weighted FRACTION of
        members whose own ``predict`` flags the point (each member
        thresholds at its own contamination quantile with its one-batch
        semantics, so ``exclude_self`` is internal there)."""
        if self.combination == "vote":
            n = len(self.members)
            labels = np.stack([self._member_labels(i, x_test) for i in range(n)])
            w = np.full(n, 1.0 / n) if self.weights is None else self.weights / self.weights.sum()
            frac = torch.as_tensor(w, device=self.device) @ torch.as_tensor(labels,
                                                                            device=self.device)
            return frac.float().cpu().numpy()
        s = self._member_scores(x_test, exclude_self=exclude_self)
        combined, w = _combine(s.double(), self.combination, weights=self.weights)
        if self.combination == "select":
            self._member_weights = w.float().cpu().numpy()
        return combined.float().cpu().numpy()

    def _member_labels(self, i: int, x_test: np.ndarray) -> np.ndarray:
        """One member's 0/1 vote (float64): its own ``predict``, or, when
        distilled, the regressor's scores thresholded at the (1 -
        contamination) quantile of the regressor's TRAIN scores."""
        m = self.members[i]
        if i not in self._distillers:
            return m.predict(x_test).astype(np.float64)
        dist = self._distillers[i]
        thr = np.quantile(dist.predict(self._train_matrix()), 1.0 - self.contamination)
        return (dist.predict(np.asarray(x_test, np.float32)) > thr).astype(np.float64)

    @property
    def member_weights_(self) -> Optional[np.ndarray]:
        """Reliability weights from the last 'select' scoring call (one per
        member, summing to 1), or None before scoring / for other modes."""
        return self._member_weights

    def predict(self, x_test: np.ndarray) -> np.ndarray:
        """0/1 labels at the (1 - contamination) train-score quantile.

        Train and test rows are scored in ONE batch, so the member
        standardization is shared; ``threshold_`` is recomputed per call.
        With ``combination='vote'``: the strict weighted majority of the
        members' own labels (a tie is an inlier)."""
        if self.combination == "vote":
            frac = self.decision_function(x_test)
            self._threshold = 0.5
            return (frac > 0.5).astype(np.int64)
        x_train = self._train_matrix()
        n_tr = len(x_train)
        both = np.concatenate([x_train, np.asarray(x_test, np.float32)])
        scores = self.decision_function(both, exclude_self=True)
        self._threshold = float(np.quantile(scores[:n_tr], 1.0 - self.contamination))
        return (scores[n_tr:] > self._threshold).astype(np.int64)

    @property
    def threshold_(self) -> Optional[float]:
        """Train-score threshold from the last ``predict`` call."""
        return self._threshold
