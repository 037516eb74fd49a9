"""Serving export: the sampler and the ensemble scorers as ``torch.export``
programs (counterpart of ``vgan_tpu.serving``).

A fitted model's mask sampler (noise -> linear stack -> upper softmax ->
binarize) and a fitted ensemble's ``decision_function`` are exported with
``torch.export`` into self-contained ``ExportedProgram`` files (the graph
and its weights, training rows and masks as constants) with a dynamic batch
dimension ``Dim("b")``, written with ``torch.export.save``. A serving
process loads them with ``torch.export.load`` and needs only torch, none of
this package. A program runs on the device it was exported on.

The scorers export the generic chunked path of the native bases, as
``vgan_tpu``'s exports run the generic XLA path and not the Pallas kernels:
the CUDA kernels are ``ctypes`` calls, which a trace cannot record, so a
live knn ensemble on the card runs K6 / K7 and its exported program the
generic torch path. Seeded torch draws (iforest's forest, loda's
directions, cblof's and gmm's centroids) are made before the trace and held
as constants (``od._scorer_with_draws``); ocsvm's and sos's fixed-count
loops export as ``while_loop``s (``od._fixed_loop``).
"""

from __future__ import annotations

import numpy as np
import torch

from vgan_tpu_torch.ops.activations import binarize_mask

_EXPORT_ROWS = 4  # the example batch of a trace (a size of 0 or 1 would specialize)


class _Program(torch.nn.Module):
    """``forward(x) = fn(x)``: the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _export(fn, d: int, path, device) -> None:
    """Export ``fn: (b, d) float32 -> ...`` with a dynamic batch and save it."""
    example = torch.zeros((_EXPORT_ROWS, d), dtype=torch.float32, device=device)
    with torch.no_grad():
        program = torch.export.export(_Program(fn), (example,),
                                      dynamic_shapes={"x": {0: torch.export.Dim("b")}})
    torch.export.save(program, str(path))


def _program_device(program) -> torch.device:
    """Where a loaded program's weights and constants live (a CUDA one if any)."""
    tensors = [t for t in (*program.state_dict.values(), *program.constants.values())
               if isinstance(t, torch.Tensor)]
    cuda = [t.device for t in tensors if t.device.type == "cuda"]
    return cuda[0] if cuda else torch.device("cpu")


def _load(path):
    """``(module, device)`` of a saved program."""
    program = torch.export.load(str(path))
    return program.module(), _program_device(program)


def export_sampler(model, path) -> None:
    """Save the fitted model's mask sampler to ``path``.

    The program maps noise ``z (b, latent)`` to boolean masks ``(b, d)``:
    the generator's deterministic upper-softmax forward, then
    :func:`~vgan_tpu_torch.ops.activations.binarize_mask`. The weights are
    the program's; it runs on the generator's device. A generator built with
    ``model_matmul_dtype='bfloat16'`` is traced with its bf16 layers, as
    ``generate_subspaces`` samples it."""
    generator = model.generator
    dtype = next(generator.parameters()).dtype

    def sample(z):
        return binarize_mask(generator.sample(z.to(dtype)), axis=-1)

    device = next(generator.parameters()).device
    _export(sample, model._latent_size, path, device)


def load_sampler(path):
    """Load a saved sampler; returns ``fn(z) -> bool masks`` (numpy), ``z``
    numpy or a tensor."""
    module, device = _load(path)

    def fn(z):
        with torch.no_grad():
            return module(torch.as_tensor(z, dtype=torch.float32, device=device)).cpu().numpy()

    return fn


def sample_masks(sampler_fn, nsubs: int, latent_size: int, seed: int = 777) -> np.ndarray:
    """The estimator's sampling semantics against a loaded sampler: noise
    re-drawn from a CPU ``torch.Generator`` seeded with ``seed``, as
    ``generate_subspaces`` draws it, so the same (seed, nsubs) gives the
    same masks."""
    g = torch.Generator().manual_seed(int(seed))
    z = torch.randn((nsubs, latent_size), generator=g, dtype=torch.float32)
    return np.asarray(sampler_fn(z))


def _require_native(ensemble) -> None:
    from vgan_tpu_torch.ensemble.od import _BASE_SCORERS, _DIM_BASES, _PARAM_BASES

    ensemble._require_fit()
    if not (isinstance(ensemble.base, str)
            and ensemble.base in (*_BASE_SCORERS, *_DIM_BASES, *_PARAM_BASES)):
        raise ValueError("only native base scorers export (a pyod-style detector instance "
                         "runs a CPU loop that no program can hold)")


def _chunked_pool(ensemble, weights, max_batch: int, scorer_k):
    """The pool as ``(n_chunks, chunk, d)`` masks and ``(n_chunks, chunk)``
    weights on the ensemble's device, the chunk sized by ``_effective_chunk``
    with ``max_batch`` as nt."""
    from vgan_tpu_torch.ensemble.od import _chunked_masks, _effective_chunk

    ntr, d = ensemble._x_train.shape
    chunk = _effective_chunk(ensemble.base, ensemble.chunk, max_batch, ntr, d, scorer_k,
                             n_clusters=ensemble.n_clusters,
                             gmm_covariance=ensemble.gmm_covariance, n_trees=ensemble.n_trees,
                             inne_psi=ensemble.inne_psi, kpca_sampling=ensemble.kpca_sampling,
                             subset_size=ensemble.subset_size, mcd_starts=ensemble.mcd_starts,
                             ae_hidden=ensemble.ae_hidden, sod_ref_set=ensemble.sod_ref_set)
    masks_np, proba_np = _chunked_masks(ensemble.subspaces, weights, chunk)
    dev = ensemble.device
    return (torch.as_tensor(masks_np, dtype=torch.float32, device=dev),
            torch.as_tensor(proba_np, device=dev))


def _with_jl(ensemble, score):
    """``(score, input width)``: a JL member's program takes original-d
    rows and holds the (d, m) projection in-graph."""
    if ensemble._jl_R is None:
        return score, int(ensemble._x_train.shape[1])
    jl_r = ensemble._jl_R

    def projected(x):
        return score(x @ jl_r)

    return projected, int(jl_r.shape[0])


def _ensemble_score_fn(ensemble, max_batch: int = 4096):
    """``(fn, d)``: the traceable ``x_test -> aggregated scores`` closure of
    a fitted native-base :class:`~vgan_tpu_torch.ensemble.SubspaceEnsemble`
    (shared by the ensemble and heterogeneous exporters), and the width of
    its input. Raises on non-native bases and on the aggregations that
    cannot reduce inside mask chunks.

    ``max_batch`` stands in for the symbolic test batch where the memory
    governors size the program (``_effective_chunk``; the streamed tiles
    inside the scorers use ``od._EXPORT_NT_HINT``)."""
    from vgan_tpu_torch.ensemble.od import (
        _DIM_BASES, _chunked_scores, _dim_scores_impl, _dim_subspace_raw, _reduce,
        _scorer_params, _scorer_with_draws, _zscore,
    )

    _require_native(ensemble)
    if ensemble.aggregation not in ("average", "max", "weighted"):
        raise ValueError(
            f"aggregation={ensemble.aggregation!r} does not export: the program "
            "reduces inside mask chunks, which cannot express the 'aom'/'moa'/"
            "'median' whole-pool combinations (nor 'vote', whose thresholds come "
            "from predict-time train batches); export with aggregation='average'/"
            "'max'/'weighted', or use export_per_subspace_scorer and combine on "
            "the serving side"
        )
    x_train = ensemble._x_train
    ntr, d = x_train.shape
    aggregation, normalize = ensemble._reduce_aggregation, ensemble.normalize
    if ensemble.base in _DIM_BASES:
        # the live dim route weights by the pool probabilities ('weighted' too)
        masks, _ = ensemble._device_pool()
        proba = torch.as_tensor(ensemble.proba, device=ensemble.device)
        base, n_bins = ensemble.base, ensemble.n_bins

        def score(x_test):
            s = _dim_subspace_raw(_dim_scores_impl(x_test, x_train, base=base, n_bins=n_bins),
                                  masks)
            if normalize == "zscore":
                s = _zscore(s)
            return _reduce(s, proba, aggregation)
    else:
        scorer, k = _scorer_with_draws(ensemble.base, ntr, d, ensemble.device,
                                       **_scorer_params(ensemble))
        masks, proba = _chunked_pool(ensemble, ensemble._combining_weights(), max_batch, k)

        def score(x_test):
            return _chunked_scores(x_test, x_train, masks, proba, scorer, k, aggregation,
                                   normalize)
    return _with_jl(ensemble, score)


def export_ensemble_scorer(ensemble, path, max_batch: int = 4096) -> None:
    """Save a fitted :class:`~vgan_tpu_torch.ensemble.SubspaceEnsemble`'s
    ``decision_function`` to ``path`` (dynamic test batch).

    The training rows, masks, weights and the base scorer are the
    program's; an ensemble's ``mesh`` does not reach it (the program scores
    every mask on the device it runs on). Where the train set streams (a neighbour base past
    ``STREAM_NTR``) or a governor clamps the mask chunk, the program is
    sized for serving batches up to ``max_batch``; larger batches still run,
    with proportionally more memory."""
    score, d = _ensemble_score_fn(ensemble, max_batch=max_batch)
    _export(score, d, path, ensemble.device)


def export_per_subspace_scorer(ensemble, path, max_batch: int = 4096) -> None:
    """Save the per-subspace score matrix program: ``x_test (b, d) ->
    (n_subspaces, b)``, normalized per the ensemble's ``normalize``.

    The serving side combines as it wants: the export path for the bucketed
    'aom'/'moa'/'median' modes and for per-subspace analysis."""
    from vgan_tpu_torch.ensemble.od import (
        _DIM_BASES, _chunked_raw, _dim_scores_impl, _dim_subspace_raw, _scorer_params,
        _scorer_with_draws, _zscore,
    )

    _require_native(ensemble)
    x_train = ensemble._x_train
    ntr, d = x_train.shape
    n_subs, normalize = len(ensemble.subspaces), ensemble.normalize
    if ensemble.base in _DIM_BASES:
        masks, _ = ensemble._device_pool()
        base, n_bins = ensemble.base, ensemble.n_bins

        def raw(x_test):
            return _dim_subspace_raw(_dim_scores_impl(x_test, x_train, base=base, n_bins=n_bins),
                                     masks)
    else:
        scorer, k = _scorer_with_draws(ensemble.base, ntr, d, ensemble.device,
                                       **_scorer_params(ensemble))
        masks, _ = _chunked_pool(ensemble, ensemble.proba, max_batch, k)

        def raw(x_test):
            return _chunked_raw(x_test, x_train, masks, scorer, k).reshape(
                -1, x_test.shape[0])[:n_subs]

    def score(x_test):
        s = raw(x_test)
        return _zscore(s) if normalize == "zscore" else s

    score, d_in = _with_jl(ensemble, score)
    _export(score, d_in, path, ensemble.device)


def export_hetero_scorer(het, path, max_batch: int = 4096) -> None:
    """Save a fitted
    :class:`~vgan_tpu_torch.ensemble.HeterogeneousEnsemble`'s
    ``decision_function`` as one program: every member's chunk-reduced
    scores (a distilled member's regressor,
    ``ScoreDistiller._predict_torch``), the per-member standardization and
    the 'average'/'max'/'median'/'select'/'weighted' combination, with
    'select''s reliability weights computed in-program from the batch, as
    the live path derives them.

    Every member needs a native base and an aggregation that exports (as for
    :func:`export_ensemble_scorer`). As in the live path, the member scores
    are standardized in float64 (``od._zscore``), rounded to float32 and
    combined in float64 (``hetero._combine``); ``vgan_tpu``'s export runs
    float32 throughout. A live knn member on the card rides K6 / K7, its
    exported program the generic path."""
    from vgan_tpu_torch.ensemble.hetero import _combine
    from vgan_tpu_torch.ensemble.od import _zscore

    if het.combination == "vote":
        raise ValueError(
            "combination='vote' cannot be exported as one program: each member's "
            "labels come from its own predict-time train-batch thresholding. Export "
            "the members individually (or use export_per_subspace_scorer) and vote "
            "on the serving side."
        )
    # every member takes original-d rows (a JL member holds its projection)
    d = int(het._train_matrix().shape[1])
    member_fns = [het._distillers[i]._predict_torch if i in het._distillers
                  else _ensemble_score_fn(m, max_batch=max_batch)[0]
                  for i, m in enumerate(het.members)]
    combination, weights = het.combination, het.weights

    def score(x_test):
        s = torch.stack([fn(x_test) for fn in member_fns]).double()
        combined, _ = _combine(_zscore(s).float().double(), combination, weights=weights)
        return combined.float()

    _export(score, d, path, het.device)


def load_ensemble_scorer(path):
    """Load a saved ensemble, per-subspace or heterogeneous scorer; returns
    ``fn(x_test) -> scores``, numpy in and numpy out (the rows go to the
    device of the program's constants)."""
    module, device = _load(path)

    def fn(x_test):
        x = torch.as_tensor(np.asarray(x_test, np.float32), device=device)
        with torch.no_grad():
            return module(x).cpu().numpy()

    return fn
