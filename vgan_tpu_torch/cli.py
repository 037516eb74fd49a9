"""Command-line interface (counterpart of ``vgan_tpu.cli``).

The reference is configured through constructor kwargs; this CLI exposes the
same hyperparameters, names and defaults as ``vgan_tpu``'s. Subcommands:

    python -m vgan_tpu_torch fit          --data X.npy --variant kl --epochs 2000 ...
    python -m vgan_tpu_torch sample       --generator g.pt --ndims 32 --nsubs 500
    python -m vgan_tpu_torch export       --generator g.pt --ndims 32 --out sampler.pt2
    python -m vgan_tpu_torch check-myopic --data X.npy --generator g.pt ...
    python -m vgan_tpu_torch score        --train X.npy --generator g.pt --base knn

Where it differs from ``vgan_tpu``'s:

- ``--device`` on every subcommand (default: the card; ``cpu`` only when
  asked for). JAX picks its platform from the environment, so ``vgan_tpu``
  has no such flag.
- ``--mmd-impl`` takes the port's ``auto``/``torch``/``cuda``/``chunked``,
  and ``jnp``/``pallas`` as the names of ``torch``/``cuda``, so a
  ``vgan_tpu`` command line runs unchanged.
- ``--mesh data=N[,model=M]`` builds a mesh over the ``torch.distributed``
  world, one process per device: run the command under ``torchrun
  --nproc-per-node N`` (``env://``), or with ``data=1`` in a plain process
  (a world of one). Every rank runs the command; only rank 0 prints and
  writes files.
- ``fit --variant no_kl`` refuses ``--generator-grad`` and
  ``--latent-size`` away from their defaults (``vgan_tpu`` drops them
  silently there).
- ``fit --out`` writes ``.pt`` generator files; ``--generator`` takes a
  ``.pt`` or a ``vgan_tpu`` ``.msgpack``; ``export`` writes a
  ``torch.export`` program (load it with
  ``vgan_tpu_torch.serving.load_sampler``).
"""

from __future__ import annotations

import argparse
import sys

# Native base scorers for `score` --base/--members (a literal, so that the
# parser builds without the ensemble; held to the ensemble's registry in
# tests/test_torch_cli.py).
_SCORE_BASES = ("knn", "knn_mean", "lof", "abod", "cof", "iforest",
                "mahalanobis", "cblof", "gmm", "loda", "kde", "inne",
                "pca", "sampling", "kpca", "mcd", "ae", "dsvdd", "sod",
                "ocsvm", "sos", "lmdd", "copod", "hbos", "ecod")
# vgan_tpu's --mmd-impl names of the port's implementations
_MMD_IMPL_ALIASES = {"jnp": "torch", "pallas": "cuda"}


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card, which must be present; "
                        "'cpu' runs on the CPU)")


def _add_common_hyperparams(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch-size", type=int, default=500)
    p.add_argument("--epochs", type=int, default=2000)
    p.add_argument("--seed", type=int, default=777)
    p.add_argument("--weight-decay", type=float, default=0.04)
    p.add_argument("--momentum", type=float, default=0.99)
    p.add_argument("--mmd-impl", choices=["auto", "torch", "cuda", "chunked", "jnp", "pallas"],
                   default="auto",
                   help="MMD implementation ('jnp' and 'pallas' are vgan_tpu's names of "
                        "'torch' and 'cuda')")
    p.add_argument("--model-dtype", choices=["bfloat16"], default=None,
                   help="run generator/detector layers with bf16 operands (f32 master "
                        "parameters, f32 accumulation, f32 pre-softmax logits)")
    p.add_argument("--opt-state-dtype", choices=["bfloat16"], default=None,
                   help="store the Adadelta averages in bf16 (f32 math)")
    p.add_argument("--gram-dtype", choices=["bfloat16"], default=None,
                   help="round the MMD's distance operands to bf16 (f32 accumulation; the "
                        "Gram kernels' tensor-core variants on the card)")
    p.add_argument("--mesh", default=None, metavar="data=N[,model=M]",
                   help="multi-device mesh: shard batch rows over 'data' (and features "
                        "over 'model' with --shard-features), one process per device "
                        "(torchrun --nproc-per-node N*M), e.g. --mesh data=4,model=2")
    p.add_argument("--shard-features", action="store_true",
                   help="additionally split the dataset's columns over the mesh's 'model' "
                        "axis: this splits its storage only, since each step gathers the "
                        "columns back and the 'model' ranks repeat the same full-width work")
    p.add_argument("--no-quirks", action="store_true",
                   help="disable reference-quirk replication")
    p.add_argument("--quiet", action="store_true")
    _add_device(p)


def _parse_mesh(spec, device):
    """'data=N[,model=M]' -> a mesh over the ``torch.distributed`` world
    (joined from torchrun's environment, or a world of one); None for None."""
    if spec is None:
        return None
    axes = {"data": 1, "model": 1}
    for part in spec.split(","):
        name, _, value = part.partition("=")
        name = name.strip()
        if name not in axes or not value.strip().isdigit():
            raise SystemExit(f"--mesh: expected data=N[,model=M], got {spec!r}")
        axes[name] = int(value)
    from vgan_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(data=axes["data"], model=axes["model"], device=device)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vgan_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    fit = sub.add_parser("fit", help="train a subspace generator")
    fit.add_argument("--data", required=True,
                     help=".npy/.npz/.csv file, or sklearn:<name> (e.g. sklearn:digits)")
    fit.add_argument("--variant", choices=["kl", "no_kl"], default="no_kl")
    fit.add_argument("--out", default=None, help="artifact directory "
                     "(models/, train_history/, params.csv, loss PDF)")
    fit.add_argument("--lr", type=float, default=0.007)
    fit.add_argument("--lr-d", type=float, default=0.007)
    fit.add_argument("--temperature", type=float, default=0.0)
    fit.add_argument("--iternum-d", type=int, default=1)
    fit.add_argument("--iternum-g", type=int, default=5)
    fit.add_argument("--generator-grad", choices=["reference", "st", "gumbel_st"],
                     default="reference",
                     help="kl binarization gradient estimator: the reference's "
                          "mask-as-constant semantics, straight-through, or Gumbel-ST "
                          "(kl variant only)")
    fit.add_argument("--latent-size", type=int, default=None,
                     help="override the reference's max(d//16, 1) generator latent size "
                          "(kl variant only)")
    fit.add_argument("--checkpoint", default=None,
                     help="directory for a full-train-state checkpoint")
    _add_common_hyperparams(fit)

    sample = sub.add_parser("sample", help="sample subspace masks")
    sample.add_argument("--generator", required=True,
                        help=".pt (reference layout) or vgan_tpu .msgpack generator")
    sample.add_argument("--ndims", type=int, required=True)
    sample.add_argument("--nsubs", type=int, default=500)
    sample.add_argument("--seed", type=int, default=777)
    sample.add_argument("--out", default=None, help="write masks to .npy")
    sample.add_argument("--dist", action="store_true",
                        help="print the unique-mask distribution")
    _add_device(sample)

    export = sub.add_parser(
        "export", help="save the mask sampler as a serving artifact "
        "(torch.export program; load via vgan_tpu_torch.serving.load_sampler)"
    )
    export.add_argument("--generator", required=True,
                        help=".pt (reference layout) or vgan_tpu .msgpack generator")
    export.add_argument("--ndims", type=int, required=True)
    export.add_argument("--out", required=True, help="artifact path (e.g. sampler.pt2)")
    _add_device(export)

    myopic = sub.add_parser("check-myopic", help="MMD GoF test")
    myopic.add_argument("--data", required=True)
    myopic.add_argument("--generator", required=True)
    myopic.add_argument("--bandwidth", type=float, nargs="+", default=[0.01])
    myopic.add_argument("--count", type=int, default=500)
    myopic.add_argument("--seed", type=int, default=777)
    _add_device(myopic)

    score = sub.add_parser("score", help="subspace-ensemble outlier scores for a test set")
    score.add_argument("--train", required=True, help="training data file")
    score.add_argument("--test", default=None, help="data to score (defaults to --train)")
    score.add_argument("--generator", required=True)
    score.add_argument("--base", choices=sorted(_SCORE_BASES), default="knn")
    score.add_argument("--members", default=None, metavar="B1,B2,...",
                       help="comma-separated base list for a heterogeneous (suod-style) "
                            "combination; overrides --base")
    score.add_argument("--combination",
                       choices=["average", "max", "median", "select", "weighted", "vote"],
                       default="average",
                       help="member combination for --members ('select' = "
                            "consensus-correlation reliability weighting; 'weighted' needs "
                            "--weights; 'vote' = combo's majority vote over member labels)")
    score.add_argument("--weights", default=None, metavar="W1,W2,...",
                       help="comma-separated per-member weights for --combination "
                            "weighted/vote")
    score.add_argument("--k", type=int, default=10)
    score.add_argument("--n-trees", type=int, default=100,
                       help="forest size for --base iforest")
    score.add_argument("--kde-bandwidth", type=float, default=1.0,
                       help="Gaussian kernel width for --base kde")
    score.add_argument("--n-projections", type=int, default=100,
                       help="random-direction count for --base loda")
    score.add_argument("--inne-psi", type=int, default=8,
                       help="hypersphere-center subsample size for base='inne' (reads "
                            "--n-trees as its ensemble size)")
    score.add_argument("--subset-size", type=int, default=20,
                       help="train-subsample size for --base sampling")
    score.add_argument("--sod-ref-set", type=int, default=10,
                       help="shared-nearest-neighbor reference-set size for --base sod "
                            "(--k is its n_neighbors)")
    score.add_argument("--ocsvm-nu", type=float, default=0.5,
                       help="one-class SVM nu (outlier-fraction bound) for --base ocsvm")
    score.add_argument("--ocsvm-gamma", type=float, default=0.0,
                       help="RBF width for --base ocsvm (0 = pyod's 'auto': "
                            "1/n_active_features per subspace)")
    score.add_argument("--sos-perplexity", type=float, default=4.5,
                       help="target binding-distribution perplexity for --base sos")
    score.add_argument("--lmdd-dis", choices=["var", "aad"], default="var",
                       help="dissimilarity measure for --base lmdd")
    score.add_argument("--ae-hidden", default="64,32",
                       help="comma-separated encoder widths for --base ae (decoder mirrored)")
    score.add_argument("--ae-epochs", type=int, default=50,
                       help="full-batch Adam steps for --base ae")
    score.add_argument("--support-fraction", type=float, default=0.0,
                       help="FastMCD support fraction for --base mcd (0 = sklearn's None)")
    score.add_argument("--kpca-gamma", type=float, default=0.0,
                       help="RBF width for --base kpca (0 = 1/n_active_features per "
                            "subspace)")
    score.add_argument("--kpca-sampling", action="store_true",
                       help="fit --base kpca's kernel spectrum on a --subset-size train "
                            "subsample")
    score.add_argument("--pca-n-selected", type=int, default=0,
                       help="component count scored by --base pca, from the "
                            "smallest-variance end (0 = all valid components)")
    score.add_argument("--n-clusters", type=int, default=8,
                       help="k-means cluster count for --base cblof (mixture components "
                            "for --base gmm)")
    score.add_argument("--gmm-covariance", choices=["diag", "full"], default="diag",
                       help="gmm covariance family")
    score.add_argument("--mesh", default=None, metavar="data=N",
                       help="shard the subspace axis over devices (one process per device: "
                            "torchrun --nproc-per-node N)")
    score.add_argument("--subspaces", type=int, default=500)
    score.add_argument("--aggregation",
                       choices=["average", "max", "aom", "moa", "median", "vote"],
                       default="average",
                       help="subspace-score combination ('vote' = combo's majority vote; "
                            "'weighted' with explicit per-mask weights is API-only)")
    score.add_argument("--seed", type=int, default=777)
    score.add_argument("--out", default=None, help="write scores to .npy")
    _add_device(score)

    return parser


def _load_data(spec: str):
    from vgan_tpu_torch.data import load_tabular, sklearn_dataset

    if spec.startswith("sklearn:"):
        x, _ = sklearn_dataset(spec.split(":", 1)[1])
        return x
    return load_tabular(spec)


def _fit(args, parser) -> int:
    from vgan_tpu_torch import VGAN, VGAN_no_kl
    from vgan_tpu_torch.parallel.mesh import is_rank0

    if args.shard_features and args.mesh is None:
        parser.error("--shard-features requires --mesh (it shards the feature axis over "
                     "'model')")
    if args.variant == "no_kl":
        dropped = [flag for flag, value, default in (
            ("--generator-grad", args.generator_grad, "reference"),
            ("--latent-size", args.latent_size, None)) if value != default]
        if dropped:
            parser.error(f"{', '.join(dropped)} only apply to --variant kl")
    mesh = _parse_mesh(args.mesh, args.device)
    x = _load_data(args.data)
    common = dict(
        batch_size=args.batch_size,
        epochs=args.epochs,
        momentum=args.momentum,
        seed=args.seed,
        weight_decay=args.weight_decay,
        path_to_directory=args.out,
        mmd_impl=_MMD_IMPL_ALIASES.get(args.mmd_impl, args.mmd_impl),
        gram_matmul_dtype=args.gram_dtype,
        model_matmul_dtype=args.model_dtype,
        opt_state_dtype=args.opt_state_dtype,
        mesh=mesh,
        shard_features=args.shard_features,
        replicate_reference_quirks=not args.no_quirks,
        verbose=not args.quiet,
        device=args.device,
    )
    if args.variant == "kl":
        model = VGAN(temperature=args.temperature, lr_G=args.lr, lr_D=args.lr_d,
                     iternum_d=args.iternum_d, iternum_g=args.iternum_g,
                     generator_grad=args.generator_grad, latent_size=args.latent_size,
                     **common)
    else:
        model = VGAN_no_kl(lr=args.lr, **common)
    model.fit(x)
    if args.checkpoint:
        model.save_checkpoint(args.checkpoint)
    if not is_rank0(mesh):
        return 0
    if model.train_history["generator_loss"]:
        print(f"final loss: {model.train_history['generator_loss'][-1]}")
    else:
        print("final loss: n/a (0 epochs)")
    if args.checkpoint:
        print(f"checkpoint written to {args.checkpoint}")
    return 0


def _sampler(args, ndims: int, **kw):
    from vgan_tpu_torch import VGAN_no_kl

    model = VGAN_no_kl(verbose=False, device=args.device, **kw)
    model.load_models(args.generator, ndims=ndims)
    return model


def _score(args, parser) -> int:
    import numpy as np

    from vgan_tpu_torch.ensemble import HeterogeneousEnsemble, SubspaceEnsemble
    from vgan_tpu_torch.parallel.mesh import is_rank0, write_on_rank0

    # validate --members before any data or model loading, so that a typo'd
    # base name errors at once through the parser
    member_bases = None
    if args.members:
        member_bases = [b.strip() for b in args.members.split(",")]
        bad = [b for b in member_bases if b not in _SCORE_BASES]
        if bad:
            parser.error(f"--members: unknown base(s) {bad}; choose from {sorted(_SCORE_BASES)}")
    mesh = _parse_mesh(args.mesh, args.device)
    x_train = _load_data(args.train)
    x_test = _load_data(args.test) if args.test else x_train
    model = _sampler(args, x_train.shape[1], seed=args.seed)
    knobs = dict(
        k=args.k, n_trees=args.n_trees, kde_bandwidth=args.kde_bandwidth,
        n_projections=args.n_projections, inne_psi=args.inne_psi,
        pca_n_selected=args.pca_n_selected, subset_size=args.subset_size,
        kpca_gamma=args.kpca_gamma, kpca_sampling=args.kpca_sampling,
        support_fraction=args.support_fraction,
        ae_hidden=tuple(int(h) for h in args.ae_hidden.split(",")),
        ae_epochs=args.ae_epochs, sod_ref_set=args.sod_ref_set, ocsvm_nu=args.ocsvm_nu,
        ocsvm_gamma=args.ocsvm_gamma, sos_perplexity=args.sos_perplexity,
        lmdd_dis=args.lmdd_dis, n_clusters=args.n_clusters,
        gmm_covariance=args.gmm_covariance, aggregation=args.aggregation,
        mesh=mesh, device=args.device,
    )
    if member_bases:
        ens = HeterogeneousEnsemble.from_model(
            model, subspace_count=args.subspaces, members=[{"base": b} for b in member_bases],
            combination=args.combination,
            weights=[float(w) for w in args.weights.split(",")] if args.weights else None,
            **knobs,
        ).fit(x_train)
    else:
        ens = SubspaceEnsemble.from_model(model, subspace_count=args.subspaces, base=args.base,
                                          **knobs).fit(x_train)
    scores = ens.decision_function(x_test)
    if args.out:
        write_on_rank0(mesh, np.save, args.out, scores)
    if not is_rank0(mesh):
        return 0
    if args.out:
        print(f"{scores.shape} scores -> {args.out}")
    else:
        print(scores)
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cmd == "fit":
        return _fit(args, parser)

    if args.cmd == "sample":
        model = _sampler(args, args.ndims, seed=args.seed)
        u = model.generate_subspaces(args.nsubs)
        if args.out:
            import numpy as np

            np.save(args.out, u)
            print(f"{u.shape} masks -> {args.out}")
        if args.dist or not args.out:
            import pandas as pd

            model.approx_subspace_dist(args.nsubs)
            print(pd.DataFrame(model.subspaces, model.proba))
        return 0

    if args.cmd == "score":
        return _score(args, parser)

    if args.cmd == "export":
        from vgan_tpu_torch.serving import export_sampler

        model = _sampler(args, args.ndims)
        export_sampler(model, args.out)
        print(f"sampler artifact (latent_size={model._latent_size}) -> {args.out}")
        return 0

    if args.cmd == "check-myopic":
        x = _load_data(args.data)
        model = _sampler(args, x.shape[1], seed=args.seed)
        print(model.check_if_myopic(x, bandwidth=list(args.bandwidth), count=args.count))
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
