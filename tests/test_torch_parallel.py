"""The port's multi-device paths (``vgan_tpu_torch.parallel``, ``mesh=`` on
the estimators, the ensemble and the tiled GoF tests, the CLI's ``--mesh``
and ``_dryrun``) on gloo CPU ranks, against ``vgan_tpu``'s sharded calls on
``jax.devices()[:4]`` of conftest's 8 virtual devices and against the
port's own single-device calls.

One module-scoped gloo world of 4 ranks runs the port's side of every check:
this file, run as a script (``python tests/test_torch_parallel.py world4
RANK PORT OUT``), is each rank. A 2-rank world (the counterpart of
``tests/test_distributed.py``) and ``python -m vgan_tpu_torch._dryrun 4``
start beside it. The ranks write their results to ``.npz`` files; the JAX
side runs here, on the same numpy inputs made from seeds, while the ranks
work. The ranks import no JAX.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from vgan_tpu_torch import VGAN, VGAN_no_kl, SubspaceEnsemble
from vgan_tpu_torch.ensemble import od as TOD
from vgan_tpu_torch.ops.cuda import gof_gram as TG
from vgan_tpu_torch.parallel import (
    data_sharding,
    make_mesh,
    mmd2_feature_sharded,
    mmd2_ring_rowsharded,
    no_kl_fit_program_dp,
    process_row_range,
    replicated,
    shard_dataset,
)
from vgan_tpu_torch.parallel.dp import MeshBatches
from vgan_tpu_torch.parallel.ring import mmd_loss_ring_rowsharded
from vgan_tpu_torch.train import steps as TS

if __name__ != "__main__":  # the gloo ranks (this file run as a script) import no JAX
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec

    import vgan_tpu.ops.pallas.gof_gram as JG
    import vgan_tpu.parallel.dp as JDP
    import vgan_tpu.parallel.mesh as JMESH
    import vgan_tpu.parallel.ring as JR
    from vgan_tpu.ensemble import SubspaceEnsemble as JaxEnsemble
    from vgan_tpu.train import steps as JS
    from vgan_tpu_torch.interop import detector_state_dict_from_jax, generator_state_dict_from_jax

REPO = Path(__file__).resolve().parent.parent
RANKS = 4
WAIT_S = 300

# ---------------------------------------------------------------------------
# inputs, made from seeds alike in this process and in the ranks
# ---------------------------------------------------------------------------

DP = dict(n=40, d=16, bs=10, epochs=3)  # the no-kl dp epochs (float64; float32 with a bf16 option)
KL = dict(n=40, d=48, bs=10)  # the kl dp epoch pair (detector, then generator)
KL_FLAGS = {"replicate_generator_detach": False}  # the generator trains: its rows gather
ENS = dict(n_train=60, n_test=20, d=12, n_masks=13, k=5)  # 13: not a multiple of chunk x ranks
ONE_CHUNK = ("ocsvm", "ae", "dsvdd")  # scored in one chunk, as their own tests keep them
NATIVE_BASES = sorted((*TOD._BASE_SCORERS, *TOD._DIM_BASES, *TOD._PARAM_BASES))
GOF = dict(n1=40, n2=36, d=5, perms=60, alphas=(0.5,))
# the dp epochs again in float32 with each bf16 option, against vgan_tpu's
# mesh epochs with the same option, at tests/test_torch_bf16.py's lockstep
# limit: the bf16 roundings of the layers (and of the Gram's operands and
# the optimizer state) turn float32 summation-order differences into
# bf16-sized ones wherever a value lies near a rounding boundary, so the
# losses and the bandwidth are held within half a bf16 ulp
BF16 = "bfloat16"
BF16_OPTIONS = ("gram_matmul_dtype", "model_matmul_dtype", "opt_state_dtype")
FIT_RTOL = 2e-3
# The kl epoch pair with bf16 layers runs JAX's side op by op
# (jax.disable_jit): XLA's fusions may keep a bf16 layer's intermediates
# in f32 (excess precision), and at this configuration's bandwidth (about
# 2e-3, L = 3 encodings) the generator epoch's loss is so sensitive to the
# encodings' bf16 roundings that one batch of JAX's jitted epoch lay 5% from
# JAX's own op-by-op evaluation of the same step, which the port follows
# within 4e-5 (the detector epoch and the other options agree jitted).
EAGER_OPTION = "model_matmul_dtype"
# mesh axes of a 2-d tensor's dims, () for replicated
PLACEMENTS = ((), ("data",), ("data", None), (None, "model"), ("data", "model"),
              ("model", "data"))


def ring_pair(n, d, shift, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(dtype)
    return x, (rng.normal(size=(n, d)) + shift).astype(dtype)


def dp_draws(seed, n, nb, bs, latent, dtype):
    rng = np.random.default_rng(seed)
    return rng.permutation(n), rng.normal(size=(nb, bs, latent)).astype(dtype)


def ens_data():
    cfg = ENS
    rng = np.random.default_rng(70)
    xtr = rng.normal(size=(cfg["n_train"], cfg["d"])).astype(np.float32)
    xte = rng.normal(size=(cfg["n_test"], cfg["d"])).astype(np.float32)
    masks = rng.random(size=(cfg["n_masks"], cfg["d"])) < 0.5
    masks[:, 0] |= ~masks.any(axis=1)  # no empty masks
    proba = rng.random(size=(cfg["n_masks"],)).astype(np.float32)
    return xtr, xte, masks, proba / proba.sum()


def aom_data():
    rng = np.random.default_rng(71)
    xtr = rng.normal(size=(50, 10)).astype(np.float32)
    xte = rng.normal(size=(15, 10)).astype(np.float32)
    masks = rng.random(size=(11, 10)) < 0.5  # 11: not a multiple of chunk x ranks
    masks[:, 0] |= ~masks.any(axis=1)
    return xtr, xte, masks, np.full((11,), 1.0 / 11, np.float32)


AOM_KW = dict(base="knn", k=4, chunk=2, aggregation="aom", n_buckets=3)


def gof_data():
    rng = np.random.default_rng(80)
    x = rng.normal(size=(GOF["n1"], GOF["d"])).astype(np.float32)
    y = (rng.normal(size=(GOF["n2"], GOF["d"])) * 1.2 + 0.4).astype(np.float32)
    base = np.r_[np.ones(GOF["n1"]), np.zeros(GOF["n2"])]
    return x, y, np.stack([rng.permutation(base) for _ in range(GOF["perms"])])


def ens_kw(base):
    return dict(base=base, k=ENS["k"], chunk=ENS["n_masks"] if base in ONE_CHUNK else 2)


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------


def _blocks(a, rank, parts, axis=0):
    per = a.shape[axis] // parts
    return np.take(a, range(rank * per, (rank + 1) * per), axis=axis)


def _replica_spread(tensors) -> float:
    """Largest |t - t on rank 0| over every rank and tensor (0.0: the
    replicated state is equal to the bit on every rank)."""
    worst = torch.zeros((), dtype=torch.float64)
    for t in tensors:
        t = t.detach()
        ref = t.clone()
        dist.broadcast(ref, src=0)
        worst = torch.maximum(worst, (t - ref).abs().max().double())
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return float(worst)


def _ring_checks(rank, out):
    ring = make_mesh(data=RANKS, model=1, device="cpu").get_group("data")
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        x, y = ring_pair(64, 12, 0.4, seed=10, dtype=np.float64)
        xl, yl = (torch.from_numpy(_blocks(a, rank, RANKS)).to(dtype) for a in (x, y))
        v, bw = mmd2_ring_rowsharded(xl, yl, torch.zeros((), dtype=dtype), torch.tensor(False),
                                     ring)
        out[f"ring_value_{name}"] = np.array([float(v), float(bw)])
    x, y = ring_pair(32, 6, 0.4, seed=11)
    y_loc = torch.from_numpy(_blocks(y, rank, RANKS)).requires_grad_()
    v, _ = mmd2_ring_rowsharded(torch.from_numpy(_blocks(x, rank, RANKS)), y_loc,
                                torch.tensor(2.5), torch.tensor(True), ring)
    (g,) = torch.autograd.grad(v, y_loc)
    out["ring_grad_loss"], out["ring_grad_block"] = np.array(float(v)), g.numpy()
    x, _ = ring_pair(32, 10, 0.0, seed=12)
    u = np.random.default_rng(13).uniform(size=(32, 10)).astype(np.float32)
    xl, ul = (torch.from_numpy(_blocks(a, rank, RANKS)) for a in (x, u))
    loss, _ = mmd_loss_ring_rowsharded(xl, ul * xl, ul, 10.0, torch.zeros(()),
                                       torch.tensor(False), ring)
    out["ring_penalty"] = np.array(float(loss))
    feat = make_mesh(data=1, model=RANKS, device="cpu").get_group("model")
    x, y = ring_pair(24, 40, 0.2, seed=14)
    v, bw = mmd2_feature_sharded(torch.from_numpy(_blocks(x, rank, RANKS, 1)),
                                 torch.from_numpy(_blocks(y, rank, RANKS, 1)),
                                 torch.zeros(()), torch.tensor(False), feat)
    out["feature_value"] = np.array([float(v), float(bw)])


def _initial_state(path: Path):
    """A state dict the test process writes (atomically) once the ranks run."""
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"{path} was never written")
        time.sleep(0.05)
    return torch.load(path, weights_only=True)


def _dp_dtypes(option):
    """The dp runs' dtype and training options: float64 with none, or
    float32 with one bf16 option (``option``, a TrainConfig field)."""
    if option is None:
        return torch.float64, np.float64, {}
    return torch.float32, np.float32, {option: BF16}


@contextlib.contextmanager
def _gram_dtypes_seen(seen: set):
    """Record, in ``seen``, the ``matmul_dtype`` that each MMD loss call of
    the epochs receives."""
    real = TS.mmd_ops.mmd_loss_constrained_stateful

    def recording(*args, **kwargs):
        seen.add(str(kwargs.get("matmul_dtype")))
        return real(*args, **kwargs)

    TS.mmd_ops.mmd_loss_constrained_stateful = recording
    try:
        yield
    finally:
        TS.mmd_ops.mmd_loss_constrained_stateful = real


def _options_reached(out, prefix, gram_seen, modules, opt_states):
    """What the epochs ran with, under ``<prefix>_gram``, ``_compute`` and
    ``_state``: the MMD calls' ``matmul_dtype``, the layers'
    ``compute_dtype`` and the Adadelta averages' dtypes (each the sorted
    distinct values)."""
    out[f"{prefix}_gram"] = np.array(sorted(gram_seen))
    out[f"{prefix}_compute"] = np.array(sorted({str(m.compute_dtype) for m in modules}))
    out[f"{prefix}_state"] = np.array(sorted(
        {str(t.dtype) for o in opt_states for t in (*o.square_avg.values(), *o.acc_delta.values())}))


def _dp_checks(rank, out, tmp):
    mesh = make_mesh(data=2, model=2, device="cpu")
    for option in (None, *BF16_OPTIONS):
        _dp_no_kl_run(mesh, out, tmp, option)
        _dp_kl_run(mesh, out, tmp, option)


def _dp_no_kl_run(mesh, out, tmp, option):
    """No-kl epochs from JAX's initial state, columns sharded too; keys
    ``dp_*`` (float64, with the parameters) or ``dp_*_<option>``."""
    dtype, npdtype, options = _dp_dtypes(option)
    key = "" if option is None else f"_{option}"
    config = TS.TrainConfig(ndims=DP["d"], batch_size=DP["bs"], mmd_impl="torch", **options)
    state = TS.init_no_kl_state(config, 0, "cpu", dtype=dtype)
    state.generator.load_state_dict(_initial_state(tmp / "no_kl_init.pt"))
    x = np.random.default_rng(20).normal(size=(DP["n"], DP["d"])).astype(npdtype)
    x_local = shard_dataset(x, mesh, shard_features=True)
    layout = MeshBatches(mesh, DP["bs"], shard_features=True)
    losses, gram_seen = [], set()
    with _gram_dtypes_seen(gram_seen):
        for e in range(DP["epochs"]):
            perm, noise = dp_draws(30 + e, DP["n"], DP["n"] // DP["bs"], DP["bs"],
                                   config.latent_size, npdtype)
            state, loss = TS.no_kl_epoch(state, x_local, config, layout=layout,
                                         rng=(torch.from_numpy(perm), torch.from_numpy(noise)))
            losses.append(float(loss))
    _options_reached(out, f"dp{key}", gram_seen, [state.generator], [state.opt_state])
    out[f"dp_losses{key}"] = np.asarray(losses)
    out[f"dp_bw{key}"] = np.array(float(state.bw_value))
    if option is None:
        for name, p in state.generator.state_dict().items():
            out[f"dp_param_{name}"] = p.numpy()
    out[f"dp_spread{key}"] = np.array(_replica_spread(
        [*state.generator.parameters(), *state.opt_state.square_avg.values(),
         *state.opt_state.acc_delta.values(), state.bw_value]))


def _dp_kl_run(mesh, out, tmp, option):
    """One kl epoch pair (detector, generator), the generator training;
    keys ``kl_*`` (float64, with the parameters) or ``kl_*_<option>``."""
    dtype, npdtype, options = _dp_dtypes(option)
    key = "" if option is None else f"_{option}"
    config = TS.TrainConfig(ndims=KL["d"], batch_size=KL["bs"], mmd_impl="torch", **KL_FLAGS,
                            **options)
    state = TS.init_kl_state(config, 0, "cpu", dtype=dtype)
    init = _initial_state(tmp / "kl_init.pt")
    state.generator.load_state_dict(init["generator"])
    state.detector.load_state_dict(init["detector"])
    x = np.random.default_rng(21).normal(size=(KL["n"], KL["d"])).astype(npdtype)
    x_local = shard_dataset(x, mesh, shard_features=True)
    layout = MeshBatches(mesh, KL["bs"], shard_features=True)
    losses, gram_seen = [], set()
    with _gram_dtypes_seen(gram_seen):
        for i, epoch in enumerate((TS.kl_detector_epoch, TS.kl_generator_epoch)):
            perm, noise = dp_draws(40 + i, KL["n"], KL["n"] // KL["bs"], KL["bs"],
                                   config.latent_size, npdtype)
            state, loss = epoch(state, x_local, config, layout=layout,
                                rng=(torch.from_numpy(perm), torch.from_numpy(noise)))
            losses.append(float(loss))
    _options_reached(out, f"kl{key}", gram_seen,
                     [state.generator, state.detector.encoder, state.detector.decoder],
                     [state.gen_opt, state.det_opt])
    out[f"kl_losses{key}"] = np.asarray(losses)
    if option is None:
        for prefix, module in (("gen", state.generator), ("det", state.detector)):
            for name, p in module.state_dict().items():
                out[f"kl_{prefix}_{name}"] = p.numpy()
    out[f"kl_spread{key}"] = np.array(_replica_spread(
        [*state.generator.parameters(), *state.detector.parameters(),
         *state.det_opt.square_avg.values(), *state.gen_opt.acc_delta.values()]))


def _estimator_checks(rank, out):
    mesh = make_mesh(data=2, model=2, device="cpu")
    x = np.random.default_rng(50).normal(size=(128, 16)).astype(np.float32)
    kw = dict(batch_size=32, epochs=3, verbose=False, device="cpu")
    for label, cls, extra in (("no_kl", VGAN_no_kl, {}),
                              ("kl", VGAN, {"replicate_reference_quirks": False,
                                            "shard_features": True})):
        m_dp = cls(mesh=mesh, **kw, **extra).fit(x)
        m_ref = cls(**kw, **{k: v for k, v in extra.items() if k != "shard_features"}).fit(x)
        m_dp.continue_fit(x, 2)
        m_ref.continue_fit(x, 2)
        for key in ("generator_loss", "detector_loss"):
            if m_ref.train_history.get(key):
                out[f"est_{label}_{key}_dp"] = np.asarray(m_dp.train_history[key])
                out[f"est_{label}_{key}_ref"] = np.asarray(m_ref.train_history[key])
        out[f"est_{label}_masks_dp"] = m_dp.generate_subspaces(16)
        out[f"est_{label}_masks_ref"] = m_ref.generate_subspaces(16)
    # the reference's private elm flag freezes the encoder from the start,
    # with the quirks on or off, under the mesh too
    x_elm = np.random.default_rng(51).normal(size=(96, 10)).astype(np.float32)
    for quirks in (True, False):
        m = VGAN(batch_size=32, epochs=2, verbose=False, device="cpu", mesh=mesh, elm=True,
                 replicate_reference_quirks=quirks).fit(x_elm)
        init = TS.init_kl_state(m._config, m.seed, "cpu").detector.state_dict()
        fitted = m.detector.state_dict()
        out[f"elm_quirks_{quirks}"] = np.array([
            all(torch.equal(init[k], v) for k, v in fitted.items() if k.startswith("encoder.")),
            any(not torch.equal(init[k], v) for k, v in fitted.items()
                if k.startswith("decoder."))])
    try:
        VGAN_no_kl(fit_impl="fused", mesh=mesh, **kw).fit(x)
        out["fused_refused"] = np.array(False)
    except ValueError as e:
        out["fused_refused"] = np.array("single-device" in str(e))
    refusals = []
    for args in (dict(data=64), dict(data=None, model=64), dict(data=2, model=1)):
        try:
            make_mesh(device="cpu", **args)
            refusals.append("")
        except ValueError as e:
            refusals.append(str(e))
    out["mesh_refusals"] = np.asarray(refusals)
    # this rank's block of a full array, and of its process rows
    full = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
    out["shard_block"] = shard_dataset(full, mesh, shard_features=True).numpy()
    out["row_range"] = np.asarray(process_row_range(100))
    rows = np.arange(104 * 3, dtype=np.float32).reshape(104, 3)
    start, end = process_row_range(104)
    out["shard_block_n_total"] = shard_dataset(rows[start:end], mesh, n_total=104).numpy()


def _placement_checks(out):
    """This rank's block of a tensor distributed over a 2 x 2 mesh with the
    placements of ``data_sharding`` / ``replicated``."""
    from torch.distributed.tensor import distribute_tensor

    mesh = make_mesh(data=2, model=2, device="cpu")
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for i, axes in enumerate(PLACEMENTS):
        placements = data_sharding(mesh, *axes) if axes else replicated(mesh)
        out[f"placement_{i}"] = distribute_tensor(full, mesh, placements).to_local().numpy()


def _ensemble_checks(rank, out, tmp):
    mesh = make_mesh(data=RANKS, model=1, device="cpu")
    xtr, xte, masks, proba = ens_data()
    for i, base in enumerate(NATIVE_BASES):
        for agg in ("average", "max"):
            kw = dict(ens_kw(base), aggregation=agg, device="cpu")
            out[f"ens_{base}_{agg}_mesh"] = SubspaceEnsemble(
                masks, proba, mesh=mesh, **kw).fit(xtr).decision_function(xte)
            if i % RANKS == rank:  # the single-device calls, spread over the ranks
                out[f"ens_{base}_{agg}_single"] = SubspaceEnsemble(
                    masks, proba, **kw).fit(xtr).decision_function(xte)
    xtr, xte, masks, proba = aom_data()
    sharded = SubspaceEnsemble(masks, proba, mesh=mesh, device="cpu", **AOM_KW).fit(xtr)
    single = SubspaceEnsemble(masks, proba, device="cpu", **AOM_KW).fit(xtr)
    out["aom_per_subspace_mesh"] = sharded.per_subspace_scores(xte)
    out["aom_per_subspace_single"] = single.per_subspace_scores(xte)
    out["aom_decision_mesh"] = sharded.decision_function(xte)
    out["aom_decision_single"] = single.decision_function(xte)
    out["aom_predict_mesh"] = sharded.predict(xte)
    out["aom_predict_single"] = single.predict(xte)
    # a mesh ensemble's program: the mesh stays out of it
    xtr, xte, masks, proba = ens_data()
    ens = SubspaceEnsemble(masks, proba, mesh=mesh, **ens_kw("knn"), device="cpu").fit(xtr)
    out["export_live"] = ens.decision_function(xte)
    if rank == 0:
        from vgan_tpu_torch.serving import export_ensemble_scorer, load_ensemble_scorer

        export_ensemble_scorer(ens, tmp / "mesh_knn.pt2", max_batch=ENS["n_test"])
        out["export_program"] = np.asarray(load_ensemble_scorer(tmp / "mesh_knn.pt2")(xte))


def _gof_checks(rank, out):
    mesh = make_mesh(data=RANKS, model=1, device="cpu")
    x, y, perms = gof_data()
    for precision in ("float32", "float64"):
        s, p = TG.mmd_permutation_test_tiled_sweep(x, y, list(GOF["alphas"]), precision=precision,
                                                   permutations=perms, mesh=mesh, device="cpu")
        s1, p1 = TG.mmd_permutation_test_tiled_sweep(x, y, list(GOF["alphas"]),
                                                     precision=precision, permutations=perms,
                                                     device="cpu")
        out[f"gof_{precision}"] = np.stack([s.numpy(), p.numpy()]).astype(np.float64)
        out[f"gof_{precision}_single"] = np.stack([s1.numpy(), p1.numpy()]).astype(np.float64)
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    s, p = TG.mmd_permutation_test_tiled(x, y, [0.5, 2.0], generator=g(), n_permutations=21,
                                         mesh=mesh, device="cpu")
    s1, p1 = TG.mmd_permutation_test_tiled(x, y, [0.5, 2.0], generator=g(), n_permutations=21,
                                           device="cpu")
    out["gof_drawn"] = np.array([float(s), float(p), float(s1), float(p1)])


def world4(rank, tmp):
    out = {}
    _ring_checks(rank, out)
    _estimator_checks(rank, out)
    _placement_checks(out)
    _ensemble_checks(rank, out, tmp)
    _gof_checks(rank, out)
    _dp_checks(rank, out, tmp)  # last: JAX's initial states are written meanwhile
    return out


def world2(rank, tmp):
    """The counterpart of tests/_distributed_worker.py, and rank-0 writes."""
    out = {}
    mesh = make_mesh(data=2, model=1, device="cpu")
    n, d = 104, 6
    start, end = process_row_range(n)
    out["row_range"] = np.array([start, end])
    ragged = np.zeros((52 if rank == 0 else 51, d), np.float32)
    try:
        shard_dataset(ragged, mesh, n_total=103)
        out["ragged"] = np.array("")
    except ValueError as e:
        out["ragged"] = np.array(str(e))
    full = np.arange(n * d, dtype=np.float32).reshape(n, d)
    block = shard_dataset(full[start:end], mesh, n_total=n)
    total = block.double().sum()
    dist.all_reduce(total)
    out["global_sum"] = np.array(float(total))
    x_full = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
    config = TS.TrainConfig(ndims=d, batch_size=32, lr_g=0.01, mmd_impl="torch")
    x_fit = shard_dataset(x_full[start:end], mesh, n_total=n)
    _, losses = no_kl_fit_program_dp(x_fit, 0, config, 2, mesh)
    _, single = TS.no_kl_fit_program(torch.from_numpy(x_full), 0, config, 2)
    out["dp_fit_losses"], out["single_fit_losses"] = losses.numpy(), single.numpy()
    # two ranks, one artifact directory and one checkpoint directory
    model = VGAN_no_kl(batch_size=32, epochs=2, verbose=False, device="cpu", mesh=mesh,
                       path_to_directory=str(tmp / "shared_run")).fit(x_full)
    model.save_checkpoint(tmp / "shared_ckpt")
    model.model_snapshot(tmp / "shared_snapshot", run_number=3)
    return out


WORLDS = {"world4": world4, "world2": world2}


def _rank_main(argv) -> None:
    name, rank, world, port, tmp = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        out = WORLDS[name](rank, tmp)
        np.savez(tmp / f"{name}_rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the worlds, started once for the module
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Worlds:
    """The module's running worlds; :meth:`ranks` waits for one and loads
    its ranks' results."""

    def __init__(self, tmp: Path):
        self.tmp = tmp
        self.procs, self.results = {}, {}
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
        for name, size in (("world4", RANKS), ("world2", 2)):
            port = _free_port()
            self.procs[name] = [self._start(f"{name}_{r}", [sys.executable, __file__, name, str(r),
                                                            str(size), str(port), str(tmp)], env)
                                for r in range(size)]
        self.procs["dryrun"] = [self._start("dryrun", [sys.executable, "-m",
                                                       "vgan_tpu_torch._dryrun", "4"], env)]
        self.t0 = time.monotonic()

    def _start(self, label, cmd, env):
        log = open(self.tmp / f"{label}.log", "w")
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
        log.close()
        proc.label = label
        return proc

    def wait(self, name):
        """Wait for the world ``name``; its logs on failure."""
        for proc in self.procs[name]:
            try:
                proc.wait(timeout=max(1.0, WAIT_S - (time.monotonic() - self.t0)))
            except subprocess.TimeoutExpired:
                self.kill()
        logs = {p.label: (self.tmp / f"{p.label}.log").read_text() for p in self.procs[name]}
        bad = {p.label: p.returncode for p in self.procs[name] if p.returncode != 0}
        assert not bad, f"{name} failed {bad}:\n" + "\n".join(
            f"--- {k}\n{v[-4000:]}" for k, v in logs.items())
        return logs

    def ranks(self, name):
        if name not in self.results:
            self.wait(name)
            self.results[name] = [dict(np.load(self.tmp / f"{name}_rank{r}.npz"))
                                  for r in range(len(self.procs[name]))]
        return self.results[name]

    def kill(self):
        for procs in self.procs.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def _save(obj, path: Path) -> None:
    torch.save(obj, path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("parallel"))
    try:
        # JAX's initial states for the lockstep dp epochs, as the port's
        # state dicts, written while the ranks run their other checks
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        jstate = JS.init_no_kl_state(JS.TrainConfig(ndims=DP["d"], batch_size=DP["bs"]),
                                     jax.random.PRNGKey(3))
        _save(generator_state_dict_from_jax(f64(jstate.params)), w.tmp / "no_kl_init.pt")
        kstate = JS.init_kl_state(JS.TrainConfig(ndims=KL["d"], batch_size=KL["bs"]),
                                  jax.random.PRNGKey(4))
        _save({"generator": generator_state_dict_from_jax(f64(kstate.gen_params)),
               "detector": detector_state_dict_from_jax(f64(kstate.det_params))},
              w.tmp / "kl_init.pt")
        w.inits = {"no_kl": jstate, "kl": kstate}
        yield w
    finally:
        w.kill()


# ---------------------------------------------------------------------------
# the JAX side, and the comparisons
# ---------------------------------------------------------------------------


def jax_mesh(axis="data"):
    return Mesh(np.asarray(jax.devices()[:RANKS]), (axis,))


def close_to_jax(got, want):
    """The port's float32 scores against ``vgan_tpu``'s, at the limits of the
    port's other ensemble tests (tests/test_torch_ensemble.py): rtol 1e-5
    and 1e-5 of the largest score."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


def _replicated(ranks, key):
    """The value every rank holds, after checking that they all hold it."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


def _jax_dp_state(inits, kind, option):
    """JAX's initial dp state of ``kind`` ('no_kl' or 'kl'): ``inits[kind]``,
    whose parameters the ranks loaded, in float64 without an option; else
    made anew with the option (float32, the same parameters)."""
    from vgan_tpu.train.adadelta import AdadeltaState

    js = inits[kind]
    if option is not None:
        cfg = DP if kind == "no_kl" else KL
        init = JS.init_no_kl_state if kind == "no_kl" else JS.init_kl_state
        fresh = init(JS.TrainConfig(ndims=cfg["d"], batch_size=cfg["bs"], **{option: BF16}),
                     jax.random.PRNGKey(3 if kind == "no_kl" else 4))
        params = ("params",) if kind == "no_kl" else ("gen_params", "det_params")
        for name in params:
            for a, b in zip(jax.tree.leaves(getattr(fresh, name)),
                            jax.tree.leaves(getattr(js, name))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        return fresh
    cast = lambda t: jax.tree.map(lambda a: a.astype(jnp.float64), t)  # noqa: E731
    if kind == "no_kl":
        return js._replace(params=cast(js.params),
                           opt_state=AdadeltaState(cast(js.opt_state.square_avg),
                                                   cast(js.opt_state.acc_delta)),
                           bw_value=jnp.zeros((), jnp.float64))
    return js._replace(
        gen_params=cast(js.gen_params), det_params=cast(js.det_params),
        gen_opt=AdadeltaState(cast(js.gen_opt.square_avg), cast(js.gen_opt.acc_delta)),
        det_opt=AdadeltaState(cast(js.det_opt.square_avg), cast(js.det_opt.acc_delta)),
        bw_value=jnp.zeros((), jnp.float64))



def _assert_options_reached(ranks, prefix, option, dtype):
    """On every rank the epochs ran with ``option`` and no other: the MMD
    calls got ``matmul_dtype`` 'bfloat16' only under gram_matmul_dtype, the
    layers computed in bf16 only under model_matmul_dtype, and the Adadelta
    averages were stored in bf16 only under opt_state_dtype (else in
    ``dtype``, the parameters')."""
    want = {"gram": [BF16 if option == "gram_matmul_dtype" else "None"],
            "compute": [str(torch.bfloat16) if option == "model_matmul_dtype" else "None"],
            "state": [str(torch.bfloat16 if option == "opt_state_dtype" else dtype)]}
    for rank, out in enumerate(ranks):
        for what, values in want.items():
            assert out[f"{prefix}_{what}"].tolist() == values, (rank, what, option)


@pytest.mark.parametrize("option", [None, *BF16_OPTIONS])
def test_dp_no_kl_epochs_match_jax(worlds, option):
    """Three epochs on a 2 x 2 mesh with the columns sharded: the port's dp
    epochs against JAX's epoch body on the same placement, with the same
    permutations and noise; in float64 (losses rtol 1e-9, parameters 1e-8),
    or in float32 with one bf16 option on both sides (losses and bandwidth
    within FIT_RTOL). Every rank's epochs ran with that option and no other
    (_assert_options_reached)."""
    jstate = _jax_dp_state(worlds.inits, "no_kl", option)
    _, npdtype, options = _dp_dtypes(option)
    jconfig = JS.TrainConfig(ndims=DP["d"], batch_size=DP["bs"], mmd_impl="jnp", **options)
    mesh = JMESH.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    x = np.random.default_rng(20).normal(size=(DP["n"], DP["d"])).astype(npdtype)
    xs = JDP._shard_x(x, mesh, shard_features=True)
    losses = []
    for e in range(DP["epochs"]):
        perm, noise = dp_draws(30 + e, DP["n"], DP["n"] // DP["bs"], DP["bs"],
                               jconfig.latent_size, npdtype)
        jstate, loss = JS._no_kl_epoch_body(jstate, xs, jconfig,
                                            rng=(jnp.asarray(perm), jnp.asarray(noise)))
        losses.append(float(loss))
    ranks = worlds.ranks("world4")
    key = "" if option is None else f"_{option}"
    _assert_options_reached(ranks, f"dp{key}", option, _dp_dtypes(option)[0])
    rtol = 1e-9 if option is None else FIT_RTOL
    np.testing.assert_allclose(_replicated(ranks, f"dp_losses{key}"), losses, rtol=rtol)
    np.testing.assert_allclose(_replicated(ranks, f"dp_bw{key}"), float(jstate.bw_value),
                               rtol=1e-12 if option is None else FIT_RTOL)
    if option is None:
        want = generator_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
        for name, p in want.items():
            np.testing.assert_allclose(_replicated(ranks, f"dp_param_{name}"), p.numpy(),
                                       rtol=1e-8, atol=1e-12, err_msg=name)
    assert float(ranks[0][f"dp_spread{key}"]) == 0.0, "the replicated state differs between ranks"


@pytest.mark.parametrize("option", [None, *BF16_OPTIONS])
def test_dp_kl_epoch_pair_matches_jax(worlds, option):
    """A detector epoch, then a training generator epoch, on the 2 x 2 mesh
    with the columns sharded, against JAX's epochs there: float64, or
    float32 with one bf16 option (as test_dp_no_kl_epochs_match_jax; with
    bf16 layers JAX's epochs run op by op, EAGER_OPTION)."""
    jstate = _jax_dp_state(worlds.inits, "kl", option)
    _, npdtype, options = _dp_dtypes(option)
    jconfig = JS.TrainConfig(ndims=KL["d"], batch_size=KL["bs"], mmd_impl="jnp",
                             scan_unroll=1, **KL_FLAGS, **options)
    mesh = JMESH.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    x = np.random.default_rng(21).normal(size=(KL["n"], KL["d"])).astype(npdtype)
    xs = JDP._shard_x(x, mesh, shard_features=True)
    losses = []
    # with bf16 layers, JAX's side op by op: see EAGER_OPTION
    with jax.disable_jit() if option == EAGER_OPTION else contextlib.nullcontext():
        for i, epoch in enumerate((JS.kl_detector_epoch, JS.kl_generator_epoch)):
            perm, noise = dp_draws(40 + i, KL["n"], KL["n"] // KL["bs"], KL["bs"],
                                   jconfig.latent_size, npdtype)
            jstate, loss = epoch(jstate, xs, jconfig,
                                 rng=(jnp.asarray(perm), jnp.asarray(noise)))
            losses.append(float(loss))
    ranks = worlds.ranks("world4")
    key = "" if option is None else f"_{option}"
    _assert_options_reached(ranks, f"kl{key}", option, _dp_dtypes(option)[0])
    np.testing.assert_allclose(_replicated(ranks, f"kl_losses{key}"), losses,
                               rtol=1e-9 if option is None else FIT_RTOL)
    if option is None:
        for prefix, tree, conv in (("gen", jstate.gen_params, generator_state_dict_from_jax),
                                   ("det", jstate.det_params, detector_state_dict_from_jax)):
            for name, p in conv(jax.tree.map(np.asarray, tree)).items():
                np.testing.assert_allclose(_replicated(ranks, f"kl_{prefix}_{name}"), p.numpy(),
                                           rtol=1e-8, atol=1e-12, err_msg=f"{prefix} {name}")
    assert float(ranks[0][f"kl_spread{key}"]) == 0.0, "the replicated state differs between ranks"


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_ring_value_matches_jax(worlds, dtype):
    npdt = np.float32 if dtype == "f32" else np.float64
    x, y = (a.astype(npdt) for a in ring_pair(64, 12, 0.4, seed=10, dtype=np.float64))
    fn = shard_map(
        lambda xl, yl: JR.mmd2_ring_rowsharded(xl, yl, jnp.zeros((), npdt), jnp.asarray(False),
                                               "data"),
        mesh=jax_mesh(), in_specs=(PartitionSpec("data", None),) * 2,
        out_specs=(PartitionSpec(), PartitionSpec()))
    want = np.array([float(v) for v in jax.jit(fn)(x, y)])
    got = _replicated(worlds.ranks("world4"), f"ring_value_{dtype}")
    np.testing.assert_allclose(got, want, rtol=1e-4 if dtype == "f32" else 1e-10)


def test_ring_gradients_match_jax(worlds):
    x, y = ring_pair(32, 6, 0.4, seed=11)
    bw = jnp.asarray(2.5, jnp.float32)
    fn = shard_map(
        lambda xl, yl: JR.mmd2_ring_rowsharded(xl, yl, bw, jnp.asarray(True), "data")[0],
        mesh=jax_mesh(), in_specs=(PartitionSpec("data", None),) * 2,
        out_specs=PartitionSpec())
    loss, g_jax = jax.value_and_grad(lambda y_: jax.jit(fn)(x, y_))(jnp.asarray(y))
    ranks = worlds.ranks("world4")
    # every rank's loss is the global loss; its block gets its own rows
    np.testing.assert_allclose(_replicated(ranks, "ring_grad_loss"), float(loss), rtol=1e-4)
    g_port = np.concatenate([r["ring_grad_block"] for r in ranks])
    np.testing.assert_allclose(g_port, np.asarray(g_jax), rtol=1e-3, atol=1e-7)


def test_ring_loss_coverage_penalty_matches_jax(worlds):
    x, _ = ring_pair(32, 10, 0.0, seed=12)
    u = np.random.default_rng(13).uniform(size=(32, 10)).astype(np.float32)
    fn = shard_map(
        lambda xl, yl, ul: JR.mmd_loss_ring_rowsharded(
            xl, yl, ul, 10.0, jnp.zeros(()), jnp.asarray(False), "data"),
        mesh=jax_mesh(), in_specs=(PartitionSpec("data", None),) * 3,
        out_specs=(PartitionSpec(), PartitionSpec()), check_vma=False)
    want, _ = jax.jit(fn)(x, u * x, u)
    got = _replicated(worlds.ranks("world4"), "ring_penalty")
    np.testing.assert_allclose(got, float(want), rtol=1e-4)


def test_feature_sharded_mmd_matches_jax(worlds):
    x, y = ring_pair(24, 40, 0.2, seed=14)  # 10 features a rank
    fn = shard_map(
        lambda xl, yl: JR.mmd2_feature_sharded(xl, yl, jnp.zeros(()), jnp.asarray(False),
                                               "model"),
        mesh=jax_mesh("model"), in_specs=(PartitionSpec(None, "model"),) * 2,
        out_specs=(PartitionSpec(), PartitionSpec()))
    want = np.array([float(v) for v in jax.jit(fn)(x, y)])
    got = _replicated(worlds.ranks("world4"), "feature_value")
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("label", ["no_kl", "kl"])
def test_estimator_api_with_mesh(worlds, label):
    """``mesh=`` on the estimator (2 x 2; the kl one with ``shard_features``
    and the generator training) against the port's single-device fit, then
    ``continue_fit`` under the mesh: losses within 1e-4, the same masks."""
    ranks = worlds.ranks("world4")
    keys = [k[: -len("_dp")] for k in ranks[0] if k.startswith(f"est_{label}_")
            and k.endswith("_dp") and "masks" not in k]
    assert keys
    for key in keys:
        got = _replicated(ranks, f"{key}_dp")
        assert len(got) == 5 and np.all(np.isfinite(got[-4:])), (key, got)
        np.testing.assert_allclose(got, ranks[0][f"{key}_ref"], rtol=1e-4, err_msg=key)
    np.testing.assert_array_equal(_replicated(ranks, f"est_{label}_masks_dp"),
                                  ranks[0][f"est_{label}_masks_ref"])


@pytest.mark.parametrize("quirks", [True, False])
def test_elm_flag_freezes_encoder_under_mesh(worlds, quirks):
    """``elm=True`` under a 2 x 2 mesh: the encoder ends equal to its
    initial weights to the bit, the decoder trains (with the reference
    quirks on and off, as JAX's two elm tests)."""
    frozen, trained = _replicated(worlds.ranks("world4"), f"elm_quirks_{quirks}")
    assert frozen and trained


def test_make_mesh_rejects_oversubscription_and_fused_mesh(worlds):
    ranks = worlds.ranks("world4")
    over64, model64, under = _replicated(ranks, "mesh_refusals")
    assert "devices" in over64 and "devices" in model64
    assert "every one must be in the mesh" in under
    assert bool(_replicated(ranks, "fused_refused"))


def test_shard_dataset_and_process_row_range(worlds):
    ranks = worlds.ranks("world4")
    full = np.arange(32 * 8, dtype=np.float32).reshape(32, 8)
    rows = np.arange(104 * 3, dtype=np.float32).reshape(104, 3)
    for r, res in enumerate(ranks):
        i, j = divmod(r, 2)  # the 2 x 2 mesh's (data, model) coordinate of rank r
        np.testing.assert_array_equal(res["shard_block"], full[16 * i:16 * i + 16, 4 * j:4 * j + 4])
        assert tuple(res["row_range"]) == (25 * r, 25 * r + 25)
        # process rows (26 a rank) reassembled into the rank's 'data' block
        np.testing.assert_array_equal(res["shard_block_n_total"], rows[52 * i:52 * i + 52])


def test_placements_match_jax_shardings(worlds):
    """Each rank's block under ``data_sharding`` / ``replicated`` is the
    block JAX's ``NamedSharding`` of the same spec puts on the device at the
    same mesh position."""
    ranks = worlds.ranks("world4")
    mesh = JMESH.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    full = np.arange(8 * 6, dtype=np.float32).reshape(8, 6)
    for i, axes in enumerate(PLACEMENTS):
        sharding = JMESH.data_sharding(mesh, *axes) if axes else JMESH.replicated(mesh)
        blocks = {s.device: np.asarray(s.data)
                  for s in jax.device_put(full, sharding).addressable_shards}
        for rank, r in enumerate(ranks):
            np.testing.assert_array_equal(r[f"placement_{i}"], blocks[mesh.devices.flat[rank]],
                                          err_msg=f"{axes} on rank {rank}")


@pytest.mark.parametrize("base", NATIVE_BASES)
def test_sharded_ensemble_matches_single_device(worlds, base):
    """Each native base under 'average' and 'max', its 13 masks sharded over
    4 ranks (the dim bases ignore the mesh), against the single-device call."""
    merged = {}
    for res in worlds.ranks("world4"):
        merged.update({k: v for k, v in res.items() if k.endswith("_single")})
    ranks = worlds.ranks("world4")
    for agg in ("average", "max"):
        got = _replicated(ranks, f"ens_{base}_{agg}_mesh")
        want = merged[f"ens_{base}_{agg}_single"]
        assert np.all(np.isfinite(want)), (base, agg)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"{base} {agg}")


@pytest.mark.parametrize("base,agg", [("knn", "average"), ("kde", "max")])
def test_sharded_ensemble_matches_jax(worlds, base, agg):
    """knn and a parametric base against ``vgan_tpu``'s mask-sharded call."""
    xtr, xte, masks, proba = ens_data()
    want = JaxEnsemble(masks, proba, aggregation=agg, mesh=jax_mesh(),
                       **ens_kw(base)).fit(xtr).decision_function(xte)
    close_to_jax(_replicated(worlds.ranks("world4"), f"ens_{base}_{agg}_mesh"), want)


def test_sharded_per_subspace_scores_aom(worlds):
    """'aom' over mask-sharded per-subspace scores (11 masks): the raw rows
    gathered in mask order, against the single-device call and JAX's
    sharded one."""
    xtr, xte, masks, proba = aom_data()
    jens = JaxEnsemble(masks, proba, mesh=jax_mesh(), **AOM_KW).fit(xtr)
    ranks = worlds.ranks("world4")
    got = _replicated(ranks, "aom_per_subspace_mesh")
    np.testing.assert_allclose(got, ranks[0]["aom_per_subspace_single"], rtol=1e-5, atol=1e-6)
    close_to_jax(got, jens.per_subspace_scores(xte))
    got = _replicated(ranks, "aom_decision_mesh")
    np.testing.assert_allclose(got, ranks[0]["aom_decision_single"], rtol=1e-5, atol=1e-6)
    close_to_jax(got, jens.decision_function(xte))
    np.testing.assert_array_equal(_replicated(ranks, "aom_predict_mesh"),
                                  ranks[0]["aom_predict_single"])


def test_mesh_ensemble_exports(worlds):
    """A mesh ensemble exports (the program holds the generic chunked path
    over every mask, no mesh) and its loaded program scores as the live
    sharded call."""
    ranks = worlds.ranks("world4")
    live = _replicated(ranks, "export_live")
    np.testing.assert_allclose(ranks[0]["export_program"], live, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_sharded_tiled_gof_matches_jax(worlds, precision):
    """The permutation-sharded tiled sweep (61 indicator rows over 4 ranks)
    against ``vgan_tpu``'s ``mesh=`` call with the same permutations."""
    x, y, perms = gof_data()
    sj, pj = JG.mmd_permutation_test_tiled_sweep(
        x, y, list(GOF["alphas"]), jax.random.PRNGKey(0), precision=precision,
        permutations=perms, mesh=jax_mesh(), interpret=True)
    ranks = worlds.ranks("world4")
    stat, pval = _replicated(ranks, f"gof_{precision}")
    # float32: the plain K5 forms C = A @ K in one product, JAX's kernel in
    # Kahan-compensated tiles; the statistics differ by 2.4e-6 relative
    # here, so they are held at tests/test_torch_gof_gram.py's port-vs-JAX
    # limit, and the sharding at 1e-6 against the port's single-device call
    np.testing.assert_allclose(stat, np.asarray(sj), rtol=1e-6 if precision == "float64" else 1e-4)
    np.testing.assert_allclose(pval, np.asarray(pj), atol=1e-9)
    single_stat, single_p = ranks[0][f"gof_{precision}_single"]
    np.testing.assert_allclose(stat, single_stat, rtol=1e-6)
    np.testing.assert_allclose(pval, single_p, atol=1e-9)
    s, p, s1, p1 = _replicated(ranks, "gof_drawn")  # permutations drawn alike on every rank
    assert np.isclose(s, s1, rtol=1e-6) and p == p1


def test_two_process_distributed_smoke(worlds):
    """A 2-rank world: each rank loads its ``process_row_range``, a ragged
    global count is refused, an even split assembles with ``n_total``, and a
    tiny dp fit equals the single-process fit."""
    ranks = worlds.ranks("world2")
    assert [tuple(r["row_range"]) for r in ranks] == [(0, 52), (52, 104)]
    for r in ranks:
        assert "divide evenly" in str(r["ragged"]), r["ragged"]
    full = np.arange(104 * 6, dtype=np.float32).reshape(104, 6)
    assert float(_replicated(ranks, "global_sum")) == float(full.sum(dtype=np.float64))
    losses = _replicated(ranks, "dp_fit_losses")
    assert losses.shape == (2,) and np.all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ranks[0]["single_fit_losses"], rtol=1e-5)


def test_rank0_writes_one_run(worlds):
    """Two ranks with one ``path_to_directory`` (and one checkpoint and
    snapshot directory) leave one run's files, not two."""
    worlds.wait("world2")
    run = worlds.tmp / "shared_run"
    assert sorted(p.name for p in (run / "models").iterdir()) == ["generator_0.pt"]
    assert sorted(p.name for p in (run / "train_history").iterdir()) == ["generator_loss_0.csv"]
    params = (run / "params.csv").read_text().strip().splitlines()
    assert len(params) == 2, params  # the header and run 0
    fits = [line for line in (run / "metrics.jsonl").read_text().splitlines() if '"fit"' in line]
    assert len(fits) == 1
    ckpt = worlds.tmp / "shared_ckpt"
    assert sorted(p.name for p in ckpt.iterdir() if p.is_dir()) == ["ckpt_0"]
    snap = worlds.tmp / "shared_snapshot"
    assert [p.name for p in (snap / "train_history").iterdir()] == ["generator_loss_3.csv"]


def test_dryrun_runs_on_four_gloo_ranks(worlds):
    logs = worlds.wait("dryrun")
    ok = [line for line in logs["dryrun"].splitlines() if "dryrun_multidevice OK" in line]
    assert len(ok) == 1 and "mesh=(2x2)" in ok[0], logs["dryrun"][-2000:]


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
