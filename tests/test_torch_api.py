"""The port's estimator (``vgan_tpu_torch.api``) and its GoF test against
``vgan_tpu``, plus the package rules: no JAX or ``vgan_tpu`` import, and no
quiet CPU fallback when there is no card."""

import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.ops.mmd_test as JT
import vgan_tpu.ops.pallas.gof_gram as JG
from vgan_tpu import VGAN as JVGAN
from vgan_tpu import VGAN_no_kl as JVGAN_no_kl
from vgan_tpu.ops.activations import binarize_mask as j_binarize_mask
from vgan_tpu.train import steps as JS
from vgan_tpu_torch import VGAN, VGAN_no_kl, resolve_device
from vgan_tpu_torch.interop import generator_state_dict_from_jax
from vgan_tpu_torch.ops import mmd_test as TT
from vgan_tpu_torch.ops.cuda import gof_gram as TG

REPO = Path(__file__).resolve().parents[1]
N, D, BS, EPOCHS = 200, 12, 50, 3


def _data(seed=0, n=N, d=D):
    rng = np.random.default_rng(seed)
    cov = np.eye(d)
    for i, j in [(0, 8), (0, 9), (8, 9)]:
        cov[i, j] = cov[j, i] = 0.9
    return rng.multivariate_normal(np.zeros(d), cov, size=n)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    run = tmp_path_factory.mktemp("run")
    model = VGAN_no_kl(batch_size=BS, epochs=EPOCHS, verbose=False, device="cpu",
                       path_to_directory=run)
    model.fit(_data())
    return model, run


def _jax_generator(d, seed):
    """A JAX generator module and its params, as the JAX estimator builds them."""
    module = JS.TrainConfig(ndims=d, batch_size=BS).generator_module(kl=False)
    latent = JS.TrainConfig(ndims=d, batch_size=BS).latent_size
    params = module.init(jax.random.PRNGKey(seed), jnp.zeros((1, latent), jnp.float32))
    return module, params


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_fit_sample_gof_workflow(fitted):
    model, _ = fitted
    losses = model.train_history["generator_loss"]
    assert len(losses) == EPOCHS and all(np.isfinite(losses))
    # the bandwidth was frozen after the first batch and not moved after it
    state = model.train_state
    assert bool(state.bw_is_set) and model.bandwidth == float(state.bw_value) > 0
    assert model.generator_optimizer == "Adadelta"

    u1 = model.generate_subspaces(64)
    assert u1.shape == (64, D) and u1.dtype == np.bool_
    np.testing.assert_array_equal(u1, model.generate_subspaces(64))
    reseeded = VGAN_no_kl(seed=778, device="cpu")
    reseeded.generator, reseeded._latent_size = model.generator, model._latent_size
    assert not np.array_equal(u1, reseeded.generate_subspaces(64)), "masks ignore the seed"

    model.approx_subspace_dist(subspace_count=64)
    assert model.subspaces.shape[1] == D and len(model.subspaces) == len(model.proba)
    np.testing.assert_allclose(model.proba.sum(), 1.0, rtol=1e-12)

    for precision in ("float64", "float32"):
        df = model.check_if_myopic(_data(1, n=120), bandwidth=[0.5, 0.01], count=60,
                                   n_permutations=40, rng=np.random.default_rng(2),
                                   precision=precision)
        assert list(df.index) == ["p-val"]
        assert list(df.columns) == [0.01, 0.5, "recommended bandwidth"]
        p = df.to_numpy().ravel()
        assert np.all((p >= 0.0) & (p <= 1.0))


def test_leftover_feature_quirk(fitted):
    model, _ = fitted
    model.approx_subspace_dist(subspace_count=64, add_leftover_features=True)
    if (model.subspaces[:-1].sum(axis=0) < 1).sum() != 0:
        np.testing.assert_allclose(model.proba[-1], 0.5, rtol=1e-12)
    np.testing.assert_allclose(model.proba.sum(), 1.0, rtol=1e-12)


def test_snapshot_artifacts_load_in_jax(fitted):
    """The port writes the reference layout; its generator .pt loads into the
    JAX estimator and samples the same masks from the same noise."""
    model, run = fitted
    for rel in ("models/generator_0.pt", "train_history/generator_loss_0.csv",
                "params.csv", "train_history.pdf", "metrics.jsonl"):
        assert (run / rel).is_file(), rel
    jm = JVGAN_no_kl(verbose=False)
    jm.load_models(run / "models" / "generator_0.pt", ndims=D)
    z = np.random.default_rng(3).normal(size=(64, model._latent_size)).astype(np.float32)
    want = np.asarray(jm._sample_jit(jm.generator_params, jnp.asarray(z)))
    np.testing.assert_array_equal(model._masks_from_noise(torch.from_numpy(z)), want)


def test_get_params_keys_and_defaults_match_jax(fitted):
    model, _ = fitted
    jm = JVGAN_no_kl(verbose=False)
    assert set(model.get_params()) == set(jm.get_params())
    ours = inspect.signature(VGAN_no_kl.__init__).parameters
    theirs = inspect.signature(JVGAN_no_kl.__init__).parameters
    assert set(ours) - set(theirs) == {"device"}
    for name, p in theirs.items():
        assert ours[name].default == p.default, name


def test_generate_subspaces_matches_jax_generator():
    """With JAX-initialized params carried over, the port's masks are JAX's
    ``binarize_mask(gen.apply(params, z))`` on the port's own noise draw."""
    module, params = _jax_generator(D, seed=4)
    model = VGAN_no_kl(device="cpu", seed=31)
    model._latent_size = latent = max(D // 16, 1)
    model.generator = model.get_the_networks(D, latent)
    model.generator.load_state_dict(generator_state_dict_from_jax(_np_tree(params)))
    z = torch.randn((80, latent), generator=torch.Generator().manual_seed(31))
    want = np.asarray(j_binarize_mask(module.apply(params, jnp.asarray(z.numpy())), axis=-1))
    np.testing.assert_array_equal(model.generate_subspaces(80), want)


def test_load_models_reference_pt_matches_jax(tmp_path):
    d = 40
    latent = max(d // 16, 1)
    g = torch.Generator().manual_seed(5)
    widths = [latent, 2 * latent, 4 * latent, 8 * latent, d]
    sd = {}
    for i in range(4):
        sd[f"main.{i}.weight"] = torch.randn((widths[i + 1], widths[i]), generator=g)
        sd[f"main.{i}.bias"] = torch.randn((widths[i + 1],), generator=g) * 0.1
    pt = tmp_path / "generator_7.pt"
    torch.save(sd, pt)

    tm = VGAN_no_kl(verbose=False, device="cpu")
    tm.load_models(pt, ndims=d)
    jm = JVGAN_no_kl(verbose=False)
    jm.load_models(pt, ndims=d)
    z = np.random.default_rng(6).normal(size=(100, latent)).astype(np.float32)
    want = np.asarray(jm._sample_jit(jm.generator_params, jnp.asarray(z)))
    got = tm._masks_from_noise(torch.from_numpy(z))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    assert tm.generator_optimizer == jm.generator_optimizer
    assert tm.generate_subspaces(10).shape == (10, d)


def test_precise_sweep_equals_jax_exactly():
    rng = np.random.default_rng(8)
    n1, n2 = 30, 26
    x = rng.normal(size=(n1, 5)).astype(np.float32)
    y = (rng.normal(size=(n2, 5)) + 0.2).astype(np.float32)
    base = np.concatenate([np.ones(n1), np.zeros(n2)])
    perms = np.stack([rng.permutation(base) for _ in range(50)])
    alphas = [0.01, 0.5, 0.1234]
    st, pt = TT.mmd_permutation_test_sweep_precise(x, y, alphas, permutations=perms)
    sj, pj = JT.mmd_permutation_test_sweep_precise(x, y, alphas, permutations=perms)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(pt, pj)
    # drawn from the same numpy seed, the permutation sets agree too
    st2, _ = TT.mmd_permutation_test_sweep_precise(
        x, y, alphas, rng=np.random.default_rng(9), n_permutations=20)
    sj2, _ = JT.mmd_permutation_test_sweep_precise(
        x, y, alphas, rng=np.random.default_rng(9), n_permutations=20)
    np.testing.assert_array_equal(st2, sj2)


def test_device_sweep_statistics_match_jax():
    """The f32 route's statistic algebra, in float64, against JAX's."""
    rng = np.random.default_rng(10)
    n1, n2 = 20, 17
    z = rng.normal(size=(n1 + n2, 4))
    a = np.stack([rng.permutation(np.r_[np.ones(n1), np.zeros(n2)]) for _ in range(6)])
    alphas = np.array([0.2, 1.3])
    kj = JT.alpha_gram(jnp.asarray(z), jnp.asarray(alphas))
    kt = TT.alpha_gram(torch.tensor(z), torch.tensor(alphas))
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=1e-12)
    sj = JT._stat_from_indicators(kj, jnp.asarray(a), n1, n2)
    stt = TT._stat_from_indicators(kt, torch.tensor(a), n1, n2)
    np.testing.assert_allclose(stt.numpy(), np.asarray(sj), rtol=1e-9, atol=1e-14)
    # the sweep's p-values with injected permutations, against the precise path
    x, y = z[:n1], z[n1:] + 0.5
    _, p_dev = TT.mmd_permutation_test_sweep(torch.tensor(x), torch.tensor(y), [0.2, 1.3],
                                             permutations=torch.tensor(a), device="cpu")
    _, p_host = TT.mmd_permutation_test_sweep_precise(x, y, [0.2, 1.3], permutations=a)
    np.testing.assert_allclose(p_dev.numpy(), p_host)


def _jax_tiled_single(x, y, alphas, perms):
    """JAX's streaming single test with injected permutations: its per-alpha
    statistics summed (its public function draws its own)."""
    z_pad, norms, a_rows, n1, n2, m, tile_d = JG._pooled_pad_rows(x, y, None, 0, perms)
    stats = np.asarray(JG._stats_for_rows(
        a_rows, z_pad, norms, jnp.asarray(alphas, jnp.float32), n1, n2, m, tile_d,
        interpret=True)).sum(axis=0)
    return stats[0], np.mean(stats[1:] >= stats[0])


@pytest.mark.parametrize("call", ["sweep", "single", "precise"])
def test_gof_past_dense_caps_raises(call, monkeypatch):
    """Past the dense caps (lowered here) each route takes the streaming
    test and agrees with JAX's route on the same injected permutations; with
    no device named it raises without a card instead of running on the
    CPU."""
    assert TT.DENSE_GOF_MAX_M == JT.DENSE_GOF_MAX_M
    assert TT.DENSE_PRECISE_MAX_M == JT.DENSE_PRECISE_MAX_M
    cap = "DENSE_PRECISE_MAX_M" if call == "precise" else "DENSE_GOF_MAX_M"
    monkeypatch.setattr(TT, cap, 64)
    monkeypatch.setattr(JT, cap, 64)
    rng = np.random.default_rng(11)
    n1, n2 = 40, 33
    x = (rng.normal(size=(n1, 6)) * 0.4).astype(np.float32)
    y = (rng.normal(size=(n2, 6)) * 0.4 + 0.2).astype(np.float32)
    base = np.r_[np.ones(n1), np.zeros(n2)]
    perms = np.stack([rng.permutation(base) for _ in range(25)])
    alphas = [0.05, 0.7]
    taken = []
    for name in ("mmd_permutation_test_tiled_sweep", "mmd_permutation_test_tiled"):
        fn = getattr(TG, name)
        monkeypatch.setattr(TG, name, lambda *a, _fn=fn, _n=name, **k: taken.append(_n) or _fn(*a, **k))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        {"sweep": TT.mmd_permutation_test_sweep, "single": TT.mmd_permutation_test,
         "precise": TT.mmd_permutation_test_sweep_precise}[call](x, y, alphas, permutations=perms)

    if call == "sweep":
        st, pt = TT.mmd_permutation_test_sweep(x, y, alphas, permutations=perms, device="cpu")
        sj, pj = JG.mmd_permutation_test_tiled_sweep(
            x, y, alphas, jax.random.PRNGKey(0), permutations=perms, interpret=True)
        st, pt, sj, pj = st.numpy(), pt.numpy(), np.asarray(sj), np.asarray(pj)
    elif call == "single":
        st, pt = TT.mmd_permutation_test(x, y, alphas, permutations=perms, device="cpu")
        sj, pj = _jax_tiled_single(x, y, alphas, perms)
        st, pt = st.numpy(), pt.numpy()
    else:
        st, pt = TT.mmd_permutation_test_sweep_precise(x, y, alphas, permutations=perms,
                                                       device="cpu")
        sj, pj = JT.mmd_permutation_test_sweep_precise(x, y, alphas, permutations=perms)
    want = "mmd_permutation_test_tiled" if call == "single" else "mmd_permutation_test_tiled_sweep"
    assert taken[-1] == want
    np.testing.assert_allclose(st, sj, rtol=1e-4)
    np.testing.assert_array_equal(pt, pj)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        VGAN_no_kl()
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        VGAN()
    model = VGAN_no_kl(device="cpu")
    with pytest.raises(RuntimeError):
        model.get_the_networks(D, 1, device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    x = np.zeros((3, 2), np.float32)
    for fn in (TT.mmd_permutation_test_sweep, TT.mmd_permutation_test):
        with pytest.raises(RuntimeError):
            fn(x, x, [0.1])
    gen = model.get_the_networks(D, 1)
    assert next(gen.parameters()).device.type == "cpu"
    assert [k for k in gen.state_dict()] == [f"main.{i}.{p}" for i in range(4)
                                              for p in ("weight", "bias")]


_LEFT_OUT = [dict(mesh=object()), dict(shard_features=True)]


@pytest.mark.parametrize("cls,kwargs", [(VGAN_no_kl, kw) for kw in _LEFT_OUT]
                         + [(VGAN, kw) for kw in _LEFT_OUT])
def test_left_out_options_raise(cls, kwargs):
    """``mesh=`` and ``shard_features=`` are ported
    (tests/test_torch_parallel.py) and raise only when misused: a mesh that
    is not a ``DeviceMesh``, or ``shard_features`` without a mesh. The bf16
    options are ported (test_bf16_options_reach_the_config)."""
    if "mesh" in kwargs:
        with pytest.raises(TypeError, match="make_mesh"):
            cls(device="cpu", **kwargs)
    else:
        with pytest.raises(ValueError, match="needs mesh="):
            cls(device="cpu", **kwargs)


_BF16_OPTIONS = ("gram_matmul_dtype", "model_matmul_dtype", "opt_state_dtype")


@pytest.mark.parametrize("cls,option", [(c, o) for c in (VGAN_no_kl, VGAN) for o in _BF16_OPTIONS])
def test_bf16_options_reach_the_config(cls, option):
    """Each bf16 option is stored on the estimator as given (the others stay
    None, as in vgan_tpu) and reaches the ``TrainConfig`` of a fit, and
    through it the modules and the optimizer it builds."""
    model = cls(device="cpu", **{option: "bfloat16"})
    for name in _BF16_OPTIONS:
        assert getattr(model, name) == ("bfloat16" if name == option else None)
    config = model._make_config(D, BS)
    for name in _BF16_OPTIONS:
        assert getattr(config, name) == getattr(model, name)
    gen = config.generator_module(kl=cls is VGAN)
    assert gen.compute_dtype == (torch.bfloat16 if option == "model_matmul_dtype" else None)
    state = config.adadelta(0.01).init(dict(gen.named_parameters()))
    want = torch.bfloat16 if option == "opt_state_dtype" else torch.float32
    assert all(t.dtype == want for t in state.square_avg.values())


@pytest.mark.parametrize("cls", [VGAN_no_kl, VGAN])
def test_left_out_entry_points_raise(cls, tmp_path):
    """No entry point is left out: ``.msgpack`` loading, the last, is
    ported. A ``vgan_tpu`` generator file loads and samples JAX's masks; a
    detector file is refused as not a generator; a missing file raises."""
    import flax.serialization

    module, params = _jax_generator(D, seed=9)
    path = tmp_path / "generator_0.msgpack"
    path.write_bytes(flax.serialization.to_bytes(params))
    model = cls(device="cpu")
    model.load_models(path, ndims=D)
    z = np.random.default_rng(9).normal(size=(60, model._latent_size)).astype(np.float32)
    want = np.asarray(j_binarize_mask(module.apply(params, jnp.asarray(z)), axis=-1))
    assert want.any() and not want.all()
    np.testing.assert_array_equal(model._masks_from_noise(torch.from_numpy(z)), want)
    detector = JS.TrainConfig(ndims=D, batch_size=BS).detector_module()
    det = detector.init(jax.random.PRNGKey(0), jnp.zeros((1, D), jnp.float32))
    (tmp_path / "detector_0.msgpack").write_bytes(flax.serialization.to_bytes(det))
    with pytest.raises(ValueError, match="reference generator"):
        model.load_models(tmp_path / "detector_0.msgpack", ndims=D)
    with pytest.raises(FileNotFoundError):
        model.load_models(tmp_path / "generator_1.msgpack", ndims=D)
    # the checkpoint knobs are ported: accepted and kept
    kept = cls(device="cpu", checkpoint_dir="ck", checkpoint_every=5)
    assert (kept.checkpoint_dir, kept.checkpoint_every) == ("ck", 5)


def test_vgan_defaults_and_seed_quirk_match_jax():
    ours = inspect.signature(VGAN.__init__).parameters
    theirs = inspect.signature(JVGAN.__init__).parameters
    assert set(ours) - set(theirs) == {"device"}
    for name, p in theirs.items():
        assert ours[name].default == p.default, name
    for kw in (dict(seed=5), dict(seed=5, replicate_reference_quirks=False),
               dict(replicate_reference_quirks=False, replicate_generator_detach=True)):
        tm, jm = VGAN(device="cpu", **kw), JVGAN(**kw)
        assert tm.seed == jm.seed and tm.get_params() == jm.get_params()
        assert tm.replicate_generator_detach == jm.replicate_generator_detach
        assert tm._make_config(D, BS).replicate_encoder_freeze == \
            jm._make_config(D, BS).replicate_encoder_freeze
    assert VGAN(device="cpu", seed=5).seed == 777


def test_vgan_fit_history_and_artifacts(tmp_path):
    """The kl workflow on the CPU: histories with NaN before the first epoch
    of each kind and the last-seen loss carried, generator and detector
    ``.pt`` files in the reference layout, runs numbered on."""
    model = VGAN(batch_size=BS, epochs=3, iternum_g=1, verbose=False, device="cpu",
                 path_to_directory=tmp_path)
    model.fit(_data())
    det, gen = model.train_history["detector_loss"], model.train_history["generator_loss"]
    # AlternationSchedule(1, 1): detector, generator, detector
    assert np.isnan(gen[0]) and np.isfinite(gen[1:]).all() and gen[2] == gen[1]
    assert np.isfinite(det).all() and det[1] == det[0] != det[2]
    assert model.generator_optimizer == model.detector_optimizer == "Adadelta"
    assert model.bandwidth == float(model.train_state.bw_value) > 0
    assert not bool(model.train_state.encoder_active)
    gen_m, det_m = model.get_the_networks(D, 1)
    sd = torch.load(tmp_path / "models" / "detector_0.pt", weights_only=True)
    assert list(sd) == list(det_m.state_dict()) == list(model.detector.state_dict())
    assert all(torch.equal(sd[k], v) for k, v in model.detector.state_dict().items())
    gsd = torch.load(tmp_path / "models" / "generator_0.pt", weights_only=True)
    assert list(gsd) == list(gen_m.state_dict())
    for rel in ("train_history/generator_loss_0.csv", "params.csv", "train_history.pdf",
                "metrics.jsonl"):
        assert (tmp_path / rel).is_file(), rel
    VGAN(batch_size=BS, epochs=1, verbose=False, device="cpu",
         path_to_directory=tmp_path).fit(_data())
    assert (tmp_path / "models" / "detector_1.pt").is_file()
    # masks from the saved generator, through the JAX estimator's loader
    jm = JVGAN(verbose=False)
    jm.load_models(tmp_path / "models" / "generator_0.pt", ndims=D)
    z = np.random.default_rng(3).normal(size=(32, model._latent_size)).astype(np.float32)
    want = np.asarray(jm._sample_jit(jm.generator_params, jnp.asarray(z)))
    np.testing.assert_array_equal(model._masks_from_noise(torch.from_numpy(z)), want)


def test_fit_rejects_bad_input():
    model = VGAN_no_kl(device="cpu", verbose=False, epochs=1)
    with pytest.raises(ValueError):
        model.fit(np.zeros((5,)))
    with pytest.raises(ValueError):
        model.fit(np.full((5, 3), np.nan))
    with pytest.raises(ValueError):
        model.check_if_myopic(np.zeros((3, 2)), count=5)


def test_port_imports_neither_jax_nor_vgan_tpu():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter
    (this process has JAX loaded by conftest); then one mcd ensemble scored,
    and still neither JAX, vgan_tpu, scipy nor sklearn in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vgan_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(vgan_tpu_torch.__path__, 'vgan_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert {'vgan_tpu_torch.ops.cuda.fused_no_kl', 'vgan_tpu_torch.utils.checkpoint',\n"
        "        'vgan_tpu_torch.ensemble.iforest', 'vgan_tpu_torch.ensemble.hetero',\n"
        "        'vgan_tpu_torch.ensemble.distill', 'vgan_tpu_torch.serving',\n"
        "        'vgan_tpu_torch.cli', 'vgan_tpu_torch.__main__', 'vgan_tpu_torch.data',\n"
        "        'vgan_tpu_torch.io_native', 'vgan_tpu_torch.utils.flax_msgpack',\n"
        "        'vgan_tpu_torch.utils.profiling', 'vgan_tpu_torch.parallel',\n"
        "        'vgan_tpu_torch.parallel.mesh', 'vgan_tpu_torch.parallel.input',\n"
        "        'vgan_tpu_torch.parallel.ring', 'vgan_tpu_torch.parallel.dp',\n"
        "        'vgan_tpu_torch._dryrun'} <= set(names)\n"
        "import chip_smoke\n"
        "banned = ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'vgan_tpu', 'scipy', 'sklearn')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "import numpy as np\n"
        "from vgan_tpu_torch import SubspaceEnsemble\n"
        "rng = np.random.default_rng(0)\n"
        "ens = SubspaceEnsemble(rng.random((3, 5)) < 0.6, np.ones(3), base='mcd', device='cpu')\n"
        "s = ens.fit(rng.normal(size=(30, 5))).decision_function(rng.normal(size=(8, 5)))\n"
        "assert s.shape == (8,) and np.all(np.isfinite(s))\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in banned)\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 17


def test_exports_match_jax():
    """The port exports every name ``vgan_tpu`` exports from its ensemble
    package and at its top level (the JAX package's ``TrainConfig`` and
    ``__version__`` included)."""
    import vgan_tpu
    import vgan_tpu.ensemble
    import vgan_tpu_torch
    import vgan_tpu_torch.ensemble

    assert set(vgan_tpu.ensemble.__all__) <= set(vgan_tpu_torch.ensemble.__all__)
    assert set(vgan_tpu.__all__) <= set(vgan_tpu_torch.__all__)
    for name in vgan_tpu_torch.__all__:
        assert getattr(vgan_tpu_torch, name) is not None
    for name in vgan_tpu_torch.ensemble.__all__:
        assert getattr(vgan_tpu_torch.ensemble, name).__module__.startswith("vgan_tpu_torch.")
