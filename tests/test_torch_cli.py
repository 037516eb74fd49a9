"""The port's CLI and its data path (``vgan_tpu_torch.cli``, ``__main__``,
``data``, ``io_native``), its Flax msgpack reader
(``utils.flax_msgpack``) and its profiling hooks (``utils.profiling``),
against ``vgan_tpu``'s on the same inputs, on the CPU (``--device cpu``).

Held to the bit: the parser (every subcommand, flag, default and choice,
but the documented differences), the data loaders and the CSV engine, the
msgpack trees, and the masks and scores the CLI writes against the same
calls through the API.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import flax.serialization
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vgan_tpu.cli as JCLI
import vgan_tpu.data as JDATA
import vgan_tpu.io_native as JIO
import vgan_tpu_torch.cli as TCLI
import vgan_tpu_torch.data as TDATA
import vgan_tpu_torch.io_native as TIO
import vgan_tpu_torch.ensemble.od as TOD
from vgan_tpu import VGAN_no_kl as JVGAN_no_kl
from vgan_tpu_torch import VGAN_no_kl
from vgan_tpu_torch.ensemble import SubspaceEnsemble
from vgan_tpu_torch.serving import load_sampler, sample_masks
from vgan_tpu_torch.utils import flax_msgpack, profiling
from test_torch_bases import one_torch_thread  # noqa: F401  (module fixture)

REPO = Path(__file__).resolve().parent.parent


def _options(parser):
    """{subcommand: {dest: (option strings, default, choices, nargs, type,
    required)}} of a parser."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {
        name: {a.dest: (tuple(a.option_strings), a.default, a.choices and tuple(a.choices),
                        a.nargs, a.type, a.required)
               for a in p._actions if a.dest != "help"}
        for name, p in sub.choices.items()
    }


def test_parser_matches_jax():
    """Same subcommands, flags, defaults and choices as ``vgan_tpu``'s, but:
    ``--device`` on every subcommand, and ``--mmd-impl`` also takes the
    port's names."""
    ours, theirs = _options(TCLI.build_parser()), _options(JCLI.build_parser())
    assert set(ours) == set(theirs) == {"fit", "sample", "export", "check-myopic", "score"}
    for cmd in theirs:
        device = ours[cmd].pop("device")
        assert device[:2] == (("--device",), None)
        if "mmd_impl" in theirs[cmd]:
            o, t = ours[cmd].pop("mmd_impl"), theirs[cmd].pop("mmd_impl")
            assert set(o[2]) == set(t[2]) | {"torch", "cuda"}
            assert o[:2] == t[:2] and o[3:] == t[3:]
        assert ours[cmd] == theirs[cmd], cmd
    assert TCLI._SCORE_BASES == JCLI._SCORE_BASES
    assert set(TCLI._SCORE_BASES) == {*TOD._BASE_SCORERS, *TOD._DIM_BASES, *TOD._PARAM_BASES}


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    d = tmp_path_factory.mktemp("rows")
    x = np.random.default_rng(0).normal(size=(64, 8))
    np.save(d / "x.npy", x)
    return d / "x.npy", x


def _run(argv, capsys):
    assert TCLI.main(argv) == 0
    return capsys.readouterr().out


def test_round_trip_fit_sample_myopic_score_export(rows, tmp_path, capsys):
    path, x = rows
    out = tmp_path / "run"
    text = _run(["fit", "--data", str(path), "--epochs", "2", "--batch-size", "16",
                 "--out", str(out), "--quiet", "--mmd-impl", "jnp", "--device", "cpu"], capsys)
    assert text.startswith("final loss: ")
    gen = out / "models" / "generator_0.pt"
    assert gen.is_file() and (out / "params.csv").is_file()
    model = VGAN_no_kl(verbose=False, device="cpu", seed=5)
    model.load_models(gen, ndims=8)

    _run(["sample", "--generator", str(gen), "--ndims", "8", "--nsubs", "30", "--seed", "5",
          "--out", str(tmp_path / "m.npy"), "--device", "cpu"], capsys)
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"), model.generate_subspaces(30))
    text = _run(["check-myopic", "--data", str(path), "--generator", str(gen), "--count", "20",
                 "--bandwidth", "0.01", "1.0", "--device", "cpu"], capsys)
    assert "p-val" in text and "recommended bandwidth" in text

    _run(["score", "--train", str(path), "--generator", str(gen), "--base", "lof", "--k", "5",
          "--subspaces", "20", "--seed", "5", "--out", str(tmp_path / "s.npy"),
          "--device", "cpu"], capsys)
    ens = SubspaceEnsemble.from_model(model, 20, base="lof", k=5, device="cpu").fit(x)
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), ens.decision_function(x))
    _run(["score", "--train", str(path), "--generator", str(gen), "--members", "knn,ecod",
          "--combination", "select", "--k", "5", "--subspaces", "20",
          "--out", str(tmp_path / "h.npy"), "--device", "cpu"], capsys)
    assert np.load(tmp_path / "h.npy").shape == (64,)

    text = _run(["export", "--generator", str(gen), "--ndims", "8",
                 "--out", str(tmp_path / "sampler.pt2"), "--device", "cpu"], capsys)
    assert "latent_size=1" in text
    fn = load_sampler(tmp_path / "sampler.pt2")
    np.testing.assert_array_equal(sample_masks(fn, 30, 1, seed=5), model.generate_subspaces(30))


def test_jax_written_msgpack_samples_and_scores(rows, tmp_path, capsys):
    """``vgan_tpu``'s CLI writes ``generator_0.msgpack``; the port's
    ``sample`` draws JAX's masks on the port's noise, and its ``score``
    equals the API on the same generator."""
    path, x = rows
    assert JCLI.main(["fit", "--data", str(path), "--epochs", "1", "--batch-size", "16",
                      "--out", str(tmp_path / "jax"), "--quiet"]) == 0
    gen = tmp_path / "jax" / "models" / "generator_0.msgpack"
    capsys.readouterr()
    _run(["sample", "--generator", str(gen), "--ndims", "8", "--nsubs", "40",
          "--out", str(tmp_path / "m.npy"), "--device", "cpu"], capsys)
    jm = JVGAN_no_kl(verbose=False)
    jm.load_models(gen, ndims=8)
    z = torch.randn((40, 1), generator=torch.Generator().manual_seed(777))
    want = np.asarray(jm._sample_jit(jm.generator_params, jnp.asarray(z.numpy())))
    np.testing.assert_array_equal(np.load(tmp_path / "m.npy"), want)
    _run(["score", "--train", str(path), "--generator", str(gen), "--k", "5",
          "--subspaces", "20", "--out", str(tmp_path / "s.npy"), "--device", "cpu"], capsys)
    model = VGAN_no_kl(verbose=False, device="cpu")
    model.load_models(gen, ndims=8)
    ens = SubspaceEnsemble.from_model(model, 20, k=5, device="cpu").fit(x)
    np.testing.assert_array_equal(np.load(tmp_path / "s.npy"), ens.decision_function(x))


def test_fit_out_without_matplotlib(rows, tmp_path, capsys, monkeypatch):
    """Where matplotlib is not installed ``fit --out`` writes every artifact
    but the loss PDF, and warns."""
    path, _ = rows
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import raises ImportError
    with pytest.warns(RuntimeWarning, match="matplotlib"):
        _run(["fit", "--data", str(path), "--epochs", "1", "--batch-size", "32",
              "--out", str(tmp_path / "run"), "--quiet", "--device", "cpu"], capsys)
    run = tmp_path / "run"
    for rel in ("models/generator_0.pt", "params.csv", "train_history/generator_loss_0.csv"):
        assert (run / rel).is_file(), rel
    assert not (run / "train_history.pdf").exists()


def test_main_module_runs(rows, tmp_path):
    path, _ = rows
    pt = tmp_path / "g.pt"
    torch.save(VGAN_no_kl(device="cpu").get_the_networks(8, 1).state_dict(), pt)
    out = subprocess.run([sys.executable, "-m", "vgan_tpu_torch", "sample", "--generator",
                          str(pt), "--ndims", "8", "--nsubs", "5", "--out",
                          str(tmp_path / "m.npy"), "--device", "cpu"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert np.load(tmp_path / "m.npy").shape == (5, 8)


class _Stop(Exception):
    """Raised in place of a fit, once its estimator has been read."""


def test_refusals(rows, tmp_path):
    path, _ = rows
    fit = ["fit", "--data", str(path), "--epochs", "1", "--device", "cpu"]
    # --mesh is ported (tests/test_torch_parallel.py runs it under gloo); in
    # this one process a mesh of two devices is oversubscribed, refused
    # before any process group starts, and a malformed spec stops the CLI
    for extra in (["--mesh", "data=2"], ["--mesh", "data=2", "--shard-features"]):
        with pytest.raises(ValueError, match="devices"):
            TCLI.main(fit + extra)
    with pytest.raises(ValueError, match="devices"):
        TCLI.main(["score", "--train", str(path), "--generator", "g.pt", "--mesh", "data=2",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="data=N"):
        TCLI.main(fit + ["--mesh", "data=two"])
    assert not torch.distributed.is_initialized()
    # the bf16 flags reach the estimator (a fit with all three:
    # test_torch_bf16.py)
    seen = {}

    def record(self, X):
        seen.update(gram=self.gram_matmul_dtype, model=self.model_matmul_dtype,
                    state=self.opt_state_dtype)
        raise _Stop

    for flag, key in (("--model-dtype", "model"), ("--opt-state-dtype", "state"),
                      ("--gram-dtype", "gram")):
        seen.clear()
        with mock.patch.object(VGAN_no_kl, "fit", record), pytest.raises(_Stop):
            TCLI.main(fit + [flag, "bfloat16"])
        assert seen == {k: ("bfloat16" if k == key else None) for k in ("gram", "model", "state")}
    # parser errors, before any data is read
    for extra in (["--shard-features"], ["--generator-grad", "st"], ["--latent-size", "3"],
                  ["--variant", "no_kl", "--latent-size", "1"]):
        with pytest.raises(SystemExit):
            TCLI.main(["fit", "--data", "missing.npy", "--device", "cpu"] + extra)
    with pytest.raises(SystemExit):
        TCLI.main(["score", "--train", "missing.npy", "--generator", "g.pt",
                   "--members", "knn,nope"])


def test_data_matches_jax(tmp_path):
    for fn in ("notebook_gaussian", "correlated_gaussian"):
        np.testing.assert_array_equal(getattr(TDATA, fn)(n=50, d=6, coupled=(0, 4), seed=3),
                                      getattr(JDATA, fn)(n=50, d=6, coupled=(0, 4), seed=3))
    x = np.random.default_rng(1).normal(size=(30, 4))
    np.save(tmp_path / "a.npy", x)
    np.savez(tmp_path / "a.npz", first=x, second=x[:3])
    np.savetxt(tmp_path / "a.csv", x, delimiter=",", header="a,b,c,d", comments="")
    for name in ("a.npy", "a.npz", "a.csv"):
        np.testing.assert_array_equal(TDATA.load_tabular(tmp_path / name),
                                      JDATA.load_tabular(tmp_path / name))
    for module in (TDATA, JDATA):
        with pytest.raises(ValueError, match="unsupported"):
            module.load_tabular(tmp_path / "a.txt")
    np.savez(tmp_path / "ad.npz", X=x, y=(x[:, 0] > 1).astype(np.int32))
    ours, theirs = TDATA.load_adbench(tmp_path / "ad.npz"), JDATA.load_adbench(tmp_path / "ad.npz")
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.savez(tmp_path / "bad.npz", X=x)
    np.savez(tmp_path / "bad_y.npz", X=x, y=np.full(30, 2))
    for name in ("bad.npz", "bad_y.npz"):
        for module in (TDATA, JDATA):
            with pytest.raises(ValueError):
                module.load_adbench(tmp_path / name)
    for a, b in zip(TDATA.sklearn_dataset("iris"), JDATA.sklearn_dataset("iris")):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown dataset"):
        TDATA.sklearn_dataset("nope")


def _csv_cases(tmp_path):
    """(name, text, kwargs) of tests/test_io_native.py's cases."""
    rng = np.random.default_rng(5)
    data = rng.integers(0, 1000, size=(3000, 4))
    ranged = ["c0,c1,c2,c3"]
    for i, row in enumerate(data):
        ranged.append(",".join(map(str, row)))
        if i % 53 == 0:
            ranged.append("")
    page = 4096
    row = "1.5,2.5\n"
    cases = [
        ("plain", "1.0,2.0\n3.5,4.5", {}),
        ("scientific", "-1.5e-3,2E4\n+0.5,-7\n", {}),
        ("malformed", "1,2\n3,oops\n", {}),
        ("blank lines", "a,b\n1,2\n\n3,4\n   \n5,6\n\n\n", dict(dtype=np.float32)),
        ("single column", "1st_percentile\n1.5\n2.5\n3.5\n", {}),
        ("single column range", "1st_percentile\n1.5\n2.5\n3.5\n", dict(skip_rows=1)),
        ("trailing comma", "1,2,\n3,4,\n", {}),
        ("page boundary", row * (page // len(row) - 1) + "9.25,3.5", {}),
    ]
    cases += [(f"range {s} {c}", "\n".join(ranged) + "\n",
               dict(nthreads=8, skip_rows=s, max_rows=c))
              for s, c in [(0, 100), (997, 1003), (2500, 10_000), (3000, 5)]]
    for i, (name, text, kw) in enumerate(cases):
        p = tmp_path / f"case{i}.csv"
        p.write_text(text)
        yield name, p, kw


def _outcome(load, path, kw):
    try:
        return load(path, **kw)
    except Exception as e:  # the fallback's error, the same in both packages
        return type(e)


def test_load_csv_matches_jax(tmp_path):
    assert TIO.native_available()
    for name, path, kw in _csv_cases(tmp_path):
        got, want = _outcome(TIO.load_csv, path, kw), _outcome(JIO.load_csv, path, kw)
        if isinstance(want, type):
            assert got is want, name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
            assert got.dtype == want.dtype, name
    fallback = TIO._numpy_fallback(str(tmp_path / "case4.csv"), np.float64)
    np.testing.assert_array_equal(fallback, JIO._numpy_fallback(str(tmp_path / "case4.csv"),
                                                                 np.float64))


def _same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(got, torch.Tensor):  # bfloat16
        assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


def test_msgpack_matches_flax(monkeypatch):
    rng = np.random.default_rng(2)
    tree = {
        "params": {"Dense_0": {"kernel": rng.normal(size=(3, 5)).astype(np.float32),
                               "bias": np.zeros(5, np.float32)},
                   "Dense_1": {"kernel": np.asarray(jnp.asarray(rng.normal(size=(4, 2)),
                                                                jnp.bfloat16))}},
        "scalars": {"f": np.float64(2.5), "i": np.int32(-7), "u": np.uint8(200),
                    "b": np.bool_(True)},
        "py": {"int": 70000, "neg": -2**40, "float": 1.5, "complex": 1 + 2j, "true": True,
               "none": None, "text": "x" * 40, "list": [1, -3, 0.25]},
        "wide": np.arange(70000, dtype=np.int64),
        "empty": np.zeros((0, 3), np.float32),
    }
    data = flax.serialization.to_bytes(tree)
    _same_tree(flax_msgpack.msgpack_restore(data), flax.serialization.msgpack_restore(data))
    # a leaf past MAX_CHUNK_SIZE bytes is chunked; so is a bfloat16 one
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    data = flax.serialization.msgpack_serialize(
        {"big": rng.normal(size=(10, 7)), "h": np.asarray(jnp.ones((9, 5), jnp.bfloat16)),
         "small": np.arange(3, dtype=np.int16)})
    want = flax.serialization.msgpack_restore(data)
    got = flax_msgpack.msgpack_restore(data)
    _same_tree(got, want)
    assert got["h"].shape == (9, 5)
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.msgpack_restore(data[:-3])


def test_utils_exports_match_jax():
    import vgan_tpu.utils
    import vgan_tpu_torch.utils

    assert set(vgan_tpu.utils.__all__) <= set(vgan_tpu_torch.utils.__all__)
    for name in vgan_tpu_torch.utils.__all__:
        assert getattr(vgan_tpu_torch.utils, name).__module__.startswith("vgan_tpu_torch.")


def test_profiling_trace_has_the_annotation(tmp_path):
    @profiling.annotate("vgan_region")
    def work(a):
        return (a @ a).sum()

    assert work.__name__ == "work"
    with profiling.trace_context(tmp_path / "trace"):
        work(torch.ones(8, 8))
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "vgan_region" for e in events)
    assert float(work(torch.ones(2, 2))) == 8.0
