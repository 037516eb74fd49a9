"""The port's CUDA sources and its one ctypes boundary (``_build``) as the
CPU sees them: each ctypes signature against the C declaration it binds;
the build cache key, which must change with a source, an included header
or the flags; every kernel module binding, launching and counting through
``_build`` alone; and nothing built or loaded at import.

No ``nvcc`` is needed: the sources are read as text, and the libraries are
stand-ins.
"""

import ast
import contextlib
import ctypes
import importlib
import re
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from vgan_tpu_torch.ops.cuda import _build

MODULES = ["mmd_gram", "gof_gram", "knn_score", "fused_no_kl", "adadelta"]
# each module's launch_counts() keys: the benchmark's rooflines and route
# share divide by those of mmd_gram and knn_score
COUNT_KEYS = {
    "mmd_gram": ["gram_quadrant_sums", "gram_quadrant_sums_stash", "gram_backward_flash",
                 "kprime_panel", "gram_quadrant_sums_bf16", "gram_quadrant_sums_stash_bf16",
                 "gram_backward_flash_bf16", "kprime_panel_bf16"],
    "knn_score": ["knn_scores_resident", "knn_scores_stream", "knn_generic"],
    "gof_gram": ["a_times_k"],
    "fused_no_kl": ["fused_no_kl_fit_cuda"],
    "adadelta": ["adadelta_multi", "plain_update"],
}
_SCALARS = {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float}


def _declarations(source: str) -> dict:
    """name -> parameter types of every ``int vgan_*(...)`` entry."""
    return {
        name: [p.strip() for p in params.split(",")]
        for name, params in re.findall(r"^int (vgan_\w+)\(([^)]*)\)", source, flags=re.M)
    }


def _matches(param: str, argtype) -> bool:
    if "*" in param:
        return argtype is ctypes.c_void_p or issubclass(argtype, ctypes._Pointer)
    return argtype is _SCALARS[param.rsplit(" ", 1)[0]]


@pytest.mark.parametrize("module", MODULES)
def test_ctypes_signatures_match_the_c_declarations(module):
    mod = importlib.import_module(f"vgan_tpu_torch.ops.cuda.{module}")
    decls = _declarations((_build.CSRC / f"{module}.cu").read_text())
    assert set(mod._SIGNATURES) == set(decls)
    for name, argtypes in mod._SIGNATURES.items():
        params = decls[name]
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            assert _matches(param, argtype), (name, param, argtype)


@pytest.mark.parametrize("module", ["gof_gram", "knn_score", "mmd_gram"])
def test_build_key_follows_the_included_header(tmp_path, monkeypatch, module):
    """The sources that include ``dist_tile.cuh`` build anew when a byte
    of that header, of the source or of the flags changes, and not
    otherwise."""
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src = tmp_path / f"{module}.cu"
    key = _build.source_key(src)
    assert key == _build.source_key(src)
    assert '#include "dist_tile.cuh"' in src.read_text()

    header = tmp_path / "dist_tile.cuh"
    original = header.read_bytes()
    header.write_bytes(original.replace(b"constexpr int BK = 16;", b"constexpr int BK = 32;"))
    assert header.read_bytes() != original
    assert _build.source_key(src) != key
    header.write_bytes(original)
    assert _build.source_key(src) == key

    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.source_key(src) != key
    src.write_bytes(src.read_bytes()[:-1])
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    assert _build.source_key(src) != key


def test_build_key_follows_the_wgmma_header(tmp_path):
    """mmd_gram.cu's bf16 forward includes ``wgmma_tile.cuh`` (the TMA-fed
    wgmma product): a byte of it builds anew; the sources that do not
    include it keep their key."""
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src, other = tmp_path / "mmd_gram.cu", tmp_path / "knn_score.cu"
    assert '#include "wgmma_tile.cuh"' in src.read_text()
    assert "wgmma_tile.cuh" not in other.read_text()
    key, other_key = _build.source_key(src), _build.source_key(other)
    header = tmp_path / "wgmma_tile.cuh"
    header.write_bytes(header.read_bytes().replace(b"constexpr int STAGES = 4;",
                                                   b"constexpr int STAGES = 3;"))
    assert _build.source_key(src) != key
    assert _build.source_key(other) == other_key


def test_build_key_ignores_headers_not_included(tmp_path):
    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    src = tmp_path / "fused_no_kl.cu"
    assert "dist_tile.cuh" not in src.read_text()
    key = _build.source_key(src)
    (tmp_path / "dist_tile.cuh").write_text("// another header\n")
    assert _build.source_key(src) == key


@pytest.mark.parametrize("module", MODULES)
def test_kernel_module_binds_through_build(module):
    """No loader, binding or counter of its own, and no private name of
    another kernel module: ``_build`` is the only ctypes boundary."""
    path = _build.CSRC.parent / f"{module}.py"
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("CDLL", "launches"), (module, node.lineno)
            if isinstance(node.ctx, ast.Store):
                assert node.attr not in ("argtypes", "restype"), (module, node.lineno)
        if isinstance(node, ast.ImportFrom) and node.module:
            other = node.module.rsplit(".", 1)[-1]
            if node.module.startswith("vgan_tpu_torch.ops.cuda.") and other in MODULES:
                assert not any(a.name.startswith("_") for a in node.names), (module, node.lineno)
    assert "_build.bound(" in path.read_text()


@pytest.mark.parametrize("module", MODULES)
def test_launch_counts_keep_their_keys(module):
    """Each module's counts are exactly its keys, zero after a reset, and
    count through ``_build``'s registry apart from every other module's."""
    mods = {m: importlib.import_module(f"vgan_tpu_torch.ops.cuda.{m}") for m in MODULES}
    mod, keys = mods[module], COUNT_KEYS[module]
    for m in mods.values():
        m.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(keys, 0)
    for i, key in enumerate(keys):
        for _ in range(i + 1):
            _build.count(key)
    assert mod.launch_counts() == {key: i + 1 for i, key in enumerate(keys)}
    for other, m in mods.items():
        if other != module:
            assert sum(m.launch_counts().values()) == 0, other
    mod.reset_launch_counts()
    assert mod.launch_counts() == dict.fromkeys(keys, 0)


def test_launch_raises_naming_the_entry(monkeypatch):
    """The entry gets its arguments and the device's current stream; a
    nonzero return raises with the entry's name."""
    calls = []

    class Lib:
        @staticmethod
        def vgan_ok(*args):
            calls.append(args)
            return 0

        @staticmethod
        def vgan_failing(*args):
            calls.append(args)
            return 700

    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=42))
    _build.launch(Lib, "vgan_ok", "cuda:0", 1, 2.5)
    with pytest.raises(RuntimeError, match="vgan_failing: CUDA error 700"):
        _build.launch(Lib, "vgan_failing", "cuda:0", 3)
    assert calls == [(1, 2.5, 42), (3, 42)]


def test_built_from_rebinds_a_module_to_another_directory(monkeypatch, tmp_path):
    """Within ``built_from`` a module's library comes from the other
    directory, bound with its signatures (an entry that source lacks left
    unbound), each directory's library bound once; after it, this
    package's again."""
    loaded = []

    def load(name, csrc=_build.CSRC):
        loaded.append((name, Path(csrc)))
        lib = types.SimpleNamespace(vgan_a=types.SimpleNamespace())
        if Path(csrc) == _build.CSRC:
            lib.vgan_b = types.SimpleNamespace()
        return lib

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "_bound", {})
    sigs = {"vgan_a": [ctypes.c_void_p], "vgan_b": [ctypes.c_int]}
    tree = _build.bound("knn_score", sigs)
    with _build.built_from("knn_score", tmp_path):
        other = _build.bound("knn_score", sigs)
        assert _build.bound("knn_score", sigs) is other
        assert _build.bound("mmd_gram", sigs) is not other
    assert _build.bound("knn_score", sigs) is tree
    assert loaded == [("knn_score", _build.CSRC), ("knn_score", tmp_path),
                      ("mmd_gram", _build.CSRC)]
    assert tree.vgan_b.argtypes == [ctypes.c_int] and tree.vgan_b.restype is ctypes.c_int
    assert other.vgan_a.argtypes == [ctypes.c_void_p] and not hasattr(other, "vgan_b")


def test_wrapper_checks_reject_bad_operands():
    z = torch.zeros(4, 3)
    with pytest.raises(TypeError):
        _build.check("z", z.double(), (4, 3), z.device)
    with pytest.raises(ValueError):
        _build.check("z", z, (3, 4), z.device)
    with pytest.raises(ValueError):
        _build.check("z", z.T, (3, 4), z.device)


def test_importing_the_port_loads_no_library():
    """Every module of the port, and chip_smoke.py, in a fresh interpreter:
    ``_build`` has built, loaded and bound nothing."""
    code = (
        "import importlib, pkgutil\n"
        "import vgan_tpu_torch\n"
        "for m in pkgutil.walk_packages(vgan_tpu_torch.__path__, 'vgan_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from vgan_tpu_torch.ops.cuda import _build\n"
        "assert not (_build._libs or _build._bound or _build.build_info), _build._libs\n"
    )
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
