"""The port's CUDA sources as the CPU sees them: each ctypes signature
against the C declaration it binds, and the build cache key, which must
change with a source, an included header or the flags.

No ``nvcc`` is needed: the sources are read as text.
"""

import ctypes
import importlib
import re
import shutil

import pytest

from vgan_tpu_torch.ops.cuda import _build

MODULES = ["mmd_gram", "gof_gram", "knn_score", "fused_no_kl"]
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
