"""The reference imports nothing of JAX, of the JAX package or of the
program; the harness refuses to run without a card and prints no result;
a loaded module is judged by its whole top-level name."""

import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vgan_tpu", "vgan_tpu_torch"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


def test_reference_sources_import_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").glob("*.py"):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_modules_load_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); import reference.vgan, reference.knn_ensemble; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(BENCH_DIR), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_harness_sources_import_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "vgan_tpu"}, path


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, str(BENCH_DIR / "run.py"), "--workload", "no_kl.fit", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=BENCH_DIR.parent,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import run

    monkeypatch.setattr(run.sys, "modules", {"vgan_tpu_torch": 1, "vgan_tpu_torch.api": 1,
                                             "jaxtyping": 1, "numpy": 1})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(run.sys, "modules", {"vgan_tpu.api.vgan": 1, "jax.numpy": 1})
    assert run.forbidden_modules() == ["jax", "vgan_tpu"]
