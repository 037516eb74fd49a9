"""The benchmark's own tests: CPU tests of the harness at a tiny size, and
the tests marked ``card``, which run a cell on a CUDA card and skip
elsewhere (decided inside the test, never at import).

    python -m pytest benchmarks/tests -q          # here
    python -m pytest benchmarks/tests -q -m card  # on the card
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for _p in (str(ROOT), str(BENCH_DIR)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

TINY = {"n": 120, "d": 160, "batch_size": 30}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


# The four-card cell whose files the benchmark keeps (PERF.md, Open
# questions): the tests drive it on four gloo ranks.
DP4 = {"name": "no_kl.fit.dp4", "config": "vgan_no_kl.d10240", "traffic": "fit.e100.dp",
       "chips": 4, "why": "no_kl.fit over a data-parallel mesh of four"}


def make_tiny_root(dest: Path) -> Path:
    """A copy of ``BENCHMARK.json`` (with the four-card cell) and the
    benchmark's folder whose configurations and mixes are cut to a size the
    CPU runs in seconds."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    if DP4["name"] not in {w["name"] for w in spec["workloads"]}:
        spec["workloads"].append(DP4)
        spec["end_to_end"][0]["workloads"].append(DP4["name"])
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(BENCH_DIR, dest / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = dest / BENCH_DIR.name
    for path in (bench / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg["n"], cfg["d"] = TINY["n"], TINY["d"]
        cfg["params"]["batch_size"] = TINY["batch_size"]
        path.write_text(json.dumps(cfg))
    for path in (bench / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        if mix["kind"] == "fit":
            mix["epochs_per_call"] = 6 if mix["epochs_per_call"] % 6 == 0 else 2
        else:
            mix.update(n_masks=16, n_test=24, test_batches=3)
        path.write_text(json.dumps(mix))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(scope="session", autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
