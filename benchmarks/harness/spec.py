"""Finds by name what belongs to a cell: its entry in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``), its correctness limits (``limits/<workload>.json``)
and the readers of its metrics (``metrics/<metric>.py``). Nothing here
names a particular cell, so a new cell is new files and entries only."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, root: Path = ROOT):
        bench_dir = root / BENCH_DIR.name
        self.spec = load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(by_name)}")
        self.name = name
        self.workload = by_name[name]
        self.chips = int(self.workload["chips"])
        self.config = load_json(bench_dir / "configs" / f"{self.workload['config']}.json")
        self.traffic = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")
        self.metrics_dir = bench_dir / "metrics"

    def _reports(self, metric: dict) -> bool:
        cells = metric.get("workloads")
        return cells is None or self.name in cells

    def end_to_end(self) -> list:
        return [m for m in self.spec["end_to_end"] if self._reports(m)]

    def per_layer(self) -> list:
        return [m for m in self.spec["per_layer"] if self._reports(m)]

    def reader(self, metric_name: str):
        """The ``read(readings) -> float | None`` of ``metrics/<name>.py``."""
        path = self.metrics_dir / f"{metric_name}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric_name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


class Context:
    """What one run of a cell is given."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t_start: float,
                 rank: int = 0, world: int = 1):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t_start, self.rank, self.world = device, t_start, rank, world
        self.config, self.traffic = cell.config, cell.traffic
