"""One run of one cell: the runner of its traffic's kind, its metrics, then
the reference and the comparison once the window has closed and the
program's state is freed."""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from harness import compare, fit, score
from harness.device import free
from harness.spec import Context

def _json_number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def end_to_end(cell, r: dict) -> dict:
    """The end-to-end metrics, on the host clock, over all the window."""
    values = {"setup_s": r["setup_s"]}
    if "steps" in r:
        values["train_steps_per_s"] = r["steps"] / r["window_s"]
    if "rows" in r:
        values["score_rows_per_s"] = r["rows"] / r["window_s"]
        values["score_p95_ms"] = float(np.percentile(np.asarray(r["latencies"]), 95)) * 1e3
    return values


def readings(cell, r: dict, world_busy_s: float) -> dict:
    """What a per-layer metric's reader reads."""
    tr = r["trace"]
    return {"cell": cell.name, "config": cell.config, "traffic": cell.traffic,
            "chips": cell.chips, "window_s": tr.window_s, "busy_s": world_busy_s,
            "trace": tr, "steps": r.get("traced_steps"), "calls": r["traced_calls"],
            "launches": r["launches"], "model_flops": r.get("model_flops"),
            "call_ops": r.get("call_ops"), "call_bound_ms": r.get("call_bound_ms")}


def _world_mean(value: float, world: int, device) -> float:
    if world == 1:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return float(t) / world


def _world_max(value: int, world: int, device) -> int:
    if world == 1:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t)


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             rank: int = 0, world: int = 1) -> dict:
    kind = cell.traffic["kind"]
    ctx = Context(cell, seed, seconds, trace, device, t_start, rank, world)
    mesh = None
    if cell.traffic.get("layout") == "dp":
        from vgan_tpu_torch.parallel import make_mesh

        mesh = make_mesh(data=world, device=torch.device(device).type)
    if kind == "fit":
        r = fit.run(ctx, mesh)
    else:
        r = score.run(ctx)
    peak = _world_max(r["memory_peak_bytes"], world, device)
    busy = _world_mean(r["trace"].busy_s(), world, device) if trace else None
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier()
        dist.destroy_process_group()
    if rank != 0:
        return {}
    result = {"correct": False, "attempted": r["calls"], "failed": r["failed"]}
    if trace:
        reads = readings(cell, r, busy)
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(reads)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = end_to_end(cell, r)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    name = torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"
    dev = {"platform": "gpu", "kind": name, "count": cell.chips, "memory_peak_bytes": peak}
    if trace:
        dev["busy_s"] = busy
        dev["window_s"] = r["trace"].window_s
    print(f"route: launches {r['launches']}; calls {r['calls']}; build seconds "
          f"{build_seconds()}", file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = dev
    if trace:
        result["breakdown"] = {"device_ops": r["trace"].top_device_ops(),
                               "idle_gaps": r["trace"].idle_gaps()}
    r.pop("trace")
    gaps = judge_run(ctx, kind, r)
    correct, checks = compare.judge(gaps, cell.limits)
    result["correct"] = bool(correct and r["failed"] == 0)
    result["checks"] = {k: {"value": _json_number(v["value"]), "limit": v["limit"]}
                        for k, v in checks.items()}
    return result


def build_seconds() -> float:
    from vgan_tpu_torch.ops.cuda import _build

    return sum(info["seconds"] for info in _build.build_info.values())


def judge_run(ctx, kind: str, r: dict) -> dict:
    """The gaps of this run's outputs to the reference's, the reference run
    after the program's state is freed."""
    free(ctx.device)
    if kind == "fit":
        return compare.fit_gaps(r["program"], fit.reference_readings(ctx))
    ref, kth = score.reference_scores(ctx)
    return {"score": compare.score_gap(r["outputs"], r["order"], ref),
            "kth": compare.kth_gap(r["subspace_scores"], kth)}
