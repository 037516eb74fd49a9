"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

    python3 benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with as many
CUDA cards as the cell asks for (it refuses to run without them). The cell,
its configuration, its traffic mix, its limits and its metrics' readers
are found by name (``harness/spec.py``). A cell of several cards runs one
process a card (this script, given ``--rank``), joined over a TCP
rendezvous on localhost; rank 0 prints the result.

The last line on standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the end-to-end metrics with
``--trace 0``, the per-layer ones with ``--trace 1``), ``device`` and, when
traced, ``breakdown``; its last key, ``checks``, holds each number
compared with its limit, which also end standard error.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vgan_tpu")


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; no JAX pulled in by a library."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    for path in (str(ROOT), str(BENCH_DIR)):
        if path not in sys.path:
            sys.path.insert(0, path)


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not load (compared
    whole: ``vgan_tpu_torch`` is not ``vgan_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t-start", type=float, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_world(args, chips: int) -> int:
    """One process a card; relays rank 0's standard output."""
    port = free_port()
    procs = []
    for rank in range(chips):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(chips),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        cmd = [sys.executable, str(Path(__file__).resolve()), "--workload", args.workload,
               "--seed", str(args.seed), "--seconds", str(args.seconds), "--trace",
               str(args.trace), "--rank", str(rank), "--port", str(port),
               "--t-start", repr(T_START)]
        procs.append(subprocess.Popen(
            cmd, cwd=os.getcwd(), env=env,
            stdout=subprocess.PIPE if rank == 0 else subprocess.DEVNULL, text=True))
    out, _ = procs[0].communicate()
    codes = [procs[0].returncode] + [p.wait() for p in procs[1:]]
    if any(codes):
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        print(f"ranks exited with {codes}", file=sys.stderr)
        return 1
    if forbidden_modules():
        print(f"loaded {forbidden_modules()}", file=sys.stderr)
        return 3
    sys.stdout.write(out)
    sys.stdout.flush()
    return 0


def main(argv=None) -> int:
    _environment()
    args = parse(argv)
    from harness.spec import Cell

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {have}",
              file=sys.stderr)
        return 2
    if cell.chips > 1 and args.rank is None:
        return spawn_world(args, cell.chips)
    from harness.cell import run_cell

    rank = args.rank or 0
    if cell.chips > 1:
        torch.cuda.set_device(rank)
    device = torch.device("cuda", rank)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      args.t_start if args.t_start is not None else T_START, rank, cell.chips)
    if rank != 0:
        return 0
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures vgan_tpu_torch alone",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
