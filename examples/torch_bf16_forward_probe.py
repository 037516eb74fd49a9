#!/usr/bin/env python3
"""Where the bf16 forward's host and device time go (K1 bf16 and K2 bf16),
on one NVIDIA GPU.

    python3 examples/torch_bf16_forward_probe.py [--parent-csrc DIR]

The bf16 forward is ``gram_quadrant_sums_bf16`` (K1 bf16) and
``gram_quadrant_sums_stash_bf16`` (K2 bf16) of
``vgan_tpu_torch/ops/cuda/mmd_gram.py``. At the shapes ``chip_smoke.py``
times them at (K1 bf16: the kl cycle's Gram, m=1000, d=640; the flash
fit's, d=1024; a ragged m=2113, d=700; the panel fit's forward, d=10240;
K2 bf16: the no-kl stress Gram, m=1000, d=10240) the probe reads, for one
call:

- the wrapper's host time: the host clock over 50 calls enqueued back to
  back, a call's share (the card runs behind), and the same with the C
  entry not called (the wrapper's Python: checks, schedule, allocations);
- each pass's device time (``chip_smoke.device_split``, 20 calls);

for this tree and for builds of its ``mmd_gram.cu`` with one part of the
cluster kernel cut out: ``no_ladder`` (the ladder's body two products,
``examples/torch_mmd_ladder_probe.py``'s stub), ``no_product`` (no chunk
loaded or multiplied, the partial tiles zero) and ``no_cluster_launch``
(the cluster kernel not launched, which reads the host time of its
launch). The cuts' outputs are wrong and not read; a cut whose marker is
no longer in the source raises. With ``--parent-csrc DIR`` (an earlier
commit's ``vgan_tpu_torch/ops/cuda/csrc/`` with this tree's C interface)
the parent's kernels are read the same way, this tree's wrappers on them
(``_build.built_from``). The checks against the plain versions are
``chip_smoke.py``'s (phase 2). Prints the card's name and power limit
first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "examples"))

# (kernel, n1, n2, d)
SHAPES = (("K1 bf16", 500, 500, 640), ("K1 bf16", 500, 500, 1024), ("K1 bf16", 1100, 1013, 700),
          ("K1 bf16", 500, 500, 10240), ("K2 bf16", 500, 500, 10240))


def host_us(fn, calls: int = 50) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue, back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _cut(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"marker {old!r} occurs {src.count(old)} times")
    return src.replace(old, new)


def cuts(src: str) -> dict:
    """The sources with a part of the cluster kernel cut out (see the top)."""
    from torch_mmd_ladder_probe import variants as ladder_variants

    no_product = _cut(src, "        W::consume(n, same, ring, bars, acc);\n", "")
    no_product = _cut(no_product, "        W::produce(&rows_map, row0 + t.r0, &cols_map, t.c0, same, k0, n, "
                      "ring, bars);\n", "")
    no_launch = _cut(src, "    err = launch_clusters(cluster_gram_kernel<true, KP>,",
                     "    err = cudaSuccess;\n    if (false) launch_clusters(cluster_gram_kernel<true, KP>,")
    return {"no_ladder": ladder_variants(src)["stub"], "no_product": no_product,
            "no_cluster_launch": no_launch}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent-csrc", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_bf16_forward_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as S
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    print(S.card_identity(), flush=True)
    device = torch.device("cuda")
    mults = M.bandwidth_multipliers()
    G._lib()
    fns = {"this tree": (G.gram_quadrant_sums_bf16, G.gram_quadrant_sums_stash_bf16)}
    with tempfile.TemporaryDirectory() as tmp:
        dirs = S.variant_dirs("mmd_gram", _build.CSRC,
                              cuts((_build.CSRC / "mmd_gram.cu").read_text()), Path(tmp))
        if args.parent_csrc:
            dirs["parent"] = args.parent_csrc

        def on(fn, csrc):
            def call(*a):
                with _build.built_from("mmd_gram", csrc):
                    return fn(*a)
            return call

        for name, csrc in dirs.items():
            fns[name] = (on(G.gram_quadrant_sums_bf16, csrc),
                         on(G.gram_quadrant_sums_stash_bf16, csrc))
        for kernel, n1, n2, d in SHAPES:
            stash = kernel == "K2 bf16"
            _, _, z, norms, bw = S.gram_inputs(n1, n2, d, 61, device)
            for who, pair in fns.items():
                call = lambda: pair[stash](z, norms, bw, n1, mults)  # noqa: E731
                passes = S.device_split(call, calls=20)
                host = statistics.median(host_us(call) for _ in range(3))
                saved = G.launch  # the wrapper's Python alone: the C entry not called
                G.launch = lambda *a: None
                try:
                    python = statistics.median(host_us(call) for _ in range(3))
                finally:
                    G.launch = saved
                print(f"  {kernel} m={n1 + n2} d={d} {who}: host {host:.1f} us a call ({python:.1f} "
                      f"of it the wrapper's Python); device {sum(passes.values()):.2f} us a call: "
                      + "; ".join(f"{k} {v:.2f}" for k, v in
                                  sorted(passes.items(), key=lambda kv: -kv[1])), flush=True)
            del z, norms
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
