#!/usr/bin/env python3
"""Where K6's time goes at the bench ensemble's shape, on one NVIDIA GPU.

    python3 examples/torch_knn_probe.py [--parent-csrc DIR]

K6 is ``knn_scores_resident`` (``vgan_tpu_torch/ops/cuda/csrc/knn_score.cu``,
entry ``vgan_knn_resident``). At the bench ensemble's shape (1024 masks of
about 30% of d = 100, 500 test x 1000 train rows, k = 10, mode 'kth') the
probe splits one call into four parts:

- the wrapper's passes (the operands: each mask's column list and the
  rows' column-major copies), device time by kernel from ``torch.profiler``;
- the product alone: a build of the kernel source whose selection is cut
  out (the accumulators are summed into the output, so nothing is dead);
- the distance tile's round trip (the parent design's d2 tile written to
  shared memory and read back; in the current design the distances formed
  and filtered against a threshold no candidate passes);
- selection: the whole kernel less the previous variant.

Each variant is the source with a part cut out by text substitution,
built with ``nvcc`` (one each, started together), launched on the same
prepared operands (the wrapper's passes are not in these times) and timed
in turns (CUDA events, median of 20 calls). With ``--parent-csrc DIR``
(an earlier commit's ``vgan_tpu_torch/ops/cuda/csrc/``) the parent's kernel
is split the same way in the same call. The whole kernel's scores must equal those of this
tree's library to the bit. Prints the card's name and power limit first.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BENCH = dict(nt=500, ntr=1000, d=100, nm=1024, k=10, seed=22)


def _between(src: str, start: str, end: str, repl: str) -> str:
    """``src`` with the text from ``start`` up to (not including) ``end``
    replaced by ``repl``; each marker must occur once."""
    for marker in (start, end):
        if src.count(marker) != 1:
            raise ValueError(f"marker {marker!r} occurs {src.count(marker)} times")
    i = src.index(start)
    j = src.index(end, i)
    return src[:i] + repl + src[j:]


# The d2-tile design (``knn_kernel``: product, d2 tile in shared memory,
# serial insertion by two threads a row, merge).
_TILE_CHECKSUM = """        {
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < TM; ++r)
#pragma unroll
                for (int c = 0; c < TN; ++c) s += acc[r][c];
            chk += s;
        }
"""
_OUT_CHECKSUM = """    if (tid < BT && i0 + tid < nt) out[(size_t)m * nt + i0 + tid] = chk;
}
"""


def _tile_design(src: str) -> dict:
    d2 = "        // the d2 tile:"
    ins = "        // insertion into this thread's sorted k-list"
    merge = "    // merge the two lists of each row"
    loop = "    for (int j0 = 0; j0 < ntr; j0 += BR) {"
    end_of_kernel = "int launch_knn("
    src = src.replace(loop, "    float chk = 0.f;\n" + loop, 1)
    tail = _OUT_CHECKSUM + "\n"
    product = _between(src, d2, "        __syncthreads();\n    }\n\n    // merge",
                       _TILE_CHECKSUM)
    product = _between(product, merge, end_of_kernel, tail)
    tile = _between(src, ins, "        __syncthreads();\n    }\n\n    // merge",
                    "        chk += D2[(tid % BT) * (BR + 1) + tid / BT];\n")
    tile = _between(tile, merge, end_of_kernel, tail)
    return {"whole": src, "product": product, "tile": tile}


# The register-filter design (``knn_resident_kernel``): after the product
# a checksum of the accumulators and on to the next tile; or the distances
# formed and filtered against a threshold no candidate passes, the tiles'
# lane minima summed.
_STEPS = "    int step = 0;\n    for (int t = 0; t < ntiles; ++t) {\n"
_DISTANCES = "        // the distances, in place:"
_LANE_BOUND = "                thr[r] = fminf(thr[r], nextafterf(kth_of_lanes(lmin, k), INFINITY));\n"
_SCORE = ("    if (tid < BT && i0 + tid < nt) write_score(L, k, mean, tid, "
          "out + (size_t)m * nt + i0 + tid);\n")


def _after(src: str, anchor: str, old: str, new: str) -> str:
    """``src`` with the first ``old`` after ``anchor`` replaced by ``new``;
    ``anchor`` must occur once."""
    if src.count(anchor) != 1:
        raise ValueError(f"marker {anchor!r} occurs {src.count(anchor)} times")
    j = src.index(old, src.index(anchor))
    return src[:j] + new + src[j + len(old):]


def _filter_design(src: str) -> dict:
    kernel = "knn_resident_kernel(const float*"
    base = _after(src, kernel, _STEPS, "    float chk = 0.f;\n" + _STEPS)
    base = _after(base, kernel, _SCORE,
                  "    if (tid < BT && i0 + tid < nt) out[(size_t)m * nt + i0 + tid] = chk;\n")
    product = _after(base, kernel, _DISTANCES, """#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
            for (int c = 0; c < TN; ++c) chk += acc[r][c];
        continue;
""" + _DISTANCES)
    tile = _after(base, kernel, _LANE_BOUND,
                  _LANE_BOUND + "            thr[r] = -1.f;\n            chk += lmin;\n")
    return {"whole": src, "product": product, "tile": tile}


def variants(src: str) -> dict:
    if "knn_resident_kernel" in src:
        return _filter_design(src)
    return _tile_design(src)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent-csrc", type=Path, default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_knn_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as S
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import knn_score as KS

    print(S.card_identity(), flush=True)
    device = torch.device("cuda")
    b = BENCH
    xte, xtr, masks = S.knn_inputs(b["nt"], b["ntr"], b["d"], b["nm"], b["seed"], device)
    k = b["k"]
    print(f"bench shape: {b['nm']} masks ({int(masks.sum())} selected columns), "
          f"{b['nt']} x {b['ntr']}, d={b['d']}, k={k}", flush=True)

    # 1. the wrapper's passes and the kernel, by device kernel
    split = S.device_split(lambda: KS.knn_scores_all_masks(xte, xtr, masks, k), calls=20)
    print("  one call by device kernel (profiler, us): " + "; ".join(
        f"{name} {us:.2f}" for name, us in sorted(split.items(), key=lambda kv: -kv[1])),
        flush=True)
    print(f"  the whole call: {S.cuda_ms(lambda: KS.knn_scores_all_masks(xte, xtr, masks, k)):.4f}"
          " ms (CUDA events, median of 20)", flush=True)

    # 2. the kernel's parts, on operands prepared once
    xte_t, xtr_t, cols, counts = KS.kernel_operands(xte, xtr, masks)
    out = torch.empty((b["nm"], b["nt"]), dtype=torch.float32, device=device)
    dirs = {"this tree": _build.CSRC}
    if args.parent_csrc:
        dirs["parent"] = args.parent_csrc
    with tempfile.TemporaryDirectory() as tmp:
        libs = {}
        for who, csrc in dirs.items():
            texts = variants((csrc / "knn_score.cu").read_text())
            for name, built in S.variant_dirs("knn_score", csrc, texts, Path(tmp) / who).items():
                with _build.built_from("knn_score", built):
                    libs[who, name] = KS._lib()

        def launch(lib):
            _build.launch(lib, "vgan_knn_resident", device, xte_t.data_ptr(), xte_t.shape[1],
                          xtr_t.data_ptr(), xtr_t.shape[1], cols.data_ptr(), counts.data_ptr(),
                          b["nm"], b["nt"], b["ntr"], b["d"], k, 0, 0, out.data_ptr())

        want = KS.knn_scores_all_masks(xte, xtr, masks, k)
        for who in dirs:
            launch(libs[who, "whole"])
            S.check(torch.equal(out, want),
                    f"{who}: the whole kernel's scores differ from this tree's library")
        times = {}
        order = [(who, v) for who in dirs for v in ("whole", "product", "tile")]
        for key in order + order[::-1]:
            times.setdefault(key, []).append(S.cuda_ms(lambda: launch(libs[key]), 20, 3))
        for who in dirs:
            t = {v: sum(times[who, v]) / 2 for v in ("whole", "product", "tile")}
            print(f"  {who}: whole {', '.join(f'{x:.4f}' for x in times[who, 'whole'])} ms; "
                  f"product alone {t['product']:.4f}; distance tile round trip "
                  f"{t['tile'] - t['product']:.4f}; selection {t['whole'] - t['tile']:.4f} ms "
                  f"(product {', '.join(f'{x:.4f}' for x in times[who, 'product'])}, with the "
                  f"tile {', '.join(f'{x:.4f}' for x in times[who, 'tile'])})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
