#!/usr/bin/env python3
"""Where K3's time goes, on one NVIDIA GPU.

    python3 examples/torch_flash_bwd_probe.py [--parent-csrc DIR] [--large]

K3 is ``gram_backward_flash`` (``vgan_tpu_torch/ops/cuda/csrc/mmd_gram.cu``,
entry ``vgan_gram_backward_flash``): ``S @ z`` and ``rowsum(S)`` with
``S = coeff .* K'(d2)``. At the kl stress fit's Gram (m = 1000, d = 640) and
the flash fit's (m = 1000, d = 1024) the probe splits one call into:

- the d2 product: a build whose ladder is two products and whose ``S @ z``
  is cut out (a checksum of what it would read still goes out, so nothing
  is dead);
- the ladder: the build with the ladder and without ``S @ z``, less the
  previous one;
- ``S @ z``: the whole kernel less the previous one;
- and, from ``torch.profiler``, the device time of each kernel a call
  launches (the copies of z, the passes of the d2 product and of S, the
  sum of the partials).

Each variant is the source with a part cut out by text substitution,
built with ``nvcc`` (one each, started together), and timed in turns
through the package's wrapper (``_build.built_from``; CUDA events, median
of 20 calls). With ``--parent-csrc DIR`` (an earlier commit's
``vgan_tpu_torch/ops/cuda/csrc/`` with this tree's C interface) the
parent's kernel is split the same way in the same call, through this
tree's wrapper.
``--large`` also times the whole kernel at m = 40960, d = 1024 (3 calls)
with its bytes allocated beyond the inputs. Prints the card's name and
power limit first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

VARIANTS = ("whole", "no_sz", "no_sz_stub")


def _cut(src: str, start: str, end: str, repl: str) -> str:
    """``src`` with the text from ``start`` up to (not including) ``end``
    replaced by ``repl``; ``start`` must occur once."""
    if src.count(start) != 1:
        raise ValueError(f"marker {start!r} occurs {src.count(start)} times")
    i = src.index(start)
    return src[:i] + repl + src[src.index(end, i):]


# The pipelined design: S @ z's 16-row step reduced to a checksum of its
# operands, and the ladder to one product.
_S_Z_CHECKSUM = """__device__ __forceinline__ void s_z_step(const float* As, const float* Bs, float (&out)[ST][ST]) {
    out[0][0] += As[threadIdx.x] + Bs[threadIdx.x];"""
_LADDER = "ladder_call<false, true>(d2, bw, L, k, kp);"


def variants(src: str) -> dict:
    no_sz = _cut(src, "__device__ __forceinline__ void s_z_step(", "\n}\n", _S_Z_CHECKSUM)
    if no_sz.count(_LADDER) != 1:
        raise ValueError(f"marker {_LADDER!r} occurs {no_sz.count(_LADDER)} times")
    return {"whole": src, "no_sz": no_sz,
            "no_sz_stub": no_sz.replace(_LADDER, "k = 0.f, kp = d2 * 1e-6f;")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent-csrc", type=Path, default=None)
    parser.add_argument("--large", action="store_true")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_flash_bwd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as S
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    print(S.card_identity(), flush=True)
    device = torch.device("cuda")
    mults = M.bandwidth_multipliers()
    dirs = {"this tree": _build.CSRC}
    if args.parent_csrc:
        dirs["parent"] = args.parent_csrc
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for who, csrc in dirs.items():
            texts = variants((csrc / "mmd_gram.cu").read_text())
            root = Path(tmp) / who.replace(" ", "_")
            for name, built in S.variant_dirs("mmd_gram", csrc, texts, root).items():
                builds[who, name] = built

        def bind(built):
            """K3 of the build in ``built``, a drop-in for gram_backward_flash."""
            def flash(*call):
                with _build.built_from("mmd_gram", built):
                    return G.gram_backward_flash(*call)
            return flash

        fns = {key: bind(built) for key, built in builds.items()}
        b = 500
        for d in (640, 1024):
            _, _, z, norms, bw = S.gram_inputs(b, b, d, 21, device)
            call = (z, norms, bw, b, b, mults)
            want = G.gram_backward_flash_reference(*call)
            times, passes = {}, {}
            for who in dirs:
                got = fns[who, "whole"](*call)
                S.check(all(S.max_abs(u, v) <= S.GRAD_FRAC * float(torch.max(torch.abs(v)))
                            for u, v in zip(got, want)),
                        f"{who}: K3 disagrees with the plain version")
                passes[who] = S.device_split(lambda: fns[who, "whole"](*call), calls=20)
            order = [(who, v) for who in dirs for v in VARIANTS]
            for key in order + order[::-1]:
                times.setdefault(key, []).append(S.cuda_ms(lambda: fns[key](*call), 20, 3))
            for who in dirs:
                t = {v: sum(times[who, v]) / 2 for v in VARIANTS}
                p = passes[who]
                print(f"  K3 m={2 * b} d={d} {who}: whole "
                      f"{', '.join(f'{x:.4f}' for x in times[who, 'whole'])} ms; d2 product "
                      f"{t['no_sz_stub']:.4f}; ladder {t['no_sz'] - t['no_sz_stub']:.4f}; S @ z "
                      f"{t['whole'] - t['no_sz']:.4f} ms (by the builds); by kernel (profiler, "
                      f"us a call): " + "; ".join(
                          f"{k} {v:.2f}" for k, v in sorted(p.items(), key=lambda kv: -kv[1])),
                      flush=True)
            del z, norms
        if args.large:
            n1, n2, d = S.K1_LARGE
            z, norms, bw = S.large_gram_inputs(n1 + n2, d, 24, device)
            call = (z, norms, bw, n1, n2, mults)
            for who in dirs:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fns[who, "whole"](*call)
                torch.cuda.synchronize()
                extra = torch.cuda.max_memory_allocated() - base
                ms = S.cuda_ms(lambda: fns[who, "whole"](*call), 3, 1)
                print(f"  K3 m={n1 + n2} d={d} {who}: {ms:.4f} ms; {extra} bytes allocated "
                      f"beyond the inputs (z itself {4 * z.numel()} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
