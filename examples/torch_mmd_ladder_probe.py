#!/usr/bin/env python3
"""What the bandwidth ladder costs in the MMD-Gram kernels K1 and K4 on one
NVIDIA GPU.

    python3 examples/torch_mmd_ladder_probe.py

Builds three variants of ``vgan_tpu_torch/ops/cuda/csrc/mmd_gram.cu`` that
differ only in the body of ``ladder_call`` (the ladder behind K1, K2 and
K4's epilogues):

- ``chain``: the source as it is (power-of-two powers off one squaring chain);
- ``int_pow``: ``ladder_eval``, each power by its own square-and-multiply
  loop (the ladder K3 still inlines);
- ``stub``: two products in place of the ladder, a floor with wrong values.

and times K1 and K4 with each, in turns (chain, int_pow, stub, stub,
int_pow, chain; CUDA events, median of 20 calls, 3 at the large shapes) at
m=1000 (the kl, flash and panel fits' Grams), at a ragged m in mode (a)
(2113, d=700), at m=40960, d=1024 and on one real panel (m=45056, d=10240,
R=1472). ``chain`` and ``int_pow`` must give equal bits. Prints the card's
name and power limit first. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

BODY = "    ladder_eval<WANT_K, WANT_KP>(d2, bw, L, k, kp);\n}"


def variants(src: str) -> dict:
    """The three sources, from ``ladder_call``'s body in ``src``."""
    start = src.index("__device__ __noinline__ void ladder_call(")
    open_ = src.index("{", start)
    close = src.index("\n}\n", open_) + 2
    body_of = {
        "chain": src[open_ + 2:close],
        "int_pow": BODY,
        "stub": "    k = d2 * 1e-3f;\n    kp = d2 * 1e-6f;\n}",
    }
    return {name: src[:open_ + 2] + body + src[close:] for name, body in body_of.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mmd_ladder_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as S
    from vgan_tpu_torch.ops import mmd as M
    from vgan_tpu_torch.ops.cuda import _build
    from vgan_tpu_torch.ops.cuda import mmd_gram as G

    print(S.card_identity(), flush=True)
    device = torch.device("cuda")
    mults = M.bandwidth_multipliers()
    sources = variants((_build.CSRC / "mmd_gram.cu").read_text())
    with tempfile.TemporaryDirectory() as tmp:
        dirs = S.variant_dirs("mmd_gram", _build.CSRC, sources, Path(tmp))

        def run(label, fn, iters):
            times, outs = {}, {}
            for name in ("chain", "int_pow", "stub", "stub", "int_pow", "chain"):
                with _build.built_from("mmd_gram", dirs[name]):
                    times.setdefault(name, []).append(S.cuda_ms(fn, iters, 1))
                    outs[name] = fn()
            S.check(torch.equal(outs["chain"], outs["int_pow"]),
                    f"{label}: the chain ladder and int_pow differ")
            print(f"  {label}: " + "; ".join(
                f"{name} {t[0]:.4f}, {t[1]:.4f}" for name, t in times.items()) + " ms", flush=True)

        b = 500
        for d in (640, 1024, 10240):
            _, _, z, norms, bw = S.gram_inputs(b, b, d, 21, device)
            run(f"K1 m=1000 d={d}", lambda: G.gram_quadrant_sums(z, norms, bw, b, mults), 20)
        cols_t = G.panel_operand(z)
        run("K4 R=C=1000 d=10240 offset 0",
            lambda: G.kprime_panel(z, z, norms, norms, bw, mults, offset=0, cols_t=cols_t), 20)
        _, _, z, norms, bw = S.gram_inputs(1100, 1013, 700, 21, device)
        run("K1 m=2113 d=700 (mode a)", lambda: G.gram_quadrant_sums(z, norms, bw, 1100, mults), 20)
        n1, n2, d = S.K1_LARGE
        z, norms, bw = S.large_gram_inputs(n1 + n2, d, 24, device)
        run(f"K1 m={n1 + n2} d={d}", lambda: G.gram_quadrant_sums(z, norms, bw, n1, mults), 3)
        del z, norms, cols_t
        torch.cuda.empty_cache()
        rp = S.K4_REAL_PANEL
        m = rp["n1"] + rp["n2"]
        z, norms, bw = S.large_gram_inputs(m, rp["d"], 25, device)
        cols_t = G.panel_operand(z)
        R, off = G._panel_rows(m), rp["offset"]
        zr, nr = z[off:off + R], norms[off:off + R]
        run(f"K4 R={R} C={m} d={rp['d']} offset {off}",
            lambda: G.kprime_panel(zr, z, nr, norms, bw, mults, offset=off, cols_t=cols_t), 3)
    return 0


if __name__ == "__main__":
    sys.exit(main())
