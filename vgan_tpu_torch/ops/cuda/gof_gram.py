"""Streaming-Gram permutation test at large sample counts, through the K5
kernel (counterpart of ``vgan_tpu.ops.pallas.gof_gram``).

The permutation MMD test needs, for every indicator row ``a_p`` of the
pooled samples, the quadratic forms of the per-alpha Grams
``K_a = exp(-alpha d2)``. :func:`a_times_k` computes ``C_a = A @ K_a`` for
every alpha in one distance pass (``csrc/gof_gram.cu``), recomputing K tile
by tile, with the diagonal zeroed (the unbiased statistic excludes
self-pairs) and the accumulation over the reduction axis Kahan-compensated.
No m x m buffer exists at any point. All statistics then come from C and A
in O(P m):

    s_xx(p) = sum_i A[p, i] C[p, i],   s_xy(p) = sum_i (1 - A[p, i]) C[p, i],
    s_yy(p) = 1^T K 1 - s_xx(p) - 2 s_xy(p).

The unbiased statistic is a near-cancellation of O(m^2)-entry sums: under
the null it sits near 1e-7 while float32 final sums carry rounding of order
one, so ``precise=True`` fetches the C planes and reduces the quadratic
forms in float64 on the host.

:func:`a_times_k` given CPU tensors returns its plain version
(:func:`a_times_k_reference`); given CUDA tensors it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from vgan_tpu_torch.ops.cuda.mmd_gram import _check, _launch, _ptr
from vgan_tpu_torch.ops.mmd_test import _indicators, _pooled

# Alphas per kernel pass (the size of the kernel's alpha table); longer
# sweeps run one pass per chunk, each re-streaming the distances.
MAX_ALPHAS_PER_PASS = 8
# Indicator rows per call of the kernel: the C planes of one block of rows,
# n_alphas x rows x m float32, stay within this many bytes (the kernel's
# Kahan compensation takes as much again).
ROW_BLOCK_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def a_times_k_reference(z, norms, a, alphas) -> torch.Tensor:
    """``C[k] = a @ K_k`` with ``K_k = exp(-alphas[k] d2)``, the Gram's
    diagonal zeroed; d2 materialized as the kernel forms it,
    ``(-2 z z^T + |z_i|^2) + |z_j|^2`` clamped at 0. (n_alphas, P, m), in
    the inputs' dtype."""
    d2 = torch.clamp_min(-2.0 * (z @ z.T) + norms[:, None] + norms[None, :], 0.0)
    off_diag = ~torch.eye(z.shape[0], dtype=torch.bool, device=z.device)
    return torch.stack([a @ torch.where(off_diag, torch.exp(-float(al) * d2), 0.0)
                        for al in alphas])


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


class _Alphas(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("a", ctypes.c_float * MAX_ALPHAS_PER_PASS)]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vgan_gof_a_times_k": [_P, _P, _P, _I, _I, _I, ctypes.POINTER(_Alphas), _P, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from vgan_tpu_torch.ops.cuda import _build

    lib = _build.load("gof_gram")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _launch_pass(z, norms, a, alphas) -> torch.Tensor:
    m, d = z.shape
    P = a.shape[0]
    table = _Alphas()
    table.n = len(alphas)
    for i, al in enumerate(alphas):
        table.a[i] = al
    c = torch.empty((len(alphas), P, m), dtype=torch.float32, device=z.device)
    comp = torch.empty_like(c)
    _launch("vgan_gof_a_times_k", z.device, _ptr(z), _ptr(norms), _ptr(a), m, d, P,
            ctypes.byref(table), _ptr(c), _ptr(comp), lib=_lib())
    a_times_k.launches += 1
    return c


def a_times_k(z, norms, a, alphas: Sequence[float]) -> torch.Tensor:
    """``C_a = A @ K_a(z)`` for every alpha, (n_alphas, P, m) float32:
    ``z`` (m, d) the unpadded pooled rows, ``norms`` (m,) their squared
    norms, ``a`` (P, m) the indicator rows. One launch per
    ``MAX_ALPHAS_PER_PASS`` alphas."""
    alphas = [float(al) for al in alphas]
    if not z.is_cuda:
        return a_times_k_reference(z, norms, a, alphas)
    m, d = z.shape
    _check("z", z, (m, d), z.device)
    _check("norms", norms, (m,), z.device)
    _check("a", a, (a.shape[0], m), z.device)
    if not alphas:
        raise ValueError("a_times_k needs at least one alpha")
    parts = [_launch_pass(z, norms, a, alphas[i:i + MAX_ALPHAS_PER_PASS])
             for i in range(0, len(alphas), MAX_ALPHAS_PER_PASS)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def reset_launch_counts() -> None:
    a_times_k.launches = 0


def launch_counts() -> dict:
    return {"a_times_k": a_times_k.launches}


reset_launch_counts()


# ---------------------------------------------------------------------------
# statistics and the tiled permutation tests
# ---------------------------------------------------------------------------


def _stats_from_c(c, a, totals, n1: int, n2: int) -> torch.Tensor:
    """(n_alphas, rows) unbiased statistics from C planes (n_alphas, rows,
    m), indicator rows ``a`` and the pooled off-diagonal totals."""
    s_xx = torch.einsum("apm,pm->ap", c, a)
    s_xy = torch.einsum("apm,pm->ap", c, 1.0 - a)
    s_yy = totals[:, None] - s_xx - 2.0 * s_xy
    return (
        s_xx / (n1 * (n1 - 1))
        + s_yy / (n2 * (n2 - 1))
        - 2.0 * s_xy / (n1 * n2)
    )


def _stats_for_rows(a_rows, z, norms, alphas, n1: int, n2: int, precise: bool = False):
    """Unbiased two-sample MMD statistics for a block of indicator rows.

    ``a_rows`` is (n_rows, m); rows are independent (C = A @ K row-wise).
    They go to the kernel in blocks of at most ``ROW_BLOCK_BYTES`` of C
    planes; the first block carries one all-ones row more, whose C row sums
    to the pooled total ``1^T K_offdiag 1``. Returns (n_alphas, n_rows):
    float32 on the rows' device, or with ``precise=True`` float64 on the CPU,
    reduced from the fetched C planes.
    """
    n_rows, m = a_rows.shape
    per_block = max(1, ROW_BLOCK_BYTES // (4 * len(alphas) * m))
    ones = torch.ones((1, m), dtype=a_rows.dtype, device=a_rows.device)
    chunks, totals = [], None
    for start in range(0, n_rows, per_block):
        block = a_rows[start:start + per_block]
        n_blk = block.shape[0]
        rows = torch.cat([block, ones]) if totals is None else block
        c = a_times_k(z, norms, rows.contiguous(), alphas)
        if precise:
            c, block = c.cpu().double(), block.cpu().double()
        if totals is None:
            totals = c[:, n_blk].sum(dim=1)
        chunks.append(_stats_from_c(c[:, :n_blk], block, totals, n1, n2))
    return torch.cat(chunks, dim=1)


def _tiled_stats(x, y, alphas, generator, n_permutations, precision, permutations, mesh,
                 device) -> torch.Tensor:
    """(n_alphas, 1 + P) statistics of the observed split, then of each
    permutation: float32 pooled rows and the [observed; permutations]
    indicator rows on one device, through :func:`_stats_for_rows`."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (the permutation rows sharded over devices) is not ported "
            "yet; see ROADMAP.md Queue 1, item 14"
        )
    if precision not in ("float32", "float64"):
        raise ValueError(f"precision must be 'float32' or 'float64', got {precision!r}")
    z, n1, n2 = _pooled(x, y, device)
    z = z.to(torch.float32).contiguous()
    norms = torch.sum(z * z, dim=1)
    base = torch.cat([torch.ones(n1), torch.zeros(n2)]).to(device=z.device, dtype=torch.float32)
    if permutations is None:
        permutations = _indicators(n1, n2, n_permutations, generator, torch.float32, z.device)
    perms = torch.as_tensor(permutations, dtype=torch.float32, device=z.device)
    a_rows = torch.cat([base[None, :], perms])
    alphas = [float(al) for al in torch.as_tensor(alphas, dtype=torch.float64).reshape(-1)]
    return _stats_for_rows(a_rows, z, norms, alphas, n1, n2, precise=precision == "float64")


def mmd_permutation_test_tiled_sweep(
    x,
    y,
    alphas,
    generator: Optional[torch.Generator] = None,
    n_permutations: int = 1000,
    precision: str = "float32",
    permutations=None,
    mesh=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-alpha large-m permutation tests in one distance-stream pass.

    Returns ``(statistics, p_values)``, each (n_alphas,). Same statistic and
    permutation semantics as ``ops.mmd_test.mmd_permutation_test_sweep``;
    the per-alpha Grams never materialize. ``precision='float64'`` reduces
    the final quadratic forms in float64 on the host (required for valid
    p-values near the null; the results are then CPU float64 tensors).
    ``permutations``: an optional pre-drawn (P, m) 0/1 matrix whose rows sum
    to n1, in place of the ``generator`` draw. ``device`` as in
    ``mmd_permutation_test_sweep``.
    """
    stats = _tiled_stats(x, y, alphas, generator, n_permutations, precision,
                         permutations, mesh, device)
    observed = stats[:, 0]
    pvals = torch.mean((stats[:, 1:] >= observed[:, None]).to(stats.dtype), dim=1)
    return observed, pvals


def mmd_permutation_test_tiled(
    x,
    y,
    alphas,
    generator: Optional[torch.Generator] = None,
    n_permutations: int = 1000,
    precision: str = "float32",
    permutations=None,
    mesh=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Large-m counterpart of ``mmd_permutation_test``: one test on the
    summed-alpha kernel (C is linear in K, so the per-alpha statistics
    sum). Returns the scalar ``(statistic, p_value)``."""
    stats = _tiled_stats(x, y, alphas, generator, n_permutations, precision,
                         permutations, mesh, device).sum(dim=0)
    observed = stats[0]
    return observed, torch.mean((stats[1:] >= observed).to(stats.dtype))
