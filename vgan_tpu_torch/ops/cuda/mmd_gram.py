"""Hand-written CUDA kernels for the multi-bandwidth RBF MMD, and their VJP.

Counterpart of ``vgan_tpu.ops.pallas.mmd_gram``. Four kernels
(``csrc/mmd_gram.cu``), each behind a wrapper with a launch counter and a
plain PyTorch version beside it:

- :func:`gram_quadrant_sums` (forward quadrant sums XX, XY, YY);
- :func:`gram_quadrant_sums_stash` (the same plus the (m, m) K'(d2));
- :func:`gram_backward_flash` (``S @ z`` and ``rowsum(S)`` with S the
  coefficient-weighted K', no m^2 buffer; :func:`flash_schedule`);
- :func:`kprime_panel` (an (R, C) K'(d2) row panel).

Each has a bf16-operand variant (:func:`gram_quadrant_sums_bf16`,
:func:`gram_quadrant_sums_stash_bf16`, :func:`gram_backward_flash_bf16`,
:func:`kprime_panel_bf16`), the kernels of ``matmul_dtype='bfloat16'``:
same arguments, the distance product on z rounded to bf16 (on the tensor
cores), the norms given (the f32 z's) and everything after the product
f32. K3's variant multiplies S with the rounded z, as the Pallas kernel does.
Their plain versions are the f32 ones on the rounded operands
(:func:`rounded`); each variant counts its own launches. They have a Hopper
design of their own: one pass rounds z to a row-major bf16 copy, read
through TMA, and the products run on the tensor cores (``wgmma``). The bf16
forward (K1 bf16, K2 bf16) and K4 bf16 split each tile's d axis over the
CTAs of a thread-block cluster that add their partial tiles in shared
memory (:func:`cluster_schedule`, :func:`panel_bf16_schedule`); K3 bf16
forms each S tile once in a cluster, as three bf16 terms that sum to it
exactly (:func:`split_bf16x3`), and multiplies them with z on the tensor
cores (:func:`flash_cluster_schedule`).

All four run on 128 x 128 tiles; :func:`tile_schedule` picks, from the
number of tiles a launch forms (:func:`tile_pairs`, :func:`panel_blocks`),
whether the summed d axis is split over the card (mode (b)) or each tile
runs its epilogue in registers (mode (a)). K3 also splits the column tiles
of the square into runs (:func:`flash_schedule`).

A wrapper given CPU tensors returns its plain version; given CUDA tensors it
launches its kernel or raises. The wrappers take the unpadded (m, d) rows:
the kernels mask their own ragged edges, which is equivalent to the JAX
functions' zero padding (padded rows are masked out of every sum there, and
padded columns add zero to every distance).

:class:`_MMD2Core` mirrors ``_mmd2_core`` / ``_mmd2_fwd`` / ``_mmd2_bwd``:
the regime (flash, stash or panel) is the same function of (m, d) as in the
JAX package, through the padded layout of ``_pad_layout``. The backward is
rank-1: with ``q_i = 1/n1`` on x rows and ``-1/n2`` on y rows,
``S = (q q^T) .* K'`` and ``dz = 4 g (rowsum(S) z - S @ z)``. No gradient
flows to the bandwidth. With ``matmul_dtype='bfloat16'`` it takes the bf16
variants and keeps the JAX backward's operands: the norms always from the
f32 z; the stash backward contracts K' with the f32 z; the flash backward's
``S @ z`` is on the rounded z and ``rowsum(S) z`` on the f32 z; the panel
backward's panels come from the rounded z and its ``K' @ (q .* z)`` from
the f32 z.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from vgan_tpu_torch._dtypes import low_precision
from vgan_tpu_torch.ops import mmd as _mmd
from vgan_tpu_torch.utils.profiling import span

# The JAX package's tiling constants, kept because they decide the regime
# (the CUDA kernels use their own tiles).
TILE_M = 256
TILE_D = 512
FLASH_D_MAX = 2048
# Each streamed K' panel of the panel backward holds at most this many bytes.
PANEL_BYTES = 1 << 28
# Stash the (m, m) K' in the forward when it fits in this many bytes; set it
# to 0 to force the bounded-memory panel backward.
_KP_STASH_BYTES = 7 << 30
MAX_MULTS = 8
# The row granularity of the panel backward's panels.
PANEL_ROW_MULTIPLE = 64
# K3 splits the column tiles of the square into runs whose partial sums of
# S @ z (beyond the first run's, which goes straight to the output) stay
# within FLASH_SPLIT_BYTES.
FLASH_SPLIT_BYTES = 1 << 28
# The kernels' 128 x 128 tiles (SB in csrc/mmd_gram.cu) and the d-chunk of
# dist_tile.cuh (BK), of which a d slice is a multiple; d is split until
# tiles x slices give each SM this many blocks.
STASH_TILE = 128
STASH_BK = 16
STASH_BLOCKS_PER_SM = 2
# The bf16 forward (csrc/wgmma_tile.cuh) reads d in 64-column chunks (one
# TMA box under the 128-byte swizzle) and splits them over the CTAs of a
# cluster, at most the portable cluster size, one CTA an SM.
BF16_CHUNK = 64
CLUSTER_MAX = 8
# K3 bf16: output chunks (of BF16_CHUNK columns) a cluster, two a CTA
# (FC_GROUP in csrc/mmd_gram.cu); wider d runs in groups of them.
FLASH_GROUP_CHUNKS = 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def _pad_layout(m: int, d: int) -> Tuple[int, int, int]:
    """Padded (M, D, tile_d) of the JAX package's kernels."""
    M = _round_up(m, TILE_M)
    if d <= TILE_D:
        D = max(128, _round_up(d, 128))
        return M, D, D
    D = _round_up(d, TILE_D)
    return M, D, TILE_D


def _stash_kprime(M: int, D: int) -> bool:
    """Stash K' from the forward (only where the panel backward would
    otherwise recompute it)?"""
    return D > FLASH_D_MAX and M * M * 4 <= _KP_STASH_BYTES


def regime(m: int, d: int) -> str:
    """'stash', 'flash' or 'panel': the backward a training step takes."""
    M, D, _ = _pad_layout(m, d)
    if _stash_kprime(M, D):
        return "stash"
    return "flash" if D <= FLASH_D_MAX else "panel"


def cuda_supported(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Should ``impl='auto'`` take the kernels? CUDA tensors with a feature
    axis of at least a d-chunk, or enough samples that the dense Gram is
    traffic-bound (the JAX package's ``pallas_supported`` rule)."""
    if not (x.is_cuda and y.is_cuda) or x.ndim != 2 or y.ndim != 2:
        return False
    return x.shape[1] >= TILE_D or x.shape[0] + y.shape[0] >= 4096


# ---------------------------------------------------------------------------
# plain versions (the arithmetic of the Pallas kernels, on whole tensors)
# ---------------------------------------------------------------------------


def rounded(z: torch.Tensor) -> torch.Tensor:
    """z as the bf16 variants' distance product reads it: rounded to bf16
    (to nearest even), in float32."""
    return z.to(torch.bfloat16).to(z.dtype)


def _sq_dists(zr, zc, nr, nc):
    """d2 = (-2 zr . zc + |zr|^2) + |zc|^2, clamped at 0, as the kernels."""
    return torch.clamp_min(-2.0 * (zr @ zc.T) + nr[:, None] + nc[None, :], 0.0)


def _kernel_deriv(d2, bw, mults):
    """K'(d2) = -sum_k exp(-d2/(bw mk)) / (bw mk)."""
    ladder = _mmd.ladder_exponents(mults)
    kprime = torch.zeros_like(d2)
    if ladder is not None:
        base, ints = ladder
        t = torch.exp(-d2 / (bw * base))
        for mk, pw in zip(mults, _mmd.integer_powers(t, ints)):
            kprime = kprime - pw / (bw * mk)
        return kprime
    for mk in mults:
        kprime = kprime - torch.exp(-d2 / (bw * mk)) / (bw * mk)
    return kprime


def _quadrant_sums(k, n1):
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack(
        [k[:n1, :n1].sum(), k[:n1, n1:].sum(), k[n1:, n1:].sum(), zero]
    ).reshape(1, 4)


def gram_quadrant_sums_reference(z, norms, bw, n1, mults):
    d2 = _sq_dists(z, z, norms, norms)
    return _quadrant_sums(_mmd.multi_rbf_gram(d2, bw, mults), n1)


def _pair_once_quadrant_sums(k, n1):
    """[XX, XY, YY, 0] of a symmetric Gram from its diagonal and upper
    triangle, as K2 sums: each off-diagonal pair counts twice in XX and YY
    and once in XY (row < n1 <= col)."""
    upper = torch.triu(k, diagonal=1)
    diag = torch.diagonal(k)
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    return torch.stack([
        diag[:n1].sum() + 2.0 * upper[:n1, :n1].sum(),
        upper[:n1, n1:].sum(),
        diag[n1:].sum() + 2.0 * upper[n1:, n1:].sum(),
        zero,
    ]).reshape(1, 4)


def gram_quadrant_sums_stash_reference(z, norms, bw, n1, mults):
    d2 = _sq_dists(z, z, norms, norms)
    sums = _pair_once_quadrant_sums(_mmd.multi_rbf_gram(d2, bw, mults), n1)
    return sums, _kernel_deriv(d2, bw, mults)


def _coefficients(n1: int, n2: int):
    return 1.0 / (n1 * n1), 1.0 / (n2 * n2), -1.0 / (n1 * n2)


def gram_backward_flash_reference(z, norms, bw, n1, n2, mults):
    m = z.shape[0]
    cxx, cyy, cxy = _coefficients(n1, n2)
    coeff = torch.full((m, m), cxy, dtype=z.dtype, device=z.device)
    coeff[:n1, :n1] = cxx
    coeff[n1:, n1:] = cyy
    s = coeff * _kernel_deriv(_sq_dists(z, z, norms, norms), bw, mults)
    return s @ z, torch.sum(s, dim=1, keepdim=True)


def kprime_panel_reference(z_rows, z_cols, n_rows, n_cols, bw, mults):
    return _kernel_deriv(_sq_dists(z_rows, z_cols, n_rows, n_cols), bw, mults)


def split_bf16x3(s: torch.Tensor):
    """``(hi, mid, lo)``, bf16, with ``s = hi + mid + lo`` exactly for float32
    ``s`` (while lo is a normal number, |s| above about 2^-110): hi is s
    rounded to bf16 (to nearest even), mid the rest rounded, lo what is left.
    Each step takes 8 of f32's 24 significant bits and leaves an exact f32
    remainder. K3 bf16 multiplies the three with the bf16 z on the tensor
    cores (csrc/mmd_gram.cu ``split_bf16x3``), so that S @ z comes out to
    f32 rounding."""
    hi = s.to(torch.bfloat16)
    r1 = s - hi.to(s.dtype)
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.to(s.dtype)).to(torch.bfloat16)
    return hi, mid, lo


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


class _Ladder(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("use_pow", ctypes.c_int),
        ("base", ctypes.c_float),
        ("mult", ctypes.c_float * MAX_MULTS),
        ("pw", ctypes.c_int * MAX_MULTS),
    ]


@functools.lru_cache(maxsize=None)
def _ladder(mults: Tuple[float, ...]) -> _Ladder:
    if not 1 <= len(mults) <= MAX_MULTS:
        raise ValueError(f"the kernels take 1..{MAX_MULTS} bandwidths, got {len(mults)}")
    lad = _Ladder()
    lad.n = len(mults)
    structure = _mmd.ladder_exponents(mults)
    lad.use_pow = int(structure is not None)
    if structure is not None:
        lad.base = structure[0]
        for i, p in enumerate(structure[1]):
            lad.pw[i] = p
    for i, mk in enumerate(mults):
        lad.mult[i] = mk
    return lad


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "vgan_gram_quadrant_sums": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P],
    "vgan_gram_quadrant_sums_stash": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    "vgan_gram_backward_flash": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _I, _I, _P, _P, _P, _P],
    "vgan_transpose_pad": [_P, _I, _I, _I, _P, _P],
    "vgan_kprime_panel": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P],
    # (..., slices, scratch, sums[, kp], stream)
    "vgan_gram_quadrant_sums_bf16": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P],
    "vgan_gram_quadrant_sums_stash_bf16": [_P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P],
    # (..., ladder, cluster, nsplit, scratch, sz, rs, stream)
    "vgan_gram_backward_flash_bf16": [_P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _I, _I, _P, _P, _P,
                                      _P],
    "vgan_round_rows_bf16": [_P, _I, _I, _I, _P, _P],
    # (rows_b, row0, cols_b, ld, n_rows, n_cols, bw, R, C, d, diag, ladder,
    #  slices, kp, stream)
    "vgan_kprime_panel_bf16": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _P],
}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from vgan_tpu_torch.ops.cuda import _build

    lib = _build.load("mmd_gram")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _column_major(x: torch.Tensor, rows_multiple: int) -> torch.Tensor:
    """(d, N) float32 copy of the (n, d) rows ``x``, column-major, zero-padded
    to N = n rounded up to ``rows_multiple``: the operand layout of
    ``csrc/dist_tile.cuh``, where a column is one contiguous run of rows."""
    n, d = x.shape
    out = torch.zeros((d, _round_up(n, rows_multiple)), dtype=torch.float32, device=x.device)
    out[:, :n] = x.T
    return out


def _transposed(x: torch.Tensor, ld: int) -> torch.Tensor:
    """(d, ld) column-major copy of the (n, d) float32 rows ``x``, rows n ..
    ld zero: ``transpose_pad_kernel`` on the card, torch on the CPU."""
    n, d = x.shape
    if not x.is_cuda:
        out = torch.zeros((d, ld), dtype=torch.float32)
        out[:, :n] = x.T
        return out
    _check("x", x, (n, d), x.device)
    out = torch.empty((d, ld), dtype=torch.float32, device=x.device)
    _launch("vgan_transpose_pad", x.device, _ptr(x), n, d, ld, _ptr(out))
    return out


def _rounded_rows(x: torch.Tensor) -> torch.Tensor:
    """(n, ld) row-major copy of the (n, d) float32 rows ``x`` rounded to
    bf16, ld = d rounded up to 8 (a 16-byte row, as TMA wants), columns d ..
    ld zero: ``round_rows_kernel`` on the card, torch on the CPU."""
    n, d = x.shape
    ld = _round_up(d, 8)
    if not x.is_cuda:
        out = torch.zeros((n, ld), dtype=torch.bfloat16)
        out[:, :d] = x
        return out
    _check("x", x, (n, d), x.device)
    out = torch.empty((n, ld), dtype=torch.bfloat16, device=x.device)
    _launch("vgan_round_rows_bf16", x.device, _ptr(x), n, d, ld, _ptr(out))
    return out


def panel_operand(x: torch.Tensor, bf16: bool = False) -> torch.Tensor:
    """K4's column operand of the (n, d) rows ``x``. float32: column-major,
    one tile more than n rounded up to 128, so that a tile may start at any
    row below n (a panel's diagonal block starts at its row offset). bf16
    (for :func:`kprime_panel_bf16`): ``x`` rounded to bf16, row-major (n, d
    rounded up to 8), which the kernel reads through TMA (rows past n read
    as zeros)."""
    if bf16:
        return _rounded_rows(x)
    return _transposed(x, _round_up(x.shape[0], STASH_TILE) + STASH_TILE)


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(fn_name: str, device, *args, lib=None) -> None:
    """Call ``fn_name`` of ``lib`` (default: this module's library) on the
    current stream of ``device``; raise on a launch error."""
    lib = lib if lib is not None else _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name}: CUDA error {rc} at launch")


def _check_gram_inputs(z, norms, bw):
    m, d = z.shape
    _check("z", z, (m, d), z.device)
    _check("norms", norms, (m,), z.device)
    _check("bw", bw.reshape(1), (1,), z.device)
    return m, d


def tile_pairs(m: int) -> int:
    """Tile pairs J <= I of the symmetric (m, m) square in 128 x 128 tiles:
    the tiles K1 and K2 form."""
    tiles = _cdiv(m, STASH_TILE)
    return tiles * (tiles + 1) // 2


def tile_schedule(blocks: int, d: int, sms: int) -> Tuple[str, int, int]:
    """``(mode, slice, count)`` of a K1, K2 or K4 launch over ``blocks``
    tiles: the summed d axis in ``count`` slices of ``slice`` columns (the
    last one ragged), ``slice`` a multiple of ``STASH_BK``, so that blocks x
    slices give each of ``sms`` SMs at most ``STASH_BLOCKS_PER_SM`` blocks
    in one wave. Mode 'a' (one slice, once the tiles alone give more than
    half a wave): each block runs its epilogue on its own accumulators.
    Mode 'b': the partial dot tiles, at most one wave of them, go to
    scratch and a second pass adds them in slice order."""
    chunks = _cdiv(d, STASH_BK)
    want = max(1, min(STASH_BLOCKS_PER_SM * sms // blocks, chunks))
    slice_ = _cdiv(chunks, want) * STASH_BK
    count = _cdiv(d, slice_)
    return ("a" if count == 1 else "b"), slice_, count


def stash_slices(m: int, d: int, sms: int) -> Tuple[int, int]:
    """``(slice, count)`` of K1 and K2 over the tile pairs of m rows."""
    return tile_schedule(tile_pairs(m), d, sms)[1:]


def cluster_schedule(blocks: int, d: int, sms: int) -> Tuple[int, int]:
    """``(slices, clusters)`` of a K1 bf16 or K2 bf16 launch over ``blocks``
    tile pairs: a cluster of ``slices`` CTAs a tile pair, CTA q taking the
    64-column chunks [q n / slices, (q + 1) n / slices) of the n = cdiv(d,
    64), so that blocks x slices CTAs, one an SM, fill at most one wave of
    ``sms``; at most ``CLUSTER_MAX`` and at most n. Past a wave of tile
    pairs a cluster is one CTA over all of d. ``clusters``: the clusters of
    one wave."""
    slices = max(1, min(CLUSTER_MAX, sms // blocks, _cdiv(d, BF16_CHUNK)))
    return slices, sms // slices


def bf16_forward_scratch_floats(m: int, d: int, slices: int) -> int:
    """K1 bf16's and K2 bf16's scratch: z rounded to bf16, row-major (m x d
    rounded up to 8, two values a float), and three sums a CTA. No partial
    dot tile: a cluster adds its slices' tiles in shared memory."""
    return m * _round_up(d, 8) // 2 + 3 * tile_pairs(m) * slices


def _zt_floats(d: int, M: int) -> int:
    """Floats of scratch that the (d, M) column-major copy of z takes."""
    return d * M


def stash_scratch_floats(m: int, d: int, slice_: int) -> int:
    """K2's scratch, always mode (b)'s: the column-major padded z, the
    partial dot tile of every (tile pair, slice), and three sums per quarter
    of a tile pair."""
    pairs = tile_pairs(m)
    return (_zt_floats(d, _round_up(m, STASH_TILE))
            + _cdiv(d, slice_) * pairs * STASH_TILE ** 2 + 12 * pairs)


def quadrant_sums_scratch_floats(m: int, d: int, slice_: int) -> int:
    """K1's scratch: the column-major padded z, then in mode (a) (one slice)
    three sums per tile pair; in mode (b) the partial dot tile of every
    (tile pair, slice), at most one wave of them, and three sums per
    sixteenth of a tile pair (its epilogue's blocks). Never m^2."""
    pairs, count = tile_pairs(m), _cdiv(d, slice_)
    zt = _zt_floats(d, _round_up(m, STASH_TILE))
    if count == 1:
        return zt + 3 * pairs
    return zt + count * pairs * STASH_TILE ** 2 + 48 * pairs


def _quadrant_sums_launch(bf16: bool, stash: bool, z, norms, bw, n1: int, mults):
    """``(sums (1, 4), kp (m, m) or None)`` from K1 (K2 with ``stash``), on
    f32 operands (the d slices of :func:`stash_slices`) or bf16 ones (the
    clusters of :func:`cluster_schedule`)."""
    m, d = _check_gram_inputs(z, norms, bw)
    if bf16:
        split, _ = cluster_schedule(tile_pairs(m), d, _sms(z.device))
        size = bf16_forward_scratch_floats(m, d, split)
    else:
        split, _ = stash_slices(m, d, _sms(z.device))
        size = (stash_scratch_floats if stash else quadrant_sums_scratch_floats)(m, d, split)
    scratch = torch.empty(size, dtype=torch.float32, device=z.device)
    sums = torch.empty(4, dtype=torch.float32, device=z.device)
    kp = torch.empty((m, m), dtype=torch.float32, device=z.device) if stash else None
    _launch("vgan_gram_quadrant_sums" + ("_stash" if stash else "") + ("_bf16" if bf16 else ""),
            z.device,
            _ptr(z), _ptr(norms), _ptr(bw.reshape(1)), m, d, n1,
            ctypes.byref(_ladder(tuple(mults))), split, _ptr(scratch), _ptr(sums),
            *([_ptr(kp)] if stash else []))
    return sums.reshape(1, 4), kp


def gram_quadrant_sums(z, norms, bw, n1: int, mults) -> torch.Tensor:
    """Quadrant sums ``(1, 4)`` = [XX, XY, YY, 0] of ``K(d2(z, z))``."""
    if not z.is_cuda:
        return gram_quadrant_sums_reference(z, norms, bw, n1, mults)
    sums, _ = _quadrant_sums_launch(False, False, z, norms, bw, n1, mults)
    gram_quadrant_sums.launches += 1
    return sums


def gram_quadrant_sums_bf16(z, norms, bw, n1: int, mults) -> torch.Tensor:
    """:func:`gram_quadrant_sums` with d2 from ``rounded(z)`` and ``norms``."""
    if not z.is_cuda:
        return gram_quadrant_sums_reference(rounded(z), norms, bw, n1, mults)
    sums, _ = _quadrant_sums_launch(True, False, z, norms, bw, n1, mults)
    gram_quadrant_sums_bf16.launches += 1
    return sums


def gram_quadrant_sums_stash(z, norms, bw, n1: int, mults):
    """``(sums (1, 4), kp (m, m))``: the quadrant sums and K'(d2) in one call
    (K2: four launches on one stream, counted once)."""
    if not z.is_cuda:
        return gram_quadrant_sums_stash_reference(z, norms, bw, n1, mults)
    out = _quadrant_sums_launch(False, True, z, norms, bw, n1, mults)
    gram_quadrant_sums_stash.launches += 1
    return out


def gram_quadrant_sums_stash_bf16(z, norms, bw, n1: int, mults):
    """:func:`gram_quadrant_sums_stash` with d2 from ``rounded(z)`` and ``norms``."""
    if not z.is_cuda:
        return gram_quadrant_sums_stash_reference(rounded(z), norms, bw, n1, mults)
    out = _quadrant_sums_launch(True, True, z, norms, bw, n1, mults)
    gram_quadrant_sums_stash_bf16.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def flash_schedule(m: int, d: int, sms: int) -> Tuple[str, int, int]:
    """``(mode, slice, nsplit)`` of a K3 launch. The mode and d slice are
    K1's (:func:`tile_schedule` over the tile pairs): in mode (a) a block
    (row tile, split) forms each of its ordered dot tiles over all of d; in
    mode (b) a pass forms the partial dot tiles of every (tile pair, d
    slice), a second adds them into the S tiles, and a block (row tile,
    split, 128-column chunk of ``[z | 1]``) multiplies them with z.
    The column tiles go in ``nsplit`` runs of ``per = cdiv(tiles, nsplit)``
    tiles: the run length that finishes soonest in waves of
    ``STASH_BLOCKS_PER_SM * sms`` blocks (a block's time taken as its run
    length), the longer run on a tie, with the partials of runs 1 ..
    nsplit - 1 within ``FLASH_SPLIT_BYTES``."""
    tiles = _cdiv(m, STASH_TILE)
    mode, slice_, _ = tile_schedule(tile_pairs(m), d, sms)
    per_split = tiles * (flash_chunks(d) if mode == "b" else 1)  # blocks of one split
    wave = STASH_BLOCKS_PER_SM * sms
    slot = 4 * tiles * STASH_TILE * flash_chunks(d) * STASH_TILE
    best = None
    for per in range(tiles, 0, -1):
        nsplit = _cdiv(tiles, per)
        if nsplit > 1 and (nsplit - 1) * slot > FLASH_SPLIT_BYTES:
            break
        cost = per * _cdiv(nsplit * per_split, wave)
        if best is None or cost < best[0]:
            best = (cost, nsplit)
    return mode, slice_, best[1]


def flash_chunks(d: int) -> int:
    """128-column chunks of ``[z | 1]`` (d + 1 columns, the ones column
    giving rowsum(S)), zero-padded."""
    return _cdiv(d + 1, STASH_TILE)


def flash_scratch_floats(m: int, d: int, slice_: int, nsplit: int) -> int:
    """K3's scratch: z column-major (d x M), ``[z | 1]`` row-major (M x
    128 chunks), in mode (b) the partial dot tiles of every (tile pair,
    slice) and the S tiles of every ordered tile (mode (b) runs only while
    the tile pairs fall short of half a wave: at most about two waves of
    tiles), and the partial sums of splits 1 .. nsplit - 1."""
    tiles = _cdiv(m, STASH_TILE)
    M, D1 = tiles * STASH_TILE, flash_chunks(d) * STASH_TILE
    count = _cdiv(d, slice_)
    mode_b = (count * tile_pairs(m) + tiles * tiles) * STASH_TILE ** 2 if count > 1 else 0
    return _zt_floats(d, M) + M * D1 + mode_b + (nsplit - 1) * M * D1


def gram_backward_flash(z, norms, bw, n1: int, n2: int, mults):
    """``(sz (m, d), rs (m, 1))`` = ``(S @ z, rowsum(S))``, S = coeff .* K'."""
    if not z.is_cuda:
        return gram_backward_flash_reference(z, norms, bw, n1, n2, mults)
    out = _flash_launch(z, norms, bw, n1, n2, mults)
    gram_backward_flash.launches += 1
    return out


def gram_backward_flash_bf16(z, norms, bw, n1: int, n2: int, mults):
    """:func:`gram_backward_flash` on ``rounded(z)`` (S's distances and S @ z)
    with ``norms``."""
    if not z.is_cuda:
        return gram_backward_flash_reference(rounded(z), norms, bw, n1, n2, mults)
    out = _flash_launch_bf16(z, norms, bw, n1, n2, mults)
    gram_backward_flash_bf16.launches += 1
    return out


def _flash_outputs(z, norms, bw, n1: int, n2: int):
    m, d = _check_gram_inputs(z, norms, bw)
    if n1 + n2 != m:
        raise ValueError(f"n1 + n2 = {n1 + n2} != m = {m}")
    return (m, d, torch.empty((m, d), dtype=torch.float32, device=z.device),
            torch.empty((m, 1), dtype=torch.float32, device=z.device))


def _flash_launch(z, norms, bw, n1: int, n2: int, mults):
    m, d, sz, rs = _flash_outputs(z, norms, bw, n1, n2)
    _, slice_, nsplit = flash_schedule(m, d, _sms(z.device))
    scratch = torch.empty(flash_scratch_floats(m, d, slice_, nsplit), dtype=torch.float32,
                          device=z.device)
    cxx, cyy, cxy = _coefficients(n1, n2)
    _launch("vgan_gram_backward_flash", z.device, _ptr(z), _ptr(norms),
            _ptr(bw.reshape(1)), m, d, n1, cxx, cyy, cxy,
            ctypes.byref(_ladder(tuple(mults))), slice_, nsplit, _ptr(scratch), _ptr(sz),
            _ptr(rs))
    return sz, rs


@functools.lru_cache(maxsize=None)
def flash_cluster_schedule(m: int, d: int, sms: int) -> Tuple[int, int, int]:
    """``(cluster, groups, nsplit)`` of a K3 bf16 launch. d's n = cdiv(d, 64)
    chunks: a cluster of ``cluster`` CTAs a row tile, each taking
    [q n / cluster, (q + 1) n / cluster) of the chunks for the dot products
    and the same of the output, at most two (``cluster`` = n / 2 rounded up)
    while n <= ``FLASH_GROUP_CHUNKS``; past that, 8 CTAs a cluster and the
    output chunks in ``groups`` groups of 16, each group's cluster forming
    the whole S (its ladder repeated a group). The column tiles go in
    ``nsplit`` runs, as in :func:`flash_schedule`: the run length that
    finishes soonest in waves of ``sms // cluster`` clusters, the longer run
    on a tie, the partials of runs 1 .. nsplit - 1 (m x (d + 1) floats each)
    within ``FLASH_SPLIT_BYTES``."""
    chunks = _cdiv(d, BF16_CHUNK)
    groups = _cdiv(chunks, FLASH_GROUP_CHUNKS)
    cluster = _cdiv(chunks, 2) if groups == 1 else CLUSTER_MAX
    tiles = _cdiv(m, STASH_TILE)
    wave = max(1, sms // cluster)
    best = None
    for per in range(tiles, 0, -1):
        nsplit = _cdiv(tiles, per)
        if nsplit > 1 and (nsplit - 1) * 4 * m * (d + 1) > FLASH_SPLIT_BYTES:
            break
        cost = per * _cdiv(nsplit * tiles * groups, wave)
        if best is None or cost < best[0]:
            best = (cost, nsplit)
    return cluster, groups, best[1]


def flash_bf16_scratch_floats(m: int, d: int, nsplit: int) -> int:
    """K3 bf16's scratch: z rounded to bf16, row-major (m x d rounded up to
    8, two values a float), and the partial outputs of splits 1 .. nsplit -
    1 (m x (d + 1) each, rowsum(S) in the last column). No dot tile and no S
    tile: nothing grows with m^2."""
    return m * _round_up(d, 8) // 2 + (nsplit - 1) * m * (d + 1)


def _flash_launch_bf16(z, norms, bw, n1: int, n2: int, mults):
    m, d, sz, rs = _flash_outputs(z, norms, bw, n1, n2)
    cluster, _, nsplit = flash_cluster_schedule(m, d, _sms(z.device))
    scratch = torch.empty(flash_bf16_scratch_floats(m, d, nsplit), dtype=torch.float32,
                          device=z.device)
    cxx, cyy, cxy = _coefficients(n1, n2)
    _launch("vgan_gram_backward_flash_bf16", z.device, _ptr(z), _ptr(norms),
            _ptr(bw.reshape(1)), m, d, n1, cxx, cyy, cxy,
            ctypes.byref(_ladder(tuple(mults))), cluster, nsplit, _ptr(scratch), _ptr(sz),
            _ptr(rs))
    return sz, rs


def panel_blocks(R: int, C: int, offset=None) -> int:
    """The blocks (128 x 128 tiles) of a K4 launch over an (R, C) panel:
    with ``offset``, the tile pairs of its diagonal block and the ordered
    tiles left and right of it; without, every tile ordered."""
    rows = _cdiv(R, STASH_TILE)
    if offset is None:
        return rows * _cdiv(C, STASH_TILE)
    side = _cdiv(offset, STASH_TILE) + _cdiv(C - offset - R, STASH_TILE)
    return rows * (rows + 1) // 2 + rows * side


def panel_bf16_schedule(blocks: int, d: int, sms: int) -> int:
    """CTAs a tile's cluster in a K4 bf16 launch over ``blocks`` tiles: K1
    and K2 bf16's :func:`cluster_schedule`, d split over up to 8 CTAs while
    the tiles fall short of half a wave, one CTA a tile past it."""
    return cluster_schedule(blocks, d, sms)[0]


def panel_scratch_floats(blocks: int, d: int, slice_: int) -> int:
    """K4's scratch: in mode (b) the partial dot tile of every (tile, slice),
    at most one wave of them; none in mode (a)."""
    count = _cdiv(d, slice_)
    return count * blocks * STASH_TILE ** 2 if count > 1 else 0


def kprime_panel(z_rows, z_cols, n_rows, n_cols, bw, mults, offset=None,
                 cols_t=None) -> torch.Tensor:
    """(R, C) panel of K'(d2) between ``z_rows`` (R, d) and ``z_cols`` (C, d).

    With ``offset``, ``z_rows`` is the view ``z_cols[offset:offset + R]``:
    the kernel forms each unordered pair of the diagonal block once and
    writes its K' to both places. ``offset`` is a multiple of 4, and so is R
    when columns follow the block. ``cols_t`` is ``panel_operand(z_cols)``,
    made here when not given (the panel backward makes it once for all its
    panels)."""
    if not z_rows.is_cuda:
        return kprime_panel_reference(z_rows, z_cols, n_rows, n_cols, bw, mults)
    kp = _panel_launch(z_rows, z_cols, n_rows, n_cols, bw, mults, offset, cols_t)
    kprime_panel.launches += 1
    return kp


def kprime_panel_bf16(z_rows, z_cols, n_rows, n_cols, bw, mults, offset=None,
                      cols_t=None) -> torch.Tensor:
    """:func:`kprime_panel` with d2 from the rounded rows and columns and the
    given norms; ``cols_t`` is ``panel_operand(z_cols, bf16=True)``."""
    if not z_rows.is_cuda:
        return kprime_panel_reference(rounded(z_rows), rounded(z_cols), n_rows, n_cols, bw,
                                      mults)
    kp = _panel_launch_bf16(z_rows, z_cols, n_rows, n_cols, bw, mults, offset, cols_t)
    kprime_panel_bf16.launches += 1
    return kp


def _check_panel_inputs(z_rows, z_cols, n_rows, n_cols, bw, offset):
    """``(R, C, d, device)`` of a K4 launch, its inputs checked; with an
    offset, ``z_rows`` must be the view ``z_cols[offset:offset + R]`` and
    the offset (and R when columns follow the block) a multiple of 4."""
    R, d = z_rows.shape
    C = z_cols.shape[0]
    dev = z_rows.device
    _check("z_rows", z_rows, (R, d), dev)
    _check("z_cols", z_cols, (C, d), dev)
    _check("n_rows", n_rows, (R,), dev)
    _check("n_cols", n_cols, (C,), dev)
    _check("bw", bw.reshape(1), (1,), dev)
    if offset is not None:
        if not (0 <= offset and offset + R <= C and offset % 4 == 0
                and (offset + R == C or R % 4 == 0)):
            raise ValueError(f"offset {offset} with R={R}, C={C}: expected a multiple of 4 with "
                             f"offset + R <= C, and R a multiple of 4 unless offset + R == C")
        if z_rows.data_ptr() != z_cols[offset:].data_ptr():
            raise ValueError("with an offset, z_rows must be the view z_cols[offset:offset + R]")
    return R, C, d, dev


def _panel_launch(z_rows, z_cols, n_rows, n_cols, bw, mults, offset, cols_t):
    R, C, d, dev = _check_panel_inputs(z_rows, z_cols, n_rows, n_cols, bw, offset)
    if cols_t is None:
        cols_t = panel_operand(z_cols)
    _check("cols_t", cols_t, (d, _round_up(C, STASH_TILE) + STASH_TILE), dev)
    if offset is None:
        rows_t, row0, diag = _transposed(z_rows, _round_up(R, STASH_TILE)), 0, -1
    else:
        rows_t, row0, diag = cols_t, offset, offset
    blocks = panel_blocks(R, C, offset)
    _, slice_, _ = tile_schedule(blocks, d, _sms(dev))
    scratch = torch.empty(max(1, panel_scratch_floats(blocks, d, slice_)), dtype=torch.float32,
                          device=dev)
    kp = torch.empty((R, C), dtype=torch.float32, device=dev)
    _launch("vgan_kprime_panel", dev, _ptr(rows_t), rows_t.shape[1],
            row0, _ptr(cols_t), cols_t.shape[1], _ptr(n_rows), _ptr(n_cols), _ptr(bw.reshape(1)),
            R, C, d, diag, ctypes.byref(_ladder(tuple(mults))), slice_, _ptr(scratch), _ptr(kp))
    return kp


def _panel_launch_bf16(z_rows, z_cols, n_rows, n_cols, bw, mults, offset, cols_t):
    R, C, d, dev = _check_panel_inputs(z_rows, z_cols, n_rows, n_cols, bw, offset)
    if cols_t is None:
        cols_t = panel_operand(z_cols, bf16=True)
    _check("cols_t", cols_t, (C, _round_up(d, 8)), dev, torch.bfloat16)
    if offset is None:
        rows_b, row0, diag = _rounded_rows(z_rows), 0, -1
    else:
        rows_b, row0, diag = cols_t, offset, offset
    slices = panel_bf16_schedule(panel_blocks(R, C, offset), d, _sms(dev))
    kp = torch.empty((R, C), dtype=torch.float32, device=dev)
    _launch("vgan_kprime_panel_bf16", dev, _ptr(rows_b), row0, _ptr(cols_t), cols_t.shape[1],
            _ptr(n_rows), _ptr(n_cols), _ptr(bw.reshape(1)), R, C, d, diag,
            ctypes.byref(_ladder(tuple(mults))), slices, _ptr(kp))
    return kp


KERNELS = (gram_quadrant_sums, gram_quadrant_sums_stash, gram_backward_flash, kprime_panel)
BF16_KERNELS = (gram_quadrant_sums_bf16, gram_quadrant_sums_stash_bf16, gram_backward_flash_bf16,
                kprime_panel_bf16)


def reset_launch_counts() -> None:
    for fn in KERNELS + BF16_KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS + BF16_KERNELS}


reset_launch_counts()


# ---------------------------------------------------------------------------
# autograd Function and public entry points
# ---------------------------------------------------------------------------


def _q_vector(m: int, n1: int, device) -> torch.Tensor:
    """Rank-1 quadrant weights: C_sym = q q^T."""
    q = torch.full((m,), -1.0 / (m - n1), dtype=torch.float32, device=device)
    q[:n1] = 1.0 / n1
    return q


def _panel_rows(m: int) -> int:
    """Largest PANEL_ROW_MULTIPLE-multiple panel height R with R m 4 <=
    PANEL_BYTES."""
    max_rows = (PANEL_BYTES // (m * 4)) // PANEL_ROW_MULTIPLE * PANEL_ROW_MULTIPLE
    return max(PANEL_ROW_MULTIPLE, min(m, max_rows))


def gram_backward_panel(z, norms, bw, n1: int, mults, bf16: bool = False) -> torch.Tensor:
    """Unscaled cotangent ``rowsum(S) z - S @ z`` through bounded (R, m) K'
    panels: ``rowsum(S) = q .* (K' @ q)``, ``S @ z = q .* (K' @ (q .* z))``.
    On the card, one copy of z (:func:`panel_operand`) serves every panel,
    and each panel's diagonal block is formed pair-once (its row offset).
    ``bf16``: the panels from :func:`kprime_panel_bf16`; the contractions
    stay on the f32 z."""
    m = z.shape[0]
    R = _panel_rows(m)
    q = _q_vector(m, n1, z.device)
    qz = q[:, None] * z
    z_t = panel_operand(z, bf16) if z.is_cuda else None
    panel = kprime_panel_bf16 if bf16 else kprime_panel
    out = torch.empty_like(z)
    for off in range(0, m, R):
        rows = slice(off, off + R)
        kp = panel(z[rows], z, norms[rows], norms, bw, mults, offset=off, cols_t=z_t)
        a = kp @ q
        u = kp @ qz
        out[rows] = q[rows, None] * (a[:, None] * z[rows] - u)
    return out


def _mmd2_from_sums(sums, n1: int, n2: int):
    return (
        sums[0, 0] / (n1 * n1)
        - 2.0 * sums[0, 1] / (n1 * n2)
        + sums[0, 2] / (n2 * n2)
    )


class _MMD2Core(torch.autograd.Function):
    """Biased MMD^2 through the kernels, with the JAX package's custom VJP;
    ``bf16``: the bf16-operand variants (``matmul_dtype='bfloat16'``)."""

    @staticmethod
    def forward(ctx, x, y, bw, mults, want_grad, bf16=False):
        n1, n2 = x.shape[0], y.shape[0]
        z = torch.cat([x, y], dim=0).to(torch.float32).contiguous()
        norms = torch.sum(z * z, dim=1)
        bw = bw.detach().to(torch.float32).reshape(())
        M, D, _ = _pad_layout(n1 + n2, x.shape[1])
        kp = None
        if want_grad and _stash_kprime(M, D):
            stash = gram_quadrant_sums_stash_bf16 if bf16 else gram_quadrant_sums_stash
            sums, kp = stash(z, norms, bw, n1, mults)
        else:
            sums = (gram_quadrant_sums_bf16 if bf16 else gram_quadrant_sums)(z, norms, bw, n1,
                                                                            mults)
        ctx.mults, ctx.n1, ctx.n2, ctx.bf16 = mults, n1, n2, bf16
        ctx.dtypes = (x.dtype, y.dtype)
        ctx.save_for_backward(z, norms, bw, kp)
        return _mmd2_from_sums(sums, n1, n2)

    @staticmethod
    def backward(ctx, g):
        with span("vgan::mmd.backward"):
            z, norms, bw, kp = ctx.saved_tensors
            mults, n1, n2 = ctx.mults, ctx.n1, ctx.n2
            m = n1 + n2
            M, D, _ = _pad_layout(m, z.shape[1])
            g = g.to(torch.float32)
            if kp is not None:
                q = _q_vector(m, n1, z.device)
                if M <= D:
                    # scale kp's columns; a is a rowsum, u reads z directly
                    kp_q = kp * q[None, :]
                    a = torch.sum(kp_q, dim=1, keepdim=True)
                    u = kp_q @ z
                else:
                    # read kp once against the stacked rhs [q | q .* z]
                    rhs = torch.cat([q[:, None], q[:, None] * z], dim=1)
                    au = kp @ rhs
                    a, u = au[:, :1], au[:, 1:]
                dz = 4.0 * g * (q[:, None] * (a * z - u))
            elif D <= FLASH_D_MAX:
                flash = gram_backward_flash_bf16 if ctx.bf16 else gram_backward_flash
                sz, rs = flash(z, norms, bw, n1, n2, mults)
                dz = 4.0 * g * (rs * z - sz)
            else:
                dz = 4.0 * g * gram_backward_panel(z, norms, bw, n1, mults, ctx.bf16)
            dx = dz[:n1].to(ctx.dtypes[0])
            dy = dz[n1:].to(ctx.dtypes[1])
            return dx, dy, None, None, None, None


def mmd2_cuda_core(x, y, bw, mults, matmul_dtype=None) -> torch.Tensor:
    """Biased MMD^2 through the kernels, given a resolved bandwidth. The
    stash kernel runs only when a gradient will be taken (inside the
    Function's forward, grad mode is always off, so it is decided here).
    ``matmul_dtype='bfloat16'`` takes the bf16-operand variants."""
    bf16 = low_precision(matmul_dtype, "matmul_dtype") is not None
    want_grad = torch.is_grad_enabled() and (x.requires_grad or y.requires_grad)
    return _MMD2Core.apply(x, y, bw, tuple(mults), want_grad, bf16)


def mmd2_biased_cuda(x, y, bandwidth=None, mults=_mmd.bandwidth_multipliers(), matmul_dtype=None):
    """Kernel counterpart of :func:`vgan_tpu_torch.ops.mmd.mmd2_biased`."""
    if bandwidth is None:
        bandwidth = _mmd.candidate_bandwidth(torch.cat([x, y], dim=0))
    bw = torch.as_tensor(bandwidth, dtype=torch.float32, device=x.device)
    return mmd2_cuda_core(x, y, bw, mults, matmul_dtype), bw


def mmd2_biased_stateful_cuda(x, y, bw_value, bw_is_set,
                              mults=_mmd.bandwidth_multipliers(), matmul_dtype=None):
    """Kernel counterpart of ``mmd2_biased_stateful``."""
    candidate = _mmd.candidate_bandwidth(torch.cat([x, y], dim=0))
    bw = torch.where(bw_is_set, bw_value, candidate).to(torch.float32)
    return mmd2_cuda_core(x, y, bw, mults, matmul_dtype), bw
