"""One Adadelta update over a list of tensors, in one CUDA launch
(``csrc/adadelta.cu``), and its plain PyTorch version.

The optimizer of ``train/adadelta.py`` hands :func:`update` its leaves, one
``(p, g, square_avg, acc_delta, flag)`` a parameter, ``flag`` a Python bool
or a one-value bool tensor (the parameter steps while it is true).
:func:`plan` routes them by what it can see in them:

- a leaf whose flag is a host ``False`` takes no update at all;
- a float32 parameter on a CUDA card with a float32 gradient, a float32 or
  bf16 state, all four contiguous and on its card, and a flag that is a
  host ``True`` or a bool on the same card, goes to the kernel: one launch
  for up to ``MAX_LEAVES`` such leaves of one card and one state dtype
  (``adadelta_multi_kernel``, each leaf's flag read on the card);
- everything else (CPU tensors, float64, a strided view) takes
  :func:`plain_update`.

The kernel reads p, g and both averages once and writes p and both
averages once, with 16-byte accesses where :func:`vector_aligned` holds and
one value a thread elsewhere. It keeps the JAX package's operation order
with every operation rounded on its own, so on the card it equals
:func:`plain_update` to the bit (a frozen leaf keeps its bits: the plain
path's zero update turns -0.0 into +0.0).

:func:`launch_counts` counts the kernel's launches and the plain path's
calls on CUDA tensors (a fit on the card should read one launch an update
and no plain call).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple, Union

import torch

from vgan_tpu_torch.ops.cuda import _build
from vgan_tpu_torch.ops.cuda._build import cdiv, launch

Flag = Union[bool, torch.Tensor]
Leaf = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, Flag]

# The kernel's parameter struct holds at most this many leaves (MAX_LEAVES
# in csrc/adadelta.cu); a block updates CHUNK values of one leaf.
MAX_LEAVES = 48
CHUNK = 16384
STATE_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches, and plain-path calls on CUDA tensors
_COUNTED = ("adadelta_multi", "plain_update")


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def plain_update(p, g, sq, acc, flag: Flag, rho: float, eps: float, lr: float,
                 wd: float) -> None:
    """The update of one leaf in PyTorch operations, in place, in the
    parameter's dtype and the JAX package's order; a low-precision state is
    read into that dtype and rounded once, in ``copy_``. A tensor ``flag``
    selects with ``torch.where`` (no host sync): false leaves p and the
    state as they were."""
    if p.is_cuda:
        _build.count("plain_update")
    g = g + wd * p
    sqm, accm = sq.to(p.dtype), acc.to(p.dtype)
    new_sq = rho * sqm + (1.0 - rho) * g * g
    delta = g * torch.sqrt(accm + eps) / torch.sqrt(new_sq + eps)
    new_acc = rho * accm + (1.0 - rho) * delta * delta
    upd = -lr * delta
    if isinstance(flag, torch.Tensor):
        upd = torch.where(flag, upd, torch.zeros_like(upd))
        new_sq, new_acc = torch.where(flag, new_sq, sqm), torch.where(flag, new_acc, accm)
    p.add_(upd)
    sq.copy_(new_sq)
    acc.copy_(new_acc)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def kernel_takes(leaf: Leaf, device_type: str = "cuda") -> bool:
    """Can the kernel update ``leaf``? Not one whose flag is a host False,
    which takes no update. ``device_type``: the device the kernel runs on."""
    p, g, sq, acc, flag = leaf
    dev = p.device
    if isinstance(flag, torch.Tensor):
        if flag.dtype != torch.bool or flag.numel() != 1 or flag.device != dev:
            return False
    elif not flag:
        return False
    # flat, cheap checks: this runs for every parameter of every step
    on_device = p.is_cuda if device_type == "cuda" else dev.type == device_type
    return (on_device and p.dtype == torch.float32 and g.dtype == torch.float32
            and sq.dtype in STATE_DTYPES and acc.dtype == sq.dtype
            and g.device == dev and sq.device == dev and acc.device == dev
            and g.shape == p.shape and sq.shape == p.shape and acc.shape == p.shape
            and p.is_contiguous() and g.is_contiguous() and sq.is_contiguous()
            and acc.is_contiguous())


def vector_aligned(leaf: Leaf) -> bool:
    """Do p and g start on 16 bytes and each average on 4 values? Then the
    kernel moves the leaf in 16-byte accesses (a bf16 average in 8), up to
    its last multiple of 4 values."""
    p, g, sq, acc, _ = leaf
    state = 4 * sq.element_size()
    return (p.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0
            and sq.data_ptr() % state == 0 and acc.data_ptr() % state == 0)


def plan(leaves: Sequence[Leaf], device_type: str = "cuda") -> Tuple[List[List[int]], List[int]]:
    """``(launches, plain)``: the indices of ``leaves`` that each kernel
    launch updates, in order, and those :func:`plain_update` takes. A leaf
    whose flag is a host False is in neither. A launch holds the leaves of
    one device and one state dtype, at most ``MAX_LEAVES`` of them."""
    launches: List[List[int]] = []
    plain: List[int] = []
    open_runs: dict = {}  # (device, state dtype) -> its open launch's indices
    for i, leaf in enumerate(leaves):
        flag = leaf[4]
        if not isinstance(flag, torch.Tensor) and not flag:
            continue
        if not kernel_takes(leaf, device_type):
            plain.append(i)
            continue
        key = (leaf[0].device, leaf[2].dtype)
        run = open_runs.get(key)
        if run is None or len(run) == MAX_LEAVES:
            run = open_runs[key] = []
            launches.append(run)
        run.append(i)
    return launches, plain


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------


class _Leaf(ctypes.Structure):
    _fields_ = [
        ("p", ctypes.c_void_p),
        ("g", ctypes.c_void_p),
        ("sq", ctypes.c_void_p),
        ("acc", ctypes.c_void_p),
        ("flag", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("vec", ctypes.c_int),
        ("chunk0", ctypes.c_int),
    ]


class _Batch(ctypes.Structure):
    _fields_ = [
        ("leaf", _Leaf * MAX_LEAVES),
        ("count", ctypes.c_int),
        ("chunks", ctypes.c_int),
        ("rho", ctypes.c_float),
        ("one_minus_rho", ctypes.c_float),
        ("eps", ctypes.c_float),
        ("neg_lr", ctypes.c_float),
        ("wd", ctypes.c_float),
    ]


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "vgan_adadelta_layout": [_P, _P, _P, _P],
    "vgan_adadelta_multi": [_P, _I, _P],  # (batch, state_bf16, stream)
}


def _lib():
    return _layout_checked(_build.bound("adadelta", _SIGNATURES))


@functools.lru_cache(maxsize=None)
def _layout_checked(lib):
    """``lib``, once its entry has confirmed the wrapper's struct layout."""
    max_leaves, leaf_bytes, batch_bytes = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    chunk = ctypes.c_longlong()
    lib.vgan_adadelta_layout(ctypes.byref(max_leaves), ctypes.byref(chunk),
                             ctypes.byref(leaf_bytes), ctypes.byref(batch_bytes))
    want = (MAX_LEAVES, CHUNK, ctypes.sizeof(_Leaf), ctypes.sizeof(_Batch))
    got = (max_leaves.value, chunk.value, leaf_bytes.value, batch_bytes.value)
    if got != want:
        raise RuntimeError(f"csrc/adadelta.cu's layout {got} is not the wrapper's {want}")
    return lib


def _launch_batch(leaves: Sequence[Leaf], rho: float, eps: float, lr: float, wd: float) -> None:
    """One launch of the kernel over leaves that :func:`plan` put in one
    launch, in place."""
    batch = _Batch()
    chunks = 0
    for slot, leaf in zip(batch.leaf, leaves):
        p, g, sq, acc, flag = leaf
        slot.p, slot.g, slot.sq, slot.acc = p.data_ptr(), g.data_ptr(), sq.data_ptr(), acc.data_ptr()
        slot.flag = flag.data_ptr() if isinstance(flag, torch.Tensor) else None
        slot.n = p.numel()
        slot.vec = int(vector_aligned(leaf))
        slot.chunk0 = chunks
        chunks += cdiv(p.numel(), CHUNK)
    batch.count, batch.chunks = len(leaves), chunks
    batch.rho, batch.one_minus_rho, batch.eps = rho, 1.0 - rho, eps
    batch.neg_lr, batch.wd = -lr, wd
    state_bf16 = int(leaves[0][2].dtype == torch.bfloat16)
    launch(_lib(), "vgan_adadelta_multi", leaves[0][0].device, ctypes.byref(batch),
           state_bf16)
    _build.count("adadelta_multi")


def update(leaves: Sequence[Leaf], rho: float, eps: float, lr: float, wd: float) -> None:
    """Every leaf's update, in place: the kernel's launches of :func:`plan`,
    then :func:`plain_update` for the rest."""
    launches, plain = plan(leaves)
    for run in launches:
        _launch_batch([leaves[i] for i in run], rho, eps, lr, wd)
    for i in plain:
        plain_update(*leaves[i], rho, eps, lr, wd)


def reset_launch_counts() -> None:
    _build.reset(_COUNTED)


def launch_counts() -> dict:
    return _build.counts(_COUNTED)
