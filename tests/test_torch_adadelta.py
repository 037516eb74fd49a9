"""The port's Adadelta update (``ops/cuda/adadelta.py``) on the CPU: the
launch planner's routes and splits, the kernel's parameter struct and the
CPU route. The plain path is held to the JAX package's ``adadelta`` in
``test_torch_kl.py`` (float64, every flag kind, full and bf16 state) and
``test_torch_bf16.py`` (float32, bf16 state); the kernel is held to the
plain path on the card in ``test_torch_adadelta_card.py``."""

import ctypes

import pytest
import torch

from vgan_tpu_torch.ops.cuda import adadelta as A
from vgan_tpu_torch.train import adadelta as TA


def _leaf(n=8, dtype=torch.float32, g_dtype=None, state=torch.float32, acc_state=None,
          flag=True, strided=False, offset=0):
    """(p, g, sq, acc, flag) of n values; ``strided``: g a non-contiguous
    view; ``offset``: p, g, sq and acc views that start ``offset`` values
    into a larger buffer; ``acc_state``: acc's dtype, if not sq's."""
    def make(dt):
        return torch.zeros(n + offset, dtype=dt)[offset:]

    p, sq, acc = make(dtype), make(state), make(acc_state or state)
    g = torch.zeros(2 * n, dtype=g_dtype or dtype)[::2] if strided else make(g_dtype or dtype)
    return p, g, sq, acc, flag


def _model(widths, flag=True):
    """The leaves of a linear stack's weights and biases, in module order."""
    leaves = []
    for a, b in zip(widths[:-1], widths[1:]):
        leaves += [_leaf(a * b, flag=flag), _leaf(b, flag=flag)]
    return leaves


L, D = 4, 64
GEN = [L, 2 * L, 4 * L, 8 * L, D]
ENC, DEC = [D, 8 * L, 4 * L, 2 * L, L], GEN

CASES = {
    # name: (leaves, device type the kernel runs on, launches, plain)
    "host True": ([_leaf()], "cpu", [[0]], []),
    "device flag": ([_leaf(flag=torch.tensor(False))], "cpu", [[0]], []),
    "host False": ([_leaf(flag=False), _leaf()], "cpu", [[1]], []),
    "not the kernel's device": ([_leaf(), _leaf(flag=torch.tensor(True))], "cuda", [], [0, 1]),
    "float64": ([_leaf(dtype=torch.float64, state=torch.float64), _leaf()], "cpu", [[1]], [0]),
    "float64 gradient": ([_leaf(g_dtype=torch.float64)], "cpu", [], [0]),
    "bf16 state": ([_leaf(state=torch.bfloat16)], "cpu", [[0]], []),
    "float16 state": ([_leaf(state=torch.float16)], "cpu", [], [0]),
    "one launch a state dtype": ([_leaf(), _leaf(state=torch.bfloat16), _leaf()], "cpu",
                                [[0, 2], [1]], []),
    "strided gradient": ([_leaf(strided=True), _leaf()], "cpu", [[1]], [0]),
    "misaligned view": ([_leaf(offset=1)], "cpu", [[0]], []),
    "numel not a multiple of 4": ([_leaf(n=1001)], "cpu", [[0]], []),
    "flag not bool": ([_leaf(flag=torch.tensor(1.0))], "cpu", [], [0]),
    "flag of two values": ([_leaf(flag=torch.tensor([True, True]))], "cpu", [], [0]),
    "flag of shape (1,)": ([_leaf(flag=torch.tensor([True]))], "cpu", [[0]], []),
    "averages of two dtypes": ([_leaf(acc_state=torch.bfloat16), _leaf()], "cpu", [[1]], [0]),
    "strided parameter": ([(torch.zeros(16)[::2],) + _leaf()[1:]], "cpu", [], [0]),
    "empty parameter": ([_leaf(n=0), _leaf()], "cpu", [[0, 1]], []),
    "generator": (_model(GEN), "cpu", [list(range(8))], []),
    "detector, encoder flag on the device": (
        _model(ENC, flag=torch.tensor(False)) + _model(DEC), "cpu", [list(range(16))], []),
    "detector, encoder frozen on the host": (
        _model(ENC, flag=False) + _model(DEC), "cpu", [list(range(8, 16))], []),
    "past one struct": ([_leaf() for _ in range(A.MAX_LEAVES + 2)], "cpu",
                        [list(range(A.MAX_LEAVES)), [A.MAX_LEAVES, A.MAX_LEAVES + 1]], []),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plan_routes_and_splits(case):
    """Which leaves go to the kernel, in which launch, and which to the plain
    path, by device, dtype, contiguity and flag kind; a misaligned view or a
    ragged numel still goes to the kernel, whose 16-byte path
    (``vector_aligned``) needs only the alignment."""
    leaves, device_type, launches, plain = CASES[case]
    assert A.plan(leaves, device_type) == (launches, plain)
    for i, leaf in enumerate(leaves):
        flag = leaf[4]
        steps = isinstance(flag, torch.Tensor) or flag
        assert A.kernel_takes(leaf, device_type) == (steps and i not in plain)
    if case == "misaligned view":
        assert not A.vector_aligned(leaves[0])
    elif case in ("host True", "numel not a multiple of 4", "bf16 state"):
        assert A.vector_aligned(leaves[0])


def test_batch_struct_fits_kernel_parameters():
    """The by-value struct (csrc/adadelta.cu ``VganAdadeltaBatch``) within
    the 4 KiB of a kernel's parameters, laid out as the C compiler lays it
    out (the library checks its own sizes against these when it loads)."""
    assert ctypes.sizeof(A._Leaf) == 5 * 8 + 8 + 2 * 4
    assert ctypes.sizeof(A._Batch) == A.MAX_LEAVES * ctypes.sizeof(A._Leaf) + 32
    assert ctypes.sizeof(A._Batch) <= 4096
    assert A.CHUNK % (256 * 4 * 4) == 0  # whole rounds of NT x ILP float4s


def test_cpu_update_takes_the_plain_path():
    """CPU tensors never reach the kernel (the launcher refuses them), and
    the counters count only CUDA work."""
    A.reset_launch_counts()
    opt = TA.Adadelta(0.007, weight_decay=0.04)
    params = {"w": torch.ones(6), "b": torch.ones(3, dtype=torch.float64)}
    state = opt.init(params)
    opt.step(params, [torch.ones(6), torch.ones(3, dtype=torch.float64)], state,
             active={"b": torch.tensor(True)})
    assert A.launch_counts() == {"adadelta_multi": 0, "plain_update": 0}
    assert not torch.equal(params["w"], torch.ones(6))
    assert not torch.equal(params["b"], torch.ones(3, dtype=torch.float64))
