"""The multi-tensor Adadelta kernel (``ops/cuda/csrc/adadelta.cu``) on a
CUDA card: equal to the plain path to the bit over the generator's and the
detector's tensors at d = 10240 (f32 and bf16 state, the encoder's device
flag false and true, with a misaligned view and a ragged numel beside
them), the same bits on a second run, and one launch a step in the fits.
Tests marked ``card`` skip without a card; on the card:

    python -m pytest --noconftest -o addopts="" -m card tests/test_torch_adadelta_card.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import adadelta_copies, adadelta_leaves, adadelta_models, bits
from vgan_tpu_torch import VGAN, VGAN_no_kl
from vgan_tpu_torch.ops.cuda import adadelta as A

LR, WD, RHO, EPS = 0.007, 0.04, 0.9, 1e-6
D = 10240


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", ["generator", "detector, encoder frozen",
                                   "detector, encoder active"])
def test_kernel_equals_plain_path(card, model, state):
    """One launch over the model's tensors and the two odd leaves; p and
    both averages equal to the plain path's (a frozen leaf's bits as they
    were), and a second run from the same start gives the same bits."""
    shapes, flags = adadelta_models(D, card)[model]
    start = adadelta_leaves(card, shapes, flags, getattr(torch, state), seed=len(shapes))
    kernel, plain, again = adadelta_copies(start), adadelta_copies(start), adadelta_copies(start)
    A.reset_launch_counts()
    A.update(kernel, RHO, EPS, LR, WD)
    torch.cuda.synchronize()
    assert A.launch_counts() == {"adadelta_multi": 1, "plain_update": 0}
    assert not A.vector_aligned(kernel[-2]) and A.vector_aligned(kernel[0])
    for leaf in plain:
        A.plain_update(*leaf, RHO, EPS, LR, WD)
    A.update(again, RHO, EPS, LR, WD)
    torch.cuda.synchronize()
    for i, (mine, theirs, second, first) in enumerate(zip(kernel, plain, again, start)):
        frozen = isinstance(first[4], torch.Tensor) and not bool(first[4])
        for j in (0, 2, 3):
            assert torch.equal(mine[j], theirs[j]), (model, state, i, j)
            assert torch.equal(bits(mine[j]), bits(second[j])), (model, state, i, j)
            if frozen:
                assert torch.equal(bits(mine[j]), bits(first[j])), (model, state, i, j)
            elif j == 0:
                assert not torch.equal(mine[j], first[j]), (model, state, i, j)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["no_kl", "kl"])
def test_fit_launches_once_an_update(card, kind):
    """A short fit on the card: one kernel launch an Adadelta step and no
    plain-path call; in the kl fit's second detector epoch the encoder is
    frozen (its flag false on the card), its parameters unchanged."""
    x = np.random.default_rng(0).normal(size=(200, 64)).astype(np.float32)
    steps = 200 // 50
    cls = VGAN_no_kl if kind == "no_kl" else VGAN
    A.reset_launch_counts()
    # kl: epochs (1 detector, 5 generator), the generator detached: updates
    # in the detector epoch only
    est = cls(epochs=2 if kind == "no_kl" else 6, batch_size=50, device=card,
              verbose=False).fit(x)
    torch.cuda.synchronize()
    assert A.launch_counts() == {"adadelta_multi": 2 * steps if kind == "no_kl" else steps,
                                 "plain_update": 0}
    if kind == "no_kl":
        return
    before = {k: v.clone() for k, v in est.detector.named_parameters()}
    A.reset_launch_counts()
    est.continue_fit(x, 1)  # the next detector epoch
    torch.cuda.synchronize()
    assert A.launch_counts() == {"adadelta_multi": steps, "plain_update": 0}
    for name, p in est.detector.named_parameters():
        assert torch.equal(p, before[name]) == name.startswith("encoder."), name
