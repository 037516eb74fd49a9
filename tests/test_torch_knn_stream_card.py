"""K7 (``knn_kernel``, entry ``vgan_knn_stream``: chunks double-buffered
across the train tiles, selection in registers, the half last tile) on a
CUDA card:
its scores equal to K6's (``knn_resident_kernel``, the same arithmetic and
the same k-smallest multisets) to the bit and to a re-run of its own, at k
from 1 to 64, 'kth' and 'mean', with and without ``exclude_self``, on
standard normal and small-integer (tied) rows, over 1, 129, 192 (a last
tile of exactly half), 801 and 2000 train rows at d = 10240 and 20531 (32-
and 16-column chunks: k up to 39 and past it). Tests marked ``card`` skip
without a card; on the card:

    python -m pytest --noconftest -o addopts="" -m card tests/test_torch_knn_stream_card.py -q
"""

from __future__ import annotations

import pytest
import torch

from vgan_tpu_torch.ops.cuda import knn_score as KS

SHAPES = [(300, 1, 10240), (300, 129, 10240), (300, 192, 20531), (500, 801, 20531),
          (300, 2000, 10240)]
KS_ = (1, 10, 17, 64)
CASES = [(shape, k, integer) for shape in SHAPES for k in KS_ for integer in (False, True)
         if k <= shape[1]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(nt, ntr, d, integer, seed, device):
    """Rows standard normal or in {-2 .. 2} (exact, heavily tied distances),
    the leading test rows equal to the train rows (so that exclude_self
    drops true self-pairs), and six masks: all-zero, full, one column, and
    three keeping 10%, 48% and 90% of the columns."""
    g = torch.Generator(device=device).manual_seed(seed)
    if integer:
        xtr = torch.randint(-2, 3, (ntr, d), generator=g, device=device).float()
        xte = torch.randint(-2, 3, (nt, d), generator=g, device=device).float()
    else:
        xtr = torch.randn((ntr, d), generator=g, device=device)
        xte = torch.randn((nt, d), generator=g, device=device)
    xte[:min(nt, ntr)] = xtr[:min(nt, ntr)]
    keep = torch.tensor([0.0, 1.0, 0.0, 0.1, 0.477, 0.9], device=device)[:, None]
    masks = (torch.rand((6, d), generator=g, device=device) < keep).float()
    masks[2, d // 3] = 1.0
    return xte, xtr, masks


@pytest.mark.card
@pytest.mark.parametrize("shape,k,integer", CASES)
def test_stream_equals_resident_to_the_bit(card, shape, k, integer):
    nt, ntr, d = shape
    xte, xtr, masks = _inputs(nt, ntr, d, integer, seed=nt * 7 + ntr * 131 + k, device=card)
    for mode in ("kth", "mean"):
        for excl in (False, True):
            if excl and k >= ntr:
                continue
            KS.reset_launch_counts()
            got = KS.knn_scores_stream(xte, xtr, masks, k, mode, excl)
            again = KS.knn_scores_stream(xte, xtr, masks, k, mode, excl)
            want = KS._launch_scores("vgan_knn_resident", xte, xtr, masks, k, mode, excl)
            torch.cuda.synchronize()
            tag = f"{shape} k={k} {mode} exclude_self={excl} integer={integer}"
            assert KS.launch_counts()["knn_scores_stream"] == 2, tag
            assert torch.equal(got, want), (tag, float((got - want).abs().max()))
            assert torch.equal(got, again), tag
            assert torch.all(torch.isfinite(got)), tag
            assert torch.all(got[0] == 0.0), tag  # the all-zero mask
