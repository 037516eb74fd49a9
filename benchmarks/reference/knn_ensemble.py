"""Plain reference of a subspace ensemble's ``decision_function`` with the
k-th nearest neighbour base (pyod's KNN, method 'largest'), as the V-GAN
paper scores data in its sampled subspaces:

- per mask, the squared distance of each test row to each train row over
  the mask's selected columns, and the k-th smallest of them per test row;
  its square root is the row's score in that subspace;
- per mask, the scores standardized over the test rows (population
  standard deviation, plus 1e-12);
- the standardized scores summed with the masks' normalized weights.

In ``precision`` (float64 for the reference; 'tf32' for the control), one
mask at a time over every test batch at once.
"""

from __future__ import annotations

import torch

from reference.precision import dtype_of, mm


@torch.no_grad()
def decision_function(x_test: torch.Tensor, x_train: torch.Tensor, masks: torch.Tensor,
                      weights: torch.Tensor, k: int, precision: str = "float64") -> torch.Tensor:
    """``(scores, kth)``: the (batches, n_test) scores of each of the
    (batches, n_test, d) test batches, each standardized over its own rows,
    and the (batches, n_masks, n_test) k-th neighbour distances in each
    subspace; ``masks`` (n_masks, d) bool, ``weights`` (n_masks,)."""
    dtype = dtype_of(precision)
    nb, nt, d = x_test.shape
    xte, xtr = x_test.reshape(nb * nt, d).to(dtype), x_train.to(dtype)
    w = weights.to(torch.float64)
    w = w / w.sum()
    out = torch.zeros((nb, nt), dtype=torch.float64, device=xte.device)
    kth_all = torch.empty((nb, masks.shape[0], nt), dtype=torch.float64, device=xte.device)
    for j, mask in enumerate(masks):
        cols = torch.nonzero(mask).flatten()
        a, b = xte[:, cols], xtr[:, cols]
        d2 = (torch.sum(a * a, dim=1)[:, None] + torch.sum(b * b, dim=1)[None, :]
              - 2.0 * mm(a, b.T, precision))
        kth = torch.kthvalue(torch.clamp_min(d2, 0.0), k, dim=1).values
        score = torch.sqrt(kth).reshape(nb, nt)
        kth_all[:, j] = score
        mu = score.mean(dim=1, keepdim=True)
        sd = torch.sqrt(torch.mean((score - mu) ** 2, dim=1, keepdim=True)) + 1e-12
        out += w[j] * ((score - mu) / sd).to(torch.float64)
    return out, kth_all
