"""Faults planted in the program under the harness, to show that the
comparison refuses them: each is a context manager that breaks the timed
path where it is produced and restores it on exit.

- ``state_unchanged``: the optimizer's step returns with the state as it was;
- ``half_batch``: the loss over the first half of the batch's rows (the MMD,
  the coverage and the reconstruction means), the rest left out;
- ``no_exchange``: the gradients not summed over the mesh's 'data' ranks;
- ``answer_altered``: one subspace score of one test row off by 1% where
  the KNN kernel produces it;
- ``half_masks``: the scores of the first half of the masks stand for the
  rest (the mean taken over half the ensemble).
"""

from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


@contextmanager
def state_unchanged():
    from vgan_tpu_torch.train import adadelta

    with _patched(adadelta.Adadelta, "step", lambda self, *a, **k: None):
        yield


@contextmanager
def half_batch():
    from vgan_tpu_torch.ops import mmd
    from vgan_tpu_torch.parallel import dp
    from vgan_tpu_torch.train import steps

    loss = mmd.mmd_loss_constrained_stateful

    def half_loss(x, y, u, *args, **kwargs):
        h = x.shape[0] // 2
        return loss(x[:h], y[:h], u[:h], *args, **kwargs)

    whole_mean, mesh_mean = steps.WholeBatch.mean, dp.MeshBatches.mean

    def half(mean):
        return lambda self, t: mean(self, t[: t.shape[0] // 2])

    with _patched(mmd, "mmd_loss_constrained_stateful", half_loss), \
            _patched(steps.WholeBatch, "mean", half(whole_mean)), \
            _patched(dp.MeshBatches, "mean", half(mesh_mean)):
        yield


@contextmanager
def no_exchange():
    from vgan_tpu_torch.parallel import dp

    with _patched(dp.MeshBatches, "reduce_grads", lambda self, grads: grads):
        yield


@contextmanager
def answer_altered():
    from vgan_tpu_torch.ensemble import od

    scores = od.knn_scores_all_masks

    def altered(*args, **kwargs):
        s = scores(*args, **kwargs).clone()
        s[0, 0] *= 1.01
        return s

    with _patched(od, "knn_scores_all_masks", altered):
        yield


@contextmanager
def half_masks():
    import torch

    from vgan_tpu_torch.ensemble import od

    scores = od.knn_scores_all_masks

    def half(x_test, x_train, masks, *args, **kwargs):
        h = (masks.shape[0] + 1) // 2
        s = scores(x_test, x_train, masks[:h], *args, **kwargs)
        return torch.cat([s, s])[: masks.shape[0]]

    with _patched(od, "knn_scores_all_masks", half):
        yield


FIT = {"state_unchanged": state_unchanged, "half_batch": half_batch}
DP = {**FIT, "no_exchange": no_exchange}
SCORE = {"answer_altered": answer_altered, "half_masks": half_masks}
