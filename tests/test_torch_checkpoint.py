"""The port's checkpoints (``vgan_tpu_torch.utils.checkpoint`` and the
estimators' ``save_checkpoint`` / ``restore_checkpoint`` / ``continue_fit``
/ ``checkpoint_dir`` / ``checkpoint_every``): each test of
``tests/test_checkpoint.py`` but the bf16 one, on the CPU, plus a fused fit
checkpointed and restored. Resume is bit-identical on the same device."""

import shutil

import numpy as np
import pytest
import torch

from vgan_tpu_torch import VGAN, VGAN_no_kl
from vgan_tpu_torch.train.steps import (
    TrainConfig,
    init_no_kl_state,
    train_state_from_payload,
    train_state_to_payload,
)
from vgan_tpu_torch.utils.checkpoint import load_meta, restore_train_state, save_train_state


def data(rng, n=96, d=10):
    return rng.normal(size=(n, d)).astype(np.float32)


def no_kl(**kw):
    return VGAN_no_kl(batch_size=32, verbose=False, device="cpu", **kw)


def kl(**kw):
    return VGAN(batch_size=32, verbose=False, device="cpu", **kw)


def test_no_kl_checkpoint_roundtrip_exact_resume(tmp_path, rng):
    x = data(rng)
    m_full = no_kl(epochs=6).fit(x)
    m_a = no_kl(epochs=3).fit(x)
    m_a.save_checkpoint(tmp_path / "ckpt")
    m_b = no_kl(epochs=3).restore_checkpoint(tmp_path / "ckpt")
    m_b.continue_fit(x, 3)
    assert m_b.train_history["generator_loss"] == m_full.train_history["generator_loss"]
    np.testing.assert_array_equal(m_b.generate_subspaces(16), m_full.generate_subspaces(16))
    for k, v in m_full.train_state.opt_state.square_avg.items():
        assert torch.equal(m_b.train_state.opt_state.square_avg[k], v), k


def test_kl_checkpoint_resume_across_phase_boundary(tmp_path, rng):
    x = data(rng)
    m_full = kl(epochs=8).fit(x)
    # split mid-generator-phase (epoch 4 of the 1D+5G cycle)
    m_a = kl(epochs=4).fit(x)
    m_a.save_checkpoint(tmp_path / "ckpt")
    m_b = kl(epochs=4).restore_checkpoint(tmp_path / "ckpt")
    m_b.continue_fit(x, 4)
    for kind in ("generator_loss", "detector_loss"):
        np.testing.assert_array_equal(m_b.train_history[kind], m_full.train_history[kind])
    np.testing.assert_array_equal(m_b.generate_subspaces(16), m_full.generate_subspaces(16))
    assert bool(m_b.train_state.encoder_active) == bool(m_full.train_state.encoder_active)


def test_auto_checkpointing_fit(tmp_path, rng):
    """checkpoint_every saves during fit, and the chunked fit equals the
    single-chunk one."""
    x = data(rng)
    ck = tmp_path / "auto"
    m = no_kl(epochs=6, checkpoint_dir=ck, checkpoint_every=2).fit(x)
    assert load_meta(ck) is not None
    m_ref = no_kl(epochs=6).fit(x)
    assert m.train_history["generator_loss"] == m_ref.train_history["generator_loss"]
    # the checkpoint on disk is the final state: restoring reproduces sampling
    m2 = no_kl().restore_checkpoint(ck)
    np.testing.assert_array_equal(m2.generate_subspaces(8), m.generate_subspaces(8))


def test_kl_auto_checkpointing_chunks_match(tmp_path, rng):
    x = data(rng)
    m = kl(epochs=8, checkpoint_dir=tmp_path / "klauto", checkpoint_every=3).fit(x)
    m_ref = kl(epochs=8).fit(x)
    for kind in ("generator_loss", "detector_loss"):
        np.testing.assert_array_equal(m.train_history[kind], m_ref.train_history[kind])
    assert load_meta(tmp_path / "klauto")["schedule"] == m._schedule.get_state()


def test_continue_fit_rejects_too_small_dataset(rng):
    x = data(rng, n=96)
    m = VGAN_no_kl(batch_size=64, epochs=1, verbose=False, device="cpu").fit(x)
    with pytest.raises(ValueError, match="zero batches"):
        m.continue_fit(x[:32], 1)


def test_periodic_checkpoint_preserves_bandwidth(tmp_path, rng):
    x = data(rng)
    ck = tmp_path / "bw"
    m = no_kl(epochs=4, checkpoint_dir=ck, checkpoint_every=2).fit(x)
    m2 = no_kl().restore_checkpoint(ck)
    assert m2.bandwidth is not None and m2.bandwidth > 0
    assert m2.bandwidth == m.bandwidth


def test_checkpoint_class_mismatch_rejected(tmp_path, rng):
    m = no_kl(epochs=1).fit(data(rng))
    m.save_checkpoint(tmp_path / "ckpt")
    with pytest.raises(ValueError, match="checkpoint is for"):
        VGAN(verbose=False, device="cpu").restore_checkpoint(tmp_path / "ckpt")
    with pytest.raises(RuntimeError, match="fit first"):
        no_kl().save_checkpoint(tmp_path / "none")


def test_refit_checkpoint_stores_live_bandwidth(tmp_path, rng):
    """A second fit's checkpoints hold its own frozen bandwidth, not the
    first fit's ``self.bandwidth``."""
    x1 = data(rng)
    x2 = data(rng) * 5.0
    ck = tmp_path / "bw2"
    m = no_kl(epochs=4, checkpoint_dir=ck, checkpoint_every=2).fit(x1)
    bw1 = m.bandwidth
    m.fit(x2)
    m2 = no_kl().restore_checkpoint(ck)
    assert m2.bandwidth != bw1
    np.testing.assert_allclose(m2.bandwidth, m.bandwidth, rtol=1e-6)


def test_checkpoint_atomic_pointer_and_legacy_layout(tmp_path):
    """An interrupted save (directory made, pointer not flipped) leaves the
    previous checkpoint readable; the flat layout restores; older
    checkpoints are pruned after the flip."""
    config = TrainConfig(ndims=8, batch_size=4)
    state = init_no_kl_state(config, 0, "cpu")
    p = tmp_path / "atomic"
    save_train_state(p, train_state_to_payload(state), {"tag": 1})
    (p / "ckpt_99").mkdir()
    assert load_meta(p)["tag"] == 1
    restored = train_state_from_payload(restore_train_state(p), config, "cpu")
    assert torch.equal(restored.rng.get_state(), state.rng.get_state())
    for k, v in state.generator.state_dict().items():
        assert torch.equal(restored.generator.state_dict()[k], v), k

    save_train_state(p, train_state_to_payload(state), {"tag": 2})
    assert sorted(q.name for q in p.iterdir()) == ["LATEST", "ckpt_100"]
    assert load_meta(p)["tag"] == 2

    legacy = tmp_path / "legacy"
    legacy.mkdir()
    shutil.move(str(p / "ckpt_100" / "state.pt"), str(legacy / "state.pt"))
    shutil.move(str(p / "ckpt_100" / "meta.json"), str(legacy / "meta.json"))
    assert load_meta(legacy)["tag"] == 2
    train_state_from_payload(restore_train_state(legacy), config, "cpu")
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "empty")


def test_payload_rejects_another_device_type():
    config = TrainConfig(ndims=8, batch_size=4)
    payload = train_state_to_payload(init_no_kl_state(config, 0, "cpu"))
    payload["device_type"] = "cuda"
    with pytest.raises(ValueError, match="same device type"):
        train_state_from_payload(payload, config, "cpu")


def test_fused_fit_checkpoint_restores(tmp_path, rng):
    x = data(rng, n=128, d=16)
    ck = tmp_path / "fused"
    m = VGAN_no_kl(batch_size=64, epochs=2, lr=0.01, verbose=False, fit_impl="fused",
                   device="cpu", checkpoint_dir=ck).fit(x)
    # the learning rate is a constructor argument, not part of the checkpoint
    m2 = VGAN_no_kl(lr=0.01, verbose=False, device="cpu").restore_checkpoint(ck)
    np.testing.assert_array_equal(m2.generate_subspaces(32), m.generate_subspaces(32))
    assert m2.bandwidth == m.bandwidth
    assert m2.train_history["generator_loss"] == m.train_history["generator_loss"]
    # both continue identically on the scan path
    m.continue_fit(x, 1)
    m2.continue_fit(x, 1)
    assert m2.train_history["generator_loss"] == m.train_history["generator_loss"]
