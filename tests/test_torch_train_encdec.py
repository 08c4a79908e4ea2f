"""Training the enc-dec and VLM families on the port against the
reference, at smoke size (fp32 compute; shared set-up and tolerances in
tests/_torch_train.py): whisper-tiny (the encoder over its frames, the
teacher-forced decoder with cross-attention) and internvl2-2b (the
projected patches before the tokens).  The loss and every gradient leaf
against ``jax.value_and_grad`` of the reference's ``loss_fn``; the params
after three ``make_train_step`` steps; whisper at 1100 frames, where the
encoder's self-attention and the cross-attention are the
``FlashAttention`` Function (never ``layers.attention``, whose kernel B6
has no backward); internvl's remat; the launcher on the CPU with the
frames and patches the reference's launcher draws."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import _torch_train as H
from _torch_train import one_thread  # noqa: F401  (the fixture)
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import layers as L
from repro_torch.models.api import get_api

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["whisper-tiny", "internvl2-2b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    rcfg, cfg = H.configs(arch)
    b = H.batch(cfg)
    (rloss, rm), rgrads = H.ref_loss_and_grads(rcfg, b)
    loss, m, grads = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    assert set(m) == set(rm)  # {"loss"} for the enc-dec, {"loss", "aux"} for the VLM
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(m["loss"].detach()) == pytest.approx(float(rm["loss"]), rel=1e-5)
    H.assert_grads(grads, rgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_after_three_steps_match(arch):
    rcfg, cfg = H.configs(arch)
    rparams, rlosses = H.ref_steps(rcfg, cfg, 3)
    params, losses = H.port_steps(rcfg, cfg, 3)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    H.assert_params(params, rparams,
                    H.roundoff_masks(cfg, H.port_params(rcfg), H.batch(cfg)))


def test_whisper_long_frames_through_flash_function(monkeypatch):
    """1 encoder and 1 decoder layer at 1100 frames (past the 1024-token
    dense threshold): one ``FlashAttention`` forward and backward for the
    encoder's non-causal self-attention and one for the non-causal
    cross-attention (16 queries over 1100 frames); the decoder's causal
    self-attention stays dense.  Loss and gradients against the
    reference's custom VJP."""
    rcfg, cfg = H.configs("whisper-tiny", n_frames=1100, enc_layers=1, n_layers=1)
    b = H.batch(cfg, b=2)
    assert b["frames"].shape == (2, 1100, cfg.d_model)
    (rloss, _), rgrads = H.ref_loss_and_grads(rcfg, b)

    def refused(*a, **kw):
        raise AssertionError("the training path called layers.attention")

    monkeypatch.setattr(L, "attention", refused)
    f0, b0 = L.FlashAttention.forward_calls, L.FlashAttention.backward_calls
    loss, _, grads = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    assert (L.FlashAttention.forward_calls - f0, L.FlashAttention.backward_calls - b0) == (2, 2)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    H.assert_grads(grads, rgrads)


def test_internvl_remat_equals_no_remat():
    rcfg, cfg = H.configs("internvl2-2b")
    b = H.batch(cfg)
    _, _, want = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    _, _, got = H.port_loss_and_grads(dataclasses.replace(cfg, remat=True),
                                      H.port_params(rcfg), b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch,key,n", [("whisper-tiny", "frames", "n_frames"),
                                        ("internvl2-2b", "patches", "n_patches")])
def test_launcher_trains_with_the_reference_extras(arch, key, n):
    """The launcher's ``extras`` are the reference launcher's draws
    (``src/repro/launch/train.py:102-110``: N(0, 1) of shape (host batch,
    n, d) from ``np.random.default_rng(step)``, cast to fp32), bit for bit;
    20 steps lower the loss."""
    cfg = get_config(arch, smoke=True)
    for step in (0, 5):
        got = train.extras(cfg, get_api(cfg), 16, step)
        want = np.random.default_rng(step).normal(
            size=(16, getattr(cfg, n), cfg.d_model)).astype(np.float32)
        assert list(got) == [key] and got[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want)
    args = types.SimpleNamespace(
        arch=arch, smoke=True, steps=20, batch=16, seq=64, lr=1e-2, accum=1, seed=0,
        remat=False, compression=None, mesh="host", ckpt_dir=None, ckpt_every=100,
        log_every=100, device="cpu")
    out = train.run(args)
    assert out["restarts"] == 0 and len(out["losses"]) == 20
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "whisper-tiny", "internvl2-2b"])
def test_softcap_refused_by_name(arch):
    """Training takes what serving takes: logit softcaps, once refused by
    name (ROADMAP A8c), train in the transformer's forward and in the
    enc-dec's, the loss the reference's at cap 30."""
    rcfg, cfg = H.configs(arch, logit_softcap=30.0)
    batch = H.batch(cfg)
    (rloss, _), _ = H.ref_loss_and_grads(rcfg, batch)
    loss, _, _ = H.port_loss_and_grads(cfg, H.port_params(rcfg), batch)
    np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-5)
