"""Training the MoE family on the port against the reference, at smoke size
(fp32 compute; shared set-up and tolerances in tests/_torch_train.py):
granite-moe-1b-a400m and qwen2-moe-a2.7b (with its shared experts).  The
loss, the Switch aux loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn``; the params after
three ``make_train_step`` steps; a batch past the full-capacity limit
whose assignments are dropped; remat equal to no remat with the routing
recomputed to the same assignments; the launcher on the CPU and a
checkpoint resume."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import _torch_train as H
from _torch_train import one_thread  # noqa: F401  (the fixture)
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves
from repro_torch.launch import train
from repro_torch.models import moe as MOE
from repro_torch.models.api import get_api

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_aux_and_grads_match(arch):
    rcfg, cfg = H.configs(arch)
    b = H.batch(cfg)
    (rloss, rm), rgrads = H.ref_loss_and_grads(rcfg, b)
    loss, m, grads = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(m["loss"].detach()) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(rm["aux"]) > 0
    assert float(m["aux"].detach()) == pytest.approx(float(rm["aux"]), rel=1e-5)
    H.assert_grads(grads, rgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_after_three_steps_match(arch):
    rcfg, cfg = H.configs(arch)
    rparams, rlosses = H.ref_steps(rcfg, cfg, 3)
    params, losses = H.port_steps(rcfg, cfg, 3)
    np.testing.assert_allclose(losses, rlosses, rtol=1e-5)
    H.assert_params(params, rparams,
                    H.roundoff_masks(cfg, H.port_params(rcfg), H.batch(cfg)))


@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_assignments_match(arch, monkeypatch):
    """B 4 x 80 = 320 tokens, past FULL_CAPACITY_TOKENS, at capacity factor
    0.5 in both packages: assignments are dropped (their spare row of the
    dispatch buffer is discarded), and the loss and gradients still agree."""
    rcfg, cfg = H.configs(arch)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, capacity_factor=0.5))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    b = H.batch(cfg, b=4, s=80)
    assert 4 * 80 > MOE.FULL_CAPACITY_TOKENS
    (rloss, rm), rgrads = H.ref_loss_and_grads(rcfg, b)
    spy = H.RouteSpy(monkeypatch)
    loss, pm, grads = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    dropped = [float((~keep).float().mean()) for _, keep in spy.calls]
    assert len(dropped) == cfg.n_layers and all(d > 0 for d in dropped), dropped
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(pm["aux"].detach()) == pytest.approx(float(rm["aux"]), rel=1e-5)
    H.assert_grads(grads, rgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch, monkeypatch):
    """With ``remat`` each layer's routing runs again in the backward and
    keeps the forward's assignments; gradients equal bit for bit."""
    rcfg, cfg = H.configs(arch)
    b = H.batch(cfg)
    _, _, want = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    spy = H.RouteSpy(monkeypatch)
    _, _, got = H.port_loss_and_grads(dataclasses.replace(cfg, remat=True),
                                      H.port_params(rcfg), b)
    n = cfg.n_layers
    assert len(spy.calls) == 2 * n  # the forward's, then the backward's in reverse
    for (i0, k0), (i1, k1) in zip(spy.calls[:n], spy.calls[n:][::-1]):
        assert torch.equal(i0, i1) and torch.equal(k0, k1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _args(**kw):
    base = dict(arch="granite-moe-1b-a400m", smoke=True, steps=20, batch=16, seq=64, lr=1e-2,
                accum=1, seed=0, remat=False, compression=None, mesh="host", ckpt_dir=None,
                ckpt_every=100, log_every=100, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains(arch):
    out = train.run(_args(arch=arch))
    assert out["restarts"] == 0 and len(out["losses"]) == 20
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]
    cfg = get_config(arch, smoke=True)
    assert train.extras(cfg, get_api(cfg), 16, 0) == {}


def test_checkpoint_resume_matches_uninterrupted(tmp_path):
    d = str(tmp_path / "ck")
    full = train.run(_args(steps=6, batch=4, seq=32))
    train.run(_args(steps=3, batch=4, seq=32, ckpt_dir=d))
    assert store.latest_step(d) == 3
    resumed = train.run(_args(steps=6, batch=4, seq=32, ckpt_dir=d))
    assert resumed["losses"] == full["losses"][3:]
    for a, b in zip(flatten_leaves((resumed["params"], resumed["opt_state"])),
                    flatten_leaves((full["params"], full["opt_state"]))):
        assert torch.equal(a, b)
