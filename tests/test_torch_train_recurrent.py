"""Training the recurrent and xLSTM families on the port against the
reference, at smoke size (fp32 compute; shared set-up and tolerances in
tests/_torch_train.py): recurrentgemma-2b (``rec`` layers: the RG-LRU's
log-depth scan under autograd, and a sliding-window ``local`` layer) and
xlstm-350m (the chunkwise mLSTM and the sLSTM's token loop), each cell
run from a zero state.  The loss and every gradient leaf against
``jax.value_and_grad`` of the reference's ``loss_fn`` (xlstm also at 150
tokens: the mLSTM in chunks of 64 with a padded last one); the params after three
``make_train_step`` steps; remat equal to no remat; the launcher on the
CPU."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import _torch_train as H
from _torch_train import one_thread  # noqa: F401  (the fixture)
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.api import get_api

pytestmark = pytest.mark.usefixtures("one_thread")

ARCHS = ["recurrentgemma-2b", "xlstm-350m"]


@pytest.mark.parametrize("arch,b,s", [(a, 4, 16) for a in ARCHS] + [("xlstm-350m", 1, 150)])
def test_loss_and_grads_match(arch, b, s):
    rcfg, cfg = H.configs(arch)
    batch = H.batch(cfg, b=b, s=s)
    (rloss, rm), rgrads = H.ref_loss_and_grads(rcfg, batch)
    loss, m, grads = H.port_loss_and_grads(cfg, H.port_params(rcfg), batch)
    assert float(loss) == pytest.approx(float(rloss), rel=1e-5)
    assert float(m["aux"]) == float(rm["aux"]) == 0.0
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
def test_remat_equals_no_remat(arch):
    rcfg, cfg = H.configs(arch)
    b = H.batch(cfg)
    _, _, want = H.port_loss_and_grads(cfg, H.port_params(rcfg), b)
    _, _, got = H.port_loss_and_grads(dataclasses.replace(cfg, remat=True),
                                      H.port_params(rcfg), b)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains(arch):
    args = types.SimpleNamespace(
        arch=arch, smoke=True, steps=20, batch=16, seq=64, lr=1e-2, accum=1, seed=0,
        remat=False, compression=None, mesh="host", ckpt_dir=None, ckpt_every=100,
        log_every=100, device="cpu")
    out = train.run(args)
    assert out["restarts"] == 0 and len(out["losses"]) == 20
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]
    cfg = get_config(arch, smoke=True)
    assert train.extras(cfg, get_api(cfg), 16, 0) == {}
