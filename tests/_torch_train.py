"""Shared set-up of the training parity tests of the MoE, recurrent, xLSTM,
enc-dec and VLM families (tests/test_torch_train_families.py,
test_torch_train_encdec.py): the reference's smoke params carried into the
port by ``interop``, batches with the frontend stubs' inputs drawn as the
launchers draw them, the loss and gradients of both packages' ``loss_fn``,
and both packages' ``make_train_step`` (the reference's under ``jax.jit``,
no mesh: its launcher is red, ROADMAP C2).  Leaves compare in the
reference's flatten order.

Tolerances (as tests/test_torch_training.py's, fp32 compute): the loss to
1e-5 relative; a gradient leaf to 1e-4 of its max |g|; params after the
steps to 1e-4 absolute, a tenth of lr.  An element whose step-0 gradient
is roundoff -- below 1e-5 of its leaf's max |g|, e.g. the mLSTM's
input-gate bias (~1e-9 against ~1e-3: the normalised read-out cancels it)
or the embedding row of a token that only the unscored last position
holds -- is held to 3 lr instead: AdamW's normalised update turns that
roundoff into a step of up to lr whose sign the two packages draw apart
(seen: 1.0e-4 on xlstm's b_if, 4.0e-4 on internvl's embedding), while a
wrong update of a real gradient moves an element by about lr."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.api import get_api as ref_get_api
from repro.training import optimizer as RO
from repro.training.trainer import make_train_step as ref_make_train_step

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves
from repro_torch.data import LMDataConfig, synthetic_lm_batch
from repro_torch.launch.train import extras
from repro_torch.models import moe as MOE
from repro_torch.models.api import get_api
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step

@pytest.fixture
def one_thread():
    """Torch on one intra-op thread for the test: the suite runs several
    workers on the machine's cores, and a smoke model's small ops on a full
    thread pool each spin against the others (a 20-step launcher run beside
    five busy processes: 81 s on the default pool, 0.9 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPT = dict(lr=1e-3, grad_clip=1.0, warmup_steps=0, decay_steps=10**9, min_lr_ratio=1.0)
PARAM_ATOL = 1e-4
B, S = 4, 16


def configs(arch: str, **changes) -> tuple:
    """(reference config, port config) of the smoke config with
    ``changes`` applied to both."""
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    return dataclasses.replace(rcfg, **changes), dataclasses.replace(cfg, **changes)


@functools.lru_cache(maxsize=None)
def ref_params(rcfg):
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, params)


def port_params(rcfg):
    return interop.params_from_reference(ref_params(rcfg))


def batch(cfg, b: int = B, s: int = S, step: int = 0) -> dict:
    """Step ``step``'s synthetic tokens plus the family's ``extras``, as
    numpy arrays."""
    out = synthetic_lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=s, global_batch=b), step)
    out.update(extras(cfg, get_api(cfg), b, step))
    return out


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def ref_loss_and_grads(rcfg, batch):
    """((loss, metrics), gradient leaves) of the reference's ``loss_fn``."""
    (loss, m), g = jax.value_and_grad(
        lambda p: ref_get_api(rcfg).loss_fn(rcfg, p, to_jax(batch)), has_aux=True)(
        ref_params(rcfg))
    return (loss, m), jax.tree_util.tree_leaves(g)


def port_loss_and_grads(cfg, params, batch):
    """(loss, metrics, gradient leaves) of the port's ``loss_fn``."""
    leaves = flatten_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = get_api(cfg).loss_fn(cfg, params, to_torch(batch))
    return loss.detach(), metrics, torch.autograd.grad(loss, leaves)


def assert_grads(got, want, rel=1e-4):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
                                   err_msg=f"leaf {i}")


def roundoff_masks(cfg, params, batch, rel: float = 1e-5) -> list:
    """Per leaf, the elements whose port gradient on ``batch`` is below
    ``rel`` of the leaf's max |g| (roundoff)."""
    _, _, grads = port_loss_and_grads(cfg, params, batch)
    return [(g.abs() <= rel * g.abs().max()).numpy() for g in grads]


def assert_params(port, ref, roundoff=None, atol=PARAM_ATOL):
    """Every element to ``atol``; with ``roundoff`` (``roundoff_masks``),
    the masked elements to 3 lr."""
    got, want = flatten_leaves(port), jax.tree_util.tree_leaves(ref)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g.detach().numpy() - np.asarray(w))
        tol = np.full(d.shape, atol, dtype=np.float32)
        if roundoff is not None:
            tol[roundoff[i]] = 3 * OPT["lr"]
        assert (d <= tol).all(), (i, float(d.max()), int((d > atol).sum()))


def ref_steps(rcfg, cfg, n: int):
    oc = RO.OptimizerConfig(**OPT)
    step = jax.jit(ref_make_train_step(rcfg, ref_get_api(rcfg).loss_fn, oc))
    params = ref_params(rcfg)
    opt = RO.init_opt_state(oc, params)
    losses = []
    for s in range(n):
        params, opt, m = step(params, opt, to_jax(batch(cfg, step=s)))
        losses.append(float(m["loss"]))
    return params, losses


def port_steps(rcfg, cfg, n: int):
    oc = O.OptimizerConfig(**OPT)
    step = make_train_step(cfg, get_api(cfg).loss_fn, oc)
    params = port_params(rcfg)
    opt = O.init_opt_state(oc, params)
    losses = []
    for s in range(n):
        params, opt, m = step(params, opt, to_torch(batch(cfg, step=s)))
        losses.append(float(m["loss"]))
    return params, losses


class RouteSpy:
    """Records every ``moe.route`` call's (idx, keep) while in use."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = MOE.route

        def spy(cfg, xg, router, **kw):
            r = real(cfg, xg, router, **kw)
            self.calls.append((r.idx.clone(), r.keep.clone()))
            return r

        monkeypatch.setattr(MOE, "route", spy)
