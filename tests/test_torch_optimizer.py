"""The port's optimizer and gradient compression against the reference's
(``repro.training.optimizer``, ``repro.distributed.compression``) on the
same numpy inputs: the schedule, AdamW and momentum SGD (weight decay on a
stacked 2-D norm leaf, none on a 1-D leaf), clipping, both codecs with
error feedback, ``payload_bytes``.  All in fp32; the tolerance is 1e-6
(absolute, on values of order 1) unless a test says otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as RGC
from repro.training import optimizer as RO

from repro_torch import interop
from repro_torch.distributed import compression as GC
from repro_torch.training import optimizer as O

TOL = dict(rtol=0, atol=1e-6)


def _tree(seed: int, scale: float = 1.0):
    """A params-like tree: a matrix, a stacked norm scale (layers, d) --
    2-D, so decayed -- and a 1-D final norm scale, which is not."""
    r = np.random.default_rng(seed)
    f = lambda *s: (r.normal(size=s) * scale).astype(np.float32)
    return {"embed": {"tok": f(6, 5)}, "final_norm": {"scale": f(5)},
            "unit": [{"ln1": {"scale": f(3, 5)}, "attn": {"wq": f(3, 5, 4)}}]}


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def _port_leaves(tree):
    from repro_torch.core.weight_plan import flatten_leaves
    return [t.detach().numpy() for t in flatten_leaves(tree)]


def _assert_trees(port, ref, **tol):
    got, want = _port_leaves(port), _leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **(tol or TOL))


@pytest.mark.parametrize("warmup,decay,min_ratio", [(10, 100, 0.1), (0, 50, 0.5), (1, 1, 0.0)])
def test_lr_schedule_matches(warmup, decay, min_ratio):
    rc = RO.OptimizerConfig(lr=3e-3, warmup_steps=warmup, decay_steps=decay,
                            min_lr_ratio=min_ratio)
    pc = O.OptimizerConfig(lr=3e-3, warmup_steps=warmup, decay_steps=decay,
                           min_lr_ratio=min_ratio)
    for step in (0, 1, 5, 9, 10, 11, 30, 99, 100, 101, 1000):
        want = float(RO.lr_schedule(rc, jnp.asarray(step, jnp.int32)))
        got = float(O.lr_schedule(pc, torch.tensor(step, dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_apply_updates_matches(name, clip):
    """Three updates on the same grads; decay on every >= 2-D leaf of the
    stacked tree (the (3, 5) norm leaf included), none on the 1-D leaf."""
    kw = dict(name=name, lr=0.05, weight_decay=0.1, grad_clip=clip, warmup_steps=2,
              decay_steps=10)
    rc, pc = RO.OptimizerConfig(**kw), O.OptimizerConfig(**kw)
    params, grads = _tree(0), [_tree(s, 0.5) for s in (1, 2, 3)]
    rp, rs = params, RO.init_opt_state(rc, params)
    pp = interop.params_from_reference(params)
    ps = O.init_opt_state(pc, pp)
    for g in grads:
        rp, rs, rm = RO.apply_updates(rc, rp, g, rs)
        pp, ps, pm = O.apply_updates(pc, pp, interop.params_from_reference(g), ps)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-6)
    _assert_trees(pp, rp)
    assert int(ps["step"]) == int(rs["step"]) == 3 and ps["step"].dtype == torch.int32
    for key in ("mu", "nu") if name == "adamw" else ("mom",):
        _assert_trees(ps[key], rs[key])


def test_weight_decay_reaches_stacked_norm_not_1d():
    """Zero grads: only decoupled decay moves a leaf, and it moves the
    stacked (3, 5) norm scale and the matrices, never the 1-D scale."""
    cfg = O.OptimizerConfig(lr=0.1, weight_decay=1.0, grad_clip=0.0, warmup_steps=0,
                            decay_steps=10**9, min_lr_ratio=1.0)
    params = interop.params_from_reference(_tree(0))
    before = {k: v.clone() for k, v in (("ln1", params["unit"][0]["ln1"]["scale"]),
                                          ("final", params["final_norm"]["scale"]))}
    zeros = interop.params_from_reference(jax.tree.map(np.zeros_like, _tree(0)))
    O.apply_updates(cfg, params, zeros, O.init_opt_state(cfg, params))
    torch.testing.assert_close(params["unit"][0]["ln1"]["scale"], before["ln1"] * 0.9,
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(params["final_norm"]["scale"], before["final"])


def test_clip_by_global_norm_matches():
    g = _tree(4, 100.0)
    rc, rn = RO.clip_by_global_norm(g, 1.0)
    pcl, pn = O.clip_by_global_norm(interop.params_from_reference(g), 1.0)
    assert float(pn) == pytest.approx(float(rn), rel=1e-6) and float(pn) > 1.0
    _assert_trees(pcl, rc)
    assert float(O.global_norm(pcl)) == pytest.approx(1.0, rel=1e-5)


def test_opt_state_axes_mirror_params():
    axes = {"w": ("d", "ff")}
    for name in ("adamw", "sgd"):
        for ef in (False, True):
            assert O.opt_state_axes(O.OptimizerConfig(name=name), axes, ef) == \
                RO.opt_state_axes(RO.OptimizerConfig(name=name), axes, ef)


def test_int8_codec_matches():
    """Includes exact .5 ties of g / scale: both round half to even."""
    r = np.random.default_rng(5)
    g = r.normal(size=(64, 33)).astype(np.float32)
    g[0, :4] = [127.0, -63.5, 0.5, 1.5]  # amax 127: scale 1, ties at -63.5/0.5/1.5
    np.testing.assert_array_equal(GC._int8_codec(torch.from_numpy(g)).numpy(),
                                  np.asarray(RGC._int8_codec(jnp.asarray(g))))


@pytest.mark.parametrize("shape", [(4, 4), (5, 4), (40, 33)])
def test_topk_codec_matches(shape):
    """A leaf of <= 16 entries passes through; ties at the threshold are
    kept (>=)."""
    r = np.random.default_rng(6)
    g = r.normal(size=shape).astype(np.float32)
    g.reshape(-1)[:3] = g.reshape(-1)[3]  # a tie
    for frac in (0.1, 0.25):
        np.testing.assert_array_equal(
            GC._topk_codec(torch.from_numpy(g), frac).numpy(),
            np.asarray(RGC._topk_codec(jnp.asarray(g), frac)))


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compress_tree_error_feedback_matches(kind):
    """Two rounds: the residual of round 1 feeds round 2; a 1-D leaf passes
    through with a zero residual."""
    cfg = O.OptimizerConfig()
    params = _tree(0)
    rs = RO.init_opt_state(RO.OptimizerConfig(), params, error_feedback=True)
    ps = O.init_opt_state(cfg, interop.params_from_reference(params), error_feedback=True)
    for seed in (7, 8):
        g = _tree(seed)
        rg, rs = RGC.compress_tree(g, rs, kind=kind)
        pg, ps = GC.compress_tree(interop.params_from_reference(g), ps, kind=kind)
        _assert_trees(pg, rg)
        _assert_trees(ps["ef"], rs["ef"])
    assert not ps["ef"]["final_norm"]["scale"].any()


def test_compress_tree_needs_ef():
    params = interop.params_from_reference(_tree(0))
    state = O.init_opt_state(O.OptimizerConfig(), params)
    with pytest.raises(ValueError, match="error_feedback=True"):
        GC.compress_tree(params, state)


@pytest.mark.parametrize("kind", [None, "int8", "topk"])
def test_payload_bytes_matches(kind):
    g = _tree(0)
    assert GC.payload_bytes(interop.params_from_reference(g), kind) == \
        RGC.payload_bytes(g, kind)
    with pytest.raises(ValueError):
        GC.payload_bytes(interop.params_from_reference(g), "fp8")
