"""PyTorch port vs the JAX reference for the xLSTM blocks
(``repro_torch/models/ssm.py``) and the causal convolution they share with
the RG-LRU: the same numpy inputs and the reference's own params (carried
across by ``interop``) through both packages, fp32.

Tolerance: rtol 1e-5 / atol 1e-5 for the convolution and the blocks'
outputs and states (fp32 sums in another order; the mLSTM's chunkwise form
reassociates its exponent sums, the reference's too).  The chunkwise mLSTM
is held to the reference's chunkwise form, to the reference's sequential
form (its ``REPRO_MLSTM_SEQUENTIAL`` switch, set on the reference side
only) at rtol/atol 1e-4, and to the port's own sequential recurrence.
Prefill over S tokens followed by one decode step equals a prefill over
S + 1 in both packages."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import ssm as RS

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import ssm as S

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SEQ = dict(rtol=1e-4, atol=1e-4)
ARCH = "xlstm-350m"


def _cfgs():
    return ref_get_config(ARCH, smoke=True), get_config(ARCH, smoke=True)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cell(kind: str, seed: int = 0):
    """(reference params, port params) of one mLSTM or sLSTM cell."""
    rcfg, _ = _cfgs()
    init = RS.init_mlstm if kind == "mlstm" else RS.init_slstm
    rp = _np(init(rcfg, jax.random.key(seed)))
    return rp, interop.params_from_reference(rp)


def _x(B, T, d, seed):
    return np.random.default_rng(seed).standard_normal((B, T, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _states_close(got: dict, want: dict, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], tol)


# ---------------------------------------------------------------------------
# the causal convolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_len", [1, 3, 9])
def test_causal_conv_matches_reference_with_carried_state(S_len):
    rng = np.random.default_rng(S_len)
    u = rng.standard_normal((2, S_len, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    ry, rs = RS._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(state))
    y, s = S.causal_conv(_t(u), _t(w), _t(state))
    _close(y, ry)
    _close(s, rs)
    ry0, rs0 = RS._causal_conv(jnp.asarray(u), jnp.asarray(w), None)
    y0, s0 = S.causal_conv(_t(u), _t(w), None)
    _close(y0, ry0)
    _close(s0, rs0)


def test_causal_conv_carries_across_calls():
    """Two calls chained through the state equal one call over both spans."""
    rng = np.random.default_rng(5)
    u = _t(rng.standard_normal((2, 11, 8)).astype(np.float32))
    w = _t(rng.standard_normal((4, 8)).astype(np.float32))
    y, s = S.causal_conv(u, w)
    y1, s1 = S.causal_conv(u[:, :6], w)
    y2, s2 = S.causal_conv(u[:, 6:], w, s1)
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y)
    torch.testing.assert_close(s2, s)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def test_mlstm_state_starts_with_m_at_minus_1e30():
    rcfg, cfg = _cfgs()
    st = S.init_mlstm_state(cfg, 2, torch.bfloat16)
    rst = RS.init_mlstm_state(rcfg, 2, jnp.bfloat16)
    for k in rst:
        assert tuple(st[k].shape) == rst[k].shape, k
        assert str(st[k].dtype).split(".")[-1] == str(rst[k].dtype), k
    np.testing.assert_array_equal(st["m"].numpy(), np.asarray(rst["m"]))
    assert float(st["m"].max()) == float(np.float32(-1e30))
    assert not st["C"].any() and not st["n"].any()


@pytest.mark.parametrize("S_len", [1, 7, 64, 100])
def test_apply_mlstm_matches_reference(S_len):
    """S 1 is the decode step; 7 one short chunk; 64 one whole chunk; 100
    two chunks of 64, the second padded (i = -1e30, f = +1e30)."""
    rcfg, cfg = _cfgs()
    rp, tp = _cell("mlstm")
    x = _x(2, S_len, cfg.d_model, S_len)
    ry, rst = RS.apply_mlstm(rcfg, rp, jnp.asarray(x))
    y, st = S.apply_mlstm(cfg, tp, _t(x))
    _close(y, ry)
    _states_close(st, rst)


@pytest.mark.parametrize("S_len", [7, 100])
def test_mlstm_chunkwise_matches_reference_sequential(S_len, monkeypatch):
    """The port's chunkwise prefill against the reference's exact
    per-token scan (the reference's switch, set for the reference only)."""
    rcfg, cfg = _cfgs()
    rp, tp = _cell("mlstm", seed=1)
    x = _x(2, S_len, cfg.d_model, 10 + S_len)
    monkeypatch.setenv("REPRO_MLSTM_SEQUENTIAL", "1")
    ry, rst = RS.apply_mlstm(rcfg, rp, jnp.asarray(x))
    monkeypatch.delenv("REPRO_MLSTM_SEQUENTIAL")
    y, st = S.apply_mlstm(cfg, tp, _t(x))
    _close(y, ry, TOL_SEQ)
    _states_close(st, rst, TOL_SEQ)


@pytest.mark.parametrize("chunk", [4, 64])
def test_port_chunkwise_equals_port_sequential_from_a_carried_state(chunk):
    rng = np.random.default_rng(chunk)
    B, S_len, H, hd = 2, 37, 3, 5
    q, k, v = (_t(rng.standard_normal((B, S_len, H, hd)).astype(np.float32)) for _ in range(3))
    i_raw = _t(rng.standard_normal((B, S_len, H)).astype(np.float32))
    f_raw = _t((rng.standard_normal((B, S_len, H)) + 2).astype(np.float32))
    C0 = _t(rng.standard_normal((B, H, hd, hd)).astype(np.float32))
    n0 = _t(rng.standard_normal((B, H, hd)).astype(np.float32))
    m0 = _t(rng.standard_normal((B, H)).astype(np.float32))
    seq = S.mlstm_sequential(q, k, v, i_raw, f_raw, C0, n0, m0)
    chk = S._mlstm_chunkwise(q, k, v, i_raw, f_raw, C0, n0, m0, chunk=chunk)
    for a, b in zip(chk, seq):
        torch.testing.assert_close(a, b, **TOL_SEQ)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def test_slstm_state_and_up_width():
    rcfg, cfg = _cfgs()
    st = S.init_slstm_state(cfg, 3)
    rst = RS.init_slstm_state(rcfg, 3)
    for k in rst:
        assert tuple(st[k].shape) == rst[k].shape and st[k].dtype == torch.float32, k
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(rst[k]))
    assert S.slstm_up(get_config(ARCH)) == 1365  # round(4 * 1024 / 3)
    shapes = S.slstm_shapes(get_config(ARCH))
    assert shapes["w_up"][0] == (1024, 2730) and shapes["w_down"][0] == (1365, 1024)


@pytest.mark.parametrize("S_len", [1, 9])
def test_apply_slstm_matches_reference(S_len):
    rcfg, cfg = _cfgs()
    rp, tp = _cell("slstm")
    x = _x(2, S_len, cfg.d_model, 30 + S_len)
    ry, rst = RS.apply_slstm(rcfg, rp, jnp.asarray(x))
    y, st = S.apply_slstm(cfg, tp, _t(x))
    _close(y, ry)
    _states_close(st, rst)


# ---------------------------------------------------------------------------
# prefill S, then decode == prefill S + 1 (both packages)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_prefill_then_decode_equals_longer_prefill(kind):
    rcfg, cfg = _cfgs()
    rp, tp = _cell(kind, seed=2)
    x = _x(2, 12, cfg.d_model, 77)
    rfn = RS.apply_mlstm if kind == "mlstm" else RS.apply_slstm
    fn = S.apply_mlstm if kind == "mlstm" else S.apply_slstm
    ry_all, rst_all = rfn(rcfg, rp, jnp.asarray(x))
    _, rst = rfn(rcfg, rp, jnp.asarray(x[:, :11]))
    ry1, rst1 = rfn(rcfg, rp, jnp.asarray(x[:, 11:]), rst)
    np.testing.assert_allclose(np.asarray(ry1)[:, 0], np.asarray(ry_all)[:, -1], **TOL_SEQ)
    y_all, st_all = fn(cfg, tp, _t(x))
    _, st = fn(cfg, tp, _t(x[:, :11]))
    st = {k: v.clone() for k, v in st.items()}
    y1, st1 = fn(cfg, tp, _t(x[:, 11:]), st)
    torch.testing.assert_close(y1[:, 0], y_all[:, -1], **TOL_SEQ)
    _close(y1, ry1)
    for k in st_all:
        torch.testing.assert_close(st1[k], st_all[k], **TOL_SEQ)
        _close(st1[k], rst1[k])


def test_full_width_cell_shapes_match_reference():
    cfg, rcfg = get_config(ARCH), ref_get_config(ARCH)
    for kind, mine, ref in (("mlstm", S.mlstm_shapes, RS.init_mlstm),
                            ("slstm", S.slstm_shapes, RS.init_slstm)):
        want = jax.eval_shape(lambda: ref(rcfg, jax.random.key(0)))
        got = mine(cfg)
        assert set(got) == set(want), kind
        for k, (shape, _) in got.items():
            assert shape == want[k].shape, (kind, k)
    # the mLSTM's heads: 4 of 512 over the 2048-wide up projection
    st = S.init_mlstm_state(cfg, 1, torch.bfloat16, device="meta")
    assert tuple(st["C"].shape) == (1, 4, 512, 512)
    assert math.prod(st["C"].shape) * 4 == 4 * 512 * 512 * 4
