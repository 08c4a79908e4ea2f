"""PyTorch port vs the JAX reference: the paper's FC nets and what they run on.

Same numpy inputs feed both packages; reference params reach the port
through ``interop.params_from_reference``.  On the CPU the port's kernel
wrappers run their plain versions and the reference's Pallas kernels run in
interpret mode.  Tolerances:
  * Q7.8 (B8, ``forward_q78``, ``forward_q78_sectioned``) and the (w,z)^3
    codec: exact -- integer arithmetic and exact fp32 steps.
  * fp32 products (B5, B7, ``forward_fp32``, ``forward_pruned``): rtol 1e-5 /
    atol 1e-5 -- both sum in fp32 in another order over K <= 2000; the nets'
    outputs are sigmoids in (0, 1).
  * The paper model and the schedule: equal (the same float arithmetic).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as RB
from repro.core import perf_model as RP
from repro.core import pruning as RPr
from repro.core import sparse_format as RS
from repro.kernels import ops as rops
from repro.models import fcnet as RF

from repro_torch import interop
from repro_torch.core import batching as TB
from repro_torch.core import perf_model as TP
from repro_torch.core import pruning as TPr
from repro_torch.core import sparse_format as TS
from repro_torch.core import weight_plan as TW
from repro_torch.kernels import batched_ffn as BF
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as QM
from repro_torch.models import fcnet as TF

FP32_TOL = dict(rtol=1e-5, atol=1e-5)
NETS = list(RF.PAPER_FCNETS)
ACTIVATIONS = ["linear", "relu", "sigmoid", "gelu", "silu"]


def _rng(seed):
    return np.random.default_rng(seed)


_PARAMS: dict = {}


def _params(name):
    """The reference's init_params for net ``name`` (key 0) as numpy, built
    once per process."""
    if name not in _PARAMS:
        p = RF.init_params(RF.PAPER_FCNETS[name], jax.random.key(0))
        _PARAMS[name] = jax.tree_util.tree_map(np.asarray, p)
    return _PARAMS[name]


# ---------------------------------------------------------------------------
# the kernels' plain versions against interpret-mode Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_batched_ffn_plain_matches_pallas(activation):
    r = _rng(0)
    x = r.normal(size=(5, 70)).astype(np.float32)
    w = (r.normal(size=(70, 37)) / 8).astype(np.float32)
    b = r.normal(size=(37,)).astype(np.float32)
    want = rops.batched_ffn(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            activation=activation, interpret=True)
    got = BF.batched_ffn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                         activation=activation)
    assert got.shape == (5, 37) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_quant_matmul_plain_matches_pallas(activation):
    r = _rng(1)
    x = r.normal(size=(5, 70)).astype(np.float32)
    wq = r.integers(-127, 128, size=(70, 37)).astype(np.int8)
    s = (r.random(37) * 0.02 + 0.001).astype(np.float32)
    want = rops.quant_matmul(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(s),
                             activation=activation, interpret=True)
    got = QM.quant_matmul(torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(s),
                          activation=activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("shape", [(5, 70, 37), (2, 3000, 3)])
def test_q78_matmul_plain_matches_pallas(shape):
    """Exact, ragged and on saturated codes whose sum wraps modulo 2^32."""
    B, K, N = shape
    r = _rng(2)
    if K == 3000:
        a = r.choice(np.asarray([32767, -32768], np.int16), size=(B, K))
        w = np.full((K, N), 32767, np.int16)
    else:
        a = r.integers(-(1 << 15), 1 << 15, size=(B, K)).astype(np.int16)
        w = r.integers(-(1 << 15), 1 << 15, size=(K, N)).astype(np.int16)
    want = rops.q78_matmul(jnp.asarray(a), jnp.asarray(w), interpret=True)
    got = QM.q78_matmul(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a column section read in place (the sectioned forward's operand)
    sec = QM.q78_matmul(torch.from_numpy(a), torch.from_numpy(w)[:, 1:3])
    np.testing.assert_array_equal(sec.numpy(), np.asarray(want)[:, 1:3])


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no wrapper of B5, B7 or B8 launches."""
    before = (BF.batched_ffn.launches, QM.quant_matmul.launches, QM.q78_matmul.launches)
    x = torch.ones((2, 8))
    BF.batched_ffn(x, torch.ones((8, 3)), torch.zeros(3))
    QM.quant_matmul(x, torch.ones((8, 3), dtype=torch.int8), torch.ones(3))
    QM.q78_matmul(torch.ones((2, 8), dtype=torch.int16), torch.ones((8, 3), dtype=torch.int16))
    assert (BF.batched_ffn.launches, QM.quant_matmul.launches, QM.q78_matmul.launches) == before
    with pytest.raises(ValueError, match="activation"):
        BF.batched_ffn(x, torch.ones((8, 3)), torch.zeros(3), activation="tanhh")


# ---------------------------------------------------------------------------
# the forwards at the four published widths
# ---------------------------------------------------------------------------


def _net(name, seed=3, batch=4):
    rp = _params(name)
    x = _rng(seed).random((batch, RF.PAPER_FCNETS[name].sizes[0])).astype(np.float32)
    return RF.PAPER_FCNETS[name], TF.PAPER_FCNETS[name], rp, interop.params_from_reference(rp), x


@pytest.mark.parametrize("name", NETS)
def test_forward_fp32_matches(name):
    rcfg, tcfg, rp, tp, x = _net(name)
    assert tcfg == TF.FCNetConfig(rcfg.name, rcfg.sizes, rcfg.hidden_act, rcfg.out_act)
    assert TF.n_params_exact(tcfg) == RF.n_params_exact(rcfg) == tcfg.n_params
    want = RF.forward_fp32(rcfg, rp, jnp.asarray(x))
    got = TF.forward_fp32(tcfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("name", NETS)
def test_forward_pruned_matches(name):
    """Magnitude masks at q 0.9 are identical; the masked forward agrees."""
    rcfg, tcfg, rp, tp, x = _net(name)
    rm = RPr.update_masks(rp, 0.9)
    tm = TPr.update_masks(tp, 0.9)
    for r, t in zip(rm, tm):
        np.testing.assert_array_equal(t["w"].numpy(), np.asarray(r["w"]))
        np.testing.assert_array_equal(t["b"].numpy(), np.asarray(r["b"]))
    want = RF.forward_pruned(rcfg, rp, rm, jnp.asarray(x))
    got = TF.forward_pruned(tcfg, tp, tm, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


@pytest.mark.parametrize("name", NETS)
def test_forward_q78_and_sectioned_are_exact(name):
    rcfg, tcfg, rp, tp, x = _net(name)
    want = np.asarray(RF.forward_q78(rcfg, rp, jnp.asarray(x)))
    got = TF.forward_q78(tcfg, tp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the paper's section order (m = 114 neurons) over groups of n samples
    for n in (4, 2):
        sec_ref = np.asarray(RF.forward_q78_sectioned(rcfg, rp, jnp.asarray(x), m=114, n=n))
        sec = TF.forward_q78_sectioned(tcfg, tp, torch.from_numpy(x), m=114, n=n).numpy()
        np.testing.assert_array_equal(sec, sec_ref)
        np.testing.assert_array_equal(sec, got)


def test_accuracy_matches():
    rcfg, tcfg, rp, tp, x = _net("har-4layer", batch=16)
    y = _rng(4).integers(0, 6, size=16)
    assert TF.accuracy(tcfg, tp, torch.from_numpy(x), torch.from_numpy(y)) == \
        RF.accuracy(rcfg, rp, jnp.asarray(x), jnp.asarray(y))


def test_params_from_reference_carries_an_fc_net():
    rp = _params("har-4layer")
    tp = interop.params_from_reference(rp)
    assert isinstance(tp, list) and len(tp) == len(rp)
    for r, t in zip(rp, tp):
        assert set(t) == {"w", "b"}
        for k in ("w", "b"):
            assert t[k].dtype == torch.float32
            np.testing.assert_array_equal(t[k].numpy(), r[k])


def test_init_params_shapes_device_and_seed(monkeypatch):
    cfg = TF.HAR_4
    g = torch.Generator().manual_seed(0)
    p = TF.init_params(cfg, g, device="cpu")
    assert [tuple(l["w"].shape) for l in p] == [(561, 1200), (1200, 300), (300, 6)]
    assert all(float(l["b"].abs().max()) == 0.0 for l in p)
    assert abs(float(p[0]["w"].std()) - (2.0 / 561) ** 0.5) < 2e-3
    again = TF.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(p, again))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.init_params(cfg, torch.Generator().manual_seed(0))


def test_ops_dispatch_matches_the_wrappers():
    r = _rng(5)
    x = torch.from_numpy(r.normal(size=(3, 20)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(20, 7)).astype(np.float32))
    b = torch.from_numpy(r.normal(size=(7,)).astype(np.float32))
    assert torch.equal(tops.batched_ffn(x, w, b, "sigmoid"),
                       BF.batched_ffn_plain(x, w, b, "sigmoid"))
    leaf = TW.QuantLinear(q=torch.from_numpy(r.integers(-127, 128, (20, 7)).astype(np.int8)),
                          s=torch.from_numpy(r.random(7).astype(np.float32)))
    assert torch.equal(tops.quant_matmul(x, leaf), QM.quant_matmul_plain(x, leaf.q, leaf.s))
    with pytest.raises(ValueError, match="K="):
        tops.quant_matmul(x[:, :10], leaf)


# ---------------------------------------------------------------------------
# the paper model, the section schedule, the masks and the (w, z)^3 codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NETS)
def test_paper_model_matches(name):
    rnet, tnet = RP.PAPER_NETWORKS[name], TP.PAPER_NETWORKS[name]
    assert [(l.s_in, l.s_out) for l in tnet] == [(l.s_in, l.s_out) for l in rnet]
    assert TP.network_parameters(tnet) == RP.network_parameters(rnet)
    for rhw, thw in ((RP.ZYNQ_BATCH, TP.ZYNQ_BATCH), (RP.ZYNQ_PRUNE, TP.ZYNQ_PRUNE)):
        assert TP.n_opt(thw) == RP.n_opt(rhw) and TP.n_opt(thw, 1.33) == RP.n_opt(rhw, 1.33)
        assert TP.machine_balance(thw) == RP.machine_balance(rhw)
        for n in (1, 4, 13, 32):
            for q in (0.0, 0.9):
                assert TP.network_t_proc(tnet, thw, n, batch=n, q_prune=q, q_overhead=1.33) \
                    == RP.network_t_proc(rnet, rhw, n, batch=n, q_prune=q, q_overhead=1.33)
            for overlap in ("add", "max"):
                assert TB.batch_latency(tnet, thw, n, overlap=overlap) == \
                    RB.batch_latency(rnet, rhw, n, overlap=overlap)
                assert TB.throughput_samples_per_s(tnet, thw, n, 0.5, 1.33, overlap) == \
                    RB.throughput_samples_per_s(rnet, rhw, n, 0.5, 1.33, overlap)
    for rl, tl in zip(rnet, tnet):
        assert TP.batch_datapath_cycles(tl, 114, 8) == RP.batch_datapath_cycles(rl, 114, 8)
        assert TP.pruning_datapath_cycles(tl, 4, 3, 8, 0.9) == \
            RP.pruning_datapath_cycles(rl, 4, 3, 8, 0.9)
    assert TP.arithmetic_intensity(16) == RP.arithmetic_intensity(16)
    assert TP.n_opt(TP.ZYNQ_BATCH) == pytest.approx(12.66)


@pytest.mark.parametrize("name", NETS)
def test_section_schedule_and_transfers_match(name):
    sizes = RF.PAPER_FCNETS[name].sizes
    for m, n in ((114, 1), (114, 8), (12, 3)):
        assert list(TB.section_schedule(sizes, m, n)) == \
            [TB.SectionStep(s.layer, s.section, s.sample, s.new_weights)
             for s in RB.section_schedule(sizes, m, n)]
        assert TB.weight_transfers(sizes, m, n) == RB.weight_transfers(sizes, m, n)


def test_element_masks_match():
    r = _rng(6)
    w = r.normal(size=(70, 37)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    for delta in (0.0, 0.5, 1.5):
        np.testing.assert_array_equal(TPr.magnitude_threshold_mask(tw, delta).numpy(),
                                      np.asarray(RPr.magnitude_threshold_mask(jw, delta)))
    for q in (0.0, 0.3, 0.9):
        rm, tm = RPr.sparsity_target_mask(jw, q), TPr.sparsity_target_mask(tw, q)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(TPr.apply_mask(tw, tm).numpy(),
                                      np.asarray(RPr.apply_mask(jw, rm)))
        assert TPr.measured_q_prune(tm) == pytest.approx(RPr.measured_q_prune(rm), abs=1e-7)
        np.testing.assert_allclose(TPr.row_q_prune(tm).numpy(),
                                   np.asarray(RPr.row_q_prune(rm)), atol=1e-7)
    tree = [{"w": w, "b": w[0]}]
    rm = RPr.update_masks(jax.tree_util.tree_map(jnp.asarray, tree), 0.5)
    tm = TPr.update_masks(interop.params_from_reference(tree), 0.5)
    applied = TPr.apply_masks(interop.params_from_reference(tree), tm)
    want = RPr.apply_masks(jax.tree_util.tree_map(jnp.asarray, tree), rm)
    np.testing.assert_array_equal(applied[0]["w"].numpy(), np.asarray(want[0]["w"]))
    np.testing.assert_array_equal(applied[0]["b"].numpy(), np.asarray(want[0]["b"]))
    sched_r, sched_t = RPr.PruneSchedule(0.9, 10, 50), TPr.PruneSchedule(0.9, 10, 50)
    assert [sched_t.q_at(s) for s in range(0, 60, 7)] == [sched_r.q_at(s) for s in range(0, 60, 7)]
    assert TPr.element_stream_overhead() == RPr.element_stream_overhead()
    assert TPr.block_format_overhead(TPr.BlockPruneConfig(bk=16, bn=32)) == \
        RPr.block_format_overhead(RPr.BlockPruneConfig(bk=16, bn=32))


def test_wz_stream_codec_matches():
    """Rows with long zero runs (the 5-bit z escape), Q7.8 saturation and
    an empty row: identical words, tuple counts, bytes, decodes and the
    offset-calculation addresses."""
    r = _rng(7)
    w = r.normal(size=(6, 150)).astype(np.float32)
    w[np.abs(w) < 1.2] = 0.0
    w[1, :] = 0.0
    w[2, 5:120] = 0.0
    w[3, 7] = 500.0
    ref, got = RS.encode_matrix(w), TS.encode_matrix(w)
    assert got.n_tuples == ref.n_tuples and got.s_in == ref.s_in
    for a, b in zip(got.words, ref.words):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.uint64
    assert got.total_words == ref.total_words and got.total_bytes == ref.total_bytes
    assert got.q_overhead() == ref.q_overhead()
    np.testing.assert_array_equal(TS.decode_matrix(got), RS.decode_matrix(ref))
    for words, n in zip(got.words, got.n_tuples):
        assert TS.stream_addresses(words, n) == RS.stream_addresses(words, n)
        np.testing.assert_array_equal(TS.decode_row(words, n, 150), RS.decode_row(words, n, 150))
