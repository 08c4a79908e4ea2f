"""PyTorch port vs the JAX reference: the Q7.8 and int8 codecs.

The Q7.8 codec is integer arithmetic plus fp32 steps that are exact (scaling
by powers of two, PLAN's binary-fraction coefficients), so every Q7.8
result is held to exact equality; both sides round half to even
(``jnp.round``, ``torch.round``).  The int8 payload is exact too; its fp32
scales and the fp32 products agree to 1e-6 relative (the same IEEE
operations, summed in another order for the products)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as RQ

from repro_torch.core import quantization as TQ

ALL_INT16 = np.arange(-(1 << 15), 1 << 15, dtype=np.int64).astype(np.int16)


def _rng(seed):
    return np.random.default_rng(seed)


def test_q78_encode_and_round_trip_match():
    r = _rng(0)
    x = np.concatenate([
        r.normal(scale=40.0, size=4096),
        np.arange(-1024, 1024) / 512.0,  # exact halves of a Q7.8 step: ties to even
        [127.998, 128.0, 300.0, -128.0, -128.002, -300.0, 0.0, -0.0],
    ]).astype(np.float32)
    want = np.asarray(RQ.q78_encode(jnp.asarray(x)))
    got = TQ.q78_encode(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TQ.q78_quantize(torch.from_numpy(x)).numpy(),
                                  np.asarray(RQ.q78_quantize(jnp.asarray(x))))
    # decode -> encode returns every code
    back = TQ.q78_encode(TQ.q78_decode(torch.from_numpy(ALL_INT16))).numpy()
    np.testing.assert_array_equal(back, ALL_INT16)


@pytest.mark.parametrize("fn", ["q78_relu", "q78_sigmoid_plan", "q78_decode"])
def test_q78_elementwise_over_every_int16(fn):
    want = np.asarray(getattr(RQ, fn)(jnp.asarray(ALL_INT16)))
    got = getattr(TQ, fn)(torch.from_numpy(ALL_INT16)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_q78_requantize_over_every_int16_and_the_int32_edges():
    r = _rng(1)
    acc = np.concatenate([
        ALL_INT16.astype(np.int32) << 8,  # every Q7.8 code moved to Q15.16
        ALL_INT16.astype(np.int32),  # and every small accumulator
        r.integers(-(1 << 31), (1 << 31) - 1, size=8192, dtype=np.int64).astype(np.int32),
        np.asarray([-(1 << 31), (1 << 31) - 1, (1 << 31) - 128, (1 << 31) - 129,
                    -(1 << 31) + 127, 127, 128, -128, -129], np.int64).astype(np.int32),
    ])
    want = np.asarray(RQ.q78_requantize(jnp.asarray(acc)))
    got = TQ.q78_requantize(torch.from_numpy(acc)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(TQ.q1516_decode(torch.from_numpy(acc)).numpy(),
                                  np.asarray(RQ.q1516_decode(jnp.asarray(acc))))


@pytest.mark.parametrize("case", ["random", "saturated", "mixed_extremes"])
def test_q78_matmul_matches_including_the_wrap(case):
    r = _rng(2)
    if case == "random":
        a = r.integers(-(1 << 15), 1 << 15, size=(5, 70)).astype(np.int16)
        w = r.integers(-(1 << 15), 1 << 15, size=(70, 37)).astype(np.int16)
    elif case == "saturated":  # 3000 * 32767^2 wraps: -196605000 mod 2^32
        a = np.full((2, 3000), 32767, np.int16)
        w = np.full((3000, 3), 32767, np.int16)
    else:
        a = r.choice(np.asarray([32767, -32768], np.int16), size=(3, 3000))
        w = r.choice(np.asarray([32767, -32768], np.int16), size=(3000, 4))
    want = np.asarray(RQ.q78_matmul(jnp.asarray(a), jnp.asarray(w)))
    got = TQ.q78_matmul(torch.from_numpy(a), torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if case == "saturated":
        assert (got == -196605000).all()
    # torch's own CPU int32 product wraps the same way
    np.testing.assert_array_equal(
        (torch.from_numpy(a).to(torch.int32) @ torch.from_numpy(w).to(torch.int32)).numpy(), want)


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_int8_matches(axis):
    w = _rng(3).normal(size=(48, 40)).astype(np.float32)
    w[:, 5] = 0.0  # an all-zero channel takes the 1e-8 floor
    ref = RQ.quantize_int8(jnp.asarray(w), axis=axis)
    got = TQ.quantize_int8(torch.from_numpy(w), axis=axis)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_allclose(got.scales.numpy(), np.asarray(ref.scales), rtol=1e-6)
    np.testing.assert_allclose(got.dequantize().numpy(), np.asarray(ref.dequantize()),
                               rtol=1e-6, atol=1e-7)
    assert got.axis == ref.axis and tuple(got.shape) == tuple(ref.shape)
    assert TQ.quantization_error(torch.from_numpy(w), axis) == pytest.approx(
        RQ.quantization_error(jnp.asarray(w), axis), rel=1e-5)


def test_int8_matmul_and_pytree_match():
    r = _rng(4)
    w = r.normal(size=(64, 96)).astype(np.float32)
    x = r.normal(size=(3, 64)).astype(np.float32)
    want = RQ.int8_matmul(jnp.asarray(x), RQ.quantize_int8(jnp.asarray(w)))
    got = TQ.int8_matmul(torch.from_numpy(x), TQ.quantize_int8(torch.from_numpy(w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tree = {"big": w, "small": w[:8, :8], "vec": w[0], "layers": [w, w[:, :50]]}
    qr = RQ.quantize_pytree({k: jnp.asarray(v) if not isinstance(v, list) else
                             [jnp.asarray(a) for a in v] for k, v in tree.items()})
    qt = TQ.quantize_pytree({k: torch.from_numpy(v) if not isinstance(v, list) else
                             [torch.from_numpy(a) for a in v] for k, v in tree.items()})
    flat_t = [qt["big"], qt["small"], qt["vec"], *qt["layers"]]
    flat_r = [qr["big"], qr["small"], qr["vec"], *qr["layers"]]
    assert [isinstance(a, TQ.QuantizedTensor) for a in flat_t] == \
        [isinstance(a, RQ.QuantizedTensor) for a in flat_r] == [True, False, False, True, False]
    np.testing.assert_array_equal(qt["layers"][0].values.numpy(),
                                  np.asarray(qr["layers"][0].values))
    for fmt in ("fp32", "bf16", "q78", "int8", "int4"):
        assert TQ.bytes_per_weight(fmt) == RQ.bytes_per_weight(fmt)
