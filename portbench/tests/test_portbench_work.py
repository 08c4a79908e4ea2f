"""The operation, byte and roofline arithmetic, held to values worked out
by hand for glm4-9b (q 0.5, blocks of 128, int8 payloads and fp32 column
scales, an int8 KV cache of 2 heads of 128 with fp32 scales)."""

from __future__ import annotations

import pytest

from portbench import spec as SPEC
from portbench.work import BF16_FLOPS, HBM_BYTES_PER_S, Work, bound

# one layer's projections, by hand: kept blocks = blocks - round(0.5 * blocks)
# wq, wo (4096 x 4096): 1024 blocks, 512 kept; wk, wv (4096 x 256): 64, 32;
# w_gate, w_up (4096 x 13696) and w_down (13696 x 4096): 3424, 1712
MACS_LAYER = 2 * 512 * 16384 + 2 * 32 * 16384 + 3 * 1712 * 16384  # 101,974,016
# kept blocks x (16384 payload bytes + a 4-byte block row index) + N x 4 scales
BYTES = {"wq": 512 * 16388 + 4096 * 4, "wk": 32 * 16388 + 256 * 4,
         "w_gate": 1712 * 16388 + 13696 * 4, "w_down": 1712 * 16388 + 4096 * 4}
HEAD_MACS = 4096 * 151552  # the int8 head, every column
HEAD_BYTES = 4096 * 151552 + 151552 * 4
KV_TOKEN_LAYER = 2 * 2 * (128 + 4)  # K and V, 2 heads: int8 payload + fp32 scale


@pytest.fixture(scope="module")
def work():
    bench = SPEC.load_benchmark()
    return Work(SPEC.load_config(bench, "glm4-9b"))


def test_layer_weights(work):
    assert MACS_LAYER == 101_974_016
    assert work.weight("attn/wq", (4096, 4096), 40) == (BYTES["wq"], 512 * 16384)
    assert work.weight("attn/wk", (4096, 256), 40) == (BYTES["wk"], 32 * 16384)
    assert work.weight("mlp/w_gate", (4096, 13696), 40) == (BYTES["w_gate"], 1712 * 16384)
    assert work.weight("mlp/w_down", (13696, 4096), 40) == (BYTES["w_down"], 1712 * 16384)
    assert work.weight("embed/head", (4096, 151552), 1) == (HEAD_BYTES, HEAD_MACS)
    assert work.kv_bytes_token_layer == KV_TOKEN_LAYER


def test_decode_step_operations(work):
    contexts = [1000] * 128
    least, flops = work.decode(contexts)
    attn = 4.0 * 128_000 * 32 * 128  # QK^T and PV over every context, 32 heads of 128
    assert flops == 40 * (2.0 * 128 * MACS_LAYER + attn) + 2.0 * 128 * HEAD_MACS
    # about 9.4 GFLOP a token of weights and head at this batch
    assert (40 * 2 * MACS_LAYER + 2 * HEAD_MACS) / 1e9 == pytest.approx(9.4, abs=0.05)


def test_decode_step_least_time_at_batch_one(work):
    # one token at context 1: every part is bound by its bytes
    least, _ = work.decode([1])
    act = lambda k, n: (k + n) * 2  # noqa: E731  bf16 activations in and out
    layer = (2 * (BYTES["wq"] + act(4096, 4096)) + 2 * (BYTES["wk"] + act(4096, 256))
             + 2 * (BYTES["w_gate"] + act(4096, 13696)) + BYTES["w_down"] + act(13696, 4096)
             + KV_TOKEN_LAYER + 2 * 32 * 128 * 2)
    head = HEAD_BYTES + act(4096, 151552)
    assert least == pytest.approx((40 * layer + head) / HBM_BYTES_PER_S, rel=1e-12)
    assert least * 1e3 == pytest.approx(1.41, abs=0.01)  # ~4.7 GB at 3.35 TB/s


def test_bound_takes_the_larger_side():
    assert bound(3.35e12, 1.0) == (1.0, "bytes")
    assert bound(1.0, 2 * BF16_FLOPS) == (2.0, "operations")


def test_prefill_is_bound_by_its_operations(work):
    least, flops = work.prefill(2048)
    attn = 4.0 * 32 * 128 * 2048 * 2049 / 2
    assert flops == 40 * (2.0 * 2048 * MACS_LAYER + attn) + 2.0 * HEAD_MACS
    assert least > flops / BF16_FLOPS * 0.99
