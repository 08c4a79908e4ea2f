"""The plain reference against the port at smoke sizes on the CPU: its
worked-out plan equals the port's packed weights, and through the
harness's own path (``bench.run``) the port's served tokens read a gap of
rounding only; a token altered where it is produced, and the float8
control, come out as not correct."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import bench as B
from portbench import spec as SPEC
from portbench import weights as W
from portbench.reference import model as REF

from _smoke import cell

SEED = 3_000_000_021
SMOKE_LIMIT = 1e-3  # the smoke configs compute in float32: the port's tokens read ~0
CELLS = ["glm4-chat-decode", "qwen2moe-chat-decode"]


@pytest.mark.parametrize("workload", CELLS)
def test_worked_out_plan_equals_the_ports(workload):
    from repro_torch.core import weight_plan as WP
    from repro_torch.models import transformer as T

    bench, config, traffic = cell(workload)
    cfg = B.port_config(config)
    _, plan = B.build_engine(cfg, config, traffic, SEED, "cpu")
    layers = T.unstack(cfg, plan.params)
    port = config["port"]
    L = port["n_layers"]
    for i in range(L):
        raw = W.draw_layer(port, SEED, i, "cpu")
        for name, t in raw.items():
            node = layers["layers"][i]
            for part in name.split("/"):
                node = node[part]
            ref = REF.served_weight(name, t, L, config["serving"])
            if isinstance(node, torch.Tensor):
                got = node.to(torch.float32)
            else:
                K = t.shape[-2]
                eye = torch.eye(K).expand(*t.shape[:-2], K, K)
                got = WP.apply_linear(eye, node)
            assert got.shape == ref.shape, name
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-7, msg=name)
    for name in ("embed/tok", "embed/head"):
        node = plan.params["embed"][name.split("/")[1]]
        assert isinstance(node, WP.QuantLinear)
        ref = REF.served_weight(name, W.draw_global(port, SEED, name, "cpu"), 1,
                                config["serving"])
        torch.testing.assert_close(node.q.to(torch.float32) * node.s, ref, rtol=1e-6, atol=1e-7)


def test_block_keep_prunes_the_quantile_of_each_slice():
    w = torch.randn(3, 64, 32, generator=torch.Generator().manual_seed(0))
    keep = REF.block_keep(w, 0.5, 16, 16)
    assert keep.shape == (3, 4, 2) and keep.sum(dim=(1, 2)).tolist() == [4, 4, 4]
    s = w.abs().reshape(3, 4, 16, 2, 16).mean(dim=(2, 4))
    for i in range(3):
        assert s[i][keep[i]].min() > s[i][~keep[i]].max()


def test_int8_rows_round_each_token_and_head():
    x = torch.tensor([[1.0, -0.5, 0.25], [0.0, 0.0, 0.0]])
    y = REF.int8_rows(x)
    assert torch.allclose(y[0], torch.round(x[0] / (1 / 127)) * (1 / 127))
    assert torch.equal(y[1], x[1])


@pytest.mark.parametrize("workload", CELLS)
def test_port_agrees_with_the_reference_through_the_harness(workload):
    bench, config, traffic = cell(workload)
    out = B.run(workload, SEED, 1.0, False, started=0.0, device="cpu", bench=bench,
                config=config, traffic=traffic, limits={"max_logit_gap": SMOKE_LIMIT})
    assert out["check"]["tokens"] >= 20
    assert out["check"]["max_logit_gap"] <= 1e-4
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0


def _altered_decode(api_module, at_call: int):
    """The port's decode_step with its produced tokens altered: from call
    ``at_call`` on, every row's logits put its worst token first."""
    orig = api_module._TRANSFORMER_API
    calls = {"n": 0}

    def decode_step(cfg, params, cache, tokens, pos, **kw):
        logits, cache = orig.decode_step(cfg, params, cache, tokens, pos, **kw)
        calls["n"] += 1
        if calls["n"] >= at_call:
            last = logits[:, -1]
            rows = torch.arange(last.shape[0])
            logits = logits.clone()
            logits[rows, -1, last.argmin(dim=-1)] = last.max(dim=-1).values + 1.0
        return logits, cache

    return dataclasses.replace(orig, decode_step=decode_step)


@pytest.mark.parametrize("workload", CELLS)
def test_an_altered_token_is_not_correct(workload, monkeypatch):
    from repro_torch.models import api

    bench, config, traffic = cell(workload)
    monkeypatch.setattr(api, "_TRANSFORMER_API", _altered_decode(api, 3))
    out = B.run(workload, SEED, 1.0, False, started=0.0, device="cpu", bench=bench,
                config=config, traffic=traffic, limits={"max_logit_gap": SMOKE_LIMIT})
    assert out["check"]["max_logit_gap"] > 0.1
    assert not out["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_float8_control_is_not_correct(workload):
    """The port reads under the smoke limit in each number the cell
    compares, and the float8 control above it in one: not correct."""
    bench, config, traffic = cell(workload)
    compared = [k for k in SPEC.load_checks(workload)]
    out = B.run(workload, SEED, 1.0, False, started=0.0, device="cpu", bench=bench,
                config=config, traffic=traffic, limits={k: SMOKE_LIMIT for k in compared},
                others=("fp8",))
    assert out["correct"]
    control = [out["check"][f"fp8_{k.split('_')[0]}_gap"] for k in compared]  # max_, mean_
    assert max(control) > SMOKE_LIMIT


def test_traced_run_reads_spans_and_no_device_metric_off_the_card():
    bench, config, traffic = cell("glm4-chat-decode")
    out = B.run("glm4-chat-decode", SEED, 1.0, True, started=0.0, device="cpu",
                bench=bench, config=config, traffic=traffic, limits={"max_logit_gap": SMOKE_LIMIT})
    m = B.metrics(out["run"], bench, True)
    assert m["mean_batch.decode"]["value"] > 1 and m["decode_call_ms.decode"]["value"] > 0
    for name in ("step_mfu.decode", "kernel_roofline.decode", "device_idle.decode"):
        assert name not in m  # no device events on the CPU: nothing to read
    from repro_torch.models import moe

    assert moe.apply_moe.__name__ == "apply_moe"  # the span's wrapper is removed
