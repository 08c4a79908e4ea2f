"""BENCHMARK.json against the contract's shape, and every piece of a cell
found by name: a new configuration, mix, limit or metric is a new file
that the harness picks up without an edit to any file that is there."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import spec as SPEC
from portbench import traffic as TR

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return SPEC.load_benchmark()


def test_shape_of_benchmark_json(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and c["reduced"] == []
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
    for w in bench["workloads"]:  # every cell reports set-up, another e2e and a layer
        rep = {m["name"] for m in SPEC.cell_metrics(bench, w["name"], False)}
        assert "setup_s" in rep and len(rep) >= 2
        layer = SPEC.cell_metrics(bench, w["name"], True)
        assert layer and all(m["moves"] in rep for m in layer)


def test_every_piece_of_every_cell_is_found_by_name(bench):
    for w in bench["workloads"]:
        config = SPEC.load_config(bench, w["config"])
        assert config["name"] == w["config"]
        traffic = SPEC.load_traffic(w["traffic"])
        assert traffic["loop"] == "closed" and traffic["source"]
        limits = [v["limit"] for v in SPEC.load_checks(w["name"]).values()]
        assert limits and all(lim > 0 for lim in limits)
        for trace in (False, True):
            for m in SPEC.cell_metrics(bench, w["name"], trace):
                assert callable(SPEC.metric_reader(m["name"]))


def test_configs_state_published_widths_and_their_departures(bench):
    g = SPEC.load_config(bench, "glm4-9b")
    assert (g["port"]["n_layers"], g["port"]["d_model"], g["port"]["d_ff"]) == (
        g["published"]["num_layers"], g["published"]["hidden_size"],
        g["published"]["ffn_hidden_size"])
    assert (g["port"]["n_heads"], g["port"]["n_kv_heads"], g["port"]["head_dim"]) == (32, 2, 128)
    assert g["port"]["vocab"] == g["published"]["padded_vocab_size"]
    q = SPEC.load_config(bench, "qwen2-moe-a2.7b")
    pub, m = q["published"], q["port"]["moe"]
    assert (q["port"]["n_layers"], q["port"]["d_model"]) == (pub["num_hidden_layers"],
                                                             pub["hidden_size"])
    assert (m["n_experts"], m["top_k"], m["expert_d_ff"]) == (
        pub["num_experts"], pub["num_experts_per_tok"], pub["moe_intermediate_size"])
    assert m["n_shared_experts"] * m["shared_d_ff"] == pub["shared_expert_intermediate_size"]
    assert m["pad_to"] == 64 and "64" in q["padding"]
    for c in (g, q):
        assert c["departures"] and c["reduced"] == []


def test_port_config_matches_the_registry(bench):
    from portbench.bench import port_config
    from repro_torch.configs import get_config

    for name in ("glm4-9b", "qwen2-moe-a2.7b"):
        mine = port_config(SPEC.load_config(bench, name))
        reg = get_config(name)
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "hd", "d_ff", "vocab",
                  "rope_base", "tie_embeddings", "moe", "compute_dtype", "activation"):
            assert getattr(mine, f) == getattr(reg, f), (name, f)


def test_a_new_file_is_picked_up_without_an_edit(tmp_path, monkeypatch, bench):
    tree = tmp_path / "portbench"
    for sub in ("metrics", "traffic", "checks"):
        shutil.copytree(SPEC.BENCH_DIR / sub, tree / sub)
    (tree / "metrics" / "new_metric.decode.py").write_text("def read(run):\n    return 42.0\n")
    (tree / "traffic" / "chat-new.json").write_text(json.dumps(
        {**SPEC.load_traffic("chat-c128"), "clients": 64}))
    monkeypatch.setattr(SPEC, "BENCH_DIR", tree)
    b = json.loads(json.dumps(bench))
    b["per_layer"].append({"name": "new_metric.decode", "unit": "ms", "better": "lower",
                           "source": "program_span", "layer": "model", "moves": "out_tok_s",
                           "workloads": ["glm4-chat-decode"]})
    names = [m["name"] for m in SPEC.cell_metrics(b, "glm4-chat-decode", True)]
    assert "new_metric.decode" in names
    assert SPEC.metric_reader("new_metric.decode")(None) == 42.0
    assert SPEC.load_traffic("chat-new")["clients"] == 64
    assert TR.max_context(SPEC.load_traffic("chat-new")) == 4096 + 512
