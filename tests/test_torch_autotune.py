"""The offline autotuner in the port (``repro_torch.core.autotune``, its CLI
``repro_torch.launch.autotune``, ``ServingEngine.from_tuned`` and serve
``--autotune-plan``) against the reference's ``repro.core.autotune`` on
the same inputs, at the reference test's smoke shapes (TINY, blocks of 16)
with the TPU v5e constants passed to both sides.

Tolerances: predictions to 1e-12 relative (the same float arithmetic in
another module), search traces equal trial for trial; the calibration
oracle's accuracies within 2 test samples of the reference's (eager torch
against jitted JAX sums in another order flip an argmax on a near-tie),
verdicts equal wherever the drop lies more than that from the budget;
greedy streams exactly."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as RC
from repro.configs.base import ModelConfig as RModelConfig
from repro.core import autotune as RAT
from repro.models import fcnet as RF
from repro.models.api import get_api as ref_get_api
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import repro_torch.configs as C
from repro_torch import interop
from repro_torch.configs.base import ModelConfig
from repro_torch.core import autotune as AT
from repro_torch.core import weight_plan as WP
from repro_torch.models import fcnet as F
from repro_torch.models.api import get_api
from repro_torch.serving.engine import Request, ServingEngine

_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=256, compute_dtype="float32")
TINY, RTINY = ModelConfig(**_TINY), RModelConfig(**_TINY)

_SPACE = dict(q_prunes=(0.0, 0.25, 0.5), kinds=("quant_sparse", "block_sparse", "quant", "dense"),
              blocks=(16,), kv_dtypes=("fp",), page_sizes=(0,), min_size=1024, min_contract=16)
SPACE, RSPACE = AT.SearchSpace(**_SPACE), RAT.SearchSpace(**_SPACE)
# the wider space of the predict test: int8 and paged KV too
_WIDE = dict(_SPACE, kv_dtypes=("fp", "int8"), page_sizes=(0, 16))

_CONS = dict(max_batch=8, max_len=48, prompt_len=8, max_new=16, pool_bytes=64e6,
             peak_flops=3.3e11, hbm_bw=1e11)
CONS, RCONS = AT.Constraints(**_CONS), RAT.Constraints(**_CONS)


class CountingOracle:
    """Accuracy stub: q <= ceiling passes; records each consultation."""

    def __init__(self, ceiling: float):
        self.ceiling = ceiling
        self.calls: list = []
        self.evals: list = []

    def feasible(self, q: float) -> bool:
        self.calls.append(q)
        ok = q <= self.ceiling + 1e-12
        self.evals.append({"q": q, "achieved_q": q if ok else 0.0, "base_acc": 0.9,
                           "acc": 0.9 if ok else 0.5, "drop": 0.0 if ok else 0.4, "ok": ok})
        return ok


def _ref_cand(c):
    return RAT.Candidate(**dataclasses.asdict(c))


def _random_candidates(n, space, seed=0):
    rng = np.random.default_rng(seed)
    groups = AT.tunable_groups(TINY, space)
    return [AT._random_candidate(groups, space, rng) for _ in range(n)]


def _search_pair(strategy="anneal", trials=8, seed=0):
    kw = dict(strategy=strategy, trials=trials, seed=seed)
    return (AT.search(TINY, space=SPACE, constraints=CONS, **kw),
            RAT.search(RTINY, space=RSPACE, constraints=RCONS, **kw))


# ---------------------------------------------------------------------------
# inventory and plan stats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_model_leaves_and_groups_equal_reference(arch):
    cfg, rcfg = C.get_config(arch, smoke=True), RC.get_config(arch, smoke=True)
    got = [dataclasses.astuple(l) for l in AT.model_leaves(cfg)]
    assert got == [dataclasses.astuple(l) for l in RAT.model_leaves(rcfg)]
    space = dataclasses.replace(SPACE, min_size=256, min_contract=8)
    rspace = dataclasses.replace(RSPACE, min_size=256, min_contract=8)
    assert AT.tunable_groups(cfg, space) == RAT.tunable_groups(rcfg, rspace)
    assert AT.tunable_groups(cfg, SPACE) == RAT.tunable_groups(rcfg, RSPACE)
    # paths as compress() reports them, for the leaves it plans
    params = get_api(cfg).init_params(cfg, 0, device="cpu")
    plan = WP.compress(params, AT.candidate_plan_config(AT.uniform_candidate(cfg, space), space))
    assert set(plan.leaves) == {l.path for l in AT.model_leaves(cfg)}


def _assert_stats_match(want, plan):
    assert want.n_weights == plan.n_weights
    assert want.surviving == plan.surviving_weights
    assert want.weight_bytes == plan.weight_bytes
    assert want.b_weight_effective == plan.b_weight_effective
    assert want.q_overhead_effective == plan.q_overhead_effective
    assert want.q_prune_effective == plan.q_prune_effective


@pytest.mark.parametrize("seed", [0, 1])
def test_predicted_stats_equal_compress(seed):
    params = get_api(TINY).init_params(TINY, seed, device="cpu")
    leaves = AT.model_leaves(TINY)
    for cand in _random_candidates(4, SPACE, seed):
        plan = WP.compress(params, AT.candidate_plan_config(cand, SPACE))
        _assert_stats_match(AT.predict_plan_stats(leaves, cand, SPACE), plan)


def test_degradation_chain_equals_compress():
    """quant_sparse -> quant -> dense for a block that tiles no leaf (48), and
    quant -> dense below the size floor: the analytic stats and the packer
    degrade alike."""
    space = dataclasses.replace(SPACE, blocks=(48,))
    cand = dataclasses.replace(AT.uniform_candidate(TINY, space), block=48)
    params = get_api(TINY).init_params(TINY, 1, device="cpu")
    plan = WP.compress(params, AT.candidate_plan_config(cand, space))
    _assert_stats_match(AT.predict_plan_stats(AT.model_leaves(TINY), cand, space), plan)
    assert {l.kind for l in plan.leaves.values()} == {"quant", "dense"}
    small = dataclasses.replace(space, min_size=1 << 20)  # every TINY leaf below it
    cand = dataclasses.replace(cand, assign=tuple((g, "quant", 0.0) for g, _, _ in cand.assign))
    plan = WP.compress(params, AT.candidate_plan_config(cand, small))
    _assert_stats_match(AT.predict_plan_stats(AT.model_leaves(TINY), cand, small), plan)
    assert {l.kind for l in plan.leaves.values()} == {"dense"}


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

_PRED_FLOATS = ("tokens_per_s", "n_opt", "balance", "kv_bytes_per_token")


def test_predict_equals_reference():
    space, rspace = AT.SearchSpace(**_WIDE), RAT.SearchSpace(**_WIDE)
    cands = _random_candidates(24, space, seed=5) + [AT.uniform_candidate(TINY, space)]
    tight = dict(_CONS, pool_bytes=2e5)  # some candidates hit the KV ceiling
    for c in (_CONS, tight):
        cons, rcons = AT.Constraints(**c), RAT.Constraints(**c)
        for cand in cands:
            got = AT.predict(TINY, cand, space, cons)
            want = RAT.predict(RTINY, _ref_cand(cand), rspace, rcons)
            assert (got.feasible, got.reason, got.batch, got.context, got.num_pages) == \
                (want.feasible, want.reason, want.batch, want.context, want.num_pages), cand
            for f in _PRED_FLOATS:
                assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12, abs=0), f
            assert dataclasses.astuple(got.stats) == dataclasses.astuple(want.stats)


def test_smem_gate():
    assert AT.kernel_smem_bytes(128, 1.0, 8) == 197696  # (NC 1, S 4) at decode
    assert AT.kernel_smem_bytes(128, 1.0, 64) == 197696
    assert AT.kernel_smem_bytes(128, 1.0, 65) == 214064  # (NC 2, S 3) above 64 rows
    assert AT.kernel_smem_bytes(128, 4.0, 256) == 165888  # the fp32 payload's CUDA-core body
    assert AT.Constraints().smem_bytes == 232448
    pred = AT.predict(TINY, AT.uniform_candidate(TINY, SPACE), SPACE,
                      dataclasses.replace(CONS, smem_bytes=16.0))
    assert not pred.feasible and pred.reason == "smem"
    assert AT.predict(TINY, AT.uniform_candidate(TINY, SPACE), SPACE, CONS).feasible
    # full width, default space and constraints: both bodies fit at 128
    cfg = C.get_config("tinyllama-1.1b")
    cand = dataclasses.replace(
        AT.uniform_candidate(cfg, AT.SearchSpace()),
        assign=tuple((g, "block_sparse" if g == "wq" else "quant_sparse", 0.5)
                     for g in AT.tunable_groups(cfg, AT.SearchSpace())))
    assert AT.predict(cfg, cand, AT.SearchSpace(), AT.Constraints()).feasible


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 1), (1, 4), (2, 2), (1, 8)])
def test_predict_equals_reference_on_meshes(mesh):
    """The mesh terms: TINY's 2 KV heads split over a model axis of 2 and
    stay whole over 4 and 8 (kv_m 1); d data replicas scale the tick."""
    space, rspace = AT.SearchSpace(**_WIDE, meshes=(mesh,)), RAT.SearchSpace(**_WIDE,
                                                                            meshes=(mesh,))
    cands = [dataclasses.replace(c, mesh=mesh)
             for c in _random_candidates(12, space, seed=7) + [AT.uniform_candidate(TINY, space)]]
    tight = dict(_CONS, pool_bytes=2e5)
    for c in (_CONS, tight):
        cons, rcons = AT.Constraints(**c), RAT.Constraints(**c)
        for cand in cands:
            got = AT.predict(TINY, cand, space, cons)
            want = RAT.predict(RTINY, _ref_cand(cand), rspace, rcons)
            assert (got.feasible, got.reason, got.batch, got.context, got.num_pages) == \
                (want.feasible, want.reason, want.batch, want.context, want.num_pages), cand
            for f in _PRED_FLOATS:
                assert getattr(got, f) == pytest.approx(getattr(want, f), rel=1e-12, abs=0), f
    # the mesh moves the prediction: a split model axis streams less a card
    one = AT.predict(TINY, dataclasses.replace(cands[-1], mesh=(1, 1)), space, AT.Constraints(
        **_CONS))
    got = AT.predict(TINY, cands[-1], space, AT.Constraints(**_CONS))
    assert (got.tokens_per_s != one.tokens_per_s) == (mesh != (1, 1))


def test_h100_constants_by_default():
    from repro_torch.core import perf_model as pm

    cons = AT.Constraints()
    assert (cons.peak_flops, cons.hbm_bw) == (pm.H100_PEAK_FLOPS, pm.H100_HBM_BW) == (989e12,
                                                                                       3.35e12)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("meshes", [((1, 1),), ((1, 1), (1, 2), (2, 2))])
@pytest.mark.parametrize("strategy", ["random", "anneal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_trace_equals_reference(strategy, seed, meshes):
    """Trial for trial, with one call-counting stub oracle per side: the
    same candidates, verdicts, incumbents, and the oracle consulted at the
    same sparsity levels in the same order; on one card and over meshes
    (each draw and move of the mesh knob the reference's)."""
    ours, theirs = CountingOracle(0.25), CountingOracle(0.25)
    kw = dict(strategy=strategy, trials=16, seed=seed)
    space = dataclasses.replace(SPACE, meshes=meshes)
    rspace = dataclasses.replace(RSPACE, meshes=meshes)
    got = AT.search(TINY, space=space, constraints=CONS, accuracy=ours, **kw)
    want = RAT.search(RTINY, space=rspace, constraints=RCONS, accuracy=theirs, **kw)
    assert got.trace == want.trace
    assert dataclasses.astuple(got.best) == dataclasses.astuple(want.best)
    assert ours.calls == theirs.calls
    assert got.acc_evals == want.acc_evals == tuple(ours.evals)
    assert got.prediction.tokens_per_s >= got.uniform.tokens_per_s
    assert got.prediction.stats.max_q <= 0.25 + 1e-12


def test_search_raises_when_nothing_feasible():
    with pytest.raises(ValueError, match="feasible"):
        AT.search(TINY, space=SPACE, constraints=dataclasses.replace(CONS, pool_bytes=1.0),
                  trials=3, seed=0)


# ---------------------------------------------------------------------------
# the calibration oracle
# ---------------------------------------------------------------------------


def test_calibration_evaluator_matches_reference(monkeypatch):
    """The port's evaluator from the reference's init (carried over through
    interop): base accuracy and each evaluate(q) within 2 test samples of
    the reference's, verdicts equal where the drop is that far from the
    budget; memoized like the reference's."""
    calib = AT.CalibrationConfig.smoke()
    ref = RAT.CalibrationEvaluator(RAT.CalibrationConfig.smoke())
    netcfg = RF.FCNetConfig("autotune-calib", (calib.n_features, *calib.hidden,
                                               calib.n_classes))
    rinit = jax.tree_util.tree_map(np.asarray, RF.init_params(netcfg, jax.random.key(calib.seed)))
    seen = []

    def init_from_reference(cfg, generator, device=None):
        seen.append((cfg.sizes, generator.initial_seed()))
        return interop.params_from_reference(rinit, device=device)

    monkeypatch.setattr(F, "init_params", init_from_reference)
    ev = AT.CalibrationEvaluator(calib, device="cpu")
    assert ev.feasible(0.0) and ev.n_evals == 0  # no training for q 0
    tol = 2.0 / calib.n_test
    for q in (0.25, 0.75):
        ok = ev.feasible(q)
        got, want = ev.evals[-1], ref.evaluate(q)
        assert seen == [((32, 64, 4), 0)]  # the base net is trained once
        assert got["q"] == want["q"] and got["ok"] is ok
        for k in ("base_acc", "acc", "drop"):
            assert got[k] == pytest.approx(want[k], abs=tol), (q, k)
        if abs(want["drop"] - ev.max_acc_drop) > tol:
            assert got["ok"] == want["ok"] and got["achieved_q"] == want["achieved_q"], q
        assert ev.feasible(q) is ok  # memoized: no second prune run
    assert ev.n_evals == 2


# ---------------------------------------------------------------------------
# the artifact, both ways
# ---------------------------------------------------------------------------


def test_artifact_round_trip_and_plan_config(tmp_path):
    res, rres = _search_pair()
    doc = AT.tuned_plan_doc(TINY, res, space=SPACE, constraints=CONS)
    assert json.loads(json.dumps(doc)) == json.loads(json.dumps(
        RAT.tuned_plan_doc(RTINY, rres, space=RSPACE, constraints=RCONS)))
    path = AT.save_tuned(os.path.join(tmp_path, "tuned.json"), doc)
    loaded = AT.load_tuned(path)
    assert loaded == json.loads(json.dumps(doc))
    assert AT.plan_config(loaded) == AT.candidate_plan_config(res.best, SPACE)
    kw = AT.engine_kwargs(loaded)
    assert kw["max_batch"] == res.prediction.batch and "kv_dtype" not in kw
    assert doc["measured"] == {"tokens_per_s": None, "uniform_tokens_per_s": None}
    p = doc["predicted"]
    assert p["speedup"] == pytest.approx(p["tokens_per_s"] / p["uniform_tokens_per_s"])


def test_port_artifact_loads_in_reference(tmp_path):
    res, _ = _search_pair()
    path = AT.save_tuned(os.path.join(tmp_path, "port.json"),
                         AT.tuned_plan_doc(TINY, res, space=SPACE, constraints=CONS))
    rdoc = RAT.load_tuned(path)
    rpc = RAT.plan_config(rdoc)
    assert rpc == RAT.candidate_plan_config(_ref_cand(res.best), RSPACE)
    assert RAT.engine_kwargs(rdoc) == AT.engine_kwargs(rdoc)


def test_reference_artifact_serves_with_the_runs_use_kernel(tmp_path):
    """A reference-written file says use_kernel False and carries interpret:
    the port takes use_kernel from the run and drops interpret, so that on
    the card its plan runs the kernels."""
    _, rres = _search_pair()
    path = RAT.save_tuned(os.path.join(tmp_path, "ref.json"),
                          RAT.tuned_plan_doc(RTINY, rres, space=RSPACE, constraints=RCONS))
    doc = AT.load_tuned(path)
    assert doc["plan"]["use_kernel"] is False and "interpret" in doc["plan"]
    pc = AT.plan_config(doc)
    assert pc.use_kernel is True
    rpc = RAT.plan_config(doc)
    assert (pc.default, pc.rules, pc.q_prune, pc.bk, pc.bn, pc.score, pc.min_size,
            pc.min_contract) == (rpc.default, rpc.rules, rpc.q_prune, rpc.bk, rpc.bn, rpc.score,
                                 rpc.min_size, rpc.min_contract)
    plan = WP.compress(get_api(TINY).init_params(TINY, 0, device="cpu"), pc)
    nodes = [n for n in plan._by_path.values() if isinstance(n, WP.PLAN_NODES)]
    assert nodes and all(n.use_kernel for n in nodes)


@pytest.mark.parametrize("breakage", ["kind", "schema", "missing"])
def test_load_tuned_rejects_rot_as_the_reference_does(tmp_path, breakage):
    res, _ = _search_pair()
    doc = AT.tuned_plan_doc(TINY, res, space=SPACE, constraints=CONS)
    bad = {"kind": {**doc, "kind": "weight_plan"},
           "schema": {**doc, "schema_version": 99},
           "missing": {k: v for k, v in doc.items() if k != "serving"}}[breakage]
    path = os.path.join(tmp_path, "bad.json")
    with open(path, "w") as f:
        json.dump(bad, f)
    with pytest.raises(ValueError) as got:
        AT.load_tuned(path)
    with pytest.raises(ValueError) as want:
        RAT.load_tuned(path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# serving a tuned plan
# ---------------------------------------------------------------------------


def test_from_tuned_streams_equal_reference():
    """The reference's plan of the tuned artifact (its own params, carried
    over through interop) served by both packages' ``from_tuned``: the same
    greedy streams."""
    res, rres = _search_pair()
    doc = AT.tuned_plan_doc(TINY, res, space=SPACE, constraints=CONS)
    rdoc = RAT.tuned_plan_doc(RTINY, rres, space=RSPACE, constraints=RCONS)
    rapi = ref_get_api(RTINY)
    rplan = rapi.compress(RTINY, rapi.init_params(RTINY, jax.random.key(0)),
                          RAT.plan_config(rdoc))
    plan = interop.plan_from_reference(rplan)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, TINY.vocab, size=n).astype(np.int32) for n in (4, 7, 9)]
    reng = RServingEngine.from_tuned(RTINY, rplan.params, rdoc, plan=rplan)
    eng = ServingEngine.from_tuned(TINY, None, doc, plan=plan, device="cpu")
    assert eng.max_batch == reng.max_batch == doc["serving"]["max_batch"]
    rreqs = [RRequest(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    reqs = [Request(uid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    for r in rreqs:
        reng.submit(r)
    for r in reqs:
        eng.submit(r)
    reng.run_until_done()
    eng.run_until_done()
    assert [list(map(int, r.output)) for r in reqs] == [list(map(int, r.output)) for r in rreqs]
    assert all(len(r.output) == 5 for r in reqs)


def test_from_tuned_rejects_arch_mismatch():
    res, _ = _search_pair()
    doc = AT.tuned_plan_doc(TINY, res, space=SPACE, constraints=CONS)
    other = dataclasses.replace(TINY, name="tiny-other")
    with pytest.raises(ValueError, match="arch"):
        ServingEngine.from_tuned(other, get_api(TINY).init_params(TINY, 0, device="cpu"), doc,
                                 device="cpu")


def test_summary_per_leaf_equals_reference():
    _, rres = _search_pair()
    rapi = ref_get_api(RTINY)
    rplan = rapi.compress(RTINY, rapi.init_params(RTINY, jax.random.key(0)),
                          RAT.plan_config(RAT.tuned_plan_doc(RTINY, rres, space=RSPACE)))
    plan = interop.plan_from_reference(rplan)
    got, want = plan.summary(batch=8, per_leaf=True), rplan.summary(batch=8, per_leaf=True)
    assert got == want
    assert len(got.splitlines()) == 1 + len(plan.leaves)
    assert plan.summary(batch=8) == rplan.summary(batch=8) == got.splitlines()[0]


_CLI = ["--arch", "tinyllama-1.1b", "--smoke", "--strategy", "anneal", "--trials", "6",
        "--seed", "0", "--kv-dtypes", "fp,int8", "--page-sizes", "0,16", "--blocks", "16",
        "--min-size", "1024", "--min-contract", "16", "--calib-smoke", "--max-batch", "8",
        "--max-len", "48", "--prompt-len", "8", "--max-new", "16", "--device", "cpu"]


def test_cli_writes_loadable_artifact_and_serve_runs_it(tmp_path, capsys):
    """The port's CLI on the CPU, then serve --autotune-plan on its file
    (and the same file served from the CLI's --plan-cache, a cache hit),
    with the per-leaf lines of the reference's summary format."""
    from repro_torch.launch import autotune as cli
    from repro_torch.launch import serve

    out, cache = os.path.join(tmp_path, "tuned.json"), os.path.join(tmp_path, "plan")
    assert cli.main(_CLI + ["--out", out, "--plan-cache", cache]) == 0
    text = capsys.readouterr().out
    doc = AT.load_tuned(out)
    assert doc["arch"] == "tinyllama-smoke" and doc["predicted"]["tokens_per_s"] > 0
    assert "[autotune] serving surface:" in text and f"cached to {cache}" in text
    cfg = C.get_config("tinyllama-1.1b", smoke=True)
    plan = WP.compress(get_api(cfg).init_params(cfg, 0, device="cpu"), AT.plan_config(doc))
    leaf_lines = plan.summary(batch=1, per_leaf=True).splitlines()[1:]
    assert all(line in text for line in leaf_lines)

    for extra in ([], ["--plan-cache", cache]):
        eng = serve.main(["--arch", "tinyllama-1.1b", "--smoke", "--requests", "3",
                          "--prompt-len", "8", "--max-new", "4", "--autotune-plan", out,
                          "--device", "cpu", *extra])
        text = capsys.readouterr().out
        assert f"[serve] autotune plan {out}: strategy=anneal trials=6 seed=0" in text
        assert all(line in text for line in leaf_lines)
        assert "[serve] completed 3 requests" in text
        assert eng.max_batch == doc["serving"]["max_batch"]
        assert eng.paged == (doc["serving"]["page_size"] > 0)
        if extra:
            assert f"plan cache hit: {cache}" in text


def test_serve_refuses_autotune_plan_beside_compress_or_another_arch(tmp_path, capsys):
    from repro_torch.launch import serve

    res, _ = _search_pair()
    path = AT.save_tuned(os.path.join(tmp_path, "tiny.json"),
                         AT.tuned_plan_doc(TINY, res, space=SPACE, constraints=CONS))
    base = ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--autotune-plan", path]
    for extra, msg in ((["--compress", "quant"], "carries its own plan; drop --compress"),
                       ([], "--autotune-plan was searched for 'tiny', this run serves "
                            "'tinyllama-smoke'")):
        with pytest.raises(SystemExit) as e:
            serve.main(base + extra)
        assert e.value.code == 2
        assert msg in capsys.readouterr().err
    with pytest.raises(SystemExit):
        serve.main(["--workload-mix", "tinyllama-1.1b:1", "--autotune-plan", path, "--smoke",
                    "--device", "cpu"])
    assert "drop --autotune-plan" in capsys.readouterr().err


@pytest.mark.parametrize("kv,page", [("fp", "0"), ("int8", "16")])
def test_serve_builds_the_engine_config_the_cli_checked(tmp_path, kv, page):
    """serve --autotune-plan takes the artifact's knobs through
    AT.engine_kwargs: its engine has the EngineConfig that the CLI routes
    at tune time (AT.engine_config), the paged sizer's expected context
    included; spec_k needs a draft and is dropped by both."""
    from repro_torch.launch import autotune as cli
    from repro_torch.launch import serve

    out = os.path.join(tmp_path, "tuned.json")
    argv = list(_CLI)
    argv[argv.index("--kv-dtypes") + 1], argv[argv.index("--page-sizes") + 1] = kv, page
    assert cli.main(argv + ["--out", out, "--no-accuracy"]) == 0
    doc = AT.load_tuned(out)
    assert (doc["serving"]["kv_dtype"], doc["serving"]["page_size"]) == (kv, int(page))
    ap = serve.build_parser()
    _, eng, _ = serve.build_engine(ap.parse_args(
        ["--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu", "--autotune-plan", out,
         "--max-batch", "3", "--max-len", "32", "--page-size", "8", "--kv-dtype", "int8"]), ap)
    want, got = AT.engine_config(doc).flat(), eng.config.flat()
    for knob in ("max_batch", "max_len", "kv_dtype", "page_size", "num_pages",
                 "expected_context", "spec_k"):
        assert got[knob] == want[knob], knob


def test_cli_smem_kb_bounds_the_search():
    """--smem-kb is the ceiling of the smem gate: below the 16-block body's
    footprint no candidate is feasible."""
    from repro_torch.launch import autotune as cli

    assert AT.kernel_smem_bytes(16, 1.0, 8) > 1024
    with pytest.raises(ValueError, match="feasible"):
        cli.main(_CLI + ["--out", "unused.json", "--no-accuracy", "--smem-kb", "1"])


def test_cli_refuses_other_blocks_on_cuda(monkeypatch, capsys):
    """With CUDA the kernels take 128-blocks only: the CLI refuses another
    edge at tune time, before any search."""
    from repro_torch.launch import autotune as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit) as e:
        cli.main(["--arch", "tinyllama-1.1b", "--out", "x.json", "--blocks", "128,64"])
    assert e.value.code == 2
    assert "take 128-blocks only" in capsys.readouterr().err
