"""One run of one cell: set-up, the measured window, the traced slice, the
output check and the result.

Set-up draws the configuration's weights on the device from the seed
(``weights.py``), packs them with the port's own plan
(``api.compress``, the ``serving`` section's flags, as
``launch/serve.build_engine`` does), frees the dense weights and builds a
``repro_torch.serving.engine.ServingEngine`` with a paged int8 KV pool
that holds every slot at the mix's longest context.  It then warms up: one
request at the mix's longest and one at its shortest prompt, then the
closed loop itself until every client is in flight and the first
completions came back.  The window then runs ``seconds``: the harness
sends each client's next request when its last one completes and calls
``engine.step()`` in a loop on the engine's own wall clock, and each
committed token is stamped by ``Request.on_token``.  The device's peak
memory is counted from the window's start, so that set-up's transient
dense weights do not enter it, and the KV pages in use are read after
every step.  With ``--trace 1`` spans time the port's calls during the
window, and ``torch.profiler`` records a slice of ``trace_seconds`` after
it, under the same traffic.  Then the peak is read, the port's state is
freed, and the output check runs (``check.py``)."""

from __future__ import annotations

import dataclasses
import gc
import math
import time
from typing import Optional

import numpy as np
import torch

from portbench import check as CHECK
from portbench import spec as SPEC
from portbench import trace as TRACE
from portbench import traffic as TR
from portbench import weights as W
from portbench.work import Work

clock = time.monotonic


@dataclasses.dataclass
class Record:
    """One request as the client saw it: when it was due, when it was
    submitted, and the wall-clock stamp of every token it received."""

    uid: int
    prompt: np.ndarray
    max_new: int
    due: float
    submit: float = 0.0
    times: list = dataclasses.field(default_factory=list)
    req: object = None

    def stamp(self, req, tok) -> None:
        self.times.append(clock())

    @property
    def output(self) -> list:
        return list(self.req.output or [])

    @property
    def finished(self) -> bool:
        return self.req.state.value == "FINISHED"

    @property
    def failed(self) -> bool:
        return self.req.done and not self.finished

    @property
    def finish_t(self) -> Optional[float]:
        return self.req.finish_t

    @property
    def first_t(self) -> Optional[float]:
        return self.times[0] if self.times else None


@dataclasses.dataclass
class Run:
    """What the metric readers take (``portbench/metrics``)."""

    workload: dict
    config: dict
    traffic: dict
    setup_s: float
    t0: float
    t1: float
    records: list
    stats: dict  # EngineStats counters over the window
    spans: Optional[list] = None  # trace.Span of the window (--trace 1)
    profile: Optional[TRACE.Profile] = None  # the profiled slice (--trace 1, a card)
    profiled_work: list = dataclasses.field(default_factory=list)

    def in_window(self, t) -> bool:
        return t is not None and self.t0 <= t <= self.t1

    def window_spans(self, kind: str) -> list:
        return [s for s in (self.spans or []) if s.kind == kind and self.in_window(s.start)]


def port_config(config: dict):
    """The port's ModelConfig of a configuration file's ``port`` section."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    fields = dict(config["port"])
    moe = fields.pop("moe", None)
    return ModelConfig(**fields, moe=MoEConfig(**moe) if moe else None)


def _leaves(tree, path: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}" if path else k))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}" if path else str(i)))
        return out
    return {path: tree}


def _rebuild(tree, values: dict, path: str = ""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, values, f"{path}/{k}" if path else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, values, f"{path}/{i}" if path else str(i)) for i, v in enumerate(tree)]
    return values[path]


def program_params(cfg, config: dict, seed: int, device) -> dict:
    """The port's stacked params tree (``api.param_shapes``' layout) filled
    with the seed's weights: layer by layer, one draw each."""
    from repro_torch.models.api import get_api

    port = config["port"]
    shapes = _leaves(get_api(cfg).param_shapes(cfg))
    spec = {name: (tuple(shape), init) for name, shape, init in W.layer_spec(port)}
    dtype = W.compute_dtype(port)
    values, slots = {}, []  # slots[i]: (group prefix, index) of layer i
    groups: dict = {}
    for path, (shape, _) in shapes.items():
        top = path.split("/", 1)[0]
        if top in ("unit", "rem"):
            grp, name = path.split("/", 2)[1], path.split("/", 2)[2]
            prefix = f"{top}/{grp}"
            if spec.get(name, (None,))[0] != tuple(shape[1:]):
                raise NotImplementedError(f"{path} {tuple(shape)}: not a leaf of the layer the "
                                          f"benchmark draws ({spec.get(name)})")
            groups.setdefault(prefix, {})[name] = shape[0]
            init = spec[name][1]
            values[path] = torch.empty(tuple(shape), device=device,
                                       dtype=torch.float32 if init == "norm" else dtype)
        else:
            values[path] = W.draw_global(port, seed, path, device)
    for prefix, names in groups.items():
        if set(names) != set(spec):
            raise NotImplementedError(f"{prefix}: leaves {sorted(names)} != {sorted(spec)}")
    units = sorted(k for k in groups if k.startswith("unit/"))
    rems = sorted(k for k in groups if k.startswith("rem/"))
    n_units = next(iter(groups[units[0]].values())) if units else 0
    slots = [(p, u) for u in range(n_units) for p in units]
    for p in rems:
        slots += [(p, c) for c in range(next(iter(groups[p].values())))]
    if len(slots) != port["n_layers"]:
        raise NotImplementedError(f"{len(slots)} layers in the tree, {port['n_layers']} stated")
    for i, (prefix, idx) in enumerate(slots):
        for name, t in W.draw_layer(port, seed, i, device).items():
            values[f"{prefix}/{name}"][idx].copy_(t)
    return _rebuild(get_api(cfg).param_shapes(cfg), values)


def build_engine(cfg, config: dict, traffic: dict, seed: int, device):
    """(engine, plan) over the seed's weights, packed by the serving flags."""
    from repro_torch.core.weight_plan import PlanConfig
    from repro_torch.models.api import get_api
    from repro_torch.serving.config import CacheConfig, EngineConfig
    from repro_torch.serving.engine import ServingEngine

    sv = config["serving"]
    params = program_params(cfg, config, seed, device)
    pc = PlanConfig(default=sv["compress"], q_prune=sv.get("q_prune", 0.0), bk=sv["block"],
                    bn=sv["block"], **{k: sv[k] for k in ("min_size", "min_contract") if k in sv})
    plan = get_api(cfg).compress(cfg, params, pc)
    del params
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    max_len = TR.max_context(traffic)
    max_batch = int(traffic["max_batch"])
    moe = config["port"].get("moe")
    if moe and max_batch > config["semantics"]["moe_full_capacity_tokens"]:
        raise ValueError("a decode step past the MoE's full-capacity size drops tokens across "
                         "requests; the output check cannot follow it")
    ps = int(sv["page_size"])
    pages = 1 + max_batch * -(-max_len // ps)
    ec = EngineConfig(max_len=max_len, max_batch=max_batch, cache=CacheConfig(
        kv_dtype=sv["kv_dtype"], page_size=ps, num_pages=pages,
        share_prefix=bool(sv["share_prefix"])))
    return ServingEngine(cfg, plan.params, plan=plan, device=device, config=ec), plan


class Driver:
    """Sends a closed loop's requests into one engine and steps it: each of
    ``clients`` sends its next request when its last one completes."""

    def __init__(self, engine, planned: list, traffic: dict):
        self.engine = engine
        self.planned = planned
        self.clients = int(traffic["clients"])
        self.next = 0
        self.records: list = []
        self.inflight: list = []  # one record a client
        self.completions = 0

    def _send(self, due: float) -> Record:
        from repro_torch.serving.engine import Request

        if self.next >= len(self.planned):
            raise RuntimeError("the traffic plan ran out of requests")
        p = self.planned[self.next]
        self.next += 1
        rec = Record(uid=p.uid, prompt=p.prompt, max_new=p.max_new, due=due)
        rec.req = Request(uid=p.uid, prompt=p.prompt, max_new_tokens=p.max_new,
                          on_token=rec.stamp)
        self.engine.submit(rec.req)
        rec.submit = clock()
        self.records.append(rec)
        return rec

    def start(self) -> None:
        now = clock()
        self.inflight = [self._send(now) for _ in range(self.clients)]

    def pump(self) -> None:
        """One engine tick, then each client whose request completed sends
        its next."""
        self.engine.step()
        now = clock()
        for c, rec in enumerate(self.inflight):
            if rec.req.done:
                self.completions += 1
                self.inflight[c] = self._send(now)


def _stats(engine) -> dict:
    s = engine.stats
    return {k: getattr(s, k) for k in ("decode_steps", "decode_tokens", "prefills",
                                       "prefill_tokens")}


def _warm_up(engine, traffic: dict, vocab: int, seed: int) -> None:
    """One request at the mix's longest prompt and one at its shortest,
    run to the end: the first calls at both ends of the lengths."""
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(W.derive_seed(seed, W.TAG_PROMPTS, 2))
    for uid, S in ((-1, traffic["prompt"]["hi"]), (-2, traffic["prompt"]["lo"])):
        engine.submit(Request(uid=uid, prompt=rng.integers(0, vocab, size=int(S), dtype=np.int32),
                              max_new_tokens=2))
    engine.run_until_done()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def run(workload_name: str, seed: int, seconds: float, trace: bool, *, started: float,
        device="cuda", bench: Optional[dict] = None, config: Optional[dict] = None,
        traffic: Optional[dict] = None, limits: Optional[dict] = None, others=(),
        log=print) -> dict:
    """One run of the cell.  ``started``: the process's start on ``clock``.
    The optional dicts stand in for the cell's files (the tests run the
    path at a small size on the CPU); ``limits`` {number: limit} for its
    checks file.  Returns {"run": Run, "memory_peak", "check": the check's
    readings, "limits", "correct", "attempted", "failed"}."""
    device = torch.device(device)
    bench = bench or SPEC.load_benchmark()
    wl = SPEC.workload(bench, workload_name)
    config = config or SPEC.load_config(bench, wl["config"])
    traffic = traffic or SPEC.load_traffic(wl["traffic"])
    if limits is None:
        limits = {k: v["limit"] for k, v in SPEC.load_checks(workload_name).items()
                  if isinstance(v, dict) and "limit" in v}
    port = config["port"]
    cfg = port_config(config)
    engine, plan = build_engine(cfg, config, traffic, seed, device)
    log(f"[portbench] {workload_name}: engine built ({cfg.name}, {engine.max_batch} slots, "
        f"{engine.num_pages} pages of {engine.page_size}, max_len {engine.max_len}) "
        f"at {clock() - started:.1f}s")
    _warm_up(engine, traffic, port["vocab"], seed)
    trace_s = float(traffic["trace_seconds"]) if trace else 0.0
    planned = TR.plan(traffic, port["vocab"], seed)
    drv = Driver(engine, planned, traffic)
    spans = TRACE.Spans(engine, Work(config)) if trace else None
    try:
        drv.start()
        while drv.completions < int(traffic["open_after_completions"]) or engine.queue:
            drv.pump()
        _sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = clock()
        setup_s = t0 - started
        log(f"[portbench] window opens at {setup_s:.1f}s ({len(drv.records)} requests sent)")
        s0 = _stats(engine)
        pages_peak = 0
        while clock() < t0 + seconds:
            drv.pump()
            pages_peak = max(pages_peak, engine.pages_in_use)
        t1 = clock()
        s1 = _stats(engine)
        profile = None
        if trace:
            t = clock()
            profile = _profile_slice(drv, spans, trace_s, device)
            if profile is not None:
                log(f"[portbench] profiled slice of {profile.window_s:.2f}s: "
                    f"{profile.n_device_events} device operations, read in {clock() - t:.1f}s")
    finally:
        if spans is not None:
            spans.remove()
    stats = {k: s1[k] - s0[k] for k in s1}
    result = Run(workload=wl, config=config, traffic=traffic, setup_s=setup_s, t0=t0, t1=t1,
                 records=drv.records, stats=stats, spans=spans.spans if spans else None,
                 profile=profile, profiled_work=spans.profiled_work if spans else [])
    spans = None  # it holds the engine
    log(f"[portbench] window {t1 - t0:.2f}s: {stats['decode_steps']} decode steps, "
        f"{stats['decode_tokens']} tokens, {stats['prefills']} prefills; KV pages in use at most "
        f"{pages_peak} of {engine.num_pages - 1}")
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted = [r for r in drv.records if result.in_window(r.due)]
    n_failed = sum(1 for r in attempted if r.failed)
    picked = CHECK.sample(drv.records, seed, int(traffic["check_tokens"]), t0)
    del engine, plan, drv
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        log(f"[portbench] port freed: {torch.cuda.memory_allocated(device) / 1e9:.2f} GB "
            f"still allocated")
    t_check = clock()
    if picked:
        readings = CHECK.readings(config, seed, picked, device, others=others)
    else:
        readings = {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf"), "tokens": 0}
    log(f"[portbench] check of {len(picked)} requests, {readings['tokens']} served tokens, "
        f"in {clock() - t_check:.1f}s")
    correct = (bool(picked) and n_failed == 0
               and all(readings[k] <= lim for k, lim in limits.items()))
    return {"run": result, "memory_peak": int(memory_peak), "check": readings, "limits": limits,
            "correct": correct, "attempted": len(attempted), "failed": n_failed}


def _profile_slice(drv: Driver, spans: TRACE.Spans, seconds: float, device):
    """The profiled slice: ``seconds`` more of the traffic under
    ``torch.profiler``; None off the card (no device events to read)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    spans.profiling = True
    try:
        with profile(activities=activities) as prof:
            with record_function(TRACE.SLICE):
                t = clock()
                while clock() < t + seconds:
                    drv.pump()
                _sync(device)
    finally:
        spans.profiling = False
    if device.type != "cuda":
        return None
    return TRACE.reduce_profile(prof)


def metrics(run_: Run, bench: dict, trace: bool) -> dict:
    """{name: {"value", "unit"}} of the cell's metrics whose readers found
    something to read."""
    out = {}
    for m in SPEC.cell_metrics(bench, run_.workload["name"], trace):
        value = SPEC.metric_reader(m["name"])(run_)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
