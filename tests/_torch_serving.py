"""Shared set-up of the port's serving tests (tests/test_torch_spec.py,
test_torch_continuous.py, test_torch_faults.py): the reference engine and
the port's engine over the same weights -- the reference's own params (or
its packed plan), carried across by ``interop`` -- with one flat
configuration, and requests with the same prompts for both."""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving import config as RC
from repro.serving import faultinject as RFI
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.serving import config as PC
from repro_torch.serving import faultinject as PFI
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "tinyllama-1.1b"
_GROUPS = ("cache", "scheduler", "spec", "fault")
_TOP = {f.name for f in dataclasses.fields(PC.EngineConfig)} - set(_GROUPS)


@functools.lru_cache(maxsize=None)
def ref_model(compress: str = "none", seed: int = 0):
    """(reference cfg, params, plan) of the smoke config."""
    rcfg = ref_get_config(ARCH, smoke=True)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(seed))
    plan = None
    if compress != "none":
        plan = RW.compress(params, RW.PlanConfig(default=compress, q_prune=0.5, bk=16, bn=16))
        params = plan.params
    return rcfg, params, plan


def port_model(compress: str = "none", seed: int = 0):
    """(port cfg, params, plan) holding the reference's weights."""
    _, rparams, rplan = ref_model(compress, seed)
    cfg = get_config(ARCH, smoke=True)
    if rplan is not None:
        return cfg, None, interop.plan_from_reference(rplan)
    return cfg, interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams)), None


@functools.lru_cache(maxsize=None)
def ref_draft(kind: str):
    """The reference's dense draft params: "near" is the seed-0 target with
    noise on its head (drafts agree with the target often, not always);
    "seed1" is an independent model from seed 1 (drafts almost never
    agree, as the serve CLI's ``seed + 1`` draft)."""
    if kind == "seed1":
        return ref_model("none", 1)[1]
    params = jax.tree_util.tree_map(np.asarray, ref_model("none", 0)[1])
    head = params["embed"]["head"]
    noise = np.random.default_rng(7).standard_normal(head.shape).astype(head.dtype)
    params["embed"]["head"] = head + 0.2 * head.std() * noise
    return jax.tree_util.tree_map(jnp.asarray, params)


def port_draft(kind: str):
    return interop.params_from_reference(jax.tree_util.tree_map(np.asarray, ref_draft(kind)))


def _split(flat: dict) -> dict:
    """Flat field names -> {"top": ..., "cache": ..., "scheduler": ...,
    "fault": ...} (the port's and the reference's fields are the same)."""
    out = {"top": {}, "cache": {}, "scheduler": {}, "fault": {}}
    fields = {g: {f.name for f in dataclasses.fields(getattr(PC, c))}
              for g, c in (("cache", "CacheConfig"), ("scheduler", "SchedulerConfig"),
                           ("fault", "FaultConfig"))}
    for k, v in flat.items():
        group = "top" if k in _TOP else next((g for g, f in fields.items() if k in f), None)
        if group is None:
            raise TypeError(f"unknown engine config field {k!r}")
        out[group][k] = v
    return out


def engine_configs(*, draft=None, spec_k=0, faults=None, tick_clock=False,
                   fallback_accept=None, **flat):
    """(reference EngineConfig, port EngineConfig) of one flat configuration.
    ``faults`` is a list of ``(kind, tick, kwargs)``: each engine gets its
    own injector and its own TickClock."""
    g = _split(flat)
    cfgs = []
    for mod, fi_mod in ((RC, RFI), (PC, PFI)):
        spec = mod.SpecConfig()
        if spec_k:
            dcfg = ref_get_config(ARCH, smoke=True) if mod is RC else get_config(ARCH, smoke=True)
            dparams = ref_draft(draft) if mod is RC else port_draft(draft)
            spec = mod.SpecConfig(draft_cfg=dcfg, draft_params=dparams, spec_k=spec_k,
                                  fallback_accept=fallback_accept)
        fault = dict(g["fault"])
        clock = fi_mod.TickClock() if tick_clock else time.monotonic
        fault["clock"] = clock
        if faults is not None:
            fault["fault_injector"] = fi_mod.FaultInjector(
                [fi_mod.Fault(kind=k, tick=t, **kw) for k, t, kw in faults],
                clock=clock if tick_clock else None)
        cfgs.append(mod.EngineConfig(
            **g["top"], cache=mod.CacheConfig(**g["cache"]),
            scheduler=mod.SchedulerConfig(**g["scheduler"]), spec=spec,
            fault=mod.FaultConfig(**fault)))
    return tuple(cfgs)


def engines(compress: str = "none", **kw):
    """(reference engine, port engine on the CPU) over the same weights."""
    rcfg, rparams, rplan = ref_model(compress)
    cfg, params, plan = port_model(compress)
    rconf, pconf = engine_configs(**kw)
    ref = RServingEngine(rcfg, rparams, plan=rplan, config=rconf)
    eng = ServingEngine(cfg, params, plan=plan, device="cpu", config=pconf)
    return ref, eng


def prompts(lens, seed: int = 0, vocab: int = 256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def shared_prefix_prompts(seed: int = 0):
    """Requests 0-3 share request 0's 12-token prompt (1-3 extend it by 4
    tokens); 4-5 are independent: one full page of 8 shared, the boundary
    page copied on write."""
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 256, 12).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, r.integers(0, 256, 4).astype(np.int32)])
                      for _ in range(3)]
    return out + [r.integers(0, 256, 16).astype(np.int32) for _ in range(2)]


def request_pair(ps, max_new: int, **kw):
    """The same requests for the reference and the port."""
    return ([RRequest(uid=i, prompt=p.copy(), max_new_tokens=max_new, **kw)
             for i, p in enumerate(ps)],
            [Request(uid=i, prompt=p.copy(), max_new_tokens=max_new, **kw)
             for i, p in enumerate(ps)])


def lockstep(ref, eng, rreqs, reqs, *, tables: bool = False, max_ticks: int = 500):
    """Submit, then tick both engines together until the reference is done,
    advancing each engine's TickClock one unit a tick; ``tables`` also holds
    the page tables and slot -> page maps equal every tick.  Both must end
    with nothing queued or live."""
    for r in rreqs:
        ref.submit(r)
    for r in reqs:
        eng.submit(r)
    for _ in range(max_ticks):
        if not ref.queue and not ref._live_slots():
            break
        for e in (ref, eng):
            e.step()
            if isinstance(e.clock, (RFI.TickClock, PFI.TickClock)):
                e.clock.advance(1.0)
        if tables:
            np.testing.assert_array_equal(eng._table, ref._table)
            assert eng.slot_pages == ref.slot_pages
    assert not ref.queue and not ref._live_slots()
    assert not eng.queue and not eng._live_slots()


def outputs(reqs) -> dict:
    return {r.uid: list(r.output or []) for r in reqs}


def states(reqs) -> dict:
    return {r.uid: r.state.value for r in reqs}


SPEC_COUNTERS = ("draft_proposed", "draft_accepted", "verified_positions", "decode_steps",
                 "decode_tokens", "prefills", "completed")


def counters(stats, names=SPEC_COUNTERS) -> dict:
    return {n: getattr(stats, n) for n in names}
