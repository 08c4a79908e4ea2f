"""PyTorch port vs the JAX reference for the ``EngineConfig`` surface
(``serving/config.py``): flat-name routing (``of``/``flat``) on both
packages over the same draws, and ``ServingEngine(**legacy)`` through the
deprecation shim (``from_legacy``), as the reference's
``tests/test_engine_config.py`` holds its own."""

import warnings

import numpy as np
import pytest
from _hypcompat import given, settings, st  # degrades to skips without hypothesis

import repro.serving.config as RC

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serving import config as PC
from repro_torch.serving.engine import ServingEngine

# canonical flat names with value pools the engines accept structurally
# (the reference's tests/test_engine_config.py pools)
_FLAT_POOLS = {
    "max_len": [1, 32, 512],
    "max_batch": [None, 1, 64],
    "seed": [0, 7, 2**31 - 1],
    "kv_dtype": [None, "int8"],
    "page_size": [None, 8, 64],
    "num_pages": [None, 2, 4096],
    "share_prefix": [False, True],
    "expected_context": [None, 1, 512],
    "prefill_chunk": [None, 1, 64],
    "prefill_budget": [None, 1, 256],
    "evict_policy": ["fifo", "priority"],
    "request_timeout_s": [None, 0.5, 60.0],
    "ttft_deadline_s": [None, 0.5, 60.0],
    "max_retries": [0, 1, 5],
    "retry_backoff_s": [0.0, 0.25, 5.0],
    "deadline_slack_s": [0.0, 0.25, 5.0],
    "spec_k": [0, 4, 8],
    "fallback_accept": [None, 0.0, 0.7],
    "fallback_min_ticks": [1, 8, 64],
    "watchdog_timeout_s": [None, 0.5, 60.0],
    "audit_every_step": [False, True],
}


def _draw_flat(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    names = sorted(_FLAT_POOLS)
    picked = rng.choice(len(names), size=rng.integers(0, 9), replace=False)
    return {names[i]: _FLAT_POOLS[names[i]][rng.integers(0, len(_FLAT_POOLS[names[i]]))]
            for i in picked}


def _check_round_trip(seed: int):
    """of(**kw).flat() == defaults overridden by exactly kw, on both
    packages, and the two flat mappings are equal."""
    kw = _draw_flat(seed)
    flats = []
    for mod in (RC, PC):
        expect = mod.EngineConfig().flat()
        expect.update(kw)
        expect["spec_fallback_accept"] = expect["fallback_accept"]
        expect["spec_fallback_min_ticks"] = expect["fallback_min_ticks"]
        got = mod.EngineConfig.of(**kw).flat()
        assert got == expect
        flats.append(got)
    assert flats[0] == flats[1]


@settings(max_examples=50, deadline=None)
@given(seed=st.integers(0, 2**32 - 1))
def test_of_flat_round_trip_on_both_packages(seed):
    _check_round_trip(seed)


@pytest.mark.parametrize("seed", range(40))
def test_of_flat_round_trip_examples_on_both_packages(seed):
    _check_round_trip(seed)


def test_flat_names_are_the_references():
    assert sorted(PC._FLAT_FIELDS) == sorted(RC._FLAT_FIELDS)
    assert PC._FLAT_FIELDS == RC._FLAT_FIELDS


def test_spec_aliases_and_whole_subconfigs_route():
    ec = PC.EngineConfig.of(spec_fallback_accept=0.25, spec_fallback_min_ticks=3)
    assert (ec.spec.fallback_accept, ec.spec.fallback_min_ticks) == (0.25, 3)
    # a whole sub-config, then flat fields laid over it
    ec = PC.EngineConfig.of(max_len=64, cache=PC.CacheConfig(page_size=8), kv_dtype="int8")
    assert (ec.max_len, ec.cache.page_size, ec.cache.kv_dtype) == (64, 8, "int8")


def test_unknown_flat_name_raises_type_error():
    for mod in (RC, PC):
        with pytest.raises(TypeError, match="unknown engine config field"):
            mod.EngineConfig.of(not_a_field=1)


@pytest.mark.parametrize("flat", [dict(mesh=object()), dict(rules={}), dict(allocator=object())])
def test_unserved_flat_names_route_to_the_fields_that_refuse(flat):
    """mesh and rules are flat names like any other: they reach their
    fields, which refused them until sharded serving was ported and keep
    them now; a shared allocator, refused the same way until mixed serving
    was ported, reaches cache.allocator."""
    if "allocator" in flat:
        assert PC.EngineConfig.of(**flat).cache.allocator is flat["allocator"]
        return
    (name, value), = flat.items()
    assert getattr(PC.EngineConfig.of(**flat), name) is value
    assert PC.EngineConfig.of(**flat).flat()[name] is value


def _tiny():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    return cfg, T.init_params(cfg, 0, device="cpu")


LEGACY = dict(max_len=48, kv_dtype="int8", page_size=8, share_prefix=True,
              prefill_chunk=4, max_retries=2)


def test_legacy_kwargs_build_the_of_config(monkeypatch):
    monkeypatch.setattr(PC, "_LEGACY_WARNED", False)
    cfg, params = _tiny()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = ServingEngine(cfg, params, device="cpu", **LEGACY)
    assert eng.config == PC.EngineConfig.of(**LEGACY)
    ref = ServingEngine(cfg, params, device="cpu", config=PC.EngineConfig.of(**LEGACY))
    assert eng.config == ref.config
    assert (eng.paged, eng.page_size, eng.prefill_chunk, eng.max_retries) == (True, 8, 4, 2)


def test_legacy_kwargs_warn_once_per_process(monkeypatch):
    monkeypatch.setattr(PC, "_LEGACY_WARNED", False)
    cfg, params = _tiny()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ServingEngine(cfg, params, device="cpu", max_len=32)
        ServingEngine(cfg, params, device="cpu", max_len=32)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and "EngineConfig" in str(dep[0].message)


def test_legacy_kwargs_with_config_raise_type_error():
    cfg, params = _tiny()
    with pytest.raises(TypeError, match="not both"):
        ServingEngine(cfg, params, device="cpu", config=PC.EngineConfig(), max_len=32)


def test_unknown_legacy_kwarg_raises_type_error(monkeypatch):
    monkeypatch.setattr(PC, "_LEGACY_WARNED", True)
    cfg, params = _tiny()
    with pytest.raises(TypeError, match="unknown engine config field"):
        ServingEngine(cfg, params, device="cpu", not_a_field=1)
