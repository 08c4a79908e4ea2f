"""EngineConfig: the serving engine's constructor surface as data (port of
``repro/serving/config.py``).

Four frozen dataclasses group the knobs by subsystem and compose into the
one ``EngineConfig`` the engine accepts.  The port serves plain, paged,
speculative and chunked decode, deadlines, eviction, fault injection, a
shared page allocator (mixed-family serving) and a mesh with its rules
(sharded serving: ``launch/mesh.py``; a mesh serves every family --
attention, MoE, RG-LRU and xLSTM layers, the enc-dec and VLM families --
plain, speculative or chunked, over its own pool or a shared allocator,
and refuses nothing).
``EngineConfig.of``/``flat`` route the reference's flat keyword names into
the sub-configs and back, and ``from_legacy`` is the deprecation shim
behind ``ServingEngine(**legacy)``.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Optional


def positional_state_gate(cfg, feature: str) -> Optional[str]:
    """The gate for features that write a span of positions ahead of the
    committed frontier and rely on position masks to hide the uncommitted
    tail (speculative decode, chunked prefill): None when ``cfg``'s caches
    are positionally addressed (``api.supports_spec_decode``), else the one
    error text."""
    from repro_torch.models.api import supports_spec_decode

    if supports_spec_decode(cfg):
        return None
    return (f"{cfg.name}: {feature} needs multi-token decode on a "
            f"positionally-addressed cache ({cfg.family} does not qualify)")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV-cache geometry: dtype, paging, prefix sharing."""

    kv_dtype: Any = None  # "int8" / torch.int8 selects the quantized cache
    page_size: Optional[int] = None  # tokens/page: selects the paged cache
    num_pages: Optional[int] = None  # pool capacity (None: contiguous parity)
    share_prefix: bool = False  # map common prompt prefixes copy-on-write
    expected_context: Optional[int] = None  # mean (S + max_new) for the sizer
    allocator: Any = None  # shared PageAllocator (serving/mixed.py injects it)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission, chunked prefill, deadlines, retries, eviction."""

    prefill_chunk: Optional[int] = None  # C-token chunks (None: synchronous)
    prefill_budget: Optional[int] = None  # prompt tokens/tick across jobs
    evict_policy: str = "fifo"  # "fifo" back-pressure | "priority" preempt
    request_timeout_s: Optional[float] = None  # default total deadline
    ttft_deadline_s: Optional[float] = None  # default TTFT deadline
    max_retries: int = 1  # transient-failure retries per request
    retry_backoff_s: float = 0.0  # backoff base (doubles per retry)
    deadline_slack_s: float = 0.0  # TTFT pressure window for preemption


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decode: the draft model and the acceptance fallback."""

    draft_cfg: Any = None
    draft_params: Any = None
    spec_k: int = 0  # draft tokens per tick (0 = plain decode)
    fallback_accept: Optional[float] = None  # EMA floor; None = off
    fallback_min_ticks: int = 8  # spec ticks before the EMA check

    def validated_k(self, cfg) -> int:
        """The effective spec_k for a target ``cfg``.  Raises on a missing
        draft or a vocab mismatch; warns and returns 0 when either model's
        caches are not positionally addressed."""
        k = int(self.spec_k or 0)
        if not k:
            return 0
        if self.draft_cfg is None or self.draft_params is None:
            raise ValueError("spec_k > 0 needs draft_cfg and draft_params")
        reasons = [r for r in (
            positional_state_gate(cfg, "speculative decode"),
            positional_state_gate(self.draft_cfg, "speculative decode"),
        ) if r]
        if reasons:
            warnings.warn("; ".join(reasons) + "; serving without speculation", stacklevel=3)
            return 0
        if self.draft_cfg.vocab != cfg.vocab:
            raise ValueError(f"draft vocab {self.draft_cfg.vocab} != target vocab "
                             f"{cfg.vocab}: verification compares token ids")
        return k


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault tolerance: watchdog, chaos injection, clock, page audits."""

    watchdog_timeout_s: Optional[float] = None  # HeartbeatMonitor stall
    fault_injector: Any = None  # serving/faultinject.FaultInjector
    clock: Callable[[], float] = time.monotonic
    audit_every_step: bool = False  # audit the allocator every tick


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The whole serving surface: top-level shape knobs plus the four
    subsystem configs."""

    max_len: int = 256
    max_batch: Optional[int] = None
    mesh: Any = None  # a (data, model) DeviceMesh: sharded serving
    rules: Optional[dict] = None  # logical-axis rule overrides (launch.mesh.rules_for)
    seed: int = 0
    cache: CacheConfig = CacheConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    spec: SpecConfig = SpecConfig()
    fault: FaultConfig = FaultConfig()

    @classmethod
    def of(cls, **flat) -> "EngineConfig":
        """Build from flat keyword names (the legacy ``ServingEngine``
        kwargs), routing each into its sub-config.  Whole sub-configs may
        also be passed (``of(max_len=64, cache=CacheConfig(...))``)."""
        groups: dict = {"cache": {}, "scheduler": {}, "spec": {}, "fault": {}}
        top: dict = {}
        for name, value in flat.items():
            if name in _GROUPS:
                top[name] = value
                continue
            dest = _FLAT_FIELDS.get(name)
            if dest is None:
                raise TypeError(f"unknown engine config field {name!r}")
            group, field = dest
            if group is None:
                top[field] = value
            else:
                groups[group][field] = value
        for group, cls_g in _GROUPS.items():
            if groups[group]:
                if group in top:
                    top[group] = dataclasses.replace(top[group], **groups[group])
                else:
                    top[group] = cls_g(**groups[group])
        return cls(**top)

    def flat(self) -> dict:
        """Inverse of ``of``: the full flat-name -> value mapping."""
        out = {}
        for name, (group, field) in _FLAT_FIELDS.items():
            src = self if group is None else getattr(self, group)
            out[name] = getattr(src, field)
        return out

    @classmethod
    def from_legacy(cls, **flat) -> "EngineConfig":
        """Deprecation shim for ``ServingEngine(**legacy_kwargs)``: the
        routing of ``of``, plus a once-per-process DeprecationWarning."""
        global _LEGACY_WARNED
        if not _LEGACY_WARNED:
            warnings.warn(
                "passing ServingEngine configuration as loose keyword "
                "arguments is deprecated; pass "
                "config=EngineConfig(...)/EngineConfig.of(...) "
                "(repro_torch/serving/config.py)",
                DeprecationWarning, stacklevel=4)
            _LEGACY_WARNED = True
        return cls.of(**flat)


_LEGACY_WARNED = False

_GROUPS = {"cache": CacheConfig, "scheduler": SchedulerConfig, "spec": SpecConfig,
           "fault": FaultConfig}

# legacy flat kwarg name -> (sub-config, field); None routes to EngineConfig
# itself.  Generated from the dataclass fields so that the shim follows the
# real surface; the two spec_* renames keep the historical names.
_FLAT_FIELDS: dict = {}
for _f in dataclasses.fields(EngineConfig):
    if _f.name not in _GROUPS:
        _FLAT_FIELDS[_f.name] = (None, _f.name)
for _group, _cls in _GROUPS.items():
    for _f in dataclasses.fields(_cls):
        _FLAT_FIELDS[_f.name] = (_group, _f.name)
_FLAT_FIELDS["spec_fallback_accept"] = ("spec", "fallback_accept")
_FLAT_FIELDS["spec_fallback_min_ticks"] = ("spec", "fallback_min_ticks")


def config_from_args(ns, *, clock=None, expected_context=None, draft_cfg=None,
                     draft_params=None, mesh=None, rules=None) -> EngineConfig:
    """The argparse-namespace -> EngineConfig adapter of ``launch/serve.py``.
    Flags use 0/"" as "unset"; missing attributes keep the defaults.  What
    argparse cannot carry (clock, draft model, the sizer's expected
    context, the mesh and its rules) comes in as keyword arguments."""

    def get(name, default=None):
        return getattr(ns, name, default)

    return EngineConfig(
        max_len=int(get("max_len", 256) or 256),
        max_batch=int(get("max_batch") or 0) or None,
        mesh=mesh,
        rules=rules,
        seed=int(get("seed", 0) or 0),
        cache=CacheConfig(
            kv_dtype="int8" if get("kv_dtype") == "int8" else None,
            page_size=int(get("page_size") or 0) or None,
            num_pages=int(get("pool_pages") or 0) or None,
            share_prefix=bool(get("share_prefix", False)),
            expected_context=expected_context,
        ),
        scheduler=SchedulerConfig(
            prefill_chunk=int(get("prefill_chunk") or 0) or None,
            prefill_budget=int(get("prefill_budget") or 0) or None,
            evict_policy=get("evict_policy", "fifo") or "fifo",
            request_timeout_s=float(get("request_timeout") or 0) or None,
            ttft_deadline_s=float(get("ttft_deadline") or 0) or None,
            max_retries=int(get("max_retries", 1)),
        ),
        spec=SpecConfig(
            draft_cfg=draft_cfg,
            draft_params=draft_params,
            spec_k=int(get("spec_k") or 0) if draft_cfg is not None else 0,
        ),
        fault=FaultConfig(clock=clock) if clock is not None else FaultConfig(),
    )
