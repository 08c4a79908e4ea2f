"""EngineConfig: the serving engine's constructor surface as data (port of
``repro/serving/config.py``).

Four frozen dataclasses group the knobs by subsystem and compose into the
one ``EngineConfig`` the engine accepts.  The port serves plain and paged
decode with int8 KV and prefix sharing; every field of a feature it does
not serve yet must keep its default, and ``EngineConfig`` raises
``NotImplementedError`` naming the ROADMAP item otherwise.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """KV-cache geometry: dtype, paging, prefix sharing."""

    kv_dtype: Any = None  # "int8" / torch.int8 selects the quantized cache
    page_size: Optional[int] = None  # tokens/page: selects the paged cache
    num_pages: Optional[int] = None  # pool capacity (None: contiguous parity)
    share_prefix: bool = False  # map common prompt prefixes copy-on-write
    expected_context: Optional[int] = None  # mean (S + max_new) for the sizer
    allocator: Any = None  # shared PageAllocator (mixed serving, ROADMAP A10)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Admission, chunked prefill, deadlines, retries, eviction."""

    prefill_chunk: Optional[int] = None
    prefill_budget: Optional[int] = None
    evict_policy: str = "fifo"
    request_timeout_s: Optional[float] = None
    ttft_deadline_s: Optional[float] = None
    max_retries: int = 1  # retries of a request whose logits went non-finite
    retry_backoff_s: float = 0.0
    deadline_slack_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative decode (ROADMAP A7): only the defaults are served."""

    draft_cfg: Any = None
    draft_params: Any = None
    spec_k: int = 0
    fallback_accept: Optional[float] = None
    fallback_min_ticks: int = 8


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Fault tolerance: clock and page audits are served; the watchdog and
    chaos injection are ROADMAP A7."""

    watchdog_timeout_s: Optional[float] = None
    fault_injector: Any = None
    clock: Callable[[], float] = time.monotonic
    audit_every_step: bool = False


# (sub-config, field) -> the ROADMAP item that ports it
_UNSERVED = {
    ("cache", "allocator"): "A10 (mixed-family serving)",
    ("scheduler", "prefill_chunk"): "A7 (chunked prefill)",
    ("scheduler", "prefill_budget"): "A7 (chunked prefill)",
    ("scheduler", "evict_policy"): "A7 (eviction)",
    ("scheduler", "request_timeout_s"): "A7 (deadlines)",
    ("scheduler", "ttft_deadline_s"): "A7 (deadlines)",
    ("scheduler", "retry_backoff_s"): "A7 (fault model)",
    ("scheduler", "deadline_slack_s"): "A7 (deadlines)",
    ("spec", "draft_cfg"): "A7 (speculative decode)",
    ("spec", "draft_params"): "A7 (speculative decode)",
    ("spec", "spec_k"): "A7 (speculative decode)",
    ("spec", "fallback_accept"): "A7 (speculative decode)",
    ("spec", "fallback_min_ticks"): "A7 (speculative decode)",
    ("fault", "watchdog_timeout_s"): "A7 (fault model)",
    ("fault", "fault_injector"): "A7 (fault model)",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The whole serving surface: top-level shape knobs plus the four
    subsystem configs."""

    max_len: int = 256
    max_batch: Optional[int] = None
    mesh: Any = None  # sharded serving: ROADMAP A13
    rules: Optional[dict] = None
    seed: int = 0
    cache: CacheConfig = CacheConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    spec: SpecConfig = SpecConfig()
    fault: FaultConfig = FaultConfig()

    def __post_init__(self):
        if self.mesh is not None or self.rules is not None:
            raise NotImplementedError("sharded serving (mesh/rules) is ROADMAP A13")
        defaults = {"cache": CacheConfig(), "scheduler": SchedulerConfig(),
                    "spec": SpecConfig(), "fault": FaultConfig()}
        for (group, field), item in _UNSERVED.items():
            if getattr(getattr(self, group), field) != getattr(defaults[group], field):
                raise NotImplementedError(
                    f"EngineConfig.{group}.{field} is not served by the port yet: "
                    f"ROADMAP {item}")


def config_from_args(ns, *, clock=None, expected_context=None) -> EngineConfig:
    """The argparse-namespace -> EngineConfig adapter of ``launch/serve.py``.
    Flags use 0/"" as "unset"; missing attributes keep the defaults."""

    def get(name, default=None):
        return getattr(ns, name, default)

    return EngineConfig(
        max_len=int(get("max_len", 256) or 256),
        max_batch=int(get("max_batch") or 0) or None,
        seed=int(get("seed", 0) or 0),
        cache=CacheConfig(
            kv_dtype="int8" if get("kv_dtype") == "int8" else None,
            page_size=int(get("page_size") or 0) or None,
            num_pages=int(get("pool_pages") or 0) or None,
            share_prefix=bool(get("share_prefix", False)),
            expected_context=expected_context,
        ),
        scheduler=SchedulerConfig(max_retries=int(get("max_retries", 1))),
        fault=FaultConfig(clock=clock) if clock is not None else FaultConfig(),
    )
