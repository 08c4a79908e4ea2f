"""Heterogeneous-workload serving (port of ``repro/serving/mixed.py``): one
front door over text, enc-dec, VLM and recurrent traffic.

``MixedServingEngine`` wraps one ``ServingEngine`` per workload family --
each with its own model, plan, steps and ``BatchSizer`` charged that
family's bytes/token -- behind one ``submit(name, request)``, one
``step()`` and one page pool.  Each family keeps its own weight stream and
balance point (the paper's batching argument is per model), so a mixed
tick runs every member's own step, one after another.  Shared:

* **The page pool.**  Every paged member draws from one ``PageAllocator``
  (injected through ``CacheConfig.allocator``), so a burst in one family
  can use pages another is not using.  A page belongs to one member's slot
  at a time; members check only their own table mirrors, and this engine
  audits the allocator against the union of their page references.
* **The accounting.**  ``MixedSizer`` blends the members' sizers under the
  traffic weights.

A family whose decode path cannot page (recurrentgemma's local rings,
xLSTM) keeps its contiguous per-slot cache and draws nothing from the pool.
The members run on the CUDA device unless ``device="cpu"``.

On a mesh every rank runs one MixedServingEngine whose members carry the
mesh (``EngineConfig.mesh`` and each family's rules): each member holds
its shards and the rank's KV heads of the shared pool's page ids, and
its sizer is charged by its own parallelism degrees.  The allocator, the
members' tables and the union audit stay on the host; every rank takes
the same decisions, so they are equal on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional

from repro_torch.core.batching import MixedSizer
from repro_torch.device import resolve_device
from repro_torch.models.api import get_api, supports_paged_kv
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import EngineStats, Request, ServingEngine
from repro_torch.serving.paged import PageAllocator


@dataclasses.dataclass(frozen=True, eq=False)
class WorkloadSpec:
    """One family in the mix: a model, its weights (or ``plan``), its
    EngineConfig and its share of the traffic.  ``config.cache.allocator``
    must be unset: the MixedServingEngine owns the shared pool."""

    name: str
    cfg: object
    params: object
    config: EngineConfig = EngineConfig()
    plan: object = None
    weight: float = 1.0


def _pages_per_request(spec: WorkloadSpec) -> int:
    """The most pages one admitted request of this family holds: decoder
    pages for max_len, plus an enc-dec's frame pages -- both from the one
    shared pool."""
    ps = spec.config.cache.page_size
    pages = math.ceil(spec.config.max_len / ps)
    n_frames = int(getattr(spec.cfg, "n_frames", 0) or 0)
    if "frames" in get_api(spec.cfg).extra_keys and n_frames:
        pages += math.ceil(n_frames / ps)
    return pages


class MixedServingEngine:
    """One front door over per-family ServingEngines sharing one page pool.

    ``num_pages`` sizes the shared pool; by default it is the sum of every
    paged member's largest reservation (``max_batch`` x
    ``_pages_per_request``, plus the null page): the bytes the members
    would hold served alone."""

    def __init__(self, workloads: Iterable[WorkloadSpec], *, num_pages: Optional[int] = None,
                 device=None):
        workloads = list(workloads)
        if not workloads:
            raise ValueError("MixedServingEngine needs at least one workload")
        names = [w.name for w in workloads]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate workload names: {sorted(names)}")
        for w in workloads:
            if w.weight <= 0:
                raise ValueError(f"workload {w.name!r}: weight must be positive, got {w.weight}")
            if w.config.cache.allocator is not None:
                raise ValueError(
                    f"workload {w.name!r} carries its own allocator; the MixedServingEngine "
                    f"owns the shared pool -- leave CacheConfig.allocator unset")
        self.device = resolve_device(device)
        paged = [w for w in workloads
                 if w.config.cache.page_size is not None and supports_paged_kv(w.cfg)]
        self.allocator: Optional[PageAllocator] = None
        if paged:
            if num_pages is None:
                for w in paged:
                    if w.config.max_batch is None:
                        raise ValueError(
                            f"workload {w.name!r}: set config.max_batch (or pass num_pages=) "
                            f"so the shared pool can be sized")
                num_pages = 1 + sum(w.config.max_batch * _pages_per_request(w) for w in paged)
            self.allocator = PageAllocator(num_pages)
        self.num_pages = num_pages
        paged_names = {w.name for w in paged}

        self.engines: Dict[str, ServingEngine] = {}
        self.weights: Dict[str, float] = {}
        for w in workloads:
            cfg_w = w.config
            if w.name in paged_names:
                cfg_w = dataclasses.replace(cfg_w, cache=dataclasses.replace(
                    cfg_w.cache, allocator=self.allocator, num_pages=None))
            self.engines[w.name] = ServingEngine(w.cfg, w.params, config=cfg_w, plan=w.plan,
                                                 device=self.device)
            self.weights[w.name] = float(w.weight)
        self.sizer = MixedSizer(sizers={n: e.sizer for n, e in self.engines.items()},
                                weights=dict(self.weights))
        self.tick = 0
        self._audit_every_step = any(e.audit_every_step for e in self.engines.values())

    # -- routing ------------------------------------------------------------

    def engine(self, name: str) -> ServingEngine:
        try:
            return self.engines[name]
        except KeyError:
            raise KeyError(f"unknown workload {name!r}; serving {sorted(self.engines)}") from None

    def submit(self, name: str, req: Request):
        self.engine(name).submit(req)

    def cancel(self, name: str, req: Request) -> bool:
        return self.engine(name).cancel(req)

    # -- serving loop -------------------------------------------------------

    def step(self) -> int:
        """One mixed tick: every family runs one engine tick (admission and
        one batched decode step of its own model), in spec order; then the
        union audit if any member asked for one every step.  Returns the
        tokens committed across families."""
        self.tick += 1
        tokens = sum(eng.step() for eng in self.engines.values())
        if self._audit_every_step:
            self.audit_pages()
        return tokens

    def _busy(self) -> bool:
        return any(e.queue or e._live_slots() for e in self.engines.values())

    def run_until_done(self, max_ticks: int = 10000) -> Dict[str, EngineStats]:
        for _ in range(max_ticks):
            if not self._busy():
                break
            self.step()
        return self.stats

    # -- accounting and invariants --------------------------------------------

    @property
    def stats(self) -> Dict[str, EngineStats]:
        return {name: eng.stats for name, eng in self.engines.items()}

    def aggregate_stats(self) -> EngineStats:
        """The members' counters summed (derived properties recompute from
        the totals)."""
        total = EngineStats()
        for eng in self.engines.values():
            for f in dataclasses.fields(EngineStats):
                setattr(total, f.name, getattr(total, f.name) + getattr(eng.stats, f.name))
        return total

    def _page_refs(self) -> List[int]:
        return [p for eng in self.engines.values() if eng.paged for p in eng._page_refs()]

    def audit_pages(self):
        """Each member checks that its host tables mirror its slot->page
        mapping; then the shared allocator's refcounts and free list are
        audited against the union of every member's page references, so a
        leak in any family is caught whichever family's tick caused it.
        Raises ``PageAuditError``."""
        for eng in self.engines.values():
            eng.audit_pages()
        if self.allocator is not None:
            self.allocator.audit(self._page_refs())
