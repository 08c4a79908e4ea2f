"""Continuous-batching serving engine (port of ``repro/serving/engine.py``).

The engine keeps ``max_batch`` decode slots over one KV cache.  Requests
join free slots (a batch-1 prefill writes their KV into the slot), every
tick runs ONE decode step for all slots -- each streamed weight byte is
reused by every live sequence, the paper's batch processing -- and
finished sequences free their slots at once.

Paged mode (``CacheConfig.page_size``) replaces the per-slot ``max_len``
reservation with per-layer pools of fixed-size pages and an int32 page
table.  The host side owns the mapping (``serving/paged.py``): page 0 is
the null page that dead slots point at, a page with refcount > 1 is
read-only, and every write goes through ``_ensure_private``
(copy-on-write).  ``share_prefix`` maps the full pages of a registered
prompt prefix into a new sequence by refcount and copies the partial
boundary page at admission.  An enc-dec request's encoded frames take
pages of the same allocator at admission (``slot_xpages``, a frame table
``xpage_table``), written once and read by every decode step's
cross-attention, freed with the slot; a request's ``extras`` (an enc-dec's
frames, a VLM's patches) go into its batch-1 prefill, and a VLM's patches
take the first positions of its sequence (``api.prefix_len``).  Prefix
sharing is off for those families: equal prompts with other frames or
patches are not equal cache entries.  A family with no global attention
layer (recurrentgemma's local rings and RG-LRU states, xLSTM's states)
cannot page: it serves on the contiguous per-slot cache, with the
reference's warning, and each admission rewrites every leaf of its slot,
fixed-size states included (``_write_slot``).  Mixed-family serving
(``serving/mixed.py``) injects one ``PageAllocator`` into several engines
(``CacheConfig.allocator``): each engine then checks only its own table
mirrors, and the owner audits the allocator against the union of every
member's ``_page_refs``.

Speculative decode (``SpecConfig``: ``draft_cfg``, ``draft_params``,
``spec_k`` = k).  A dense draft model with its own contiguous cache
proposes k tokens a tick in k+1 single-token steps, and the target
verifies all k+1 positions in ONE (B, k+1) decode step: draft positions
are extra samples of the batch, one pass of the weight stream serves
B * (k+1) rows.  The accepted prefix commits under rejection sampling
(greedy: the longest argmax match, so greedy streams equal the plain
engine's where the arithmetic is the same), and every tick commits at
least one token.  Rollback is free: a tick writes positions [frontier,
frontier + k], the frontier advances by >= 1, so a rejected tail lies
inside the next tick's write range and position masks hide it until then.
Speculative sampling at a temperature draws from a host
``np.random.default_rng(seed)``, apart from the engine's torch generator.

Continuous batching (``SchedulerConfig.prefill_chunk`` / ``prefill_budget``).
Admission only reserves the slot; the prompt then advances at most
``prefill_budget`` tokens a tick (FIFO across in-flight prefills, no
overtaking) as (1, C) decode steps on a private contiguous batch-1 cache,
interleaved with the batched decode step, and tokens reach the caller the
tick they commit (``Request.on_token``).  A chunk's attention is the plain
contiguous ``decode_attention``; its projections run B1, B2 and B5 at
M = C.  In paged mode the slot's pages grow chunk by chunk and its table
row stays all-NULL until the DECODING transition.

Failure model.  Requests run a state machine (QUEUED -> PREFILLING ->
DECODING -> FINISHED / FAILED / TIMED_OUT, with the EVICTED detour), TTFT
and total deadlines are enforced every tick, transient faults retry with
backoff, ``evict_policy="priority"`` preempts the lowest-priority slot
(its committed tokens are the snapshot, readmission is prefill from the
prefix), and a slot whose logits go non-finite is quarantined.  The
degradation ladder has two rungs, each recorded in ``degraded`` and
counted in ``stats.fallback_ticks``: speculative -> plain decode, and the
paged attention kernel (B3) -> its plain version for this engine.  Unlike
the reference, whose rungs catch any exception, a rung here is taken only
for the port's ``FaultInjected`` (and, for rung 1, the draft chain's
non-finite logits): a real build, launch or CUDA error propagates out of
``step``.  ``serving/faultinject.py`` drives every rung deterministically.

Sharded serving (``EngineConfig.mesh``/``rules``).  The reference shards
one jitted program over a JAX mesh; the port runs one engine per rank of a
(data, model) ``DeviceMesh`` (``launch/mesh.py``), every rank on the same
requests and seed.  Params and caches are placed once through the axis
registry (``distributed/shardlib``): each rank keeps its pieces
(``weight_plan.local_params``; the plan's recorded axes, else the family's
dense ones) and allocates its pieces of the caches -- page pools split on
the KV heads where the model axis divides them and whole on every data
replica, contiguous caches split on the batch over ``data`` too.  The host
state (slots, the page table for every slot, the allocator, the prefix
registry) is the same on every rank: the model gathers each step's logits
over both axes, so every rank's host takes the same decisions.  The
sizer's balance point divides the weight stream by the model axis and the
KV stream by the degree the pools achieve (``shardlib.parallelism_degrees``),
and a default ``max_batch`` feeds every data replica its n_opt.  Under a
mesh the engine serves every family the port has: the dense decoders,
MoE (expert parallelism: ``models/moe.py``), recurrentgemma (the RG-LRU's
channels split: ``models/recurrent.py``), xLSTM (the mLSTM's heads split,
the sLSTM's state whole: ``models/ssm.py``), the enc-dec family (the
encoder and both attentions on the rank's heads, the frame pools on its
KV heads: ``models/encdec.py``) and the VLM (the projector replicated),
plain, speculative or with chunked prefill, alone or as a member of a
``MixedServingEngine`` over a shared allocator (which, with the tables,
stays on the host and equal on every rank).  The draft's params and its
contiguous cache are placed through the same registry (its own
``param_axes`` / ``cache_axes``) and its steps run on the mesh; the
acceptance stays on the host, where every rank draws the same tokens.  A
chunk step runs on the rank's shards over a private batch-1 cache of its
KV heads (a batch of one stays whole over the data axis).  A mesh refuses
nothing.

Where the reference jit-compiles one decode step over a donated cache, the
port runs the decode step eagerly and updates the cache in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import math
import warnings
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core.batching import BatchSizer
from repro_torch.core.weight_plan import flatten_leaves, local_params, tree_to
from repro_torch.device import resolve_device
from repro_torch.distributed import shardlib as sl
from repro_torch.distributed.fault import HeartbeatMonitor
from repro_torch.models.api import (
    get_api,
    is_int8,
    kv_bytes_per_token,
    supports_int8_kv,
    supports_paged_kv,
)
from repro_torch.models.layers import finite_rows
from repro_torch.models.ssm import placement_axes
from repro_torch.serving.config import EngineConfig, positional_state_gate
from repro_torch.serving.faultinject import FaultInjected
from repro_torch.serving.paged import (
    NULL_PAGE,
    PageAllocator,
    PageAuditError,
    PoolExhausted,
    PrefixRegistry,
)
from repro_torch.serving.scheduler import PrefillJob, TickBudget, chunk_spans

# paged pool leaf -> its name in a contiguous (prefill) cache
_PAGED_KEYS = (
    ("k_pages", "k"),
    ("v_pages", "v"),
    ("k_scale_pages", "k_scale"),
    ("v_scale_pages", "v_scale"),
)


class RequestState(enum.Enum):
    """QUEUED -> PREFILLING -> DECODING is the happy path; FINISHED, FAILED
    and TIMED_OUT are terminal; EVICTED is the snapshot-and-requeue detour."""

    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    DECODING = "DECODING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    EVICTED = "EVICTED"
    TIMED_OUT = "TIMED_OUT"


TERMINAL_STATES = frozenset(
    {RequestState.FINISHED, RequestState.FAILED, RequestState.TIMED_OUT})

# legal transitions; anything else is an engine bug and raises.  QUEUED
# re-entry from PREFILLING/DECODING is the bounded-retry path; EVICTED
# re-enters PREFILLING at readmission.
_TRANSITIONS = {
    RequestState.QUEUED: {RequestState.PREFILLING, RequestState.TIMED_OUT,
                          RequestState.FAILED},
    RequestState.PREFILLING: {RequestState.DECODING, RequestState.QUEUED,
                              RequestState.FAILED, RequestState.TIMED_OUT,
                              RequestState.EVICTED},
    RequestState.DECODING: {RequestState.FINISHED, RequestState.FAILED,
                            RequestState.EVICTED, RequestState.TIMED_OUT,
                            RequestState.QUEUED},
    RequestState.EVICTED: {RequestState.PREFILLING, RequestState.QUEUED,
                           RequestState.TIMED_OUT, RequestState.FAILED},
    RequestState.FINISHED: frozenset(),
    RequestState.FAILED: frozenset(),
    RequestState.TIMED_OUT: frozenset(),
}


class InvalidTransition(RuntimeError):
    """An engine bug drove a request through an illegal lifecycle edge."""


class NonFiniteDraft(FloatingPointError):
    """The draft chain produced non-finite logits for a live slot: its
    proposals would feed later steps, so speculation degrades (rung 1)."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    temperature: float = 0.0
    extras: Optional[dict] = None  # a VLM's "patches", an enc-dec's "frames" (numpy)
    # failure-model knobs (engine defaults apply when None): priority orders
    # preemption under evict_policy="priority"; deadlines are budgets
    # relative to submit time on the engine clock
    priority: int = 0
    ttft_deadline_s: Optional[float] = None  # queue-to-first-token budget
    deadline_s: Optional[float] = None  # total-latency budget
    # streaming: on_token(request, token) the tick each token commits; runs
    # on the engine thread and must not raise
    on_token: Optional[Callable[["Request", int], None]] = None
    # filled by the engine:
    output: Optional[List[int]] = None
    done: bool = False
    state: RequestState = RequestState.QUEUED
    error: Optional[str] = None
    retries: int = 0  # transient-failure retries consumed
    evictions: int = 0  # preemptions survived (they do not consume retries)
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    not_before: float = 0.0  # retry backoff gate (engine-clock time)
    history: List[RequestState] = dataclasses.field(
        default_factory=lambda: [RequestState.QUEUED])

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def transition(self, new: RequestState, *, error: Optional[str] = None):
        if new not in _TRANSITIONS[self.state]:
            raise InvalidTransition(f"request {self.uid}: {self.state.value} -> {new.value}")
        self.state = new
        self.history.append(new)
        if error is not None:
            self.error = error
        if new in TERMINAL_STATES:
            self.done = True


@dataclasses.dataclass
class EngineStats:
    prefills: int = 0
    decode_steps: int = 0
    decode_tokens: int = 0  # COMMITTED tokens (speculative rejects excluded)
    completed: int = 0
    context_tokens: int = 0  # sum over admitted requests of (S + max_new)
    pages_shared: int = 0  # full prefix pages mapped by refcount (no copy)
    cow_copies: int = 0  # pages copied before a write (copy-on-write)
    # speculative decode: positions the target verified vs tokens committed
    verified_positions: int = 0
    draft_proposed: int = 0  # draft tokens offered to verification
    draft_accepted: int = 0  # draft tokens committed by verification
    # failure model
    failed: int = 0  # terminal FAILED (retries exhausted / cancelled)
    evicted: int = 0  # preemptions (snapshot + requeue, not terminal)
    timed_out: int = 0  # TTFT or total-latency deadline exceeded
    retried: int = 0  # transient-failure requeues (bounded by max_retries)
    fallback_ticks: int = 0  # ticks served in any degraded mode
    # continuous batching: prompt tokens advanced through the model in both
    # modes; prefill_chunks counts only chunked-prefill steps
    prefill_chunks: int = 0
    prefill_tokens: int = 0

    @property
    def mean_batch(self) -> float:
        """Mean committed tokens per decode step: the realized weight reuse
        in useful tokens (verified positions are reported apart)."""
        return self.decode_tokens / max(1, self.decode_steps)

    @property
    def accept_rate(self) -> float:
        """Fraction of proposed draft tokens committed by verification."""
        return self.draft_accepted / max(1, self.draft_proposed)

    @property
    def mean_context(self) -> float:
        return self.context_tokens / max(1, self.prefills)


class ServingEngine:
    """Continuous-batching engine around one model's prefill/decode.

    Runs on the CUDA device unless ``device="cpu"``; params (dense or a
    compressed tree, or ``plan.params``) are moved there and unstacked
    into per-layer views once, the draft's too.  With a mesh, the rank's
    pieces of them (see the module doc)."""

    def __init__(self, cfg, params, *, config: Optional[EngineConfig] = None,
                 plan=None, sizer: Optional[BatchSizer] = None, device=None, **legacy):
        # loose kwargs (the reference's legacy surface) route through the
        # deprecation shim, which warns once per process
        if legacy:
            if config is not None:
                raise TypeError(
                    "pass either config=EngineConfig(...) or legacy keyword "
                    f"arguments, not both (got {sorted(legacy)})")
            config = EngineConfig.from_legacy(**legacy)
        elif config is None:
            config = EngineConfig()
        self.config = config
        cc, sc, pc, fc = config.cache, config.scheduler, config.spec, config.fault
        self.device = resolve_device(device)
        self.cfg = cfg
        if plan is not None and params is None:
            params = plan.params
        self.api = get_api(cfg)
        self.mesh = config.mesh
        self.rules = None
        if self.mesh is not None:
            self.rules = {**sl.DEFAULT_RULES, **(config.rules or {})}
            # the plan's recorded per-leaf axes, the family's dense ones
            # otherwise (the same paths): both expand through the registry
            axes = (plan.axes_tree() if plan is not None and any(
                l.axes for l in plan.leaves.values()) else self.api.param_axes(cfg))
            params = local_params(params, placement_axes(axes), self.mesh, self.rules)
        self.params = self.api.unstack(cfg, tree_to(params, self.device))
        self.plan = plan
        self.max_len = max_len = int(config.max_len)
        self.kv_dtype = torch.int8 if is_int8(cc.kv_dtype) else None
        if self.kv_dtype is not None and not supports_int8_kv(cfg):
            # the enc-dec cache ignores kv_dtype: the sizer must not charge
            # an int8 stream that was never allocated
            warnings.warn(f"{cfg.name}: kv_dtype=int8 requested but the {cfg.family} cache "
                          f"does not support it; serving fp", stacklevel=2)
            self.kv_dtype = None
        self.paged = cc.page_size is not None
        if self.paged and not supports_paged_kv(cfg):
            warnings.warn(f"{cfg.name}: paged KV cache requested but the {cfg.family} decode "
                          f"path does not thread a page table; serving the contiguous cache",
                          stacklevel=2)
            self.paged = False
        self.page_size = cc.page_size if self.paged else None
        # speculative decode: the validated k (raises on a missing draft or a
        # vocab mismatch); chunked prefill shares its positional-cache gate
        self.spec_k = pc.validated_k(cfg)
        self.draft_cfg = pc.draft_cfg
        self.prefill_chunk = self.prefill_budget = None
        if sc.prefill_chunk is not None:
            chunk = int(sc.prefill_chunk)
            if chunk <= 0:
                raise ValueError(f"prefill_chunk must be positive, got {chunk}")
            reason = positional_state_gate(cfg, "chunked prefill")
            if reason is not None:
                warnings.warn(reason + "; serving synchronous prefill", stacklevel=2)
            else:
                if any(k == "local" for k in cfg.layer_kinds):
                    # a chunk wider than a sliding-window ring would scatter
                    # duplicate ring slots in one step: clamp to the window
                    chunk = min(chunk, cfg.local_window)
                self.prefill_chunk = chunk
                self.prefill_budget = max(int(sc.prefill_budget or 0), chunk)
        ctx = min(int(cc.expected_context) if cc.expected_context else max_len, max_len)
        self.expected_context = ctx
        kv_tok = kv_bytes_per_token(cfg, self.kv_dtype, context_len=ctx)
        # multi-rank accounting: the model axis divides the weight stream,
        # the KV term divides by the degree the pools achieve; data replicas
        # repeat the whole analysis over the batch
        self.data_parallel, self.model_parallel, self.kv_parallel = sl.parallelism_degrees(
            self.mesh, self.rules, int(getattr(cfg, "n_kv_heads", 0) or 0))
        if sizer is None:
            n_params = self.api.n_params_exact(cfg)
            mp_kw = dict(model_parallel=self.model_parallel, kv_parallel=self.kv_parallel,
                         spec_k=self.spec_k)
            if self.spec_k:
                mp_kw["draft_n_params"] = get_api(self.draft_cfg).n_params_exact(self.draft_cfg)
            if plan is not None:
                sizer = plan.sizer(n_params=n_params, kv_bytes_per_token=kv_tok,
                                   context_len=ctx, **mp_kw)
            else:
                sizer = BatchSizer(n_params=n_params, kv_bytes_per_token=kv_tok,
                                   context_len=ctx, **mp_kw)
        max_batch = config.max_batch
        if max_batch is None:
            # n_opt balances ONE model group: every data replica gets its own
            max_batch = min(64, sizer.n_opt * self.data_parallel)
        self.max_batch = max_batch
        self.sizer = sizer
        self.dtype = getattr(torch, cfg.compute_dtype)
        # slot state (host-side)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros((max_batch,), np.int32)  # next position to write
        self.slot_remaining = np.zeros((max_batch,), np.int32)
        self.slot_last_tok = np.zeros((max_batch,), np.int32)
        self.slot_admit_seq = np.zeros((max_batch,), np.int64)  # admission order
        # slot -> in-flight chunked prefill: live (pages, deadlines,
        # eviction) but not in the decode batch (_decoding_slots)
        self.slot_prefill: List[Optional[PrefillJob]] = [None] * max_batch
        self.last_tick_prefill_tokens = 0  # budget spent by the last tick
        self.queue: deque = deque()
        self.stats = EngineStats()
        # -- failure model ----------------------------------------------
        if sc.evict_policy not in ("fifo", "priority"):
            raise ValueError(f"evict_policy must be fifo|priority, got {sc.evict_policy!r}")
        self.evict_policy = sc.evict_policy
        self.request_timeout_s = sc.request_timeout_s
        self.ttft_deadline_s = sc.ttft_deadline_s
        self.max_retries = int(sc.max_retries)
        self.retry_backoff_s = float(sc.retry_backoff_s)
        self.deadline_slack_s = float(sc.deadline_slack_s)
        self.clock = fc.clock
        self.fault_injector = fc.fault_injector
        self.spec_fallback_accept = pc.fallback_accept
        self.spec_fallback_min_ticks = int(pc.fallback_min_ticks)
        self.audit_every_step = bool(fc.audit_every_step)
        self.tick = 0  # 1-based after the first step()
        self._admit_seq = 0
        self._spec_ticks = 0
        # degradation ladder: rung name -> reason; rungs are one-way
        self.degraded: dict = {}
        self.spec_active = self.spec_k > 0
        # rung 2 switches this engine's paged attention to its plain version
        self.attention_kernel = True
        self.watchdog = (HeartbeatMonitor(n_hosts=1, timeout_s=fc.watchdog_timeout_s,
                                          clock=self.clock)
                         if fc.watchdog_timeout_s is not None else None)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        # host RNG of the speculative draft/accept chain (the torch generator
        # above stays the plain sampler)
        self._np_rng = np.random.default_rng(config.seed)
        # enc-dec paged serving: the frame pages' lists and table (below)
        self.xpages_per_seq = 0
        self.slot_xpages: Optional[List[List[int]]] = None
        self._xtable = None
        self._owns_allocator = False
        if self.paged:
            self.pages_per_seq = math.ceil(max_len / self.page_size)
            if cc.allocator is not None:
                # mixed-family serving: several engines draw from one
                # allocator (shared capacity, disjoint page ownership); the
                # pools span its page ids and its owner runs the union audit
                self.allocator = cc.allocator
                self.num_pages = self.allocator.num_pages
            else:
                # default pool: byte parity with the contiguous reservation
                self.num_pages = cc.num_pages or (1 + max_batch * self.pages_per_seq)
                self.allocator = PageAllocator(self.num_pages)
                self._owns_allocator = True
            share_prefix = cc.share_prefix
            if share_prefix and self.api.extra_keys:
                # prefix sharing keys on prompt tokens only; this family's KV
                # also depends on each request's patches or frames
                warnings.warn(
                    f"{cfg.name}: share_prefix keys on prompt tokens but this family's "
                    f"cache also depends on {self.api.extra_keys}; serving without "
                    f"prefix sharing", stacklevel=2)
                share_prefix = False
            self.registry = PrefixRegistry() if share_prefix else None
            self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
            self._table = np.full((max_batch, self.pages_per_seq), NULL_PAGE, np.int32)
            self.cache = self._new_cache(max_batch, page_size=self.page_size,
                                         num_pages=self.num_pages)
            if "xpage_table" in self.cache:
                # enc-dec: each slot's encoded frames take pages of the same
                # allocator, written once at admission, read-only after
                self.xpages_per_seq = int(self.cache["xpage_table"].shape[1])
                self.slot_xpages = [[] for _ in range(max_batch)]
                self._xtable = np.full((max_batch, self.xpages_per_seq), NULL_PAGE, np.int32)
        else:
            self.allocator = None
            self.registry = None
            self.cache = self._new_cache(max_batch)
        # this data replica's slots of a cache whose batch is split (None: all)
        with self._on_mesh():
            self._rows = sl.data_rows(max_batch)
        # the draft side: its own model (dense from the CLI) over a contiguous
        # cache; on a mesh the rank's pieces of both, by the draft's axes
        self.draft_api = self.draft_params = self.draft_cache = None
        if self.spec_k:
            self.draft_api = get_api(self.draft_cfg)
            self.draft_dtype = getattr(torch, self.draft_cfg.compute_dtype)
            draft_params = pc.draft_params
            if self.mesh is not None:
                draft_params = local_params(draft_params,
                                            self.draft_api.param_axes(self.draft_cfg),
                                            self.mesh, self.rules)
            self.draft_params = self.draft_api.unstack(
                self.draft_cfg, tree_to(draft_params, self.device))
            self.draft_cache = self._new_cache(max_batch, draft=True)

    @classmethod
    def from_tuned(cls, cfg, params, tuned: dict, *, plan=None, device=None, **overrides):
        """An engine at a TunedPlan artifact's serving point
        (``core/autotune``): its knobs (kv_dtype, page geometry, max_batch,
        expected context, spec_k) become the EngineConfig, ``overrides``
        (flat names) win over them.  ``plan`` is the WeightPlan the
        artifact's PlanConfig materializes (``autotune.plan_config`` +
        ``compress``, or a ``load_plan`` cache); pass it so that the sizer
        charges the tuned weight stream.  spec_k is kept only when a draft
        is passed (``draft_cfg``/``draft_params``): the artifact carries
        none."""
        from repro_torch.core import autotune as AT

        if tuned.get("arch") != cfg.name:
            raise ValueError(f"TunedPlan was searched for arch {tuned.get('arch')!r}, "
                             f"engine config is {cfg.name!r}")
        return cls(cfg, params, plan=plan, device=device,
                   config=AT.engine_config(tuned, **overrides))

    # -- sharded placement ---------------------------------------------------

    def _on_mesh(self):
        """The engine's mesh and rules active for the model code (nothing
        without a mesh)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sl.use_mesh(self.mesh, self.rules)

    def _new_cache(self, batch: int, draft: bool = False, **paged):
        """A cache of ``batch`` slots in the engine's dtypes (paged with
        ``page_size``/``num_pages``; ``draft``: the draft model's contiguous
        cache in its compute dtype): on a mesh, the rank's pieces of each
        leaf by the registered cache axes, allocated as such; the page
        and frame tables stay whole (every rank scatters the whole batch's
        K/V)."""
        api, cfg = (self.draft_api, self.draft_cfg) if draft else (self.api, self.cfg)
        dtype = self.draft_dtype if draft else self.dtype
        kw = dict(spec_k=self.spec_k, **paged)
        if not draft:
            kw["kv_dtype"] = self.kv_dtype
        if self.mesh is None:
            return api.init_cache(cfg, batch, self.max_len, dtype, device=self.device, **kw)
        meta = api.init_cache(cfg, batch, self.max_len, dtype, device="meta", **kw)
        # each leaf's starting value, from a cache of one slot, one position
        # and one page on the host
        start = api.init_cache(cfg, 1, 1, dtype, device="cpu",
                               **(dict(kw, num_pages=1) if paged else kw))
        axes = api.cache_axes(cfg, quantized_kv=kw.get("kv_dtype") is not None,
                              paged=bool(paged))
        axes.pop("page_table", None)
        axes.pop("xpage_table", None)
        return sl.local_zeros(meta, axes, self.mesh, self.rules, self.device, start=start)

    def _local_row(self, slot: int) -> Optional[int]:
        """``slot``'s row in this rank's piece of a batch-split cache (None:
        another data replica holds it)."""
        if self._rows is None:
            return slot
        if self._rows.start <= slot < self._rows.stop:
            return slot - self._rows.start
        return None

    def weight_bytes(self) -> int:
        """Bytes of the params this rank holds on its device (its pieces on
        a mesh; each storage once: the per-layer views share theirs)."""
        seen, total = set(), 0
        for t in flatten_leaves(self.params):
            st = t.untyped_storage()
            if t.device.type == self.device.type and st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        return total

    # -- host-side plumbing -------------------------------------------------

    def submit(self, req: Request):
        if req.submit_t is not None or req.state is not RequestState.QUEUED:
            raise ValueError(f"request {req.uid} already submitted (state {req.state.value})")
        req.output = []
        req.submit_t = self.clock()
        self.queue.append(req)

    def cancel(self, req: Request) -> bool:
        """Cancel a queued or running request: slot and pages free at once,
        the request ends FAILED("cancelled").  False for a terminal one."""
        if req.terminal:
            return False
        if req in self.queue:
            self.queue.remove(req)
        else:
            slot = next((s for s, r in enumerate(self.slot_req) if r is req), None)
            if slot is None:
                return False
            self._release_slot(slot)
        req.transition(RequestState.FAILED, error="cancelled")
        req.finish_t = self.clock()
        self.stats.failed += 1
        return True

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _live_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    def _decoding_slots(self) -> List[int]:
        """Live slots minus in-flight chunked prefills (their KV is still in
        the job's private cache and their table row is all-NULL)."""
        return [i for i, r in enumerate(self.slot_req)
                if r is not None and self.slot_prefill[i] is None]

    def _emit(self, req: Request, toks) -> None:
        """Streaming: deliver just-committed tokens to the request's callback."""
        if req.on_token is not None:
            for t in toks:
                req.on_token(req, int(t))

    @property
    def pages_in_use(self) -> int:
        return self.allocator.used_pages if self.paged else 0

    # -- failure model: deadlines, retries, eviction -------------------------

    def _release_slot(self, slot: int):
        """Free a slot and its pages (refcount-correct through shared
        prefixes).  Device rows need no scrub: position masks hide stale
        entries and the table row reverts to the null page."""
        self.slot_req[slot] = None
        self.slot_prefill[slot] = None  # an in-flight chunk job dies with the slot
        if self.paged:
            self._free_slot_pages(slot)

    def _deadline_reason(self, req: Request, now: float) -> Optional[str]:
        """Which deadline ``req`` has exceeded at ``now`` (per-request
        budgets override the engine's; TTFT applies until the first token)."""
        if req.submit_t is None:
            return None
        total = req.deadline_s if req.deadline_s is not None else self.request_timeout_s
        if total is not None and now - req.submit_t > total:
            return f"total-latency deadline {total:g}s exceeded"
        if req.first_token_t is None:
            ttft = req.ttft_deadline_s if req.ttft_deadline_s is not None else self.ttft_deadline_s
            if ttft is not None and now - req.submit_t > ttft:
                return f"TTFT deadline {ttft:g}s exceeded"
        return None

    def _time_out(self, req: Request, reason: str, slot: Optional[int] = None):
        if slot is not None:
            self._release_slot(slot)
        req.transition(RequestState.TIMED_OUT, error=reason)
        req.finish_t = self.clock()
        self.stats.timed_out += 1

    def _enforce_deadlines(self, now: float):
        """Queued requests (evicted ones too) and live slots time out the
        tick their budget lapses."""
        for req in [r for r in self.queue if self._deadline_reason(r, now)]:
            self.queue.remove(req)
            self._time_out(req, self._deadline_reason(req, now))
        for slot in self._live_slots():
            reason = self._deadline_reason(self.slot_req[slot], now)
            if reason is not None:
                self._time_out(self.slot_req[slot], reason, slot=slot)

    def _retry_or_fail(self, req: Request, reason: str):
        """Bounded retry with exponential backoff (``not_before``), resuming
        from the committed prefix; FAILED once ``max_retries`` is spent."""
        now = self.clock()
        if req.retries >= self.max_retries:
            req.transition(RequestState.FAILED, error=reason)
            req.finish_t = now
            self.stats.failed += 1
            return
        req.retries += 1
        self.stats.retried += 1
        req.not_before = now + self.retry_backoff_s * (2 ** (req.retries - 1))
        req.transition(RequestState.QUEUED, error=reason)
        self.queue.append(req)

    def _quarantine_slot(self, slot: int, reason: str):
        """Numeric guard: a slot whose logits went non-finite leaves the
        batch (slot and pages freed) and retries or fails."""
        req = self.slot_req[slot]
        self._release_slot(slot)
        self._retry_or_fail(req, reason)

    def _evict_slot(self, slot: int, reason: str):
        """Preemption: ``req.output`` is the snapshot, pages free
        refcount-correctly, and the request re-enters the queue front for
        prefill-from-prefix readmission (no retry consumed)."""
        req = self.slot_req[slot]
        self._release_slot(slot)
        req.transition(RequestState.EVICTED, error=reason)
        req.evictions += 1
        self.stats.evicted += 1
        self.queue.appendleft(req)

    def _pick_victim(self, incoming: Request, now: float) -> Optional[int]:
        """Under ``evict_policy="priority"``: the lowest-priority live slot,
        ties toward the most recently admitted; it must rank strictly below
        the incoming request (no thrashing), and TTFT pressure within
        ``deadline_slack_s`` is worth one priority level."""
        if self.evict_policy != "priority":
            return None
        live = self._live_slots()
        if not live:
            return None
        slot = min(live, key=lambda s: (self.slot_req[s].priority, -int(self.slot_admit_seq[s])))
        boost = 0
        ttft = (incoming.ttft_deadline_s if incoming.ttft_deadline_s is not None
                else self.ttft_deadline_s)
        if (self.deadline_slack_s > 0 and ttft is not None
                and incoming.first_token_t is None and incoming.submit_t is not None
                and now - incoming.submit_t >= ttft - self.deadline_slack_s):
            boost = 1
        if self.slot_req[slot].priority < incoming.priority + boost:
            return slot
        return None

    def _next_queued(self, now: float) -> Optional[Request]:
        """Next admissible request: highest priority first under the
        priority policy (FIFO among equals), FIFO otherwise; requests in
        retry backoff are skipped until ``not_before``."""
        eligible = [r for r in self.queue if r.not_before <= now]
        if not eligible:
            return None
        if self.evict_policy == "priority":
            return max(eligible, key=lambda r: r.priority)
        return eligible[0]

    def _resume_tokens(self, req: Request) -> np.ndarray:
        """Prefill tokens: the prompt plus any committed output (eviction or
        retry resumes from the prefix)."""
        out = req.output or []
        if not out:
            return np.asarray(req.prompt, np.int32)
        return np.concatenate([np.asarray(req.prompt, np.int32), np.asarray(out, np.int32)])

    # -- device-side steps --------------------------------------------------

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        """A host int array as a device tensor (a copy: the host arrays move on)."""
        return torch.tensor(a, device=self.device)

    def _prefill_request(self, req: Request, tokens: np.ndarray):
        """Batch-1 prefill into a private contiguous cache.  Returns (first
        sampled token, cache1, logits-finite flag)."""
        cache1 = self._new_cache(1)
        batch = {"tokens": self._on_device(np.asarray(tokens, np.int32))[None]}
        for k, v in (req.extras or {}).items():
            batch[k] = self._on_device(np.asarray(v))[None]
        with self._on_mesh():
            logits, cache1 = self.api.prefill(self.cfg, self.params, batch, cache1)
        self.stats.prefill_tokens += len(tokens)
        row = logits[:, -1]
        ok = bool(torch.isfinite(row).all())
        tok = int(self._sample(row, req.temperature)[0])
        return tok, cache1, ok

    def _draft_prefill_slot(self, slot: int, tokens: np.ndarray):
        """Fill the draft's KV for ``tokens`` into its slot of the draft
        cache (the draft's prefill logits are not used)."""
        cache1 = self._new_cache(1, draft=True)
        batch = {"tokens": self._on_device(np.asarray(tokens, np.int32))[None]}
        with self._on_mesh():
            _, cache1 = self.draft_api.prefill(self.draft_cfg, self.draft_params, batch, cache1)
        self._write_slot(slot, cache1, self.draft_cache)

    def _start_slot(self, slot: int, req: Request, S: int, first_tok: int,
                    tokens: np.ndarray, resumed: bool):
        if self.spec_active:
            self._draft_prefill_slot(slot, tokens)
        self.slot_req[slot] = req
        self.slot_pos[slot] = S
        self._admit_seq += 1
        self.slot_admit_seq[slot] = self._admit_seq
        # resumption: committed tokens were replayed as prompt
        self.slot_remaining[slot] = req.max_new_tokens - len(req.output)
        self.slot_last_tok[slot] = first_tok
        req.transition(RequestState.DECODING)
        req.output.append(first_tok)
        self._emit(req, (first_tok,))
        self.slot_remaining[slot] -= 1
        if req.first_token_t is None:
            req.first_token_t = self.clock()
        self.stats.prefills += 1
        if not resumed:
            self.stats.context_tokens += S + req.max_new_tokens
        self._finish_if_done(slot)

    def _admit(self):
        """Move queued requests into free slots (prefill, or a chunk job);
        under the priority policy a blocked queue may preempt a slot."""
        if self.paged:
            return self._admit_paged()
        now = self.clock()
        while self.queue:
            req = self._next_queued(now)
            if req is None:
                break
            free = self._free_slots()
            if not free:
                victim = self._pick_victim(req, now)
                if victim is None:
                    break
                self._evict_slot(victim, "preempted")
                continue  # the evictee re-entered the queue: re-select
            slot = free[0]
            tokens = self._resume_tokens(req)
            S = len(tokens) + self.api.prefix_len(self.cfg)
            remaining = req.max_new_tokens - len(req.output)
            # the last verify tick writes up to spec_k positions past the
            # final committed token; the cache ring must never wrap
            if S + remaining + self.spec_k > self.max_len:
                raise ValueError(
                    f"request {req.uid}: S + remaining (+ spec_k headroom) = "
                    f"{S + remaining + self.spec_k} exceeds max_len {self.max_len}")
            self.queue.remove(req)
            resumed = bool(req.output)
            req.transition(RequestState.PREFILLING)
            if self.prefill_chunk is not None:
                self._enqueue_prefill(slot, req, tokens, S, resumed)
                continue
            tok, cache1, ok = self._prefill_request(req, tokens)
            if not ok:
                self._retry_or_fail(req, "non-finite prefill logits")
                continue
            self._write_slot(slot, cache1, self.cache)
            self._start_slot(slot, req, S, tok, tokens, resumed)

    def _admit_paged(self):
        """Paged admission: map shared prefix pages, allocate the rest; on
        exhaustion preempt (priority policy) or leave the queue alone (FIFO
        back-pressure).  A failure after pages were claimed releases them
        before the request re-queues."""
        ps = self.page_size
        now = self.clock()
        while self.queue:
            req = self._next_queued(now)
            if req is None:
                break
            free = self._free_slots()
            if not free:
                victim = self._pick_victim(req, now)
                if victim is None:
                    break
                self._evict_slot(victim, "preempted (slot pressure)")
                continue
            slot = free[0]
            tokens = self._resume_tokens(req)
            S = len(tokens) + self.api.prefix_len(self.cfg)
            remaining = req.max_new_tokens - len(req.output or [])
            total = S + remaining
            capacity = self.pages_per_seq * ps
            if total + self.spec_k > capacity:
                # spec_k headroom keeps the verify scatter's table lookups in
                # range; writes past the allocated pages land on the null page
                raise ValueError(
                    f"request {req.uid}: S + remaining (+ spec_k) = {total + self.spec_k} "
                    f"exceeds the page-table capacity {capacity} (pages_per_seq * "
                    f"page_size); raise max_len")
            prompt_key = tuple(int(t) for t in tokens)
            shared_len, shared_pages = (
                self.registry.match(prompt_key) if self.registry is not None else (0, []))
            n_total = math.ceil(total / ps)
            n_full = shared_len // ps  # full pages mapped by refcount
            boundary = 1 if shared_len % ps else 0  # partial page: eager COW
            # enc-dec: the encoded frames claim their own pages from the same
            # pool, so admission back-pressure covers the whole request
            x_need = self.xpages_per_seq
            if not self._can_alloc_pages(n_total - n_full + x_need):
                victim = self._pick_victim(req, now)
                if victim is None:
                    break  # pool exhausted: the request stays queued
                self._evict_slot(victim, "preempted (page-pool pressure)")
                continue
            self.queue.remove(req)
            resumed = bool(req.output)
            req.transition(RequestState.PREFILLING)
            retained = shared_pages[:n_full]
            self.allocator.retain(retained)
            # chunked: claim the shared prefix and the boundary copy now, grow
            # the rest chunk by chunk; the row stays unpublished until DECODING
            n_fresh = boundary if self.prefill_chunk is not None else n_total - n_full
            try:
                fresh = self._alloc_pages(n_fresh)
                xpages: List[int] = []
                if x_need:
                    try:
                        xpages = self._alloc_pages(x_need)
                    except PoolExhausted:
                        self.allocator.release(fresh)
                        raise
            except PoolExhausted as e:
                # raced an (injected) failure between can_alloc and alloc
                self.allocator.release(retained)
                self._retry_or_fail(req, f"page pool exhausted at admission: {e}")
                continue
            if boundary:
                # the new sequence writes positions [shared_len, ...) into this
                # page, so it cannot share it read-only: copy it now
                self._copy_page(shared_pages[n_full], fresh[0])
                self.stats.cow_copies += 1
            pages = retained + fresh
            self.stats.pages_shared += n_full
            self.slot_pages[slot] = pages
            if self.prefill_chunk is not None:
                self._enqueue_prefill(slot, req, tokens, S, resumed, shared_len=shared_len,
                                      prompt_key=prompt_key)
                continue
            self._table[slot, :] = NULL_PAGE
            self._table[slot, : len(pages)] = pages
            if x_need:
                self.slot_xpages[slot] = xpages
                self._xtable[slot, :] = NULL_PAGE
                self._xtable[slot, : len(xpages)] = xpages
            try:
                tok, cache1, ok = self._prefill_request(req, tokens)
            except Exception:
                # torn admission: release before propagating, so the
                # allocator stays audit-clean even on unexpected errors
                self._free_slot_pages(slot)
                raise
            if not ok:
                self._free_slot_pages(slot)
                self._retry_or_fail(req, "non-finite prefill logits")
                continue
            # shared positions [0, shared_len) already hold identical KV
            # (same tokens, positions and params): write only ours
            self._write_slot_paged(slot, cache1, start=shared_len, stop=S)
            if self.registry is not None:
                self.registry.register(prompt_key, pages[: math.ceil(S / ps)])
            self._start_slot(slot, req, S, tok, tokens, resumed)

    # -- chunked prefill (continuous batching) -------------------------------

    def _enqueue_prefill(self, slot: int, req: Request, tokens: np.ndarray, S: int,
                         resumed: bool, shared_len: int = 0, prompt_key=None):
        """Reserve ``slot`` for a multi-tick chunked prefill: live from here
        (deadlines, eviction), in the decode batch from DECODING on."""
        self.slot_req[slot] = req
        self._admit_seq += 1
        self.slot_admit_seq[slot] = self._admit_seq
        self.slot_prefill[slot] = PrefillJob(
            req=req, tokens=np.asarray(tokens, np.int32), S=S, resumed=resumed,
            shared_len=shared_len, prompt_key=prompt_key)

    def _run_prefill_chunks(self):
        """Advance in-flight chunked prefills, oldest admission first, by at
        most ``prefill_budget`` prompt tokens this tick; when the oldest
        job's next span does not fit, the tick's prefill work ends."""
        budget = TickBudget(self.prefill_budget)
        jobs = sorted((s for s in range(self.max_batch) if self.slot_prefill[s] is not None),
                      key=lambda s: int(self.slot_admit_seq[s]))
        for slot in jobs:
            while self.slot_prefill[slot] is not None:
                job = self.slot_prefill[slot]
                start, stop = next((a, b) for a, b in chunk_spans(job.S, self.prefill_chunk)
                                   if b > job.done)
                if not budget.try_charge(stop - start):
                    self.last_tick_prefill_tokens = budget.used
                    return
                self._run_prefill_chunk(slot, job, start, stop)
        self.last_tick_prefill_tokens = budget.used

    def _run_prefill_chunk(self, slot: int, job: PrefillJob, start: int, stop: int):
        """One chunk: a (1, stop - start) decode step at positions
        [start, stop) of the job's private contiguous cache.  A non-finite
        chunk sends the request to the retry path."""
        if job.cache1 is None:
            job.cache1 = self._new_cache(1)
        toks = self._on_device(job.tokens[start:stop])[None]
        pos = self._on_device(np.asarray([start], np.int32))
        with self._on_mesh():
            logits, job.cache1 = self.api.decode_step(self.cfg, self.params, job.cache1, toks,
                                                      pos)
        job.done = stop
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += stop - start
        if not bool(finite_rows(logits)[0]):
            self._quarantine_slot(slot, "non-finite prefill logits (chunked)")
            return
        if self.paged:
            try:
                # capacity tracks the prefilled frontier (row unpublished)
                self._grow_slot_pages(slot, math.ceil(stop / self.page_size))
            except PoolExhausted as e:
                self._quarantine_slot(slot, f"page pool exhausted during chunked prefill: {e}")
                return
        if job.finished:
            job.last_row = logits[:, -1]
            self._finish_prefill_job(slot, job)

    def _finish_prefill_job(self, slot: int, job: PrefillJob):
        """DECODING transition: top the pages up to the decode-complete
        count, scatter the private cache into the slot, publish the row,
        register the prefix, sample the first token, start the slot."""
        req = job.req
        tok = int(self._sample(job.last_row, req.temperature)[0])
        if self.paged:
            ps = self.page_size
            remaining = req.max_new_tokens - len(req.output or [])
            try:
                self._grow_slot_pages(slot, math.ceil((job.S + remaining) / ps))
            except PoolExhausted as e:
                self._quarantine_slot(slot, f"page pool exhausted at prefill completion: {e}")
                return
            self._write_slot_paged(slot, job.cache1, start=job.shared_len, stop=job.S)
            pages = self.slot_pages[slot]
            self._table[slot, :] = NULL_PAGE
            self._table[slot, : len(pages)] = pages
            if self.registry is not None and job.prompt_key is not None:
                self.registry.register(job.prompt_key, pages[: math.ceil(job.S / ps)])
        else:
            self._write_slot(slot, job.cache1, self.cache)
        self.slot_prefill[slot] = None
        self._start_slot(slot, req, job.S, tok, job.tokens, job.resumed)

    def _grow_slot_pages(self, slot: int, n_pages: int):
        """Extend this slot's page list to ``n_pages`` (allocator-charged,
        row unpublished).  Raises ``PoolExhausted``."""
        need = n_pages - len(self.slot_pages[slot])
        if need > 0:
            self.slot_pages[slot].extend(self._alloc_pages(need))

    # -- paged-pool plumbing ------------------------------------------------

    def _can_alloc_pages(self, n: int) -> bool:
        """Allocator probe through the ``alloc_fail`` injection point."""
        fi = self.fault_injector
        if fi is not None and fi.alloc_fail(self.tick):
            return False
        return self.allocator.can_alloc(n)

    def _alloc_pages(self, n: int) -> List[int]:
        """Allocation through the ``alloc_fail`` injection point; callers
        treat ``PoolExhausted`` as a fault of one request."""
        fi = self.fault_injector
        if fi is not None and fi.alloc_fail(self.tick):
            raise PoolExhausted(f"injected allocation failure at tick {self.tick}")
        return self.allocator.alloc(n)

    def audit_pages(self):
        """Allocator refcounts and free list must equal the live slot->page
        mapping exactly, and the host table must mirror it (all-NULL for a
        slot still prefilling).  A shared allocator's refcounts span several
        engines: its owner (``MixedServingEngine``) audits it against the
        union of their ``_page_refs``, and this engine checks its tables
        only.  Raises ``PageAuditError``."""
        if not self.paged:
            return
        if self._owns_allocator:
            self.allocator.audit(self._page_refs())
        for slot in range(self.max_batch):
            pages = self.slot_pages[slot]
            row = self._table[slot]
            if self.slot_prefill[slot] is not None:
                if not np.all(row == NULL_PAGE):
                    raise PageAuditError(
                        f"slot {slot}: prefilling slot published table row {row.tolist()} "
                        f"before its DECODING transition")
                continue
            if not (np.array_equal(row[: len(pages)], np.asarray(pages, np.int32))
                    and np.all(row[len(pages):] == NULL_PAGE)):
                raise PageAuditError(
                    f"slot {slot}: table row {row.tolist()} does not mirror the slot "
                    f"mapping {pages}")
            if self.slot_req[slot] is None and pages:
                raise PageAuditError(f"slot {slot}: free slot still owns pages {pages}")
            if self.slot_xpages is not None:
                xpages, xrow = self.slot_xpages[slot], self._xtable[slot]
                if not (np.array_equal(xrow[: len(xpages)], np.asarray(xpages, np.int32))
                        and np.all(xrow[len(xpages):] == NULL_PAGE)):
                    raise PageAuditError(
                        f"slot {slot}: frame table row {xrow.tolist()} does not mirror the "
                        f"slot mapping {xpages}")
                if self.slot_req[slot] is None and xpages:
                    raise PageAuditError(f"slot {slot}: free slot still owns frame pages "
                                         f"{xpages}")

    def _page_refs(self) -> List[int]:
        """Every page reference this engine holds: its slots' decoder pages
        and (enc-dec) frame pages."""
        refs = [p for pages in self.slot_pages for p in pages]
        if self.slot_xpages is not None:
            refs += [p for pages in self.slot_xpages for p in pages]
        return refs

    def _copy_page(self, src: int, dst: int):
        """pool[dst] <- pool[src] for every paged leaf of every layer (in place)."""
        for entry in self.cache["layers"]:
            for pk, _ in _PAGED_KEYS:
                if pk in entry:
                    entry[pk][dst] = entry[pk][src]

    def _ensure_private(self, slot: int, logical_page: int):
        """Copy-on-write guard: the page about to be written must be owned by
        this slot alone.  Raises ``PoolExhausted`` when the copy cannot be
        allocated."""
        phys = self.slot_pages[slot][logical_page]
        if self.allocator.refcount[phys] > 1:
            new = self._alloc_pages(1)[0]
            self._copy_page(phys, new)
            self.allocator.release([phys])
            self.slot_pages[slot][logical_page] = new
            self._table[slot, logical_page] = new
            self.stats.cow_copies += 1

    def _write_slot_paged(self, slot: int, cache1, start: int, stop: int):
        """Scatter positions [start, stop) of a batch-1 contiguous prefill
        cache into this slot's pages (in place); a layer that is not paged
        (a sliding-window ring) takes its whole row, whatever the shared
        prefix covers, since rings are never shared."""
        ps = self.page_size
        pos_w = np.arange(start, stop)
        for lp in sorted({int(p) // ps for p in pos_w}):
            self._ensure_private(slot, lp)
        phys = torch.as_tensor([self.slot_pages[slot][p // ps] for p in pos_w],
                               dtype=torch.long, device=self.device)
        off = torch.as_tensor(pos_w % ps, dtype=torch.long, device=self.device)
        src = torch.as_tensor(pos_w, dtype=torch.long, device=self.device)
        row = self._local_row(slot)
        for entry, one in zip(self.cache["layers"], cache1["layers"]):
            if "k_pages" not in entry:
                if row is not None:
                    for k, ring in entry.items():
                        ring[row] = one[k][0].to(ring.dtype)
                continue
            if len(pos_w) == 0:
                continue
            for pk, ck in _PAGED_KEYS:
                if pk in entry:
                    entry[pk][phys, off] = one[ck][0, src].to(entry[pk].dtype)
        if self.slot_xpages is not None:
            self._write_slot_xpages(slot, cache1)

    def _write_slot_xpages(self, slot: int, cache1):
        """Scatter the prefill's cross-attention K/V (the encoded frames) of
        every decoder layer into this slot's frame pages (in place).  They
        are written once and only this slot reads them: no COW guard."""
        ps, nf = self.page_size, self.cfg.n_frames
        frames = np.arange(nf)
        phys = torch.as_tensor([self.slot_xpages[slot][f // ps] for f in frames],
                               dtype=torch.long, device=self.device)
        off = torch.as_tensor(frames % ps, dtype=torch.long, device=self.device)
        for pools, one in zip(self.cache["x"], cache1["layers"]):
            for pk, ck in (("k_pages", "xk"), ("v_pages", "xv")):
                pools[pk][phys, off] = one[ck][0, :nf].to(pools[pk].dtype)

    def _free_slot_pages(self, slot: int):
        freed = self.allocator.release(self.slot_pages[slot])
        if self.registry is not None:
            self.registry.evict(freed)
        self.slot_pages[slot] = []
        self._table[slot, :] = NULL_PAGE
        if self.slot_xpages is not None:
            self.allocator.release(self.slot_xpages[slot])
            self.slot_xpages[slot] = []
            self._xtable[slot, :] = NULL_PAGE

    def _write_slot(self, slot: int, cache1, cache):
        """Copy a batch-1 contiguous cache into slot ``slot`` of ``cache``
        (the target's or the draft's; in place): every leaf is (batch, ...),
        so the slot's KV rows and its recurrent / xLSTM states are all
        rewritten, and nothing of the slot's previous owner survives.  On a
        mesh only the data replica that holds the slot's row writes it, and
        each rank its pieces (its KV heads, its RG-LRU channels)."""
        row = self._local_row(slot)
        if row is None:
            return
        for entry, one in zip(cache["layers"], cache1["layers"]):
            for k, pool in entry.items():
                pool[row] = one[k][0].to(pool.dtype)

    def _sample(self, logits: torch.Tensor, temperature: float) -> torch.Tensor:
        """(n, V) logits -> (n,) tokens: argmax when greedy, else a draw
        from softmax(logits / T) with the engine's generator."""
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    def _finish_if_done(self, slot: int):
        if self.slot_remaining[slot] <= 0:
            req = self.slot_req[slot]
            self._release_slot(slot)
            req.transition(RequestState.FINISHED)
            req.finish_t = self.clock()
            self.stats.completed += 1

    def _publish_table(self, live: List[int], span: int = 0) -> List[int]:
        """COW guard on this tick's write targets (positions [pos, pos +
        span], maybe across a page boundary), then copy the host table into
        the cache's ``page_table``.  Pages past the allocated ones map to the
        null page (a verify step's overrun), and lookups past the table clamp
        (``layers.paged_cache_update``, the B3 wrapper).  A slot whose COW
        copy cannot be allocated is quarantined; returns the rest."""
        ps = self.page_size
        ok_live: List[int] = []
        for slot in live:
            first = int(self.slot_pos[slot]) // ps
            last = (int(self.slot_pos[slot]) + span) // ps
            try:
                for lp in range(first, min(last, len(self.slot_pages[slot]) - 1) + 1):
                    self._ensure_private(slot, lp)
            except PoolExhausted as e:
                self._quarantine_slot(slot, f"copy-on-write allocation failed: {e}")
                continue
            ok_live.append(slot)
        self.cache["page_table"].copy_(torch.from_numpy(self._table))
        if self._xtable is not None:
            self.cache["xpage_table"].copy_(torch.from_numpy(self._xtable))
        return ok_live

    # -- degradation ladder -------------------------------------------------

    def _degrade(self, rung: str, reason: str):
        self.degraded[rung] = reason
        warnings.warn(f"{self.cfg.name}: degraded serving — {rung}: {reason}", stacklevel=3)

    def _degrade_speculation(self, reason: str):
        """Rung 1: speculative -> plain decode over the same caches (the
        spec_k headroom stays), taken mid-flight without dropping a request."""
        self.spec_active = False
        self._degrade("speculative", reason)

    def _degrade_attention_kernel(self, reason: str):
        """Rung 2: this engine's paged attention runs its plain version
        (``decode_step(use_kernel=False)``) from now on."""
        self.attention_kernel = False
        self._degrade("attention_kernel", reason)

    # -- the tick -----------------------------------------------------------

    def _poison(self) -> Optional[torch.Tensor]:
        """(B,) bool device mask of the ``nan_logits`` injection point, or
        None when nothing is poisoned this tick."""
        fi = self.fault_injector
        uids = fi.poison_uids(self.tick) if fi is not None else None
        if uids is None:
            return None
        mask = np.asarray([r is not None and (not uids or r.uid in uids)
                           for r in self.slot_req])
        return torch.from_numpy(mask).to(self.device)

    def _decode(self, tokens, pos, poison):
        with self._on_mesh():
            logits, self.cache = self.api.decode_step(
                self.cfg, self.params, self.cache, tokens, pos,
                use_kernel=self.attention_kernel)
        if poison is not None:
            logits = torch.where(poison[:, None, None], torch.nan, logits)
        return logits

    def _run_decode(self, tokens, pos):
        """The decode (or verify) step for every slot with the numeric guard
        on the device; returns (device logits (B, T, V), host per-slot finite
        flags).  An injected kernel fault on a paged engine takes rung 2 and
        retries the step once on the plain attention; it raises before any
        launch, so the cache is intact.  Any other error propagates."""
        poison = self._poison()
        fi = self.fault_injector
        try:
            if fi is not None:
                fi.check_kernel(self.tick, "attention_kernel" in self.degraded)
            logits = self._decode(tokens, pos, poison)
        except FaultInjected as e:
            if not self.paged or "attention_kernel" in self.degraded:
                raise
            self._degrade_attention_kernel(str(e))
            logits = self._decode(tokens, pos, poison)
        return logits, finite_rows(logits).cpu().numpy()

    def step(self) -> int:
        """One engine tick: deadlines -> admission -> chunked prefill -> one
        batched decode step (speculative draft + verify while rung 1 is
        healthy) -> audit -> watchdog.  Returns the tokens committed.  A
        dropped tick (fault injection) does not beat the watchdog."""
        self.tick += 1
        fi = self.fault_injector
        if fi is not None:
            fi.begin_tick(self.tick)
            if fi.drop_tick(self.tick):
                return 0  # lost tick: no admission, no decode, no heartbeat
        self._enforce_deadlines(self.clock())
        self._admit()
        if self.prefill_chunk is not None:
            self._run_prefill_chunks()
        live = self._decoding_slots()
        if live:
            n = self._spec_step(live) if self.spec_active else self._plain_step(live)
        else:
            n = 0
        if self.audit_every_step:
            self.audit_pages()
        if self.watchdog is not None:
            self.watchdog.beat(0)
        if live and self.degraded:
            self.stats.fallback_ticks += 1
        return n

    def _plain_step(self, live: List[int]) -> int:
        """One non-speculative decode tick; returns committed tokens."""
        if self.paged:
            live = self._publish_table(live)
            if not live:
                return 0
        tokens = self._on_device(self.slot_last_tok)[:, None]
        pos = self._on_device(self.slot_pos)
        logits, ok = self._run_decode(tokens, pos)
        rows = logits[:, 0]
        greedy = rows.argmax(dim=-1).cpu().numpy()
        committed = 0
        for slot in live:
            req = self.slot_req[slot]
            if not ok[slot]:
                self._quarantine_slot(slot, "non-finite logits (quarantined)")
                continue
            if req.temperature > 0.0:
                tok = int(self._sample(rows[slot:slot + 1], req.temperature)[0])
            else:
                tok = int(greedy[slot])
            req.output.append(tok)
            self._emit(req, (tok,))
            self.slot_last_tok[slot] = tok
            self.slot_pos[slot] += 1
            self.slot_remaining[slot] -= 1
            committed += 1
            self._finish_if_done(slot)
        self.stats.decode_steps += 1
        self.stats.decode_tokens += committed
        return committed

    # -- speculative decode -------------------------------------------------

    @staticmethod
    def _temp_softmax(row: np.ndarray, temperature: float) -> np.ndarray:
        """softmax(row / temperature) in float64: the one distribution the
        draft chain samples from and the accept/resample math uses."""
        z = row.astype(np.float64) / temperature
        z -= z.max()
        p = np.exp(z)
        return p / p.sum()

    def _host_sample(self, row: np.ndarray, temperature: float,
                     dist: Optional[np.ndarray] = None):
        """One token from a logits row on the host: (token, its sampling
        distribution, None for the greedy point mass)."""
        if temperature <= 0.0:
            return int(np.argmax(row)), None
        p = self._temp_softmax(row, temperature) if dist is None else dist
        return int(self._np_rng.choice(p.size, p=p)), p

    @staticmethod
    def _accept_greedy(tgt: np.ndarray, drafts: np.ndarray):
        """Greedy acceptance: the longest prefix of drafts equal to the
        target's argmax tokens ``tgt`` (k+1,), plus the target's next token.
        Returns (accepted draft count, committed tokens)."""
        k = drafts.shape[0]
        a = 0
        while a < k and int(drafts[a]) == int(tgt[a]):
            a += 1
        return a, [int(t) for t in tgt[: a + 1]]

    def _accept(self, logits_rows: np.ndarray, drafts: np.ndarray,
                draft_dists: Optional[np.ndarray], temperature: float):
        """Speculative rejection sampling against the verify logits (k+1, V):
        draft d is kept with probability min(1, p_t(d) / p_d(d)), the first
        rejection resamples from max(0, p_t - p_d); all kept: a bonus token
        from the last row.  Returns (accepted draft count, committed tokens);
        at least one token commits."""
        k = drafts.shape[0]
        if temperature <= 0.0:
            return self._accept_greedy(np.argmax(logits_rows, axis=-1), drafts)
        out: List[int] = []
        a = 0
        for j in range(k):
            p_t = self._temp_softmax(logits_rows[j], temperature)
            p_d = draft_dists[j]
            d = int(drafts[j])
            if self._np_rng.random() < min(1.0, p_t[d] / max(p_d[d], 1e-30)):
                out.append(d)
                a += 1
                continue
            residual = np.maximum(p_t - p_d, 0.0)
            tot = residual.sum()
            if tot <= 0.0:  # identical distributions: any p_t sample works
                residual, tot = p_t, 1.0
            out.append(int(self._np_rng.choice(residual.size, p=residual / tot)))
            return a, out
        tok, _ = self._host_sample(logits_rows[k], temperature)
        out.append(tok)
        return a, out

    def _spec_step(self, live: List[int]) -> int:
        """One speculative tick: k+1 draft steps propose k tokens, ONE (B, k+1)
        target step verifies them, the accepted prefix commits.  A dead draft
        (injected) or non-finite draft logits take rung 1 and serve this tick
        plain; a slot with non-finite verify logits is quarantined and its
        drafts are left out of the acceptance counts."""
        k = self.spec_k
        pos0 = self._on_device(self.slot_pos)
        try:
            drafts, draft_dists = self._draft_chain(live, pos0, k)
        except (FaultInjected, NonFiniteDraft) as e:
            self._degrade_speculation(f"draft phase failed: {e}")
            return self._plain_step(live)
        if self.paged:
            live = self._publish_table(live, span=k)
            if not live:
                return 0
        tokens = np.concatenate([self.slot_last_tok[:, None].astype(np.int64), drafts], axis=1)
        logits, ok = self._run_decode(self._on_device(tokens), pos0)
        tgt = logits.argmax(dim=-1).cpu().numpy()  # (B, k+1)
        rows = None
        if any(self.slot_req[s].temperature > 0.0 for s in live):
            rows = logits.float().cpu().numpy()
        committed_total = tick_accepted = proposed = 0
        n_verified = len(live)
        for slot in live:
            req = self.slot_req[slot]
            if not ok[slot]:
                self._quarantine_slot(slot, "non-finite verify logits (quarantined)")
                continue
            remaining = int(self.slot_remaining[slot])
            if req.temperature > 0.0:
                a, toks = self._accept(rows[slot], drafts[slot], draft_dists[slot],
                                       req.temperature)
            else:
                a, toks = self._accept_greedy(tgt[slot], drafts[slot])
            c = min(len(toks), remaining)
            toks = toks[:c]
            self.stats.draft_proposed += k
            proposed += k
            # truncation by remaining may clip the bonus token: then all c
            # committed tokens are accepted drafts
            self.stats.draft_accepted += min(a, c)
            tick_accepted += min(a, c)
            req.output.extend(toks)
            self._emit(req, toks)
            self.slot_last_tok[slot] = toks[-1]
            self.slot_pos[slot] += c
            self.slot_remaining[slot] -= c
            committed_total += c
            self._finish_if_done(slot)
        self.stats.decode_steps += 1
        self.stats.decode_tokens += committed_total
        self.stats.verified_positions += n_verified * (k + 1)
        self._spec_ticks += 1
        # measured acceptance feeds the sizer's EMA; once warmed up, rung 1
        # also triggers when the payoff model says plain would commit more
        if self.sizer is not None and getattr(self.sizer, "spec_k", 0) > 0 and proposed > 0:
            self.sizer = self.sizer.observe_accept(min(1.0, tick_accepted / proposed))
            if (self.spec_fallback_accept is not None
                    and self._spec_ticks >= self.spec_fallback_min_ticks
                    and not self.sizer.spec_worthwhile(
                        max(1, n_verified), min_accept=self.spec_fallback_accept)):
                self._degrade_speculation(
                    f"acceptance collapsed (EMA {self.sizer.spec_accept:.3f} < floor "
                    f"{self.spec_fallback_accept:g} or modeled payoff < 1)")
        return committed_total

    def _draft_chain(self, live: List[int], pos0: torch.Tensor, k: int):
        """The k+1 draft steps proposing k tokens (the last one writes the
        last draft's KV, so a fully accepted tick leaves no hole).  Raises
        ``FaultInjected`` (dead draft) or ``NonFiniteDraft``; anything else
        a draft step raises propagates."""
        fi = self.fault_injector
        if fi is not None:
            fi.check_draft(self.tick)
        B = self.max_batch
        drafts = np.zeros((B, k), np.int64)
        draft_dists: List[Optional[np.ndarray]] = [None] * B
        temps = {s: self.slot_req[s].temperature for s in live}
        sampled = any(t > 0.0 for t in temps.values())
        if sampled:
            draft_dists = [np.zeros((k, self.cfg.vocab)) if self.slot_req[s] is not None
                           else None for s in range(B)]
        live_idx = self._on_device(np.asarray(live, np.int64))
        cur = self._on_device(self.slot_last_tok.astype(np.int64))[:, None]
        for j in range(k + 1):
            with self._on_mesh():
                dlogits, self.draft_cache = self.draft_api.decode_step(
                    self.draft_cfg, self.draft_params, self.draft_cache, cur, pos0 + j)
            if j == k:
                break
            rows = dlogits[:, 0]
            if not bool(torch.isfinite(rows[live_idx]).all()):
                raise NonFiniteDraft("non-finite draft logits")
            greedy = rows.argmax(dim=-1).cpu().numpy()
            host_rows = rows.float().cpu().numpy() if sampled else None
            nxt = self.slot_last_tok.astype(np.int64)
            for slot in live:
                if temps[slot] > 0.0:
                    tok, dist = self._host_sample(host_rows[slot], temps[slot])
                    draft_dists[slot][j] = dist
                else:
                    tok = int(greedy[slot])
                drafts[slot, j] = tok
                nxt[slot] = tok
            cur = self._on_device(nxt)[:, None]
        return drafts, draft_dists

    def run_until_done(self, max_ticks: int = 10000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.queue and not self._live_slots():
                break
            self.step()
        return self.stats
