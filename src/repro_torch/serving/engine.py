"""Continuous-batching serving engine (port of ``repro/serving/engine.py``:
plain and paged decode, int8 KV, prefix sharing).

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
boundary page at admission.

Where the reference jit-compiles one decode step over a donated cache, the
port runs the decode step eagerly and updates the cache in place.  Not
ported yet: chunked prefill, speculative decode, deadlines, eviction,
fault injection and the degradation ladder (ROADMAP A7), sharding (A13);
``EngineConfig`` raises for their fields.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.batching import BatchSizer
from repro_torch.core.weight_plan import tree_to
from repro_torch.device import resolve_device
from repro_torch.models.api import (
    get_api,
    is_int8,
    kv_bytes_per_token,
    supports_int8_kv,
    supports_paged_kv,
)
from repro_torch.models.layers import finite_rows
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.paged import (
    NULL_PAGE,
    PageAllocator,
    PageAuditError,
    PoolExhausted,
    PrefixRegistry,
)

# paged pool leaf -> its name in a contiguous (prefill) cache
_PAGED_KEYS = (
    ("k_pages", "k"),
    ("v_pages", "v"),
    ("k_scale_pages", "k_scale"),
    ("v_scale_pages", "v_scale"),
)


class RequestState(enum.Enum):
    QUEUED = "QUEUED"
    PREFILLING = "PREFILLING"
    DECODING = "DECODING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.FAILED})

# legal transitions; anything else is an engine bug and raises.  QUEUED
# re-entry from PREFILLING/DECODING is the bounded-retry path.
_TRANSITIONS = {
    RequestState.QUEUED: {RequestState.PREFILLING, RequestState.FAILED},
    RequestState.PREFILLING: {RequestState.DECODING, RequestState.QUEUED,
                              RequestState.FAILED},
    RequestState.DECODING: {RequestState.FINISHED, RequestState.FAILED,
                            RequestState.QUEUED},
    RequestState.FINISHED: frozenset(),
    RequestState.FAILED: frozenset(),
}


class InvalidTransition(RuntimeError):
    """An engine bug drove a request through an illegal lifecycle edge."""


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    temperature: float = 0.0
    # filled by the engine:
    output: Optional[List[int]] = None
    done: bool = False
    state: RequestState = RequestState.QUEUED
    error: Optional[str] = None
    retries: int = 0
    submit_t: Optional[float] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
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
    decode_tokens: int = 0
    completed: int = 0
    context_tokens: int = 0  # sum over admitted requests of (S + max_new)
    pages_shared: int = 0  # full prefix pages mapped by refcount (no copy)
    cow_copies: int = 0  # pages copied before a write (copy-on-write)
    failed: int = 0
    retried: int = 0
    prefill_tokens: int = 0

    @property
    def mean_batch(self) -> float:
        """Mean committed tokens per decode step: the realized weight reuse."""
        return self.decode_tokens / max(1, self.decode_steps)

    @property
    def mean_context(self) -> float:
        return self.context_tokens / max(1, self.prefills)


class ServingEngine:
    """Continuous-batching engine around one model's prefill/decode.

    Runs on the CUDA device unless ``device="cpu"``; params (dense or a
    compressed tree, or ``plan.params``) are moved there and unstacked
    into per-layer views once."""

    def __init__(self, cfg, params, *, config: Optional[EngineConfig] = None,
                 plan=None, sizer: Optional[BatchSizer] = None, device=None):
        config = config if config is not None else EngineConfig()
        self.config = config
        cc, sc, fc = config.cache, config.scheduler, config.fault
        self.device = resolve_device(device)
        self.cfg = cfg
        if plan is not None and params is None:
            params = plan.params
        self.api = get_api(cfg)
        self.params = self.api.unstack(cfg, tree_to(params, self.device))
        self.plan = plan
        self.max_len = max_len = int(config.max_len)
        self.kv_dtype = torch.int8 if is_int8(cc.kv_dtype) and supports_int8_kv(cfg) else None
        self.paged = cc.page_size is not None and supports_paged_kv(cfg)
        self.page_size = cc.page_size if self.paged else None
        ctx = min(int(cc.expected_context) if cc.expected_context else max_len, max_len)
        self.expected_context = ctx
        kv_tok = kv_bytes_per_token(cfg, self.kv_dtype)
        if sizer is None:
            n_params = self.api.n_params_exact(cfg)
            if plan is not None:
                sizer = plan.sizer(n_params=n_params, kv_bytes_per_token=kv_tok,
                                   context_len=ctx)
            else:
                sizer = BatchSizer(n_params=n_params, kv_bytes_per_token=kv_tok,
                                   context_len=ctx)
        max_batch = config.max_batch
        if max_batch is None:
            max_batch = min(64, sizer.n_opt)
        self.max_batch = max_batch
        self.sizer = sizer
        self.dtype = getattr(torch, cfg.compute_dtype)
        # slot state (host-side)
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros((max_batch,), np.int32)  # next position to write
        self.slot_remaining = np.zeros((max_batch,), np.int32)
        self.slot_last_tok = np.zeros((max_batch,), np.int32)
        self.queue: deque = deque()
        self.stats = EngineStats()
        self.max_retries = int(sc.max_retries)
        self.clock = fc.clock
        self.audit_every_step = bool(fc.audit_every_step)
        self.tick = 0
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(config.seed)
        if self.paged:
            self.pages_per_seq = math.ceil(max_len / self.page_size)
            # default pool: byte parity with the contiguous reservation
            self.num_pages = cc.num_pages or (1 + max_batch * self.pages_per_seq)
            self.allocator = PageAllocator(self.num_pages)
            self.registry = PrefixRegistry() if cc.share_prefix else None
            self.slot_pages: List[List[int]] = [[] for _ in range(max_batch)]
            self._table = np.full((max_batch, self.pages_per_seq), NULL_PAGE, np.int32)
            self.cache = self.api.init_cache(
                cfg, max_batch, max_len, self.dtype, kv_dtype=self.kv_dtype,
                page_size=self.page_size, num_pages=self.num_pages, device=self.device)
        else:
            self.allocator = None
            self.registry = None
            self.cache = self.api.init_cache(cfg, max_batch, max_len, self.dtype,
                                             kv_dtype=self.kv_dtype, device=self.device)

    # -- host-side plumbing -------------------------------------------------

    def submit(self, req: Request):
        if req.submit_t is not None or req.state is not RequestState.QUEUED:
            raise ValueError(f"request {req.uid} already submitted (state {req.state.value})")
        req.output = []
        req.submit_t = self.clock()
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _live_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.slot_req) if r is not None]

    @property
    def pages_in_use(self) -> int:
        return self.allocator.used_pages if self.paged else 0

    def _release_slot(self, slot: int):
        """Free a slot and its pages (refcount-correct through shared
        prefixes).  Device rows need no scrub: position masks hide stale
        entries and the table row reverts to the null page."""
        self.slot_req[slot] = None
        if self.paged:
            self._free_slot_pages(slot)

    def _retry_or_fail(self, req: Request, reason: str):
        """Bounded retry from the committed prefix; FAILED once
        ``max_retries`` is spent."""
        if req.retries >= self.max_retries:
            req.transition(RequestState.FAILED, error=reason)
            req.finish_t = self.clock()
            self.stats.failed += 1
            return
        req.retries += 1
        self.stats.retried += 1
        req.transition(RequestState.QUEUED, error=reason)
        self.queue.append(req)

    def _quarantine_slot(self, slot: int, reason: str):
        """Numeric guard: a slot whose logits went non-finite leaves the
        batch (slot and pages freed) and retries or fails."""
        req = self.slot_req[slot]
        self._release_slot(slot)
        self._retry_or_fail(req, reason)

    def _resume_tokens(self, req: Request) -> np.ndarray:
        """Prefill tokens: the prompt plus any committed output (retry)."""
        out = req.output or []
        if not out:
            return np.asarray(req.prompt, np.int32)
        return np.concatenate([np.asarray(req.prompt, np.int32), np.asarray(out, np.int32)])

    # -- device-side steps --------------------------------------------------

    def _prefill_request(self, req: Request, tokens: np.ndarray):
        """Batch-1 prefill into a private contiguous cache.  Returns (first
        sampled token, cache1, logits-finite flag)."""
        cache1 = self.api.init_cache(self.cfg, 1, self.max_len, self.dtype,
                                     kv_dtype=self.kv_dtype, device=self.device)
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=self.device)[None]}
        logits, cache1 = self.api.prefill(self.cfg, self.params, batch, cache1)
        self.stats.prefill_tokens += len(tokens)
        row = logits[:, -1]
        ok = bool(torch.isfinite(row).all())
        tok = int(self._sample(row, req.temperature)[0])
        return tok, cache1, ok

    def _start_slot(self, slot: int, req: Request, S: int, first_tok: int, resumed: bool):
        self.slot_req[slot] = req
        self.slot_pos[slot] = S
        self.slot_remaining[slot] = req.max_new_tokens - len(req.output)
        self.slot_last_tok[slot] = first_tok
        req.transition(RequestState.DECODING)
        req.output.append(first_tok)
        self.slot_remaining[slot] -= 1
        if req.first_token_t is None:
            req.first_token_t = self.clock()
        self.stats.prefills += 1
        if not resumed:
            self.stats.context_tokens += S + req.max_new_tokens
        self._finish_if_done(slot)

    def _admit(self):
        """Move queued requests into free slots (prefill)."""
        if self.paged:
            return self._admit_paged()
        while self.queue:
            free = self._free_slots()
            if not free:
                break
            slot = free[0]
            req = self.queue.popleft()
            resumed = bool(req.output)
            req.transition(RequestState.PREFILLING)
            tokens = self._resume_tokens(req)
            S = len(tokens)
            remaining = req.max_new_tokens - len(req.output)
            if S + remaining > self.max_len:
                raise ValueError(f"request {req.uid}: S + max_new = {S + remaining} "
                                 f"exceeds max_len {self.max_len}")
            tok, cache1, ok = self._prefill_request(req, tokens)
            if not ok:
                self._retry_or_fail(req, "non-finite prefill logits")
                continue
            self._write_slot(slot, cache1)
            self._start_slot(slot, req, S, tok, resumed)

    def _admit_paged(self):
        """Paged admission: map shared prefix pages, allocate the rest; a
        full pool leaves the request queued (back-pressure, no crash)."""
        ps = self.page_size
        while self.queue:
            free = self._free_slots()
            if not free:
                break
            slot = free[0]
            req = self.queue[0]
            tokens = self._resume_tokens(req)
            S = len(tokens)
            remaining = req.max_new_tokens - len(req.output or [])
            total = S + remaining
            capacity = self.pages_per_seq * ps
            if total > capacity:
                raise ValueError(
                    f"request {req.uid}: S + remaining = {total} exceeds the page-table "
                    f"capacity {capacity} (pages_per_seq * page_size); raise max_len")
            prompt_key = tuple(int(t) for t in tokens)
            shared_len, shared_pages = (
                self.registry.match(prompt_key) if self.registry is not None else (0, []))
            n_total = math.ceil(total / ps)
            n_full = shared_len // ps  # full pages mapped by refcount
            boundary = 1 if shared_len % ps else 0  # partial page: eager COW
            if not self.allocator.can_alloc(n_total - n_full):
                break  # pool exhausted: the request stays queued
            self.queue.popleft()
            resumed = bool(req.output)
            req.transition(RequestState.PREFILLING)
            retained = shared_pages[:n_full]
            self.allocator.retain(retained)
            fresh = self.allocator.alloc(n_total - n_full)
            if boundary:
                # the new sequence writes positions [shared_len, ...) into
                # this page, so it cannot share it read-only: copy it now
                self._copy_page(shared_pages[n_full], fresh[0])
                self.stats.cow_copies += 1
            pages = retained + fresh
            self.stats.pages_shared += n_full
            self.slot_pages[slot] = pages
            self._table[slot, :] = NULL_PAGE
            self._table[slot, : len(pages)] = pages
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
            self._start_slot(slot, req, S, tok, resumed)

    # -- paged-pool plumbing ------------------------------------------------

    def audit_pages(self):
        """Allocator refcounts and free list must equal the live slot->page
        mapping exactly, and the host table must mirror it.  Raises
        ``PageAuditError`` on the first divergence."""
        if not self.paged:
            return
        self.allocator.audit([p for pages in self.slot_pages for p in pages])
        for slot in range(self.max_batch):
            pages = self.slot_pages[slot]
            row = self._table[slot]
            if not (np.array_equal(row[: len(pages)], np.asarray(pages, np.int32))
                    and np.all(row[len(pages):] == NULL_PAGE)):
                raise PageAuditError(
                    f"slot {slot}: table row {row.tolist()} does not mirror the slot "
                    f"mapping {pages}")
            if self.slot_req[slot] is None and pages:
                raise PageAuditError(f"slot {slot}: free slot still owns pages {pages}")

    def _copy_page(self, src: int, dst: int):
        """pool[dst] <- pool[src] for every paged leaf of every layer (in place)."""
        for entry in self.cache["layers"]:
            for pk, _ in _PAGED_KEYS:
                if pk in entry:
                    entry[pk][dst] = entry[pk][src]

    def _ensure_private(self, slot: int, logical_page: int):
        """Copy-on-write guard: the page about to be written must be owned by
        this slot alone.  With eager boundary COW at admission this never
        fires in steady state; it keeps refcount > 1 pages read-only."""
        phys = self.slot_pages[slot][logical_page]
        if self.allocator.refcount[phys] > 1:
            new = self.allocator.alloc(1)[0]
            self._copy_page(phys, new)
            self.allocator.release([phys])
            self.slot_pages[slot][logical_page] = new
            self._table[slot, logical_page] = new
            self.stats.cow_copies += 1

    def _write_slot_paged(self, slot: int, cache1, start: int, stop: int):
        """Scatter positions [start, stop) of a batch-1 contiguous prefill
        cache into this slot's pages (in place)."""
        ps = self.page_size
        pos_w = np.arange(start, stop)
        if len(pos_w) == 0:
            return
        for lp in sorted({int(p) // ps for p in pos_w}):
            self._ensure_private(slot, lp)
        phys = torch.as_tensor([self.slot_pages[slot][p // ps] for p in pos_w],
                               dtype=torch.long, device=self.device)
        off = torch.as_tensor(pos_w % ps, dtype=torch.long, device=self.device)
        src = torch.as_tensor(pos_w, dtype=torch.long, device=self.device)
        for entry, one in zip(self.cache["layers"], cache1["layers"]):
            for pk, ck in _PAGED_KEYS:
                if pk in entry:
                    entry[pk][phys, off] = one[ck][0, src].to(entry[pk].dtype)

    def _free_slot_pages(self, slot: int):
        freed = self.allocator.release(self.slot_pages[slot])
        if self.registry is not None:
            self.registry.evict(freed)
        self.slot_pages[slot] = []
        self._table[slot, :] = NULL_PAGE

    def _write_slot(self, slot: int, cache1):
        """Copy a batch-1 contiguous cache into slot ``slot`` (in place);
        every layer's leaves are (batch, ...)."""
        for entry, one in zip(self.cache["layers"], cache1["layers"]):
            for k, pool in entry.items():
                pool[slot] = one[k][0].to(pool.dtype)

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

    def _publish_table(self, live: List[int]) -> List[int]:
        """COW guard on this tick's write targets, then copy the host table
        into the cache's ``page_table`` (the step reads it, never changes
        it).  A slot whose COW copy cannot be allocated retries."""
        ps = self.page_size
        ok_live: List[int] = []
        for slot in live:
            lp = int(self.slot_pos[slot]) // ps
            try:
                if lp < len(self.slot_pages[slot]):
                    self._ensure_private(slot, lp)
            except PoolExhausted as e:
                self._quarantine_slot(slot, f"copy-on-write allocation failed: {e}")
                continue
            ok_live.append(slot)
        self.cache["page_table"].copy_(torch.from_numpy(self._table))
        return ok_live

    # -- the tick -----------------------------------------------------------

    def _run_decode(self, tokens, pos):
        """The decode step for every slot; returns (device logits (B, 1, V),
        host per-slot finite flags)."""
        logits, self.cache = self.api.decode_step(self.cfg, self.params, self.cache, tokens, pos)
        return logits, finite_rows(logits).cpu().numpy()

    def step(self) -> int:
        """One engine tick: admission, then one batched decode step.
        Returns the number of tokens committed."""
        self.tick += 1
        self._admit()
        live = self._live_slots()
        n = self._plain_step(live) if live else 0
        if self.audit_every_step:
            self.audit_pages()
        return n

    def _plain_step(self, live: List[int]) -> int:
        if self.paged:
            live = self._publish_table(live)
            if not live:
                return 0
        tokens = torch.from_numpy(self.slot_last_tok).to(self.device)[:, None]
        pos = torch.from_numpy(self.slot_pos).to(self.device)
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
            self.slot_last_tok[slot] = tok
            self.slot_pos[slot] += 1
            self.slot_remaining[slot] -= 1
            committed += 1
            self._finish_if_done(slot)
        self.stats.decode_steps += 1
        self.stats.decode_tokens += committed
        return committed

    def run_until_done(self, max_ticks: int = 10000) -> EngineStats:
        for _ in range(max_ticks):
            if not self.queue and not self._live_slots():
                break
            self.step()
        return self.stats
