"""Open-loop load generation for the continuous-batching engine (port of
``repro/serving/loadgen.py``).

The closed-loop runs elsewhere in the repo (submit everything, then
``run_until_done``) measure an engine that always has work; real serving
traffic is *open-loop* — requests arrive on their own schedule whether or
not the engine kept up, which is what actually stresses admission,
chunked prefill, and the deadline machinery.  This module provides:

* ``Arrival`` / ``LengthMixture`` / ``poisson_trace`` — seeded arrival
  schedules with realistic context-length mixtures (mostly short chat
  turns, a heavy tail of long prompts).  Deterministic in the seed: the
  schedule is data, so a run replays exactly.
* ``save_trace`` / ``load_trace`` — JSONL round-trip, so measured or
  synthetic traces can be replayed via ``serve.py --trace``.
* ``run_open_loop`` — drives an engine on a ``TickClock`` through a
  trace, submitting arrivals when due, auditing the page allocator every
  tick, and recording each committed token's tick via the streaming
  callback.  Returns a ``LoadReport`` whose ``summary()`` (p50/p99 TTFT,
  per-request latency, committed tokens/s, terminal states, leaked
  pages) is computed entirely in simulated time — same seed + same trace
  ⇒ the identical summary, the property the determinism tests pin.

Time units: one engine tick advances the clock by ``tick_dt`` seconds of
simulated time, and arrival times are in the same unit.  Wall-clock cost
is reported separately (``LoadReport.wall_s``) and never enters
``summary()``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.engine import Request, RequestState
from repro_torch.serving.faultinject import TickClock


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One scheduled request arrival (times in trace units)."""

    uid: int
    t: float
    prompt_len: int
    max_new: int
    priority: int = 0
    temperature: float = 0.0


@dataclasses.dataclass(frozen=True)
class LengthMixture:
    """Weighted mixture of (prompt-length range, max-new range) components;
    ``sample`` draws one (prompt_len, max_new) pair.  Ranges are inclusive.
    The caller is responsible for components fitting the engine's max_len
    (prompt + max_new + spec_k <= max_len)."""

    components: Tuple[Tuple[float, Tuple[int, int], Tuple[int, int]], ...]

    def __post_init__(self):
        if not self.components:
            raise ValueError("mixture needs at least one component")
        for w, (pa, pb), (na, nb) in self.components:
            if w <= 0 or pa < 1 or pb < pa or na < 1 or nb < na:
                raise ValueError(f"bad component {(w, (pa, pb), (na, nb))}")

    @property
    def max_context(self) -> int:
        """Largest prompt_len + max_new this mixture can emit."""
        return max(pb + nb for _, (_, pb), (_, nb) in self.components)

    def sample(self, rng: np.random.Generator) -> Tuple[int, int]:
        w = np.asarray([c[0] for c in self.components], float)
        i = int(rng.choice(len(self.components), p=w / w.sum()))
        _, (pa, pb), (na, nb) = self.components[i]
        return int(rng.integers(pa, pb + 1)), int(rng.integers(na, nb + 1))


def chat_mixture(scale: int = 1) -> LengthMixture:
    """A realistic serving mixture at unit scale ~ tens of tokens: 70%
    short chat turns, 25% medium, 5% long-context prompts at ~4x the
    short total context.  ``scale`` multiplies every range, so the same
    shape serves smoke configs and real context windows."""
    s = int(scale)
    return LengthMixture((
        (0.70, (4 * s, 10 * s), (4 * s, 10 * s)),
        (0.25, (10 * s, 20 * s), (6 * s, 12 * s)),
        (0.05, (28 * s, 40 * s), (4 * s, 8 * s)),
    ))


def poisson_trace(rate: float, n: int, mixture: LengthMixture,
                  seed: int = 0, t0: float = 0.0) -> List[Arrival]:
    """``n`` Poisson arrivals at ``rate`` requests per time unit with
    lengths drawn from ``mixture``.  Deterministic in (rate, n, mixture,
    seed): exponential inter-arrival gaps and length draws come from one
    seeded generator."""
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    rng = np.random.default_rng(seed)
    ts = t0 + np.cumsum(rng.exponential(1.0 / rate, size=n))
    out = []
    for uid, t in enumerate(ts):
        p, m = mixture.sample(rng)
        out.append(Arrival(uid=uid, t=float(t), prompt_len=p, max_new=m))
    return out


def save_trace(path: str, arrivals: Sequence[Arrival]) -> None:
    """One JSON object per line — the ``serve.py --trace`` format."""
    with open(path, "w") as f:
        for a in arrivals:
            f.write(json.dumps(dataclasses.asdict(a)) + "\n")


def load_trace(path: str) -> List[Arrival]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(Arrival(**json.loads(line)))
    return out


def make_requests(arrivals: Sequence[Arrival], vocab: int,
                  seed: int = 0) -> List[Request]:
    """Requests for a trace with deterministic per-uid prompts: tokens
    depend only on (seed, uid, prompt_len), so replaying a trace replays
    the identical prompt set."""
    reqs = []
    for a in arrivals:
        rng = np.random.default_rng((seed, a.uid))
        reqs.append(Request(
            uid=a.uid,
            prompt=rng.integers(0, vocab, size=a.prompt_len).astype(np.int32),
            max_new_tokens=a.max_new,
            priority=a.priority,
            temperature=a.temperature,
        ))
    return reqs


@dataclasses.dataclass
class LoadReport:
    """Outcome of one ``run_open_loop`` replay, shaped for assertions and
    percentile reporting.  All times are simulated (trace units) except
    ``wall_s``."""

    arrivals: List[Arrival]
    requests: List[Request]
    token_ticks: Dict[int, List[int]]  # uid -> engine tick of each token
    work_by_tick: List[int]  # cumulative work units after each tick
    ticks: int
    tick_dt: float
    leaked_pages: int
    stats: object  # EngineStats
    wall_s: float

    @property
    def states(self) -> Dict[int, str]:
        return {r.uid: r.state.value for r in self.requests}

    @property
    def outputs(self) -> Dict[int, List[int]]:
        return {r.uid: list(r.output or []) for r in self.requests}

    @property
    def all_terminal(self) -> bool:
        return all(r.terminal for r in self.requests)

    def ttft_s(self) -> Dict[int, float]:
        """Arrival-to-first-token per finished-or-streaming request, in
        simulated seconds (measured from the scheduled arrival time, so
        queue wait before the admitting tick counts)."""
        by_uid = {a.uid: a.t for a in self.arrivals}
        return {r.uid: r.first_token_t - by_uid[r.uid]
                for r in self.requests if r.first_token_t is not None}

    def latency_s(self) -> Dict[int, float]:
        """Arrival-to-terminal per finished request (simulated)."""
        by_uid = {a.uid: a.t for a in self.arrivals}
        return {r.uid: r.finish_t - by_uid[r.uid] for r in self.requests
                if r.finish_t is not None
                and r.state is RequestState.FINISHED}

    def max_intertoken_gap(self, uids: Optional[Sequence[int]] = None,
                           unit: str = "tick") -> int:
        """Largest gap between a request's consecutive committed tokens,
        in engine ticks (``unit="tick"``) or in model work units
        (``unit="work"``: prefill + committed-decode tokens advanced
        between the two commits — the deterministic stand-in for
        wall-clock that exposes synchronous prefill stalls)."""
        if unit not in ("tick", "work"):
            raise ValueError(f"unit must be tick|work, got {unit!r}")
        gap = 0
        for uid, ticks in self.token_ticks.items():
            if uids is not None and uid not in uids:
                continue
            for a, b in zip(ticks, ticks[1:]):
                if unit == "tick":
                    gap = max(gap, b - a)
                else:
                    gap = max(gap, self.work_by_tick[b - 1]
                              - self.work_by_tick[a - 1])
        return gap

    def summary(self) -> dict:
        """Deterministic run summary (simulated time only): same seed +
        same trace ⇒ the identical dict."""
        ttft = sorted(self.ttft_s().values())
        lat = sorted(self.latency_s().values())
        committed = sum(len(r.output or []) for r in self.requests)
        span = max(1, self.ticks) * self.tick_dt
        states: Dict[str, int] = {}
        for r in self.requests:
            states[r.state.value] = states.get(r.state.value, 0) + 1
        pct = lambda xs, q: float(np.percentile(xs, q)) if xs else float("nan")  # noqa: E731
        return {
            "n_requests": len(self.requests),
            "completed": states.get("FINISHED", 0),
            "states": dict(sorted(states.items())),
            "p50_ttft_s": pct(ttft, 50),
            "p99_ttft_s": pct(ttft, 99),
            "p50_latency_s": pct(lat, 50),
            "p99_latency_s": pct(lat, 99),
            "committed_tokens": committed,
            "tokens_per_s": committed / span,
            "mean_batch": float(self.stats.mean_batch),
            "prefill_tokens": int(self.stats.prefill_tokens),
            "ticks": self.ticks,
            "leaked_pages": self.leaked_pages,
        }


def run_open_loop(engine, arrivals: Sequence[Arrival],
                  requests: Optional[Sequence[Request]] = None, *,
                  seed: int = 0, tick_dt: float = 1.0,
                  max_ticks: int = 10000, audit: bool = True) -> LoadReport:
    """Drive ``engine`` under open-loop arrivals: each tick submits every
    arrival now due, steps the engine, audits the page allocator, and
    advances the engine's ``TickClock`` by ``tick_dt`` — so deadlines,
    backoff, TTFT, and latency all read the same simulated time the
    arrival schedule is written in.  Committed tokens are timestamped via
    the streaming callback (chained in front of any caller-set
    ``on_token``).  Runs until every request is terminal or ``max_ticks``.
    """
    clock = engine.clock
    if not isinstance(clock, TickClock):
        raise TypeError(
            "run_open_loop needs an engine built with clock=TickClock(...) "
            "— open-loop timing is simulated, not wall-clock")
    if requests is None:
        requests = make_requests(arrivals, engine.cfg.vocab, seed=seed)
    if len(requests) != len(arrivals):
        raise ValueError(f"{len(requests)} requests for {len(arrivals)} arrivals")
    order = sorted(range(len(arrivals)),
                   key=lambda i: (arrivals[i].t, arrivals[i].uid))
    token_ticks: Dict[int, List[int]] = {r.uid: [] for r in requests}
    work_by_tick: List[int] = []

    def _chain(prev):
        def cb(req, tok):
            token_ticks[req.uid].append(engine.tick)
            if prev is not None:
                prev(req, tok)
        return cb

    for r in requests:
        r.on_token = _chain(r.on_token)
    i = 0
    t_wall = time.perf_counter()
    for _ in range(max_ticks):
        while i < len(order) and arrivals[order[i]].t <= clock():
            engine.submit(requests[order[i]])
            i += 1
        if i >= len(order) and not engine.queue and not engine._live_slots():
            break
        engine.step()
        work_by_tick.append(
            int(engine.stats.prefill_tokens + engine.stats.decode_tokens))
        if audit:
            engine.audit_pages()
        clock.advance(tick_dt)
    return LoadReport(
        arrivals=list(arrivals),
        requests=list(requests),
        token_ticks=token_ticks,
        work_by_tick=work_by_tick,
        ticks=engine.tick,
        tick_dt=tick_dt,
        leaked_pages=engine.pages_in_use,
        stats=engine.stats,
        wall_s=time.perf_counter() - t_wall,
    )
