"""Deterministic fault injection for the serving engine + chaos harness
(port of ``repro/serving/faultinject.py``).

The engine's failure model (``serving/engine.py``) is only trustworthy if
every rung of its degradation ladder is exercised under a *reproducible*
fault schedule — a flaky soak proves nothing.  This module provides:

* ``Fault`` / ``FaultInjector`` — a declarative schedule of injection
  points, keyed by engine tick, consulted by the engine at well-defined
  hooks (see the table below).  Same schedule + same seed ⇒ the same
  faults fire on the same ticks against the same requests.
* ``TickClock`` — a manual monotonic clock the engine, its deadlines, its
  retry backoff, and its ``fault.HeartbeatMonitor`` watchdog all share,
  so time-dependent behavior (timeouts, backoff, stall detection) is
  deterministic in tests.
* ``seeded_schedule`` — a seeded random schedule generator for soaks.
* ``run_chaos`` — replays a submit-tick-stamped request trace against an
  engine, auditing the page allocator after every tick, and returns a
  ``ChaosReport`` (terminal states, leaked pages, per-request streams)
  the caller asserts on.

Injection points (kind → engine hook):

=============  ==========================================================
``nan_logits``   the decode/verify step overwrites the target request's
                 logit rows with NaN *on the device*, upstream of the
                 step's ``isfinite`` guard — models numeric
                 poisoning (overflow, corrupted KV) of one batch slot.
``alloc_fail``   ``ServingEngine._alloc_pages`` / ``_can_alloc_pages``
                 report pool exhaustion — models transient page-pool
                 pressure at admission and mid-tick (COW) allocation.
``drop_tick``    ``step()`` returns immediately: no admission, no decode,
                 no watchdog heartbeat — models a lost scheduler tick.
``dead_draft``   the speculative draft phase raises ``FaultInjected`` —
                 models a crashed/wedged draft model.
``slow_tick``    the shared ``TickClock`` jumps by ``delay_s`` (or the
                 process sleeps, under a real clock) — models a stalled
                 step; feeds the engine's ``HeartbeatMonitor`` watchdog.
``kernel_fault`` the decode step raises before launch — models a failure
                 of the paged attention kernel (B3); the engine degrades
                 that engine's attention to the kernel's plain version
                 and retries the tick.
=============  ==========================================================
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

KINDS = (
    "nan_logits",
    "alloc_fail",
    "drop_tick",
    "dead_draft",
    "slow_tick",
    "kernel_fault",
)


class FaultInjected(RuntimeError):
    """Raised by injection points that model a raising failure (dead draft,
    kernel fault).  The port's degradation ladder takes only these: a real
    build, launch or CUDA error propagates out of ``ServingEngine.step``."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` fires on ticks
    [``tick``, ``tick + n_ticks``).  ``uid`` targets one request
    (``nan_logits``; None poisons every live slot); ``delay_s`` is the
    ``slow_tick`` stall length."""

    kind: str
    tick: int
    uid: Optional[int] = None
    delay_s: float = 0.0
    n_ticks: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if self.tick < 1 or self.n_ticks < 1:
            raise ValueError("tick and n_ticks are 1-based / positive")

    def active(self, tick: int) -> bool:
        return self.tick <= tick < self.tick + self.n_ticks


class TickClock:
    """Manual monotonic clock: ``clock()`` returns the current time,
    ``advance(dt)`` moves it.  Passed as ``ServingEngine(clock=...)`` it
    makes deadlines, retry backoff, and the watchdog deterministic."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError("clocks are monotonic")
        self.t += dt
        return self.t


class FaultInjector:
    """Schedule of ``Fault``s consulted by the engine's injection hooks.

    ``clock`` (a ``TickClock``) makes ``slow_tick`` advance simulated time;
    without one the injector sleeps for real (so wall-clock benches see a
    real stall).  ``fired`` logs every (tick, kind, uid) that actually
    fired, for assertions and bench reporting.
    """

    def __init__(self, faults: Iterable[Fault], clock: Optional[TickClock] = None):
        self.faults: List[Fault] = sorted(faults, key=lambda f: (f.tick, f.kind))
        self.clock = clock
        self.fired: List[Tuple[int, str, Optional[int]]] = []

    def _active(self, kind: str, tick: int) -> List[Fault]:
        return [f for f in self.faults if f.kind == kind and f.active(tick)]

    def _log(self, tick: int, kind: str, uid: Optional[int] = None):
        self.fired.append((tick, kind, uid))

    # -- engine hooks (called once per tick each, in this order) ----------

    def begin_tick(self, tick: int):
        """Tick preamble: apply ``slow_tick`` stalls before any deadline
        or watchdog check sees this tick's clock."""
        for f in self._active("slow_tick", tick):
            self._log(tick, "slow_tick")
            if self.clock is not None:
                self.clock.advance(f.delay_s)
            elif f.delay_s > 0:
                time.sleep(f.delay_s)

    def drop_tick(self, tick: int) -> bool:
        hit = self._active("drop_tick", tick)
        if hit:
            self._log(tick, "drop_tick")
        return bool(hit)

    def alloc_fail(self, tick: int) -> bool:
        hit = self._active("alloc_fail", tick)
        if hit:
            self._log(tick, "alloc_fail")
        return bool(hit)

    def poison_uids(self, tick: int) -> Optional[Set[int]]:
        """uids whose logit rows this tick's step must overwrite with NaN.
        Returns None for no poisoning, the empty set for "all live"."""
        hit = self._active("nan_logits", tick)
        if not hit:
            return None
        uids = {f.uid for f in hit if f.uid is not None}
        for f in hit:
            self._log(tick, "nan_logits", f.uid)
        return uids  # empty set = every live slot

    def check_draft(self, tick: int):
        if self._active("dead_draft", tick):
            self._log(tick, "dead_draft")
            raise FaultInjected(f"injected dead draft at tick {tick}")

    def check_kernel(self, tick: int, degraded: bool):
        """Raises unless the engine already degraded off the kernel path
        (the fault models the kernel; the reference path is unaffected)."""
        if not degraded and self._active("kernel_fault", tick):
            self._log(tick, "kernel_fault")
            raise FaultInjected(f"injected kernel fault at tick {tick}")


def seeded_schedule(
    seed: int,
    *,
    n_ticks: int,
    uids: Sequence[int],
    rates: Dict[str, float],
    slow_delay_s: float = 0.0,
) -> List[Fault]:
    """Seeded random fault schedule for chaos soaks: each kind in ``rates``
    fires independently per tick with its probability; ``nan_logits``
    targets a seeded-uniform uid.  Deterministic in (seed, n_ticks, uids,
    rates) — the schedule is data, so a failing soak replays exactly."""
    rng = np.random.default_rng(seed)
    faults: List[Fault] = []
    for tick in range(1, n_ticks + 1):
        for kind in sorted(rates):
            if rng.random() >= rates[kind]:
                continue
            uid = int(rng.choice(np.asarray(uids))) if kind == "nan_logits" else None
            faults.append(Fault(
                kind=kind, tick=tick, uid=uid,
                delay_s=slow_delay_s if kind == "slow_tick" else 0.0,
            ))
    return faults


@dataclasses.dataclass
class ChaosReport:
    """Outcome of one ``run_chaos`` replay, shaped for assertions."""

    requests: list
    leaked_pages: int
    ticks: int
    stats: object  # EngineStats

    @property
    def states(self) -> Dict[int, str]:
        return {r.uid: r.state.value for r in self.requests}

    @property
    def outputs(self) -> Dict[int, List[int]]:
        return {r.uid: list(r.output or []) for r in self.requests}

    @property
    def all_terminal(self) -> bool:
        return all(r.terminal for r in self.requests)

    def diff_streams(self, baseline: Dict[int, List[int]]) -> List[int]:
        """uids whose committed token stream differs from ``baseline``
        (a fault-free run's ``outputs``)."""
        out = self.outputs
        return [uid for uid in baseline if out.get(uid) != baseline[uid]]


def run_chaos(engine, trace, *, tick_dt: float = 1.0,
              max_ticks: int = 2000) -> ChaosReport:
    """Replay ``trace`` — an iterable of ``(submit_tick, Request)`` — on
    ``engine``, ticking until every request reaches a terminal state (or
    ``max_ticks``).  After every tick the page allocator is audited
    (``engine.audit_pages()`` raises ``PageAuditError`` on any refcount /
    free-list / table divergence), so a leak is caught on the tick that
    caused it, not at the end.  If the engine runs a ``TickClock`` it is
    advanced ``tick_dt`` per tick — deadlines, backoff, and the watchdog
    all see the same simulated time the injector's ``slow_tick`` stalls.
    """
    pending = sorted(trace, key=lambda it: (it[0], it[1].uid))
    reqs = [r for _, r in pending]
    clock = engine.clock if isinstance(engine.clock, TickClock) else None
    i = 0
    for _ in range(max_ticks):
        t = engine.tick + 1  # the tick about to run
        while i < len(pending) and pending[i][0] <= t:
            engine.submit(pending[i][1])
            i += 1
        if i >= len(pending) and not engine.queue and not engine._live_slots():
            break
        engine.step()
        engine.audit_pages()
        if clock is not None:
            clock.advance(tick_dt)
    return ChaosReport(
        requests=reqs,
        leaked_pages=engine.pages_in_use,
        ticks=engine.tick,
        stats=engine.stats,
    )
