"""Fault tolerance primitives (port of ``repro/distributed/fault.py``):
heartbeats, straggler detection and a restart supervisor.

The serving engine runs a single-host ``HeartbeatMonitor`` as its tick
watchdog: host 0 beats once per executed tick, and a stall shows as
silence on the engine's clock.  The training launcher records each step's
time in a ``StragglerDetector`` and runs its step loop under a
``RestartSupervisor``, which restores the latest complete checkpoint after
a ``RuntimeError``.  On the card that class also takes CUDA errors and
out-of-memory (``torch.cuda.OutOfMemoryError`` is one), so the supervisor
counts and logs every restart with its exception: a run that expects none
can check that none happened.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-host heartbeats; a host is dead after `timeout_s` silence."""

    n_hosts: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_seen: Dict[int, float] = {h: now for h in range(self.n_hosts)}

    def beat(self, host: int):
        self.last_seen[host] = self.clock()

    def silence_s(self, host: int = 0) -> float:
        """Seconds since ``host`` last beat: tells a stalled engine from a
        merely idle one."""
        return self.clock() - self.last_seen[host]

    def dead_hosts(self) -> List[int]:
        now = self.clock()
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]

    def healthy(self) -> bool:
        return not self.dead_hosts()


@dataclasses.dataclass
class StragglerDetector:
    """Flags hosts whose mean step time over the last ``window`` steps
    exceeds ``ratio`` times the median host's."""

    n_hosts: int
    window: int = 16
    ratio: float = 1.5

    def __post_init__(self):
        self.times: Dict[int, List[float]] = {h: [] for h in range(self.n_hosts)}

    def record(self, host: int, step_time_s: float):
        ts = self.times[host]
        ts.append(step_time_s)
        if len(ts) > self.window:
            ts.pop(0)

    def _avg(self, host: int) -> Optional[float]:
        ts = self.times[host]
        return sum(ts) / len(ts) if ts else None

    def stragglers(self) -> List[int]:
        avgs = {h: self._avg(h) for h in range(self.n_hosts)}
        vals = sorted(v for v in avgs.values() if v is not None)
        if not vals:
            return []
        median = vals[len(vals) // 2]
        return [h for h, v in avgs.items() if v is not None and v > self.ratio * median]


@dataclasses.dataclass
class RestartSupervisor:
    """Drives the crash-restart loop: run the train loop until it fails with
    a RuntimeError, restore, continue; more than ``max_restarts`` failures
    re-raise the last.  ``restarts`` counts the restarts the last ``run``
    took, each logged with its exception."""

    max_restarts: int = 3

    def __post_init__(self):
        self.restarts = 0

    def run(
        self,
        train_loop: Callable[[int], int],  # (start_step) -> final_step, raises on failure
        restore_fn: Callable[[], int],  # () -> step to resume from
    ) -> int:
        self.restarts = 0
        step = restore_fn()
        while True:
            try:
                return train_loop(step)
            except RuntimeError as e:
                if self.restarts == self.max_restarts:
                    raise
                self.restarts += 1
                step = restore_fn()
                print(f"[fault] restart {self.restarts} after {type(e).__name__}: {e}; "
                      f"resuming at step {step}", flush=True)
