"""Heartbeats (port of ``HeartbeatMonitor`` from
``repro/distributed/fault.py``).  The serving engine runs a single-host
monitor as its tick watchdog: host 0 beats once per executed tick, and a
stall shows as silence on the engine's clock.  The training side of the
reference module (``StragglerDetector``, ``RestartSupervisor``) waits for
ROADMAP A14."""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List


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
