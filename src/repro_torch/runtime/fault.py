"""Fault-tolerance runtime: preemption handling, straggler watchdog,
elastic rescale bookkeeping, and the goodput model; a copy of
``repro.runtime.fault`` (which imports no JAX: the port keeps its own copy
and imports nothing of ``repro``).

On a real multi-host cluster the coordinator detects failed hosts through
collective timeouts and preemption notices arrive as SIGTERM; the
mitigation actions here are the ones a 1000+-node deployment needs:
save-and-exit on preemption, step-time anomaly detection (straggler flag +
callback), and a restart ledger that chooses the new DP degree when the
healthy-host count changes (elastic rescale, consumed by
checkpoint.restore's cross-mesh path).
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Callable, List, Optional


class PreemptionHandler:
    """SIGTERM/SIGINT -> graceful save-and-exit flag (test hook: .trigger()).

    ``on_preempt`` fires once, on the first preemption notice — fabric
    workers use it to surface "draining" immediately while the executor
    finishes committing the in-flight superbatch.
    """

    def __init__(self, install: bool = True,
                 on_preempt: Optional[Callable[[], None]] = None):
        self._flag = threading.Event()
        self._on_preempt = on_preempt
        if install:
            try:
                signal.signal(signal.SIGTERM, self._on_signal)
            except ValueError:        # not main thread (tests)
                pass

    def _on_signal(self, signum, frame):
        self.trigger()

    def trigger(self) -> None:
        first = not self._flag.is_set()
        self._flag.set()
        if first and self._on_preempt is not None:
            self._on_preempt()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than `threshold` x EMA(step time).

    In a real deployment the callback would trigger hot-spare swap-in /
    re-sharding away from the slow host; here it records the event so the
    train loop (and tests) can assert the mitigation path fires.
    """

    threshold: float = 3.0
    ema_decay: float = 0.9
    warmup_steps: int = 5
    on_straggler: Optional[Callable[[int, float, float], None]] = None

    def __post_init__(self):
        self._ema: Optional[float] = None
        self._seen = 0
        self.events: List[dict] = []

    def observe(self, step: int, step_time_s: float) -> bool:
        self._seen += 1
        if self._ema is None:
            self._ema = step_time_s
            return False
        is_straggler = (self._seen > self.warmup_steps
                        and step_time_s > self.threshold * self._ema)
        if is_straggler:
            ev = {"step": step, "step_time_s": step_time_s,
                  "ema_s": self._ema}
            self.events.append(ev)
            if self.on_straggler:
                self.on_straggler(step, step_time_s, self._ema)
        else:
            # stragglers don't poison the EMA
            self._ema = (self.ema_decay * self._ema
                         + (1 - self.ema_decay) * step_time_s)
        return is_straggler


def fleet_mtbf_s(device_mtbf_s: float, n_devices: float) -> float:
    """Mean time between failures of the whole fleet (independent fails)."""
    return float(device_mtbf_s) / max(float(n_devices), 1.0)


def availability(restore_s: float, mtbf_s: float) -> float:
    """Steady-state availability: fraction of wall-clock spent serving.

    Each failure costs one restore; serving has no checkpoint-write tax
    (state is reconstructible), so goodput derates by MTBF/(MTBF+restore).
    """
    return float(mtbf_s) / max(float(mtbf_s) + float(restore_s), 1e-30)


def goodput_fraction(write_s: float, restore_s: float,
                     mtbf_s: float) -> float:
    """Fraction of wall-clock doing useful training work under failures.

    Young's optimal checkpoint interval T = sqrt(2 * write * MTBF):
    the fleet loses `write_s` per interval to checkpointing and, per
    failure (rate 1/MTBF), half an interval of lost work plus a restore.
    With write_s == 0 this degrades to the serving `availability` model.
    Clipped to [0, 1] — an MTBF shorter than the recovery cost means the
    run never progresses.
    """
    write_s = max(float(write_s), 0.0)
    mtbf_s = max(float(mtbf_s), 1e-30)
    if write_s <= 0.0:
        return availability(restore_s, mtbf_s)
    interval = (2.0 * write_s * mtbf_s) ** 0.5
    frac = ((1.0 - write_s / interval)
            * (1.0 - (interval / 2.0 + float(restore_s)) / mtbf_s))
    return min(max(frac, 0.0), 1.0)


def elastic_plan(n_healthy: int, model_parallel: int,
                 global_batch: int) -> dict:
    """Choose the new mesh for a changed healthy-device count.

    Keeps the model axis intact (weights must still fit) and gives the
    largest power-of-two DP degree that divides the global batch —
    the restart then restores the latest checkpoint onto the new mesh.
    """
    assert n_healthy >= model_parallel, "cannot fit the model axis"
    dp = n_healthy // model_parallel
    while dp & (dp - 1):
        dp -= 1
    while global_batch % dp:
        dp //= 2
    return {"data": dp, "model": model_parallel,
            "devices_used": dp * model_parallel,
            "devices_idle": n_healthy - dp * model_parallel}
