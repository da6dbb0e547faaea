"""Rate-limited hot-path logging (``SampledLogger``).

The port's copy of the ``SampledLogger`` class of the JAX package's
``srv/telemetry.py``.  The evaluator, the identity clients and the adapter
transport build one.  The rest of that module (the metrics registry, the
Prometheus exposition, the path / cache / stage counters and the profiler
hooks) comes with the serving shell, in a later slice of the port.
"""

from __future__ import annotations

import logging
import threading
import time


class SampledLogger:
    """Rate-limited wrapper for hot-path log sites: at most
    ``max_per_interval`` records per key per ``interval_s`` window; the
    overflow is counted and flushed as ONE summary line when the window
    rolls.  A down upstream under overload turns per-row warnings
    (token-unresolved, oracle fallback, adapter retry) into tens of
    thousands of records per second — enough to make the masking logger
    itself the serving bottleneck; this caps the worst case at
    ``max_per_interval + 1`` records per key per window regardless of
    offered load.  Thread-safe; the fast (suppressed) path is one lock +
    one dict update, no formatting."""

    def __init__(self, logger, max_per_interval: int = 5,
                 interval_s: float = 10.0, time_fn=time.monotonic):
        self.logger = logger
        self.max_per_interval = int(max_per_interval)
        self.interval_s = float(interval_s)
        self._time = time_fn
        self._lock = threading.Lock()
        # key -> [window_start, emitted_in_window, suppressed_in_window]
        self._state: dict[str, list] = {}  # guarded-by: _lock

    def _gate(self, key: str) -> tuple[bool, int]:
        """(emit_now, suppressed_to_report): whether THIS record may log,
        and how many suppressed records the rolled window accumulated."""
        now = self._time()
        with self._lock:
            state = self._state.get(key)
            if state is None or now - state[0] >= self.interval_s:
                rolled = state[2] if state else 0
                self._state[key] = [now, 1, 0]
                return True, rolled
            if state[1] < self.max_per_interval:
                state[1] += 1
                return True, 0
            state[2] += 1
            return False, 0

    def _log(self, level: int, key: str, msg: str, *args, **kwargs) -> None:
        if self.logger is None:
            return
        emit, rolled = self._gate(key)
        if rolled:
            self.logger.log(
                level,
                "suppressed %d '%s' records in the last %.0fs "
                "(rate-limited hot-path logging)",
                rolled, key, self.interval_s,
            )
        if emit:
            self.logger.log(level, msg, *args, **kwargs)

    def warning(self, key: str, msg: str, *args, **kwargs) -> None:
        self._log(logging.WARNING, key, msg, *args, **kwargs)

    def info(self, key: str, msg: str, *args, **kwargs) -> None:
        self._log(logging.INFO, key, msg, *args, **kwargs)

    def suppressed(self, key: str) -> int:
        with self._lock:
            state = self._state.get(key)
            return state[2] if state else 0
