"""Device-hang watchdog: bounded materialize + kernel-path quarantine.

The depth-N pipeline's only blocking point is ``materialize()`` — the
D2H fetch of a dispatched batch.  A wedged device (a hung kernel,
stuck transfer, the ``device.materialize`` failpoint) turns that call
into an unbounded stall: the finalize worker blocks forever, every slot
fills, and the whole serving surface freezes behind one batch.

This module bounds that point and heals around it:

* ``run(materialize)`` executes the fetch on a disposable daemon thread
  under ``materialize_timeout_s``.  On timeout it raises
  ``DeviceTimeoutError`` — the caller resolves the batch's rows honestly
  (expired rows shed with the deadline status, the rest get the
  never-cacheable ``degraded`` envelope —
  srv/admission.degraded_response).  Never a fabricated PERMIT/DENY, and
  never the oracle in the kernel's place (the JAX package walks the
  oracle there).
* Repeated timeouts trip a device ``CircuitBreaker``
  (srv/admission.py); an open breaker QUARANTINES the kernel path —
  ``evaluator.set_quarantined(True)`` answers every kernel-path row with
  the degraded envelope, so callers see the device's state at once.
* A background probe then re-initializes the kernel through the
  swap-stable registry (``evaluator.refresh(wait=True)``) and pushes a
  canary batch through dispatch+materialize under the same deadline;
  the first healthy probe closes the breaker and restores the kernel
  path.

Threading: each bounded call gets its OWN daemon thread, not a pool
worker — a wedged fetch strands only its thread (released when the hang
clears, leaked if it never does), and never wedges the next batch's
fetch behind it.  The probe loop is a daemon thread that lives only
while quarantined.
"""

# acs-lint: host-only — the watchdog supervises the host side of the
# device boundary and must never import the device runtime itself

from __future__ import annotations

import threading
import time
from typing import Optional

from .admission import CircuitBreaker


class DeviceTimeoutError(RuntimeError):
    """``materialize()`` exceeded the watchdog deadline — the device (or
    its D2H fetch) is wedged.  Carries no decision: callers resolve the
    affected rows with the deadline shed or the degraded envelope, never
    a fabricated PERMIT/DENY."""


# the probe's refresh(wait=True) includes a full recompile; bound it far
# looser than a steady-state fetch so slow compiles don't fail probes
_REFRESH_TIMEOUT_FLOOR_S = 30.0

_BREAKER_DEFAULTS = {
    "window_s": 30.0,
    "min_volume": 2,
    "failure_ratio": 0.5,
    "open_s": 1.0,
    "half_open_probes": 1,
}


class DeviceWatchdog:
    """Materialize deadline + quarantine breaker + restore probe over one
    evaluator's kernel path (module docstring has the full contract)."""

    def __init__(
        self,
        evaluator,
        materialize_timeout_s: float = 5.0,
        probe_interval_s: float = 0.5,
        breaker_cfg: Optional[dict] = None,
        telemetry=None,
        logger=None,
    ):
        self._evaluator = evaluator
        self.materialize_timeout_s = float(materialize_timeout_s)
        self.probe_interval_s = float(probe_interval_s)
        self.logger = logger
        cfg = dict(_BREAKER_DEFAULTS)
        cfg.update(breaker_cfg or {})
        counter = telemetry.admission if telemetry is not None else None
        self.breaker = CircuitBreaker("device", counter=counter, **cfg)
        self._lock = threading.Lock()
        self._quarantined_since: Optional[float] = None  # guarded-by: _lock
        self._degraded_accum = 0.0   # guarded-by: _lock
        self.timeouts = 0            # guarded-by: _lock
        self.quarantines = 0         # guarded-by: _lock
        self.restores = 0            # guarded-by: _lock
        self._probe_thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._shutdown = False
        evaluator.attach_watchdog(self)

    # ------------------------------------------------------------ hot path

    def run(self, materialize):
        """Materialize under the deadline; raises ``DeviceTimeoutError``
        on a hang (after breaker accounting), relays any other exception
        untouched so existing error ladders keep working."""
        try:
            out = self._bounded(materialize, self.materialize_timeout_s,
                                "acs-device-fetch")
        except DeviceTimeoutError:
            self._on_timeout()
            raise
        self.breaker.record_success()
        return out

    def _bounded(self, fn, timeout_s: float, name: str):
        """Run ``fn`` on a disposable daemon thread; DeviceTimeoutError
        after ``timeout_s``.  No breaker accounting here — run() and the
        probe account differently."""
        box: dict = {}
        done = threading.Event()

        def _call():
            try:
                box["ok"] = fn()
            except BaseException as err:  # noqa: BLE001 — relayed below
                box["err"] = err
            done.set()

        threading.Thread(target=_call, daemon=True, name=name).start()
        if not done.wait(timeout_s):
            raise DeviceTimeoutError(
                f"device materialize exceeded {timeout_s:.3f}s"
            )
        if "err" in box:
            raise box["err"]
        return box["ok"]

    def _on_timeout(self) -> None:
        self.breaker.record_failure()
        with self._lock:
            self.timeouts += 1
        if self.logger is not None:
            self.logger.warning(
                "device materialize timeout (%.3fs deadline); breaker %s",
                self.materialize_timeout_s, self.breaker.state,
            )
        if self.breaker.state != CircuitBreaker.CLOSED:
            self._enter_quarantine()

    # --------------------------------------------------------- quarantine

    def _enter_quarantine(self) -> None:
        start = False
        with self._lock:
            if self._quarantined_since is not None:
                return
            self._quarantined_since = time.monotonic()
            self.quarantines += 1
            probe = self._probe_thread
            if probe is None or not probe.is_alive():
                probe = threading.Thread(
                    target=self._probe_loop, daemon=True,
                    name="acs-device-probe",
                )
                self._probe_thread = probe
                start = True
        self._evaluator.set_quarantined(True)
        if self.logger is not None:
            self.logger.warning(
                "device path QUARANTINED — kernel-path rows answer "
                "degraded while the probe re-initializes the kernel"
            )
        if start:
            probe.start()

    def _exit_quarantine(self) -> None:
        with self._lock:
            since = self._quarantined_since
            if since is None:
                return
            self._quarantined_since = None
            self._degraded_accum += time.monotonic() - since
            self.restores += 1
        self._evaluator.set_quarantined(False)
        if self.logger is not None:
            self.logger.warning(
                "device path RESTORED — kernel serving resumed"
            )

    def _probe_loop(self) -> None:
        while not self._shutdown:
            time.sleep(self.probe_interval_s)
            with self._lock:
                if self._quarantined_since is None:
                    return
            if not self.breaker.allow():
                continue  # still in the open cooldown
            ok = self._probe_once()
            if ok:
                self.breaker.record_success()
                if self.breaker.state == CircuitBreaker.CLOSED:
                    self._exit_quarantine()
                    return
            else:
                self.breaker.record_failure()

    def _probe_once(self) -> bool:
        """Re-initialize the kernel through the swap-stable registry and
        prove the device path answers end-to-end with a canary batch —
        both bounded, so a still-wedged runtime fails the probe instead
        of wedging it."""
        evaluator = self._evaluator
        refresh_timeout = max(
            _REFRESH_TIMEOUT_FLOOR_S, 10.0 * self.materialize_timeout_s
        )
        try:
            self._bounded(
                lambda: evaluator.refresh(wait=True),
                refresh_timeout, "acs-device-probe-refresh",
            )
            return bool(self._bounded(
                evaluator.kernel_probe, self.materialize_timeout_s,
                "acs-device-probe-canary",
            ))
        except BaseException as err:  # noqa: BLE001 — probe verdict only
            if self.logger is not None:
                self.logger.info("device probe failed: %r", err)
            return False

    # -------------------------------------------------------------- status

    @property
    def quarantined(self) -> bool:
        with self._lock:
            return self._quarantined_since is not None

    def degraded_seconds(self) -> float:
        """Cumulative seconds spent quarantined, including the current
        episode — the ``acs_degraded_seconds`` telemetry gauge."""
        with self._lock:
            total = self._degraded_accum
            if self._quarantined_since is not None:
                total += time.monotonic() - self._quarantined_since
            return total

    def status(self) -> dict:
        with self._lock:
            quarantined = self._quarantined_since is not None
            timeouts = self.timeouts
            quarantines = self.quarantines
            restores = self.restores
        return {
            "quarantined": quarantined,
            "timeouts": timeouts,
            "quarantines": quarantines,
            "restores": restores,
            "degraded_seconds": self.degraded_seconds(),
            "breaker": self.breaker.stats(),
        }

    def close(self) -> None:
        self._shutdown = True
