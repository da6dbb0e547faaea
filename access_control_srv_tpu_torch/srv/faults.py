"""Deterministic failpoint framework (host only: fault injection is pure
host-side control flow and never touches the device).

The port's copy of the JAX package's ``srv/faults.py``.  In the port the
sites that fire its ``REGISTRY`` so far are the identity client
(``srv/identity.py``) and the adapter transport (``srv/adapters.py``);
the device dispatch / materialize and staging sites come with the
serving shell.

Named injection sites are threaded through every external and async
boundary of the serving stack — broker journal write/fsync and the
socket topic pump, adapter HTTP, identity resolution, device
dispatch/materialize, staging-pool acquire, router proxy, replica
spawn.  Each site is one ``fire("site.name")`` call: a single attribute
load and boolean test when the registry is disarmed (the default), so
the serving path is byte-identical with faults configured but off.

Actions (``action`` key of a point spec):

- ``error``  raise at the site (``FaultError`` by default; sites that
             need a domain exception pass an ``exc`` factory so the
             failure travels the exact path a real one would)
- ``delay``  sleep ``delay_s`` then continue
- ``hang``   block up to ``hang_s`` on an event that ``clear()``
             releases — a wedged dependency the watchdogs must bound,
             never an unkillable thread
- ``torn``   only meaningful at byte-writing sites: ``tear()`` returns
             the record truncated to ``torn_frac`` of its bytes,
             simulating a crash mid-write (journal CRC catches it on
             replay)

Schedules are deterministic: given the same seed and the same call
order, the same calls hit.  A point spec combines

- ``after``  skip the first N calls (default 0)
- ``every``  then hit every k-th eligible call (default 1)
- ``count``  stop after M hits (default unlimited)
- ``p``      instead of ``every``: per-call Bernoulli from a
             ``random.Random`` seeded with ``f"{seed}:{site}"`` — a
             reproducible flap, not true randomness

Activation: the ``faults`` config block arms the process registry at
worker start (``faults: {enabled: true, seed: 7, points: [...]}``), and
the ``faults`` command (srv/command.py) arms/clears/inspects it at
runtime.  Everything is OFF by default; ``REGISTRY.clear()`` releases
any hung threads.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

ACTIONS = ("error", "delay", "hang", "torn")


class FaultError(RuntimeError):
    """The injected failure for ``action: error`` sites that do not
    supply a domain exception."""

    def __init__(self, site: str):
        super().__init__(f"fault injected at {site}")
        self.site = site


class Failpoint:
    """One armed point: a site name, an action, and a deterministic
    schedule.  Mutable call/hit counters are guarded by the registry
    lock (``evaluate`` is only called under it)."""

    __slots__ = ("site", "action", "after", "every", "count", "p",
                 "delay_s", "hang_s", "torn_frac", "calls", "hits",
                 "_rng")

    def __init__(self, spec: dict, seed: int = 0):
        self.site = str(spec["site"])
        self.action = str(spec.get("action", "error"))
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        self.after = int(spec.get("after", 0))
        self.every = max(1, int(spec.get("every", 1)))
        count = spec.get("count")
        self.count = None if count is None else int(count)
        p = spec.get("p")
        self.p = None if p is None else float(p)
        self.delay_s = float(spec.get("delay_s", 0.01))
        self.hang_s = float(spec.get("hang_s", 30.0))
        self.torn_frac = float(spec.get("torn_frac", 0.5))
        self.calls = 0
        self.hits = 0
        # per-site stream: the schedule of one point never depends on
        # how often OTHER sites fire
        self._rng = random.Random(f"{seed}:{self.site}")

    def evaluate(self) -> bool:
        """Advance the schedule one call; True when this call hits."""
        self.calls += 1
        if self.calls <= self.after:
            return False
        if self.count is not None and self.hits >= self.count:
            return False
        if self.p is not None:
            if self._rng.random() >= self.p:
                return False
        elif (self.calls - self.after - 1) % self.every != 0:
            return False
        self.hits += 1
        return True

    def spec(self) -> dict:
        out = {"site": self.site, "action": self.action}
        if self.after:
            out["after"] = self.after
        if self.every != 1:
            out["every"] = self.every
        if self.count is not None:
            out["count"] = self.count
        if self.p is not None:
            out["p"] = self.p
        return out


class FailpointRegistry:
    """Process-wide registry the ``fire()`` sites consult.

    Disarmed (the default) the hot path is one attribute load and one
    boolean test — no lock, no dict walk.  Armed, each ``fire`` takes
    the registry lock only to advance the matching point's schedule;
    the action itself (sleep / wait / raise) runs outside the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._points: dict[str, list[Failpoint]] = {}
        self._hits: dict[str, int] = {}
        self._release = threading.Event()
        self._seed = 0
        # armed flag is read lock-free on the hot path: a one-way-ish
        # flag flipped only by configure()/clear(); a racing fire()
        # during arm/disarm harmlessly sees the old value for one call
        self.enabled = False
        # observability hook: called as on_hit(site) for every hit so
        # telemetry can count acs_failpoint_hits_total without this
        # module importing telemetry
        self.on_hit: Optional[Callable[[str], None]] = None

    # ------------------------------------------------------------ control

    def configure(self, points: list[dict], seed: int = 0) -> None:
        """Install (replace) the armed points.  An empty list disarms."""
        parsed: dict[str, list[Failpoint]] = {}
        for spec in points or []:
            point = Failpoint(spec, seed=seed)
            parsed.setdefault(point.site, []).append(point)
        with self._lock:
            self._points = parsed
            self._hits = {}
            self._seed = seed
        self.enabled = bool(parsed)

    def clear(self) -> None:
        """Disarm and release every thread parked in a ``hang``."""
        self.enabled = False
        with self._lock:
            self._points = {}
            release = self._release
            self._release = threading.Event()
        release.set()

    def arm(self, points: list[dict], seed: int = 0):
        """Context manager for tests: arm on enter, clear on exit."""
        registry = self

        class _Armed:
            def __enter__(self):
                registry.configure(points, seed=seed)
                return registry

            def __exit__(self, *exc):
                registry.clear()
                return False

        return _Armed()

    def stats(self) -> dict:
        with self._lock:
            points = [
                dict(p.spec(), calls=p.calls, hits=p.hits)
                for plist in self._points.values() for p in plist
            ]
            hits = dict(self._hits)
        return {
            "enabled": self.enabled,
            "seed": self._seed,
            "points": points,
            "hits_by_site": hits,
        }

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)

    # -------------------------------------------------------------- sites

    def fire(self, site: str, exc: Optional[Callable[[], BaseException]]
             = None) -> Optional[Failpoint]:
        """The injection site.  Returns None on the (default) miss;
        raises / sleeps / hangs on a hit; returns the hit ``Failpoint``
        for site-interpreted actions (``torn``)."""
        if not self.enabled:
            return None
        hit: Optional[Failpoint] = None
        with self._lock:
            for point in self._points.get(site, ()):
                if point.evaluate():
                    hit = point
                    break
            if hit is None:
                return None
            self._hits[site] = self._hits.get(site, 0) + 1
            release = self._release
        on_hit = self.on_hit
        if on_hit is not None:
            try:
                on_hit(site)
            except Exception:  # noqa: BLE001 — metrics must never inject
                pass
        if hit.action == "error":
            raise exc() if exc is not None else FaultError(site)
        if hit.action == "delay":
            time.sleep(hit.delay_s)
            return hit
        if hit.action == "hang":
            # bounded, releasable wedge: clear() frees every hanger
            release.wait(hit.hang_s)
            return hit
        return hit  # torn: the caller applies tear()

    def tear(self, site: str, data: bytes) -> bytes:
        """Byte-writing sites: return ``data`` possibly truncated by an
        armed ``torn`` point (a crash-interrupted write); error/delay/
        hang points at the same site act as in ``fire``."""
        hit = self.fire(site)
        if hit is not None and hit.action == "torn":
            return data[: max(1, int(len(data) * hit.torn_frac))]
        return data


# the process-wide registry every site consults; worker start/stop and
# the command interface arm/clear it, tests use REGISTRY.arm(...)
REGISTRY = FailpointRegistry()

fire = REGISTRY.fire
tear = REGISTRY.tear


def configure_from(config: dict | None) -> bool:
    """Arm the registry from a ``faults`` config block; False (and
    disarmed) when the block is missing or disabled."""
    if not config or not config.get("enabled"):
        return False
    REGISTRY.configure(
        list(config.get("points") or []), seed=int(config.get("seed", 0))
    )
    return REGISTRY.enabled
