"""Monotonic-anchored wall clock for epoch-like timestamps.

``time.time()`` jumps — NTP slew, manual clock changes, leap-second
smearing — so consecutive calls can go BACKWARD.  That is fine for a
human-facing uptime display, but poison for stored ordering-sensitive
stamps: ``meta.modified`` written by srv/store.ResourceService is
compared against earlier stamps by replication reconciliation and by
clients ("was this doc touched since I read it?"), and a backward step
silently reorders history.

``monotonic_wall()`` is the repo-blessed source for such stamps: a wall
epoch captured ONCE at import anchors ``time.monotonic()``, so values

* read as ordinary Unix epoch seconds (serializable, human-debuggable),
* never decrease within a process, whatever the wall clock does,
* drift from true wall time only by however far the wall clock is
  adjusted after process start (bounded, and irrelevant for ordering).

The single ``time.time()`` call below is the one wall-clock read this
module is FOR; everything else in the serving path uses
``time.monotonic()`` directly (deadline/TTL math) or this function
(stored stamps).  acs-lint's ``wall-clock`` rule points here.
"""

from __future__ import annotations

import time

# acs-lint: ignore[wall-clock] the one blessed wall read: anchors the
# monotonic clock to the Unix epoch at import, never consulted again
_ANCHOR = time.time() - time.monotonic()


def monotonic_wall() -> float:
    """Unix-epoch-like seconds that never go backward in this process."""
    return _ANCHOR + time.monotonic()
