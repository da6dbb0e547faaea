"""Pooled host staging buffers for the signature path.

The signature path packs every batch's per-row arrays into one int32 row
buffer and builds three small slot maps (``ops/prefilter.py``).  Those
buffers are recycled through this pool instead of being allocated per
batch.  On the card they are **pinned** host memory (a pinned torch
tensor viewed as numpy), so the
host-to-device copy of a batch is a true asynchronous DMA and the host can
pack the next batch while the card works on this one.

Shapes are stable by construction: every pooled buffer's shape derives
from the power-of-two and half-power-of-two buckets (``ops/carry.py``), so
steady-state traffic cycles through a handful of (shape, dtype) keys.

Aliasing discipline, the only correctness rule here: a leased buffer is
the source of a non-blocking host-to-device copy, which the card performs
some time after the call returns.  A buffer must therefore stay leased
until the non-blocking copy and the kernel have completed, in practice
until the batch's ``materialize()`` has waited on the event recorded after
the output copy.  Releasing it earlier lets the next batch overwrite rows
the card has not read yet.  The pool refuses a double release outright.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch


class HostBufferPool:
    """Thread-safe free-list of host buffers keyed by (shape, dtype).

    ``acquire`` returns a leased numpy buffer (recycled when one is free,
    else freshly allocated; pinned when the pool is); ``tensor`` gives the
    torch tensor over the same memory, the source of the device copy;
    ``release`` returns the buffer to the free list.  Buffers are not
    cleared on either side: callers overwrite every byte they read.
    """

    def __init__(self, max_per_key: int = 8, pinned: bool = False):
        self.max_per_key = int(max_per_key)
        self.pinned = bool(pinned)
        self._lock = threading.Lock()
        # key -> free (numpy, tensor) pairs
        self._free: dict[tuple, list[tuple]] = {}  # guarded-by: _lock
        # id(numpy buffer) -> (key, tensor), for every buffer leased out
        self._leased: dict[int, tuple] = {}  # guarded-by: _lock
        self.hits = 0     # guarded-by: _lock
        self.misses = 0   # guarded-by: _lock
        self.releases = 0  # guarded-by: _lock

    @staticmethod
    def _key(shape, dtype) -> tuple:
        return (tuple(shape), np.dtype(dtype).str)

    def acquire(self, shape, dtype=np.int32) -> np.ndarray:
        key = self._key(shape, dtype)
        with self._lock:
            free = self._free.get(key)
            if free:
                buf, t = free.pop()
                self.hits += 1
                self._leased[id(buf)] = (key, t)
                return buf
            self.misses += 1
        t = torch.from_numpy(np.empty(key[0], np.dtype(dtype)))
        if self.pinned:
            t = t.pin_memory()
        buf = t.numpy()
        with self._lock:
            self._leased[id(buf)] = (key, t)
        return buf

    def tensor(self, buf: np.ndarray) -> torch.Tensor:
        """The torch tensor over a leased buffer's memory."""
        with self._lock:
            entry = self._leased.get(id(buf))
        if entry is None:
            raise ValueError("tensor() of a buffer this pool has not leased")
        return entry[1]

    def release(self, buf: Optional[np.ndarray]) -> None:
        """Return a leased buffer.  Double release raises: handing the
        same buffer to two batches is exactly the row leak the pool must
        make impossible."""
        if buf is None:
            return
        with self._lock:
            entry = self._leased.pop(id(buf), None)
            if entry is None:
                raise ValueError(
                    "release of a buffer this pool has not leased "
                    "(double release or foreign buffer)"
                )
            key, t = entry
            self.releases += 1
            free = self._free.setdefault(key, [])
            if len(free) < self.max_per_key:
                free.append((buf, t))

    def release_all(self, bufs) -> None:
        for buf in bufs:
            self.release(buf)

    def leased_count(self) -> int:
        with self._lock:
            return len(self._leased)

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "releases": self.releases,
                "leased": len(self._leased),
                "free": sum(len(v) for v in self._free.values()),
                "keys": len(self._free),
            }


_defaults: dict[bool, HostBufferPool] = {}  # guarded-by: _default_lock
_default_lock = threading.Lock()


def default_pool(pinned: bool = False) -> HostBufferPool:
    """Process-wide pool shared by every kernel instance (one pinned, one
    pageable): kernel rebuilds after a refresh keep hitting the same
    buffers instead of refilling a cold pool."""
    with _default_lock:
        pool = _defaults.get(pinned)
        if pool is None:
            pool = _defaults[pinned] = HostBufferPool(pinned=pinned)
        return pool
