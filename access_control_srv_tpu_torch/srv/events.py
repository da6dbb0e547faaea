"""In-process event bus with offset tracking (a copy of the JAX package's
``srv/events.py``; the port's relation-tuple store replicates over it).

Framework analog of the reference's Kafka topics + OffsetStore
(reference: src/worker.ts:114-123, 249-361; cfg/config.json events.kafka):
named topics carry CRUD events, command fan-out and the HR-scope
request/response rendezvous.  The bus interface is deliberately small so a
real broker-backed implementation can be substituted; the default keeps an
in-memory log per topic with monotonically increasing offsets, supporting
replay from a stored offset (the restore/resume semantics).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Optional


class Topic:
    def __init__(self, name: str):
        self.name = name
        self._log: list[tuple[str, Any]] = []
        self._listeners: list[Callable[[str, Any, dict], None]] = []
        self._lock = threading.Lock()

    @property
    def offset(self) -> int:
        return len(self._log)

    def emit(self, event_name: str, message: Any) -> int:
        with self._lock:
            self._log.append((event_name, message))
            offset = len(self._log) - 1
            listeners = list(self._listeners)
        for listener in listeners:
            listener(event_name, message, {"offset": offset, "topic": self.name})
        return offset

    def on(
        self,
        listener: Callable[[str, Any, dict], None],
        starting_offset: Optional[int] = None,
    ) -> None:
        """Subscribe; optionally replay the log from ``starting_offset``
        first (the stored-offset resume path, reference: worker.ts:351-361)."""
        with self._lock:
            replay = (
                list(enumerate(self._log))[starting_offset:]
                if starting_offset is not None
                else []
            )
            self._listeners.append(listener)
        for offset, (event_name, message) in replay:
            listener(event_name, message, {"offset": offset, "topic": self.name})

    def read(self, from_offset: int = 0) -> list[tuple[str, Any]]:
        with self._lock:
            return list(self._log[from_offset:])


class EventBus:
    def __init__(self):
        self._topics: dict[str, Topic] = {}
        self._lock = threading.Lock()

    def topic(self, name: str) -> Topic:
        with self._lock:
            if name not in self._topics:
                self._topics[name] = Topic(name)
            return self._topics[name]

    def topics(self) -> dict[str, Topic]:
        return dict(self._topics)


def on_topics(bus, topic_names, listener) -> None:
    """Subscribe one listener to several topics (no replay).  Used to fan
    the policy CRUD topics into cross-cutting listeners — e.g. the
    decision-cache epoch flush, which must fire on REMOTE workers' frames
    immediately rather than waiting out the replicator's debounced tree
    sync."""
    for name in topic_names:
        bus.topic(name).on(listener)


CRUD_TOPICS = tuple(
    f"io.restorecommerce.{kind}s.resource"
    for kind in ("rule", "policy", "policy_set")
)


class OffsetStore:
    """Consumer-offset checkpoints (reference: chassis OffsetStore over
    Redis DB 0, src/worker.ts:123)."""

    def __init__(self):
        self._offsets: dict[str, int] = {}

    def commit(self, topic: str, offset: int) -> None:
        self._offsets[topic] = offset

    def get(self, topic: str) -> Optional[int]:
        return self._offsets.get(topic)
