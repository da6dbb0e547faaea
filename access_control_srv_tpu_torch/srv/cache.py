"""Subject cache + hierarchical-scope rendezvous protocol.

The port's copy of the JAX package's ``srv/cache.py`` (host only).

Framework analog of the reference's Redis subject cache and the Kafka
``hierarchicalScopesRequest``/``hierarchicalScopesResponse`` protocol
(reference: src/core/accessController.ts:701-783, src/worker.ts:252-345):

- HR scopes are cached under ``cache:{subjectID}:hrScopes`` for interactive
  tokens, ``cache:{subjectID}:{token}:hrScopes`` otherwise;
- on a miss, a request keyed ``token:date`` goes out on the auth topic and
  the caller parks on a waiter with a timeout; the response handler writes
  the cache and releases the waiters;
- ``userModified`` events diff role associations / token scopes and evict;
  ``userDeleted`` evicts unconditionally.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Any, Optional

from ..core.common import get_field as _get


class SubjectCache:
    """Key-value cache with prefix eviction (Redis DB-subject analog)."""

    def __init__(self):
        self._data: dict[str, Any] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def get(self, key: str) -> Any:
        with self._lock:
            return self._data.get(key)

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._data[key] = value

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._data

    def evict_prefix(self, prefix: str) -> int:
        with self._lock:
            keys = [k for k in self._data if k.startswith(prefix)]
            for k in keys:
                del self._data[k]
            return len(keys)


class HRScopeProvider:
    """createHRScope: cache lookup, else request/response rendezvous over
    the auth topic with a parked waiter + timeout
    (reference: accessController.ts:735-783).

    Rendezvous mechanics: all waiters park on ONE shared condition variable
    and wake together when their token lands in the released set — one
    kernel wait object total instead of one ``threading.Event`` allocated
    per in-flight request.  The default timeout is 15 s (config
    ``authorization:hrReqTimeout``): the reference's 300 s default parks a
    serving thread for five minutes on a dead auth service."""

    def __init__(
        self,
        cache: SubjectCache,
        auth_topic=None,
        timeout_ms: int = 15_000,
        logger=None,
    ):
        self.cache = cache
        self.auth_topic = auth_topic
        self.timeout_ms = timeout_ms
        self.logger = logger
        # token_date -> number of parked waiters; released token_dates are
        # marked until their last waiter drains
        self.waiting: dict[str, int] = {}  # guarded-by: _cond
        self._released: set[str] = set()   # guarded-by: _cond
        self._cond = threading.Condition()

    def hr_scopes_key(self, context) -> Optional[str]:
        subject = _get(context, "subject") or {}
        token = _get(subject, "token")
        subject_id = _get(subject, "id")
        tokens = _get(subject, "tokens") or []
        token_found = next(
            (t for t in tokens if _get(t, "token") == token), None
        )
        if token_found is not None and _get(token_found, "interactive"):
            return f"cache:{subject_id}:hrScopes"
        if token_found is not None:
            return f"cache:{subject_id}:{token}:hrScopes"
        return None

    def create_hr_scope(self, context):
        subject = _get(context, "subject")
        if subject is None:
            context["subject"] = subject = {}
        token = _get(subject, "token")
        key = self.hr_scopes_key(context)
        if key is None:
            return context

        if not self.cache.exists(key):
            if self.auth_topic is None:
                return context
            date = datetime.datetime.now(datetime.timezone.utc).isoformat()
            token_date = f"{token}:{date}"
            with self._cond:
                self.waiting[token_date] = self.waiting.get(token_date, 0) + 1
            # emit OUTSIDE the condition: loopback responders may answer
            # synchronously on this very thread (tests do), and the
            # response handler takes the condition to release
            self.auth_topic.emit(
                "hierarchicalScopesRequest", {"token": token_date}
            )
            with self._cond:
                released = self._cond.wait_for(
                    lambda: token_date in self._released,
                    timeout=self.timeout_ms / 1000.0,
                )
                # un-park: the last waiter out clears the bookkeeping so
                # neither the waiting map nor the released set leaks
                # (token_date keys are unique per call)
                remaining = self.waiting.get(token_date, 1) - 1
                if remaining <= 0:
                    self.waiting.pop(token_date, None)
                    self._released.discard(token_date)
                else:
                    self.waiting[token_date] = remaining
            if not released:
                if self.logger:
                    self.logger.error(
                        "hr scope read timed out", extra={"token": token_date}
                    )
                return context
        scopes = self.cache.get(key)
        if scopes is not None:
            subject["hierarchical_scopes"] = scopes
        return context

    def handle_hr_scopes_response(self, message: dict, subject_resolver=None):
        """Consume a hierarchicalScopesResponse: write the cache under the
        right key shape and release waiters
        (reference: src/worker.ts:252-299)."""
        token_date = _get(message, "token") or ""
        token = token_date.split(":", 1)[0]
        scopes = _get(message, "hierarchical_scopes") or []
        subject_id = _get(message, "subject_id")
        interactive = bool(_get(message, "interactive"))
        if subject_id is None and subject_resolver is not None:
            resolved = subject_resolver(token)
            payload = _get(resolved, "payload") or {}
            subject_id = _get(payload, "id")
            tokens = _get(payload, "tokens") or []
            token_found = next(
                (t for t in tokens if _get(t, "token") == token), None
            )
            interactive = bool(_get(token_found, "interactive")) if token_found else False
        if subject_id is not None:
            if interactive:
                key = f"cache:{subject_id}:hrScopes"
            else:
                key = f"cache:{subject_id}:{token}:hrScopes"
            self.cache.set(key, scopes)
        with self._cond:
            if token_date in self.waiting:
                self._released.add(token_date)
                self._cond.notify_all()

    def evict_hr_scopes(self, subject_id: str) -> int:
        """(reference: accessController.ts:717-725)"""
        return self.cache.evict_prefix(f"cache:{subject_id}:")


def nested_attributes_equal(cached_attrs, user_attrs) -> Optional[bool]:
    """(reference: src/core/utils.ts:364-373)"""
    if not user_attrs:
        return True
    if (cached_attrs and len(cached_attrs) > 0) and len(user_attrs) > 0:
        return all(
            any(
                _get(db_obj, "value") == _get(obj, "value")
                for db_obj in cached_attrs
            )
            for obj in user_attrs
        )
    elif len(cached_attrs or []) != len(user_attrs or []):
        return False
    return None


def compare_role_associations(user_assocs, cached_assocs, logger=None) -> bool:
    """True when the role associations changed
    (reference: src/core/utils.ts:375-421)."""
    if len(user_assocs or []) != len(cached_assocs or []):
        return True
    modified = False
    if (user_assocs and len(user_assocs) > 0) and len(cached_assocs) > 0:
        for user_assoc in user_assocs:
            found = False
            for cached in cached_assocs:
                if _get(cached, "role") == _get(user_assoc, "role"):
                    cached_attrs = _get(cached, "attributes") or []
                    if len(cached_attrs) > 0:
                        for cached_attr in cached_attrs:
                            cached_nested = _get(cached_attr, "attributes")
                            for user_attr in _get(user_assoc, "attributes") or []:
                                user_nested = _get(user_attr, "attributes")
                                if (
                                    _get(user_attr, "id") == _get(cached_attr, "id")
                                    and _get(user_attr, "value")
                                    == _get(cached_attr, "value")
                                    and nested_attributes_equal(
                                        cached_nested, user_nested
                                    )
                                ):
                                    found = True
                                    break
                    else:
                        found = True
                        break
            if not found:
                modified = True
            if modified:
                break
    return modified
