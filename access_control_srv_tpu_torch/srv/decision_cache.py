"""Server-side decision cache: TTL'd + LRU-bounded caching of
``evaluation_cacheable`` decisions on the serving hot path.

The port's copy of the JAX package's ``srv/decision_cache.py``.

Framework analog of the reference ecosystem's acs-client decision cache
(Redis DB 5, TTL 3600 — reference: cfg/config.json:254-259): the reference
*clients* hash each access request and cache the decision when the response
carries ``evaluation_cacheable``; here the cache lives server-side so every
caller benefits and invalidation is driven by the same event surface the
server already owns (CRUD hot-sync, ``userModified``/``userDeleted``,
``flushCacheCommand``).

Design:

- **Keying** — a canonical request fingerprint: an order-insensitive hash
  over the target's subject/resource/action attribute multisets plus a
  canonical digest of the (already-resolved) request context.  The digest
  covers subject id, role associations and hierarchical scopes, so a
  subject whose associations change simply stops hitting its old entries
  (content addressing backs up the explicit prefix eviction).  Keys embed
  the subject id as a searchable prefix for ``userModified``/``userDeleted``
  and the reference's ``flush_cache`` db_index/pattern payloads.
- **Sharding + lock striping** — entries hash across N shards (power of
  two), each an LRU-ordered dict behind its own lock, so batch-wide
  lookups from concurrent serving threads never serialize on one mutex.
- **TTL + LRU bound** — every entry expires ``ttl_s`` after write (lazily
  collected on lookup); each shard holds at most ``max_entries / shards``
  live entries, evicting least-recently-used beyond that.
- **Epoch flush** — Rule/Policy/PolicySet CRUD, ``restore``/``reset``/
  ``config_update`` and pattern-less ``flush_cache`` bump a global epoch;
  entries written under an older epoch are logical misses (O(1) flush, no
  lock sweep on the mutation path).
- **Scoped epoch bumps** — the incremental policy-update subsystem
  (ops/delta.py) classifies each CRUD bump with a target-signature
  *footprint*.  Entries store their request's resource features
  (:func:`request_features`) at write time; an entry whose features are
  disjoint from every bump between its epoch and the current one is
  promoted in place instead of evicted, so sustained rule churn on entity
  A keeps the warm set for entity B alive.  The epoch-race invariant
  holds verbatim on both paths: writers still snapshot the epoch BEFORE
  the walk reads the tree, and ``put`` refuses whenever any intervening
  bump (global, or scoped-and-affecting) could have changed the decision
  — entries without features degrade to the pre-delta behavior exactly.

The lookup path is host-only by construction: this module never imports
torch and a cache hit returns before any encode or device dispatch
(asserted by tests/test_torch_decision_cache.py).

Semantics bar: cache on/off must never change a decision — only responses
whose ``evaluation_cacheable`` is True (every contributing rule cacheable,
engine prefix-AND semantics) and whose operation status is 200 are stored,
and tests/test_torch_decision_cache.py holds this copy's keys, stats
and evaluator passes equal to the JAX package's.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque, namedtuple
from hashlib import blake2b
from typing import Any, Optional

from ..core.common import get_field as _get
from ..models.model import OperationStatus, Response

_SEP = "\x1f"  # subject-id / digest separator inside keys
# tenant prefix separator (multi-tenant serving, srv/tenancy.py): a
# tenanted key is "<tenant>\x1e<subject>\x1f<digest>", so per-tenant
# eviction is a prefix walk and an untenanted eviction can never match a
# tenant's entries (their keys start with the tenant id, and \x1e/\x1f
# keep an id-equals-subject collision impossible)
_TSEP = "\x1e"

# how many epoch bumps of footprint history to keep: entries older than
# the log's reach are treated as globally flushed (conservative)
_BUMP_LOG = 512

# resource features of one request, matched against delta footprints
# (ops/delta.RuleScope.affects): exact entity values, operation values and
# action values of the request target
RequestFeatures = namedtuple(
    "RequestFeatures", ("entities", "ops", "actions")
)


def request_features(request, entity_urn: str, operation_urn: str
                     ) -> Optional[RequestFeatures]:
    """Candidate-signature features of an access request (the request-side
    counterpart of ops/delta.scope_from_target); memoized on the request
    object like the fingerprint.  None when the request has no target."""
    memo = getattr(request, "_dc_features", None)
    if memo is not None:
        return memo
    target = getattr(request, "target", None)
    if target is None:
        return None
    ents, ops = [], []
    for attr in _get(target, "resources") or []:
        value = _get(attr, "value")
        if value is None:
            continue
        attr_id = _get(attr, "id")
        if attr_id == entity_urn:
            ents.append(value)
        elif attr_id == operation_urn:
            ops.append(value)
    acts = [
        _get(attr, "value") for attr in _get(target, "actions") or []
        if _get(attr, "value") is not None
    ]
    features = RequestFeatures(
        frozenset(ents), frozenset(ops), frozenset(acts)
    )
    try:
        request._dc_features = features
    except Exception:  # exotic request objects
        pass
    return features


def _canon(obj: Any) -> Any:
    """Deterministic, hashable view of a JSON-ish value.  Dict key order is
    normalized; list order is preserved (list order inside the context is
    meaningful, e.g. role-association scoping instances); dataclass-like
    objects (Attribute/Target leaking into merged contexts) degrade through
    their ``__dict__``."""
    if isinstance(obj, dict):
        return tuple(
            (k, _canon(v))
            for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))
        )
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(v) for v in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "__dict__"):
        return _canon(
            {k: v for k, v in vars(obj).items() if not k.startswith("_")}
        )
    return repr(obj)


def _attr_key(attr) -> tuple:
    nested = _get(attr, "attributes") or []
    return (
        _get(attr, "id") or "",
        _get(attr, "value") or "",
        tuple(sorted(repr(_attr_key(n)) for n in nested)),
    )


def _attr_multiset(attrs) -> tuple:
    """Order-insensitive canonical form of one target attribute list."""
    return tuple(sorted(repr(_attr_key(a)) for a in (attrs or [])))


def request_fingerprint(request, subject_id_urn: str = "") -> Optional[str]:
    """Canonical fingerprint of an access request, or None when the request
    has no target (the engine's no-target deny path is never cached).

    The context must already be resolved (token subject + HR scopes) —
    callers fingerprint after ``engine.prepare_context`` so the key reflects
    the attributes the evaluation will actually see.  The fingerprint is
    memoized on the request object (``_dc_key``): serving builds a fresh
    Request per RPC, while bench/batch callers re-submitting one object pay
    the hash once.
    """
    memo = getattr(request, "_dc_key", None)
    if memo is not None:
        return memo
    target = getattr(request, "target", None)
    if target is None:
        return None
    context = getattr(request, "context", None) or {}
    subject = _get(context, "subject") or {}
    subject_id = _get(subject, "id") or ""
    if not subject_id and subject_id_urn:
        for attr in _get(target, "subjects") or []:
            if _get(attr, "id") == subject_id_urn:
                subject_id = _get(attr, "value") or ""
                break
    body = (
        _attr_multiset(_get(target, "subjects")),
        _attr_multiset(_get(target, "resources")),
        _attr_multiset(_get(target, "actions")),
        # derived keys the engine grafts during evaluation (_queryResult)
        # are excluded: they are outputs of the walk, not request identity
        _canon({
            k: v for k, v in context.items()
            if not (isinstance(k, str) and k.startswith("_"))
        }) if isinstance(context, dict) else _canon(context),
    )
    digest = blake2b(repr(body).encode(), digest_size=16).hexdigest()
    tenant = getattr(request, "_tenant", None)
    if tenant:
        key = f"{tenant}{_TSEP}{subject_id}{_SEP}{digest}"
    else:
        key = f"{subject_id}{_SEP}{digest}"
    try:
        request._dc_key = key
    except Exception:  # exotic request objects without attribute support
        pass
    return key


def key_tenant(key: Optional[str]) -> Optional[str]:
    """The tenant a cache key is scoped to (None = default domain)."""
    if key is None or _TSEP not in key:
        return None
    return key.split(_TSEP, 1)[0]


class _Shard:
    __slots__ = ("lock", "entries")

    def __init__(self):
        self.lock = threading.Lock()
        # key -> (decision, obligations tuple, cacheable, code, message,
        #         epoch, expires_at, features); OrderedDict order IS the
        # LRU order
        self.entries: OrderedDict[str, tuple] = OrderedDict()  # guarded-by: lock


class DecisionCache:
    """Sharded, lock-striped TTL + LRU decision cache with epoch flush."""

    def __init__(
        self,
        ttl_s: float = 3600.0,
        max_entries: int = 65536,
        shards: int = 16,
        enabled: bool = True,
        telemetry=None,
        time_fn=time.monotonic,
    ):
        n = 1
        while n < max(1, int(shards)):
            n <<= 1
        self.enabled = bool(enabled)
        self.ttl_s = float(ttl_s)
        self.max_entries = int(max_entries)
        self._shards = [_Shard() for _ in range(n)]
        self._mask = n - 1
        self._per_shard = max(1, self.max_entries // n)
        self._time = time_fn
        self.telemetry = telemetry
        self._epoch = 0  # guarded-by: _stats_lock
        # (epoch, footprint-or-None, tenant-or-None) per bump, newest
        # last; footprint None = global flush, tenant None = the default
        # domain's mutation stream (affects every entry conservatively);
        # a tenant-tagged bump can only affect that tenant's entries.
        # Bounded: anything older than the log is treated as global.
        self._bumps: deque = deque(maxlen=_BUMP_LOG)  # guarded-by: _stats_lock
        self._stats_lock = threading.Lock()
        self._hits = 0        # guarded-by: _stats_lock
        self._misses = 0      # guarded-by: _stats_lock
        self._evictions = 0   # guarded-by: _stats_lock
        self._stores = 0      # guarded-by: _stats_lock
        self._scoped_bumps = 0      # guarded-by: _stats_lock
        self._scoped_survivors = 0  # guarded-by: _stats_lock

    # ---------------------------------------------------------------- stats

    def _count(self, stat: str, by: int = 1) -> None:
        with self._stats_lock:
            setattr(self, f"_{stat}", getattr(self, f"_{stat}") + by)
        if self.telemetry is not None:
            self.telemetry.cache.inc(stat, by)

    def _tenant_count(self, kind: str, key: Optional[str]) -> None:
        """Per-tenant cache attribution (cardinality-bounded, see
        srv/telemetry.TenantCounter); no-op for default-domain keys."""
        tenant = key_tenant(key)
        if tenant is None or self.telemetry is None:
            return
        tenant_inc = getattr(self.telemetry, "tenant_inc", None)
        if tenant_inc is not None:
            tenant_inc(kind, tenant)

    def stats(self) -> dict:
        with self._stats_lock:
            hits, misses = self._hits, self._misses
            evictions, stores = self._evictions, self._stores
            scoped_bumps = self._scoped_bumps
            scoped_survivors = self._scoped_survivors
            epoch = self._epoch
        entries = 0
        for shard in self._shards:
            with shard.lock:
                entries += len(shard.entries)
        lookups = hits + misses
        return {
            "enabled": self.enabled,
            "hits": hits,
            "misses": misses,
            "evictions": evictions,
            "stores": stores,
            "hit_ratio": round(hits / lookups, 4) if lookups else None,
            "entries": entries,
            "epoch": epoch,
            "scoped_bumps": scoped_bumps,
            "scoped_survivors": scoped_survivors,
            "ttl_s": self.ttl_s,
            "max_entries": self.max_entries,
            "shards": len(self._shards),
        }

    # ----------------------------------------------------------------- core

    def fingerprint(self, request, subject_id_urn: str = "") -> Optional[str]:
        return request_fingerprint(request, subject_id_urn)

    @property
    def epoch(self) -> int:
        """Current tree epoch.  Writers snapshot this BEFORE computing a
        decision and hand the snapshot back to :meth:`put` — a decision
        whose evaluation spans an epoch bump (CRUD hot-sync / restore
        completing mid-walk) is then stored under the old epoch and is a
        logical miss, never served as fresh."""
        # acs-lint: ignore[guarded-by] epoch snapshot read: atomic int load; snapshot-before-walk semantics
        return self._epoch

    def _shard(self, key: str) -> _Shard:
        # blake2b digests are uniformly distributed; Python's str hash is
        # salted per process but stable within one, which is all striping
        # needs
        return self._shards[hash(key) & self._mask]

    def _affected_between(self, entry_epoch: int,
                          features, tenant=None) -> bool:
        """True when any epoch bump AFTER ``entry_epoch`` could have
        changed a decision with these request features: global bumps
        always count, scoped bumps count when their footprint intersects.
        Feature-less entries (pre-delta callers) are affected by every
        bump — identical to the original epoch semantics.

        ``tenant`` is the entry's tenant scope (from its key prefix): a
        bump tagged with a DIFFERENT tenant can only have touched that
        tenant's tables and is skipped outright — one tenant's CRUD churn
        never invalidates another tenant's (or the default domain's) warm
        set.  Untenanted bumps stay conservative and affect everything."""
        # acs-lint: ignore[guarded-by] epoch snapshot read: atomic int load; staleness re-checked against the bump log below
        current = self._epoch
        if entry_epoch == current:
            return False
        if entry_epoch > current:
            return True
        with self._stats_lock:
            bumps = list(self._bumps)
        covered = current
        for epoch, footprint, bump_tenant in reversed(bumps):
            if epoch <= entry_epoch:
                break
            covered = epoch
            if bump_tenant is not None and bump_tenant != tenant:
                continue  # another tenant's mutation: provably disjoint
            if footprint is None or features is None:
                return True
            try:
                if footprint.affects(features):
                    return True
            except Exception:  # defensive: a broken footprint flushes
                return True
        # the log must reach back to entry_epoch + 1; older bumps were
        # evicted from the bounded deque -> conservative global
        return covered > entry_epoch + 1

    def get(self, key: Optional[str]) -> Optional[Response]:
        """Return a rebuilt Response for a live entry, else None.  Misses
        (absent, expired, stale-epoch) are counted; expired/stale entries
        are collected in place.  Entries whose features are disjoint from
        every intervening scoped bump survive (promoted to the current
        epoch in place)."""
        if not self.enabled or key is None:
            return None
        shard = self._shard(key)
        # acs-lint: ignore[guarded-by] epoch snapshot read: atomic int load taken BEFORE the entry check (snapshot-before-walk)
        epoch = self._epoch
        now = self._time()
        with shard.lock:
            entry = shard.entries.get(key)
            if entry is None:
                self._count("misses")
                self._tenant_count("cache_miss", key)
                return None
            (decision, obligations, cacheable, code, message, ent_epoch,
             exp, features) = entry
            if exp <= now or (
                ent_epoch != epoch
                and self._affected_between(ent_epoch, features,
                                           key_tenant(key))
            ):
                del shard.entries[key]
                self._count("evictions")
                self._count("misses")
                self._tenant_count("cache_miss", key)
                return None
            if ent_epoch != epoch:
                # scoped survivor: every bump since the entry was written
                # is provably disjoint from its signature — re-stamp so
                # later lookups take the fast path
                shard.entries[key] = entry[:5] + (epoch, exp, features)
                self._count("scoped_survivors")
            shard.entries.move_to_end(key)
        self._count("hits")
        self._tenant_count("cache_hit", key)
        # rebuild per hit: callers may hold the Response across a later
        # eviction, so entries never hand out shared mutable state beyond
        # the (treated-as-immutable) obligation attributes
        return Response(
            decision=decision,
            obligations=list(obligations),
            evaluation_cacheable=cacheable,
            operation_status=OperationStatus(code=code, message=message),
        )

    def put(
        self, key: Optional[str], response: Response,
        epoch: Optional[int] = None,
        features=None,
    ) -> bool:
        """Write-through hook: stores only responses the engine marked
        ``evaluation_cacheable`` with a 200 status.  Returns True when
        stored.

        ``epoch`` is the writer's :attr:`epoch` snapshot taken at
        lookup/miss time, BEFORE the evaluation read the policy tree.  The
        entry is stamped with that snapshot (not the epoch at write time):
        if a tree mutation bumped the epoch while the decision was being
        computed, the entry is born stale — stored here only to be a
        logical miss — so an old-tree decision (e.g. a revoked permit)
        can never be served as fresh for a TTL.  A snapshot already known
        stale is refused outright rather than pushing a live LRU entry
        out.  ``None`` (direct/test callers whose compute did not span a
        mutation) stamps the current epoch, matching a snapshot taken
        now.

        ``features`` (:func:`request_features`) widens the acceptance: a
        snapshot spanning only SCOPED bumps whose footprints are disjoint
        from the request signature is provably still fresh (the mutation
        could not have changed this decision) and is stored under the
        current epoch.  Without features the pre-delta refusal applies
        unchanged."""
        if not self.enabled or key is None or response is None:
            return False
        if response.evaluation_cacheable is not True:
            return False
        status = response.operation_status
        if status is not None and status.code != 200:
            return False
        # acs-lint: ignore[guarded-by] epoch snapshot reads: atomic int loads; a concurrent bump makes the entry born-stale, never served fresh
        ent_epoch = self._epoch if epoch is None else int(epoch)
        if ent_epoch != self._epoch:  # acs-lint: ignore[guarded-by] epoch snapshot read (see above)
            if self._affected_between(ent_epoch, features,
                                      key_tenant(key)):
                return False
            ent_epoch = self._epoch  # acs-lint: ignore[guarded-by] epoch snapshot read (see above)
        entry = (
            response.decision,
            tuple(response.obligations or ()),
            True,
            200,
            status.message if status is not None else "success",
            ent_epoch,
            self._time() + self.ttl_s,
            features,
        )
        shard = self._shard(key)
        with shard.lock:
            shard.entries[key] = entry
            shard.entries.move_to_end(key)
            while len(shard.entries) > self._per_shard:
                shard.entries.popitem(last=False)
                self._count("evictions")
        self._count("stores")
        return True

    # ---------------------------------------------------------- invalidation

    def bump_epoch(self, tenant: Optional[str] = None) -> int:
        """Logical full flush: policy-tree mutations (CRUD hot-sync,
        restore/reset/config_update) call this; stale entries become misses
        immediately and are collected lazily.  A ``tenant`` tag scopes the
        flush to that tenant's entries (srv/tenancy.py — one tenant's
        mutation stream must never cold-start another's warm set)."""
        return self._bump(None, tenant)

    def bump_scoped(self, footprint, tenant: Optional[str] = None) -> int:
        """Scoped epoch bump (ops/delta.Footprint): entries and in-flight
        writers whose request features are disjoint from ``footprint``
        survive; everything else behaves exactly as a global bump.  A
        global or empty-with-global footprint degrades to
        :meth:`bump_epoch` (tenant tag preserved)."""
        if footprint is None or getattr(footprint, "global_", True):
            return self._bump(None, tenant)
        epoch = self._bump(footprint, tenant)
        self._count("scoped_bumps")
        return epoch

    def _bump(self, footprint, tenant: Optional[str] = None) -> int:
        with self._stats_lock:
            self._epoch += 1
            self._bumps.append((self._epoch, footprint, tenant))
            return self._epoch

    def flush(self) -> int:
        """Physical full flush (pattern-less ``flush_cache``); returns the
        number of entries dropped."""
        dropped = 0
        for shard in self._shards:
            with shard.lock:
                dropped += len(shard.entries)
                shard.entries.clear()
        if dropped:
            self._count("evictions", dropped)
        self.bump_epoch()
        return dropped

    def evict_subject(self, subject_id: str,
                      tenant: Optional[str] = None) -> int:
        """Drop every entry fingerprinted under ``subject_id``
        (``userModified``/``userDeleted`` invalidation path).  With a
        ``tenant``, only that tenant's entries for the subject drop; an
        untenanted eviction walks only default-domain keys — tenanted
        keys carry the tenant prefix, so cross-tenant eviction is
        structurally impossible on either path."""
        if not subject_id:
            return 0
        if tenant:
            return self._evict_prefix(
                f"{tenant}{_TSEP}{subject_id}{_SEP}"
            )
        return self._evict_prefix(subject_id + _SEP,
                                  default_domain_only=True)

    def evict_pattern(self, pattern: str,
                      tenant: Optional[str] = None) -> int:
        """The reference ``flush_cache`` pattern semantics against the
        subject-id prefix of the key space; empty pattern flushes all.
        With a ``tenant``, the walk is confined to that tenant's key
        prefix (empty pattern drops the whole tenant, nothing else)."""
        if tenant:
            return self._evict_prefix(f"{tenant}{_TSEP}{pattern}")
        if not pattern:
            return self.flush()
        return self._evict_prefix(pattern, default_domain_only=True)

    def _evict_prefix(self, prefix: str,
                      default_domain_only: bool = False) -> int:
        """``default_domain_only`` confines an untenanted prefix walk to
        untenanted keys: a tenant id that happens to start with the prefix
        (e.g. pattern "u1" vs tenant "u1-corp") must not get its whole
        namespace evicted by a default-domain flush."""
        dropped = 0
        for shard in self._shards:
            with shard.lock:
                stale = [
                    k for k in shard.entries
                    if k.startswith(prefix)
                    and not (default_domain_only and _TSEP in k)
                ]
                for k in stale:
                    del shard.entries[k]
                dropped += len(stale)
        if dropped:
            self._count("evictions", dropped)
        return dropped


def from_config(cfg, telemetry=None) -> Optional[DecisionCache]:
    """Build a DecisionCache from the ``decision_cache`` config block
    (srv/config.py DEFAULT_CONFIG); None when disabled."""
    block = cfg.get("decision_cache") or {}
    if not block.get("enabled", True):
        return None
    return DecisionCache(
        ttl_s=float(block.get("ttl_s", 3600.0)),
        max_entries=int(block.get("max_entries", 65536)),
        shards=int(block.get("shards", 16)),
        telemetry=telemetry,
    )
