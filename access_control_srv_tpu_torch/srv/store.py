"""Policy store: document collections + CRUD services + hot tree sync.

Framework analog of the reference's resource layer
(reference: src/resourceManager.ts): three CRUD services (rule / policy /
policy_set) persisting flat documents (children referenced by id), each
mutation stamping owner metadata, optionally self-authorizing through the
engine, emitting a CRUD event, and hot-syncing the in-memory evaluation
tree (+ kernel recompile via the evaluator).

Persistence is pluggable: the default collection is in-memory with an
optional JSON snapshot directory (the ArangoDB role is durability +
queries; decision semantics never depended on it, SURVEY.md L6).

CRUD topic contract: frames on ``io.restorecommerce.{kind}s.resource``
are ``{"payload": <resource doc | {"id"} | {"collection": true}>,
"origin": <emitting store id>}`` — the envelope lets PolicyReplicator
skip a worker's own echoes; consumers wanting the raw resource read
``message["payload"]``.  (The reference's Kafka frames carry the bare
resource proto; this bus is framework-internal, the reference-wire
surface is gRPC — docs/WIRE_COMPAT.md.)"""

from __future__ import annotations

import copy
import json
import os
import re
import threading
import time
import uuid
from typing import Callable, Optional

from .clock import monotonic_wall
from ..core.engine import AccessController
from ..core.loader import policy_from_dict, policy_set_from_dict, rule_from_dict
from ..models.model import Decision
from ..ops.delta import CrudEvent, footprint_from_events


class Collection:
    """An ordered id -> document map with optional durable persistence.

    Persistence is snapshot + journal (the per-document-write cost model
    of the reference's ArangoDB, not rewrite-the-world): single-document
    mutations append one JSON-lines record to ``{name}.journal`` — O(doc),
    independent of corpus size — and the full ``{name}.json`` snapshot is
    rewritten only on bulk loads, clears, or when the journal exceeds
    ``compact_every`` records (then the journal is truncated).  Startup
    loads the snapshot and replays the journal; a torn trailing record
    (crash mid-append) is skipped.

    Durability caveat (same contract as the broker journal): records are
    flushed per append but NOT fsynced — a process crash loses nothing
    already flushed; a host-level crash can drop the flushed tail still
    in the page cache.  Call ``close()`` on shutdown so the handle does
    not rely on GC."""

    def __init__(self, name: str, snapshot_dir: Optional[str] = None,
                 compact_every: int = 1024):
        self.name = name
        self._docs: dict[str, dict] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.snapshot_dir = snapshot_dir
        self.compact_every = compact_every
        self._journal_fh = None       # guarded-by: _lock
        self._journal_records = 0     # guarded-by: _lock
        if snapshot_dir:
            path = os.path.join(snapshot_dir, f"{name}.json")
            if os.path.exists(path):
                with open(path) as fh:
                    for doc in json.load(fh):
                        self._docs[doc["id"]] = doc
            jpath = self._journal_path()
            if os.path.exists(jpath):
                with open(jpath) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue  # torn tail record
                        if rec.get("op") == "upsert":
                            self._docs[rec["doc"]["id"]] = rec["doc"]
                        elif rec.get("op") == "delete":
                            self._docs.pop(rec["id"], None)
                        self._journal_records += 1

    def _journal_path(self) -> str:
        return os.path.join(self.snapshot_dir, f"{self.name}.journal")

    def _append(self, rec: dict) -> None:  # holds: _lock
        """One O(doc) journal record; caller holds self._lock.  Rolls the
        journal into a fresh snapshot past the compaction threshold."""
        if not self.snapshot_dir:
            return
        if self._journal_records >= self.compact_every:
            self._snapshot()
            return
        if self._journal_fh is None:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            self._journal_fh = open(self._journal_path(), "a",
                                    encoding="utf-8")
        self._journal_fh.write(json.dumps(rec) + "\n")
        self._journal_fh.flush()
        self._journal_records += 1

    def _snapshot(self):  # holds: _lock
        """Full rewrite + journal truncation; caller holds self._lock."""
        if not self.snapshot_dir:
            return
        os.makedirs(self.snapshot_dir, exist_ok=True)
        path = os.path.join(self.snapshot_dir, f"{self.name}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(list(self._docs.values()), fh, indent=1)
        os.replace(tmp, path)
        if self._journal_fh is not None:
            self._journal_fh.close()
            self._journal_fh = None
        try:
            os.remove(self._journal_path())
        except OSError:
            pass
        self._journal_records = 0

    def upsert(self, doc: dict) -> None:
        with self._lock:
            doc = copy.deepcopy(doc)
            self._docs[doc["id"]] = doc
            self._append({"op": "upsert", "doc": doc})

    def upsert_many(self, docs: list[dict]) -> None:
        """Bulk path: one lock acquisition and one snapshot for the whole
        list (per-doc journaling would write n records for a load that a
        single compacted snapshot represents)."""
        with self._lock:
            for doc in docs:
                self._docs[doc["id"]] = copy.deepcopy(doc)
            self._snapshot()

    def insert(self, doc: dict) -> bool:
        with self._lock:
            if doc["id"] in self._docs:
                return False
            doc = copy.deepcopy(doc)
            self._docs[doc["id"]] = doc
            self._append({"op": "upsert", "doc": doc})
            return True

    def get(self, doc_id: str) -> Optional[dict]:
        with self._lock:
            doc = self._docs.get(doc_id)
            return copy.deepcopy(doc) if doc is not None else None

    def delete(self, doc_id: str) -> bool:
        with self._lock:
            existed = self._docs.pop(doc_id, None) is not None
            if existed:
                self._append({"op": "delete", "id": doc_id})
            return existed

    def all(self) -> list[dict]:
        with self._lock:
            return [copy.deepcopy(d) for d in self._docs.values()]

    def close(self) -> None:
        """Close the journal handle; shutdown must not rely on GC."""
        with self._lock:
            if self._journal_fh is not None:
                self._journal_fh.close()
                self._journal_fh = None

    def clear(self) -> None:
        with self._lock:
            self._docs.clear()
            self._snapshot()


class _FilterError(ValueError):
    pass


def _field_value(doc, path: str):
    """Dotted-path lookup into the document (missing -> None)."""
    node = doc
    for part in path.split("."):
        if isinstance(node, dict):
            node = node.get(part)
        else:
            return None
    return node


def _coerce_json(raw):
    if isinstance(raw, str):
        try:
            return json.loads(raw)
        except ValueError:
            return raw
    return raw


def _predicate_matches(flt: dict, doc: dict) -> bool:
    """One {field, operation, value} predicate (reference FilterOperation
    set: eq, neq, lt, lte, gt, gte, in, isEmpty, iLike)."""
    field = flt.get("field")
    op = (flt.get("operation") or "eq")
    if not field:
        raise _FilterError("filter predicate missing field")
    actual = _field_value(doc, field)
    if op == "isEmpty":
        return actual is None or actual == "" or actual == []
    raw = flt.get("value")
    value = _coerce_json(raw)
    if op == "eq":
        # string fields whose content happens to parse as JSON (e.g. the
        # literal string "2024") must still match: compare raw AND coerced
        return actual == raw or actual == value
    if op == "neq":
        return not (actual == raw or actual == value)
    if op == "in":
        options = value if isinstance(value, list) else [value]
        return actual in options
    if op == "iLike":
        if not isinstance(actual, str) or not isinstance(value, str):
            return False
        # SQL LIKE: % is the wildcard; everything else literal,
        # case-insensitive
        pattern = ".*".join(
            re.escape(part) for part in value.lower().split("%")
        )
        return re.fullmatch(pattern, actual.lower()) is not None
    if op in ("lt", "lte", "gt", "gte"):
        try:
            a, v = float(actual), float(value)
        except (TypeError, ValueError):
            return False
        return {"lt": a < v, "lte": a <= v,
                "gt": a > v, "gte": a >= v}[op]
    raise _FilterError(f"unknown filter operation {op!r}")


def _filter_groups_match(groups: list, doc: dict) -> bool:
    """Groups AND together; predicates inside a group combine with the
    group operator (and/or, default and)."""
    for group in groups or []:
        predicates = group.get("filters") or []
        if not predicates:
            continue
        operator = group.get("operator") or "and"
        if operator not in ("and", "or"):
            raise _FilterError(f"unknown filter group operator {operator!r}")
        results = [_predicate_matches(f, doc) for f in predicates]
        combined = any(results) if operator == "or" else all(results)
        if not combined:
            return False
    return True


def _op_status(code=200, message="success"):
    return {"code": code, "message": message}


class ResourceService:
    """Generic CRUD over one resource kind with metadata stamping,
    self-authorization, event emission and tree hot-sync
    (reference: RuleService/PolicyService/PolicySetService in
    src/resourceManager.ts)."""

    KIND_EVENT = {"rule": "rule", "policy": "policy", "policy_set": "policySet"}

    def __init__(
        self,
        kind: str,
        collection: Collection,
        store: "PolicyStore",
        topic=None,
        access_check: Optional[Callable] = None,
        urns=None,
        logger=None,
    ):
        self.kind = kind
        self.collection = collection
        self.store = store
        self.topic = topic
        self.access_check = access_check
        self.urns = urns
        self.logger = logger

    # -------------------------------------------------------------- helpers

    def read_meta_data(self, doc_id: str) -> Optional[dict]:
        doc = self.collection.get(doc_id)
        return doc.get("meta") if doc else None

    def _create_metadata(self, items: list[dict], action: str, subject) -> list[dict]:
        """Owner stamping + id generation
        (reference: src/core/utils.ts:269-349)."""
        urns = self.urns
        org_owner_attrs = []
        scope = (subject or {}).get("scope")
        if subject and scope and action in ("CREATE", "MODIFY"):
            org_owner_attrs.append(
                {
                    "id": urns.get("ownerIndicatoryEntity"),
                    "value": urns.get("organization"),
                    "attributes": [
                        {"id": urns.get("ownerInstance"), "value": scope}
                    ],
                }
            )
        # monotonic-anchored: meta.modified/created are ordering-sensitive
        # stored stamps — a raw time.time() stepping backward under NTP
        # slew would reorder document history (srv/clock.py)
        now = monotonic_wall()
        for item in items:
            meta = item.setdefault("meta", {})
            # timestamp stamping (reference: resource-base fieldHandlers
            # timeStampFields meta.created/meta.modified,
            # cfg/config.json:324-331)
            meta["modified"] = now
            # created is server-stamped: always restored from the stored
            # document (a client-supplied meta.created must never overwrite
            # the original creation time — reference resource-base
            # timeStampFields semantics), falling back to now only when no
            # prior doc exists
            existing_meta = (
                self.read_meta_data(item.get("id", ""))
                if item.get("id") else None
            )
            meta["created"] = (existing_meta or {}).get("created") or now
            if action in ("MODIFY", "DELETE"):
                if existing_meta and existing_meta.get("owners"):
                    meta["owners"] = existing_meta["owners"]
                    continue
            if not item.get("id"):
                item["id"] = uuid.uuid4().hex
            owners = meta.get("owners") or list(org_owner_attrs)
            if subject and subject.get("id"):
                owners = owners + [
                    {
                        "id": urns.get("ownerIndicatoryEntity"),
                        "value": urns.get("user"),
                        "attributes": [
                            {
                                "id": urns.get("ownerInstance"),
                                "value": subject["id"],
                            }
                        ],
                    }
                ]
            meta["owners"] = owners
        return items

    def _authorize(self, items, action, subject, ctx) -> Optional[dict]:
        """Self-authorization of CRUD through the engine
        (reference: checkAccessRequest, src/core/utils.ts:212-261; every
        CRUD op in resourceManager.ts)."""
        if self.access_check is None:
            return None
        decision = self.access_check(self.kind, items, action, subject, ctx)
        if decision != Decision.PERMIT:
            return {
                "operation_status": _op_status(
                    403,
                    f"Access not allowed for request with subject:"
                    f"{(subject or {}).get('id')}, resource:{self.kind}, "
                    f"action:{action}, target_scope:{(subject or {}).get('scope')}; "
                    f"the response was {decision}",
                )
            }
        return None

    def _emit(self, event: str, doc: dict) -> None:
        if self.topic is not None:
            # the origin id lets a PolicyReplicator on this worker skip
            # its own frames when the broker streams them back (the
            # mutation was applied locally at CRUD time); an offset-based
            # guard would race the broker, which fans a frame out to
            # subscribers BEFORE answering the emit RPC
            self.topic.emit(
                event, {"payload": doc, "origin": self.store.origin}
            )

    # ----------------------------------------------------------------- CRUD

    def create(self, items: list[dict], subject=None, ctx=None) -> dict:
        items = self._create_metadata([copy.deepcopy(i) for i in items], "CREATE", subject)
        denied = self._authorize(items, "CREATE", subject, ctx)
        if denied:
            return denied
        results = []
        events = []
        for doc in items:
            events.append(CrudEvent(
                kind=self.kind, op="create", doc_id=doc["id"],
                old_doc=self.collection.get(doc["id"]), new_doc=doc,
            ))
            self.collection.upsert(doc)
            self._emit(f"{self.KIND_EVENT[self.kind]}Created", doc)
            results.append({"payload": doc, "status": _op_status()})
        self.store.sync_after_mutation(self.kind, "create", items, events)
        return {"items": results, "operation_status": _op_status()}

    def update(self, items: list[dict], subject=None, ctx=None) -> dict:
        items = self._create_metadata([copy.deepcopy(i) for i in items], "MODIFY", subject)
        denied = self._authorize(items, "MODIFY", subject, ctx)
        if denied:
            return denied
        results = []
        events = []
        for doc in items:
            old_doc = self.collection.get(doc["id"])
            if old_doc is None:
                results.append(
                    {"payload": None,
                     "status": _op_status(404, f"{doc['id']} not found")}
                )
                continue
            events.append(CrudEvent(
                kind=self.kind, op="update", doc_id=doc["id"],
                old_doc=old_doc, new_doc=doc,
            ))
            self.collection.upsert(doc)
            self._emit(f"{self.KIND_EVENT[self.kind]}Modified", doc)
            results.append({"payload": doc, "status": _op_status()})
        self.store.sync_after_mutation(self.kind, "update", items, events)
        return {"items": results, "operation_status": _op_status()}

    def upsert(self, items: list[dict], subject=None, ctx=None) -> dict:
        items = self._create_metadata([copy.deepcopy(i) for i in items], "MODIFY", subject)
        denied = self._authorize(items, "MODIFY", subject, ctx)
        if denied:
            return denied
        results = []
        events = []
        for doc in items:
            events.append(CrudEvent(
                kind=self.kind, op="upsert", doc_id=doc["id"],
                old_doc=self.collection.get(doc["id"]), new_doc=doc,
            ))
            self.collection.upsert(doc)
            self._emit(f"{self.KIND_EVENT[self.kind]}Modified", doc)
            results.append({"payload": doc, "status": _op_status()})
        self.store.sync_after_mutation(self.kind, "upsert", items, events)
        return {"items": results, "operation_status": _op_status()}

    def super_upsert(self, items: list[dict], sync: bool = True) -> dict:
        """Seed-data path: no authorization (reference: src/worker.ts:228)."""
        self.collection.upsert_many(items)
        if sync:
            self.store.sync_after_mutation(self.kind, "upsert", items)
        return {"operation_status": _op_status()}

    def read(self, filters: Optional[dict] = None) -> dict:
        """``filters`` accepts the ids shorthand ({"ids": [...]}) or the
        resource-base filter DSL ({"filters": [group, ...]}, reference:
        resource-base-interface FilterOperation via
        resourceManager.ts:61-68): groups of {field, operation, value}
        predicates, predicates combined by the group operator (and/or),
        groups combined with AND."""
        docs = self.collection.all()
        if filters and "ids" in filters:
            wanted = set(filters["ids"])
            docs = [d for d in docs if d["id"] in wanted]
        elif filters and filters.get("filters"):
            try:
                docs = [
                    d for d in docs
                    if _filter_groups_match(filters["filters"], d)
                ]
            except _FilterError as err:
                return {"operation_status": _op_status(400, str(err))}
        return {
            "items": [{"payload": d, "status": _op_status()} for d in docs],
            "operation_status": _op_status(),
        }

    def delete(self, ids=None, collection=False, subject=None, ctx=None) -> dict:
        if collection:
            denied = self._authorize([], "DROP", subject, ctx)
            if denied:
                return denied
            self.collection.clear()
            self._emit(f"{self.KIND_EVENT[self.kind]}Deleted", {"collection": True})
            self.store.sync_after_mutation(
                self.kind, "delete_all", [],
                [CrudEvent(kind=self.kind, op="delete_all", doc_id="")],
            )
            return {"operation_status": _op_status()}
        items = [{"id": i} for i in (ids or [])]
        items = self._create_metadata(items, "DELETE", subject)
        denied = self._authorize(items, "DELETE", subject, ctx)
        if denied:
            return denied
        events = []
        for doc_id in ids or []:
            events.append(CrudEvent(
                kind=self.kind, op="delete", doc_id=doc_id,
                old_doc=self.collection.get(doc_id), new_doc=None,
            ))
            self.collection.delete(doc_id)
            self._emit(f"{self.KIND_EVENT[self.kind]}Deleted", {"id": doc_id})
        self.store.sync_after_mutation(self.kind, "delete", items, events)
        return {"operation_status": _op_status()}


class PolicyStore:
    """The three collections + tree composition + hot sync
    (reference: ResourceManager, src/resourceManager.ts:1050-1092; the
    3-level load join :765-797)."""

    def __init__(
        self,
        engine: AccessController,
        evaluator=None,
        bus=None,
        snapshot_dir: Optional[str] = None,
        access_check: Optional[Callable] = None,
        logger=None,
    ):
        self.engine = engine
        self.evaluator = evaluator
        self.logger = logger
        self.collections = {
            kind: Collection(kind, snapshot_dir)
            for kind in ("rule", "policy", "policy_set")
        }
        self.services = {
            kind: ResourceService(
                kind,
                self.collections[kind],
                self,
                topic=bus.topic(f"io.restorecommerce.{kind}s.resource")
                if bus
                else None,
                access_check=access_check,
                urns=engine.urns,
                logger=logger,
            )
            for kind in ("rule", "policy", "policy_set")
        }

        # unique per store instance: stamps emitted CRUD frames so a
        # replicator can distinguish this worker's own mutations from
        # remote ones (srv/store.PolicyReplicator)
        self.origin = uuid.uuid4().hex
        # serializes tree recompose+swap: local CRUD sync and the
        # replicator's debounced sync may run on different threads, and
        # an unserialized older compose must not swap in after a newer
        # one (load() reads the collections under this lock, so the last
        # swap always reflects the latest collection state)
        self._load_lock = threading.Lock()

    def get_resource_service(self, kind: str) -> ResourceService:
        return self.services[kind]

    def load(self, events=None) -> None:
        """Compose the 3-level tree from the flat collections and swap it
        into the engine (reference: PolicySetService.load).  The new tree is
        built aside and swapped in with one reference assignment so serving
        threads never observe a cleared or half-built tree; the whole
        read-compose-swap is serialized under _load_lock (see __init__).

        ``events`` (list of ops/delta.CrudEvent) carries the CRUD diff
        captured at mutation time: it scopes the decision-cache flush to
        the delta's target-signature footprint, lets certified-empty diffs
        skip the flush entirely, and enables the evaluator's in-place
        table patching.  ``None`` (boot load, restore, reset, seed) keeps
        the pre-delta global-flush + full-recompile behavior."""
        with self._load_lock:
            self._load_locked(events)

    def _delta_footprint(self, events):
        """Conservative affected-signature footprint of a CRUD event list
        (ops/delta.footprint_from_events over the live collections); None
        means "unknown" and degrades to the global flush."""
        if events is None:
            return None
        try:
            return footprint_from_events(
                events,
                self.engine.urns,
                lambda kind, doc_id: self.collections[kind].get(doc_id),
                lambda kind: self.collections[kind].all(),
            )
        except Exception:  # noqa: BLE001 — footprint is an optimization
            if self.logger:
                self.logger.exception("delta footprint failed; global flush")
            return None

    def _load_locked(self, events=None) -> None:
        rules = {d["id"]: rule_from_dict(d) for d in self.collections["rule"].all()}
        policies = {}
        for p_doc in self.collections["policy"].all():
            child_rules = []
            for rid in p_doc.get("rules") or []:
                # missing children become None placeholders
                child_rules.append(rules.get(rid))
            policy = policy_from_dict(p_doc)
            policy.combinables = {
                (r.id if r is not None else f"__missing_{i}"): r
                for i, r in enumerate(child_rules)
            }
            policies[p_doc["id"]] = policy
        tree: dict = {}
        for ps_doc in self.collections["policy_set"].all():
            child_policies = []
            for pid in ps_doc.get("policies") or []:
                child_policies.append(policies.get(pid))
            policy_set = policy_set_from_dict(ps_doc)
            policy_set.combinables = {
                (p.id if p is not None else f"__missing_{i}"): p
                for i, p in enumerate(child_policies)
            }
            tree[policy_set.id] = policy_set
        footprint = self._delta_footprint(events)
        decision_cache = getattr(self.evaluator, "decision_cache", None)
        if decision_cache is not None:
            # epoch-flush BEFORE the swap: between the new tree going live
            # and the evaluator refresh below, no cached old-tree decision
            # may serve.  refresh() bumps AGAIN after the swap — together
            # with writers stamping entries with an epoch snapshot taken
            # before their walk reads the tree (DecisionCache.put), the
            # pre+post bumps guarantee no evaluation that saw the OLD tree
            # can store an entry whose epoch survives: its snapshot
            # predates at least the post-swap bump.  With a delta
            # footprint both bumps are SCOPED: entries (and in-flight
            # writers) whose target signatures are provably disjoint from
            # the mutation keep the same guarantee without the flush —
            # and a certified-empty diff (no-op CRUD) skips them entirely.
            if footprint is not None and footprint.empty:
                pass
            elif footprint is not None:
                decision_cache.bump_scoped(footprint)
            else:
                decision_cache.bump_epoch()
        self.engine.replace_policy_sets(tree)
        if self.evaluator is not None:
            self.evaluator.refresh(events=events, footprint=footprint)

    def sync_after_mutation(self, kind: str, op: str, items: list[dict],
                            events=None) -> None:
        """Hot-sync the in-memory tree after a CRUD mutation.  The
        reference does targeted Map surgery for creates/deletes and a full
        reload for updates/upserts (reference: resourceManager.ts:202-215,
        274, 305, 352-369); a full recompose keeps both paths consistent
        here, then the evaluator applies the delta (in-capacity table
        patch + scoped cache invalidation) or falls back to a full
        recompile (ops/delta.py taxonomy)."""
        self.load(events)

    def seed(self, policy_set_docs, policy_docs, rule_docs) -> None:
        """superUpsert seed loading (reference: src/worker.ts:200-242).
        Per-kind sync is suppressed so startup pays one tree compose +
        evaluator compile instead of three partial ones."""
        self.services["rule"].super_upsert(rule_docs, sync=False)
        self.services["policy"].super_upsert(policy_docs, sync=False)
        self.services["policy_set"].super_upsert(policy_set_docs, sync=False)
        self.load()


# remote-frame validators per resource kind (PolicyReplicator): the same
# composers store.load() runs, invoked up front so a malformed frame is
# rejected instead of persisted
_VALIDATORS = {
    "rule": rule_from_dict,
    "policy": policy_from_dict,
    "policy_set": policy_set_from_dict,
}


class PolicyReplicator:
    """Shared mutable policy state across workers, over the broker's CRUD
    topic logs.

    The reference gets multi-replica policy storage from a shared ArangoDB
    (cfg/config.json database.main) — every replica reads one durable
    store, and in-memory trees are per-replica caches.  Here the durable
    shared store IS the broker's journaled CRUD log: every mutation a
    worker serves is already emitted to ``io.restorecommerce.{kind}s.
    resource`` (ResourceService._emit); this replicator subscribes each
    worker to those topics, replays the full log at boot (idempotent
    upserts/deletes converge to the log's final state) and applies live
    frames from OTHER workers to the local collections + engine tree, so
    N workers serve one mutable policy state without restarts.

    Apply path never re-emits (no event loops); the worker's own frames
    carry its PolicyStore.origin stamp and are skipped (they were applied
    locally at CRUD time).  Tree recompose + evaluator recompile are
    debounced so a replay burst costs one compile, not one per event.
    Concurrent writers use last-frame-wins per document — the same
    semantics concurrent replicas get from the reference's shared Arango.

    Unlike the JAX replicator, the boot replay is ONE sync: the frames
    journaled when ``start`` subscribes only queue their events until the
    last of them has been seen.  The debounced sync would otherwise cut a
    long replay at points that depend on timing, and two replicas of one
    journal could end on different capacity buckets (a patch that
    overflows a bucket grows it; a full compile sizes it to the tree), so
    on different ``table_fingerprint``s.
    """

    def __init__(self, store: PolicyStore, bus, logger=None,
                 debounce_s: float = 0.05):
        self.store = store
        self.bus = bus
        self.logger = logger
        self.debounce_s = debounce_s
        # multi-tenant registry (srv/tenancy.TenantRegistry), wired by
        # the worker: CRUD frames whose envelope carries a ``tenant`` key
        # belong to a tenant domain, not the global tree — they are routed
        # to the registry (boot replay included, so a new tenant boots by
        # replay) and never enter the global debounced sync.  None drops
        # tenant-tagged frames (single-tenant deployment).
        self.tenancy = None
        self._lock = threading.Lock()
        self._timer: Optional[threading.Timer] = None  # guarded-by: _lock
        self._stopped = False  # guarded-by: _lock
        self._applied = 0  # guarded-by: _lock
        # CRUD events captured per applied frame (old doc read before the
        # upsert/delete): the debounced sync hands them to store.load so
        # remote mutations get the same delta patch + scoped invalidation
        # as local ones
        self._pending_events: list = []  # guarded-by: _lock
        # policy-epoch bookkeeping (cluster tier, srv/router.py): highest
        # broker offset OBSERVED per CRUD topic, and the highest offset
        # whose effect is REFLECTED in the serving tree (own-origin frames
        # were applied at CRUD time; remote frames at the debounced sync).
        # sum(applied+1) is the replica's policy epoch — the number every
        # response is stamped with, so the router and the stale-decision
        # oracle can compare replica states without reading the trees.
        self.offsets: dict[str, int] = {}          # guarded-by: _lock
        self.applied_offsets: dict[str, int] = {}  # guarded-by: _lock
        self._topics = {
            self.store.services[kind].topic.name: kind
            for kind in ("rule", "policy", "policy_set")
            if self.store.services[kind].topic is not None
        }
        # per CRUD topic, its journal length when start() subscribed, for
        # the topics whose boot replay is still under way
        self._boot_tail: dict[str, int] = {}  # guarded-by: _lock

    def start(self) -> "PolicyReplicator":
        tails = {name: self.bus.topic(name).offset for name in self._topics}
        with self._lock:
            self._boot_tail = {n: t for n, t in tails.items() if t > 0}
        for topic_name in self._topics:
            self.bus.topic(topic_name).on(self._on_event, starting_offset=0)
        return self

    @property
    def epoch(self) -> int:
        """Policy epoch: count of CRUD log frames reflected in the serving
        tree (sum of applied offsets + 1 across the CRUD topics)."""
        with self._lock:
            return sum(off + 1 for off in self.applied_offsets.values())

    def _mark_applied(self, topic: str, offset: int) -> None:
        """A frame whose effect is already in the tree (own-origin, no-op,
        malformed-and-quarantined): advance the applied watermark when no
        remote frames are pending, so the mutating replica's epoch covers
        its own CRUD immediately rather than at the next debounced sync."""
        with self._lock:
            if self._pending_events:
                # remote frames are awaiting the debounced sync: this
                # frame's effect is in the tree, but claiming it applied
                # now would overclaim any pending lower-offset frame on
                # the same topic — record it for the armed sync (which
                # snapshots self.offsets) to advance instead of dropping
                # it from the watermark entirely
                self.offsets[topic] = max(
                    self.offsets.get(topic, -1), offset
                )
            else:
                self.applied_offsets[topic] = max(
                    self.applied_offsets.get(topic, -1), offset
                )

    def _on_event(self, event_name: str, message, ctx: dict) -> None:
        try:
            self._apply_frame(event_name, message, ctx)
        finally:
            # acs-lint: ignore[guarded-by] benign racy fast-path: the
            # boot bookkeeping re-checks under the lock
            if self._boot_tail:
                self._boot_progress(ctx)

    def _boot_progress(self, ctx: dict) -> None:
        """Count a boot-replay frame as seen; once every topic's boot tail
        has been seen, arm the one sync of the queued replay."""
        topic, offset = ctx.get("topic"), ctx.get("offset")
        with self._lock:
            tail = self._boot_tail.get(topic)
            if tail is None or not isinstance(offset, int) \
                    or offset + 1 < tail:
                return
            del self._boot_tail[topic]
            if self._boot_tail or not self._pending_events:
                return
        self._schedule_sync()

    def _apply_frame(self, event_name: str, message, ctx: dict) -> None:
        # acs-lint: ignore[guarded-by] benign racy fast-path: a frame that
        # slips past a concurrent stop() is applied to collections that are
        # about to be discarded; _schedule_sync re-checks under the lock
        if self._stopped:
            return
        topic = ctx.get("topic")
        kind = self._topics.get(topic)
        if kind is None or not isinstance(message, dict):
            return
        offset = ctx.get("offset")
        offset = offset if isinstance(offset, int) else -1
        if message.get("origin") == self.store.origin:
            if offset >= 0:
                self._mark_applied(topic, offset)
            return  # our own mutation, already applied + synced
        tenant = message.get("tenant")
        if tenant is not None:
            # tenant-scoped frame: apply to the tenant registry (which
            # recomposes/patches only that tenant's domain); the global
            # tree is untouched, so no debounced sync is scheduled.  The
            # watermark still advances — tenant frames count toward the
            # replica's journal-replay epoch.
            registry = self.tenancy
            if registry is not None:
                try:
                    registry.apply_remote_frame(
                        str(tenant), kind, event_name,
                        message.get("payload"),
                    )
                except Exception:  # noqa: BLE001 — bad frame, not the pump
                    if self.logger:
                        self.logger.exception(
                            "tenant replication apply failed",
                            extra={"topic": topic, "tenant": tenant},
                        )
            if offset >= 0:
                self._mark_applied(topic, offset)
            return
        doc = message.get("payload")
        if not isinstance(doc, dict):
            if offset >= 0:
                self._mark_applied(topic, offset)
            return
        collection = self.store.collections[kind]
        try:
            event: Optional[CrudEvent] = None
            if event_name.endswith("Created") or event_name.endswith(
                "Modified"
            ):
                if doc.get("id"):
                    # quarantine malformed remote docs BEFORE they reach
                    # the collection: a doc the composers reject would
                    # otherwise poison every later store.load() on this
                    # worker (local CRUD included)
                    _VALIDATORS[kind](doc)
                    event = CrudEvent(
                        kind=kind, op="upsert", doc_id=doc["id"],
                        old_doc=collection.get(doc["id"]), new_doc=doc,
                    )
                    collection.upsert(doc)
            elif event_name.endswith("Deleted"):
                if doc.get("collection"):
                    event = CrudEvent(kind=kind, op="delete_all", doc_id="")
                    collection.clear()
                elif doc.get("id"):
                    event = CrudEvent(
                        kind=kind, op="delete", doc_id=doc["id"],
                        old_doc=collection.get(doc["id"]), new_doc=None,
                    )
                    collection.delete(doc["id"])
            else:
                if offset >= 0:
                    self._mark_applied(topic, offset)
                return
        except Exception:  # noqa: BLE001 — a bad frame must not kill the pump
            if self.logger:
                self.logger.exception(
                    "replication apply failed",
                    extra={"topic": topic, "event": event_name},
                )
            if offset >= 0:
                self._mark_applied(topic, offset)  # quarantined, not pending
            return
        with self._lock:
            self._applied += 1
        self._schedule_sync(event, topic=topic, offset=offset)

    def _schedule_sync(self, event=None, topic=None, offset=-1) -> None:
        # arm only when no sync is pending: the pending sync composes
        # from the live collections at fire time, so it covers every
        # frame applied before it runs — and a replay burst of N frames
        # costs one timer thread, not N
        with self._lock:
            if event is not None:
                self._pending_events.append(event)
            if topic is not None and offset >= 0:
                # recorded under the same lock as the pending append so a
                # concurrent _sync snapshot never advances the epoch past
                # an event it did not apply
                self.offsets[topic] = max(
                    self.offsets.get(topic, -1), offset
                )
            if self._stopped or self._timer is not None \
                    or self._boot_tail:
                # a pending sync covers this frame; during the boot
                # replay the last frame's progress arms the one sync
                return
            self._timer = threading.Timer(self.debounce_s, self._sync)
            self._timer.daemon = True
            self._timer.start()

    def _sync(self) -> None:
        with self._lock:
            self._timer = None
            events = self._pending_events
            self._pending_events = []
            observed = dict(self.offsets)
        try:
            self.store.load(events or None)
        except Exception:  # noqa: BLE001
            if self.logger:
                self.logger.exception("replication tree sync failed")
        else:
            # every frame observed before this sync started is now
            # reflected in the tree: advance the epoch watermark
            with self._lock:
                for topic, off in observed.items():
                    self.applied_offsets[topic] = max(
                        self.applied_offsets.get(topic, -1), off
                    )

    def wait_caught_up(self, timeout_s: float = 60.0) -> bool:
        """Block until every CRUD frame journaled at call time is
        reflected in the serving tree (epoch >= journal tail).  A
        rebooting replica calls this before opening its serving port —
        answering from a half-replayed tree would hand the router
        INDETERMINATE decisions stamped with a stale epoch.  Returns
        False on timeout or if the journal tail is unreadable (the
        caller serves anyway, degraded, rather than hanging boot)."""
        try:
            total = sum(
                len(self.bus.topic(name).read(0))
                for name in self._topics
            )
        except Exception:  # noqa: BLE001 — broker gone: nothing to wait on
            return False
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.epoch >= total:
                return True
            time.sleep(0.02)
        return False

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
