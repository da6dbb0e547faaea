"""Zanzibar-style relationship-tuple store: the serving-side ReBAC
substrate (a copy of the JAX package's ``srv/relations.py``).

``core/relation_path.py`` is the deliberately naive scalar oracle; this
module is the store the evaluator serves from:

- an in-memory :class:`~..core.relation_path.RelationGraph` holding
  ``object#relation@subject`` tuples and userset-rewrite configs, mutated
  through a CRUD surface that journals every change;
- a **memoized closure cache** with a dependency index: every cached
  (path, object) reachable-user set records exactly which graph nodes
  ``(ns, oid, rel)`` and rewrite configs ``(ns, rel)`` its expansion
  consulted, so a tuple write invalidates ONLY the closure entries whose
  traversal touched the mutated node — the rest of the cache (and the
  flat tables built from it) survives churn untouched;
- ``tables_for(compiled)``: the flat verdict tables
  (ops/relation.pack_relation_bitplanes) in the compiled tree's
  relation-vocab order — two sorted int64 arrays + an offset table, so a
  batch verdict is two binary searches.  Rebuilt lazily per store
  generation from the (mostly cached) closure sets; identical to a
  from-scratch build by construction, and byte-equal to the JAX
  package's store for the same tuples (tests/test_torch_relations.py);
- **replication**: every mutation emits a CrudEvent-style frame
  (``origin``-stamped, ``tenant``-taggable) on an event-bus topic
  (srv/events.py).  Peers replay the topic at boot and apply live frames
  from OTHER origins (origin-skip), converging to byte-identical
  ``fingerprint()``s;
- ``witness()``: the tuple-path provenance behind a relation-decided
  row.

Tuple churn never touches the compiled policy tensors: the kernels
consume relations only through the per-batch bitplanes packed from
these tables, so a tuple write costs a scoped closure invalidation and
no new kernel build.
"""

from __future__ import annotations

import threading
import uuid
from hashlib import blake2b
from typing import Callable, Optional

import numpy as np

from ..core.relation_path import (
    RelationGraph,
    _reach_objects,
    _reach_users,
    normalize_rule,
    normalize_subject,
    parse_path,
    OBJECT,
    USER,
    USERSET,
)

# the topic relation-tuple CRUD frames ride (the policy-CRUD topics are
# io.restorecommerce.{rules,policies,policy_sets}.resource)
RELATION_TOPIC = "io.restorecommerce.relation-tuples.resource"


def _subject_wire(norm: tuple):
    """Normalized subject -> wire/journal form."""
    if norm[0] == USER:
        return norm[1]
    out = {"object": {"entity": norm[1], "id": norm[2]}}
    if norm[0] == USERSET:
        out["relation"] = norm[3]
    return out


def tuple_doc(namespace: str, object_id: str, relation: str, subject
              ) -> dict:
    """Canonical wire doc for one relation tuple."""
    return {
        "object": {"entity": namespace, "id": object_id},
        "relation": relation,
        "subject": _subject_wire(normalize_subject(subject)),
    }


def _tuple_from_doc(doc: dict) -> tuple:
    obj = doc["object"]
    return (str(obj["entity"]), str(obj["id"]), str(doc["relation"]),
            normalize_subject(doc["subject"]))


class _RecordingGraph:
    """Duck-typed RelationGraph view that records every node and rewrite
    the traversal consults — the dependency set of one closure entry.
    Sound for incremental invalidation because _reach_users/_reach_objects
    read the graph ONLY through these two methods: a mutation at a node
    no entry consulted cannot change that entry's result."""

    __slots__ = ("_g", "node_deps", "rule_deps")

    def __init__(self, graph: RelationGraph):
        self._g = graph
        self.node_deps: set = set()
        self.rule_deps: set = set()

    def subjects_of(self, ns, oid, rel):
        self.node_deps.add((ns, oid, rel))
        return self._g.subjects_of(ns, oid, rel)

    def rules_of(self, ns, rel):
        self.rule_deps.add((ns, rel))
        return self._g.rules_of(ns, rel)


def _path_users(graph, alts, ns: str, oid: str, direct: bool) -> set:
    """Users reaching (ns, oid) through any alternative — the set-valued
    form of core.relation_path.check_relation_path (subject in result
    <=> check passes), shared by the closure cache and the tables."""
    out: set[str] = set()
    for alt in alts:
        frontier = {(ns, oid)}
        for step in alt[:-1]:
            visited: set = set()
            nxt: set = set()
            for n, o in frontier:
                nxt |= _reach_objects(graph, n, o, step, direct, visited)
            frontier = nxt
            if not frontier:
                break
        if not frontier:
            continue
        visited = set()
        for n, o in frontier:
            out |= _reach_users(graph, n, o, alt[-1], direct, visited)
    return out


class RelationTupleStore:
    """The serving tuple store; attach as ``engine.relation_store`` (the
    oracle reads ``.graph``) and the evaluator pulls ``tables_for`` at
    encode time.

    ``bus``: optional EventBus (srv/events.py) — mutations emit journal
    frames on ``topic`` and :meth:`start_replication` applies remote
    peers' frames.
    ``tenant``: stamps frames with a tenant tag; a store only applies
    frames whose tag matches its own (tenant isolation on a shared log).
    """

    def __init__(self, bus=None, topic: str = RELATION_TOPIC,
                 tenant: Optional[str] = None, logger=None,
                 telemetry=None):
        self._graph = RelationGraph()
        self._lock = threading.RLock()
        self.origin = uuid.uuid4().hex
        self.tenant = tenant
        self.logger = logger
        self.telemetry = telemetry
        self._gen = 0
        self._stopped = False
        # closure cache: (alts, direct, ns, oid) -> frozenset(users)
        self._memo: dict = {}
        self._entry_deps: dict = {}   # memo key -> (node deps, rule deps)
        self._node_index: dict = {}   # (ns, oid, rel) -> {memo keys}
        self._rule_index: dict = {}   # (ns, rel) -> {memo keys}
        self._invalidated = 0         # lifetime scoped-invalidation count
        # id space -> (sig, id source, tables)
        self._tables_cache: dict = {}
        self._fp_cache: Optional[tuple] = None      # (gen, hexdigest)
        self._listeners: list[Callable[[int], None]] = []
        self._topic = bus.topic(topic) if bus is not None else None
        self._bus = bus

    # ------------------------------------------------------------- oracle
    @property
    def graph(self) -> RelationGraph:
        return self._graph

    def on_change(self, callback: Callable[[int], None]) -> None:
        """Register a change listener, called with the new generation
        after every applied mutation (local or replicated) — the
        evaluator's decision-cache bump rides this."""
        self._listeners.append(callback)

    def _notify(self, gen: int) -> None:
        for callback in list(self._listeners):
            try:
                callback(gen)
            except Exception:  # noqa: BLE001 — listeners must not kill CRUD
                if self.logger:
                    self.logger.exception("relation change listener failed")

    # --------------------------------------------------------------- CRUD
    def create(self, tuples: list[dict]) -> int:
        """Insert tuples (wire docs or (ns, oid, rel, subject) 4-tuples);
        returns how many were new.  Emits one journal frame per applied
        tuple."""
        applied = 0
        for item in tuples:
            ns, oid, rel, subj = self._coerce(item)
            with self._lock:
                if not self._graph.add(ns, oid, rel, subj):
                    continue
                self._invalidate_node((ns, oid, rel))
                gen = self._bump()
            applied += 1
            self._count("tuples_created")
            self._emit("relationTupleCreated",
                       tuple_doc(ns, oid, rel, subj))
            self._notify(gen)
        return applied

    def delete(self, tuples: list[dict]) -> int:
        """Remove tuples; returns how many existed."""
        applied = 0
        for item in tuples:
            ns, oid, rel, subj = self._coerce(item)
            with self._lock:
                if not self._graph.remove(ns, oid, rel, subj):
                    continue
                self._invalidate_node((ns, oid, rel))
                gen = self._bump()
            applied += 1
            self._count("tuples_deleted")
            self._emit("relationTupleDeleted",
                       tuple_doc(ns, oid, rel, subj))
            self._notify(gen)
        return applied

    def set_rewrite(self, namespace: str, relation: str, rules) -> None:
        """Install the userset-rewrite config for (namespace, relation) —
        e.g. ``[("this",), ("computed_userset", "owner")]``."""
        normalized = [normalize_rule(r) for r in rules]
        with self._lock:
            self._graph.set_rewrite(namespace, relation, normalized)
            self._invalidate_rule((namespace, relation))
            gen = self._bump()
        self._count("rewrites_modified")
        self._emit("relationRewriteModified", {
            "namespace": namespace, "relation": relation,
            "rules": [list(r) for r in normalized],
        })
        self._notify(gen)

    @staticmethod
    def _coerce(item) -> tuple:
        if isinstance(item, dict):
            return _tuple_from_doc(item)
        ns, oid, rel, subj = item
        return (ns, oid, rel, normalize_subject(subj))

    def _bump(self) -> int:  # holds: _lock
        self._gen += 1
        self._tables_cache.clear()
        self._fp_cache = None
        return self._gen

    def _count(self, key: str) -> None:
        if self.telemetry is not None:
            self.telemetry.relations.inc(key)

    # -------------------------------------------------- closure cache
    def _invalidate_node(self, node: tuple) -> None:  # holds: _lock
        for key in self._node_index.pop(node, set()):
            self._drop_entry(key)
            self._invalidated += 1

    def _invalidate_rule(self, rule_key: tuple) -> None:  # holds: _lock
        for key in self._rule_index.pop(rule_key, set()):
            self._drop_entry(key)
            self._invalidated += 1

    def _drop_entry(self, key: tuple) -> None:  # holds: _lock
        self._memo.pop(key, None)
        node_deps, rule_deps = self._entry_deps.pop(key, ((), ()))
        for node in node_deps:
            bucket = self._node_index.get(node)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._node_index[node]
        for rk in rule_deps:
            bucket = self._rule_index.get(rk)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._rule_index[rk]

    def _users(self, alts: tuple, direct: bool, ns: str, oid: str
               ) -> frozenset:  # holds: _lock
        key = (alts, direct, ns, oid)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        recorder = _RecordingGraph(self._graph)
        out = frozenset(_path_users(recorder, alts, ns, oid, direct))
        self._memo[key] = out
        deps = (frozenset(recorder.node_deps),
                frozenset(recorder.rule_deps))
        self._entry_deps[key] = deps
        for node in deps[0]:
            self._node_index.setdefault(node, set()).add(key)
        for rk in deps[1]:
            self._rule_index.setdefault(rk, set()).add(key)
        return out

    # ------------------------------------------------------- flat tables
    def tables_for(self, compiled, intern=None, space: str = "host"
                   ) -> dict[str, np.ndarray]:
        """The flat verdict tables for ``compiled``'s relation vocab
        (padded entries get empty segments — fail-closed, and no target
        row references them).  Cached per (generation, vocab, id space,
        id source: the interner or ``intern`` function the ids come from;
        a recompile brings a new interner whose ids for the tuples'
        strings can differ, so its tables are built anew);
        the closure sets underneath are cached much longer
        (dependency-scoped invalidation), so steady-state churn rebuilds
        only the sort/pack of segments whose closures actually changed
        inputs.

        ``intern`` overrides the string->id mapping (default: the
        compiled tree's interner).  The native wire encoder passes its
        C++ interner here (``space="native"``) — its post-preload ids can
        diverge from the Python interner's, so the tables must be built
        in the id space of whichever encoder consumes them."""
        relv = int(np.asarray(compiled.arrays["relv_path"]).shape[0])
        vocab = list(compiled.rel_vocab)
        sig = (self._gen, relv, tuple(vocab), space)
        source = compiled.interner if intern is None else intern
        with self._lock:
            cached = self._tables_cache.get(space)
            if cached is not None and cached[0] == sig \
                    and cached[1] is source:
                return cached[2]
            if intern is None:
                intern = compiled.interner.intern
            candidates = sorted({
                (ns, oid) for (ns, oid, _rel) in self._graph.tuples
            })
            obj_offs = np.zeros((2 * relv + 1,), np.int64)
            keys_out: list[int] = []
            pairs_out: list[int] = []
            for v in range(relv):
                path = None
                if v < len(vocab):
                    try:
                        path = parse_path(vocab[v])
                    except ValueError:
                        path = None
                for plane in range(2):
                    idx = v * 2 + plane
                    if path is not None:
                        seg = []
                        for ns, oid in candidates:
                            users = self._users(
                                path.alts, plane == 1, ns, oid
                            )
                            if users:
                                key = (
                                    (np.int64(intern(ns)) << 32)
                                    | np.int64(intern(oid))
                                )
                                seg.append((int(key), users))
                        seg.sort(key=lambda kv: kv[0])
                        for key, users in seg:
                            row = len(keys_out)
                            keys_out.append(key)
                            for sid in sorted(intern(u) for u in users):
                                pairs_out.append((row << 32) | sid)
                    obj_offs[idx + 1] = len(keys_out)
            tables = {
                "obj_offs": obj_offs,
                "obj_keys": np.array(keys_out, np.int64),
                "pairs": np.array(pairs_out, np.int64),
            }
            self._tables_cache[space] = (sig, source, tables)
            return tables

    # ------------------------------------------------------- replication
    def _emit(self, event_name: str, payload: dict) -> None:
        if self._topic is None:
            return
        message = {"payload": payload, "origin": self.origin}
        if self.tenant is not None:
            message["tenant"] = self.tenant
        try:
            self._topic.emit(event_name, message)
        except Exception:  # noqa: BLE001 — the local write already landed
            if self.logger:
                self.logger.exception("relation frame emit failed")

    def replay(self) -> int:
        """Boot replay: apply the full topic log (idempotent adds/removes
        converge to the log's final state).  Returns frames applied."""
        if self._topic is None:
            return 0
        applied = 0
        for event_name, message in self._topic.read(0):
            if self._apply_frame(event_name, message):
                applied += 1
        return applied

    def start_replication(self) -> "RelationTupleStore":
        """Subscribe live (after :meth:`replay`): frames from OTHER
        origins apply to the local graph; own frames were applied at CRUD
        time and are skipped."""
        if self._topic is not None:
            self._topic.on(self._on_event,
                           starting_offset=self._topic.offset)
        return self

    def _on_event(self, event_name: str, message, ctx: dict) -> None:
        if self._stopped:
            return
        if self._apply_frame(event_name, message):
            self._count("frames_replicated")

    def _apply_frame(self, event_name: str, message) -> bool:
        """One journal frame -> local mutation; False for own-origin,
        other-tenant, or malformed frames (all skipped, never fatal)."""
        if not isinstance(message, dict):
            return False
        if message.get("origin") == self.origin:
            return False
        if message.get("tenant") != self.tenant:
            return False  # another tenant's tuples: isolation on a shared log
        payload = message.get("payload")
        if not isinstance(payload, dict):
            return False
        try:
            if event_name == "relationTupleCreated":
                ns, oid, rel, subj = _tuple_from_doc(payload)
                with self._lock:
                    if not self._graph.add(ns, oid, rel, subj):
                        return False
                    self._invalidate_node((ns, oid, rel))
                    gen = self._bump()
            elif event_name == "relationTupleDeleted":
                ns, oid, rel, subj = _tuple_from_doc(payload)
                with self._lock:
                    if not self._graph.remove(ns, oid, rel, subj):
                        return False
                    self._invalidate_node((ns, oid, rel))
                    gen = self._bump()
            elif event_name == "relationRewriteModified":
                ns = str(payload["namespace"])
                rel = str(payload["relation"])
                rules = [normalize_rule(r) for r in payload["rules"]]
                with self._lock:
                    self._graph.set_rewrite(ns, rel, rules)
                    self._invalidate_rule((ns, rel))
                    gen = self._bump()
            else:
                return False
        except (KeyError, TypeError, ValueError):
            if self.logger:
                self.logger.warning(
                    "malformed relation frame skipped",
                    extra={"event": event_name},
                )
            return False
        self._notify(gen)
        return True

    def stop(self) -> None:
        self._stopped = True

    # ------------------------------------------------------ observability
    def fingerprint(self) -> str:
        """Digest of the full tuple/rewrite state: two replicas that
        applied the same journal converge to equal fingerprints."""
        with self._lock:
            cached = self._fp_cache
            if cached is not None and cached[0] == self._gen:
                return cached[1]
            h = blake2b(digest_size=16)
            for key in sorted(self._graph.tuples):
                for subj in sorted(self._graph.tuples[key]):
                    h.update(repr((key, subj)).encode())
            for rk in sorted(self._graph.rewrites):
                h.update(repr((rk, self._graph.rewrites[rk])).encode())
            out = h.hexdigest()
            self._fp_cache = (self._gen, out)
            return out

    @property
    def generation(self) -> int:
        return self._gen

    def stats(self) -> dict:
        with self._lock:
            return {
                "tuples": sum(
                    len(b) for b in self._graph.tuples.values()
                ),
                "rewrites": len(self._graph.rewrites),
                "generation": self._gen,
                "closure_entries": len(self._memo),
                "closure_invalidated": self._invalidated,
                "fingerprint": self.fingerprint(),
            }

    def check(self, expr: str, namespace: str, object_id: str,
              subject_id: str) -> bool:
        """One cached-closure verdict (the API-level check endpoint);
        bit-identical to core.relation_path.check_relation_path."""
        path = parse_path(expr)
        with self._lock:
            return subject_id in self._users(
                path.alts, path.direct, namespace, object_id
            )

    def witness(self, expr: str, namespace: str, object_id: str,
                subject_id: str) -> Optional[list[str]]:
        """The tuple-path provenance for a passing relation check: a
        human-readable hop list from the object to the subject, or None
        when the check fails."""
        try:
            path = parse_path(expr)
        except ValueError:
            return None
        with self._lock:
            graph = self._graph
            for alt in path.alts:
                frontier: dict[tuple, list[str]] = {
                    (namespace, object_id): []
                }
                for step in alt[:-1]:
                    nxt: dict[tuple, list[str]] = {}
                    for (n, o), hops in frontier.items():
                        visited: set = set()
                        for tgt in _reach_objects(
                            graph, n, o, step, path.direct, visited
                        ):
                            if tgt not in nxt:
                                nxt[tgt] = hops + [
                                    f"{n}:{o}#{step} -> {tgt[0]}:{tgt[1]}"
                                ]
                    frontier = nxt
                    if not frontier:
                        break
                if not frontier:
                    continue
                last = alt[-1]
                for (n, o), hops in frontier.items():
                    visited = set()
                    if subject_id in _reach_users(
                        graph, n, o, last, path.direct, visited
                    ):
                        return hops + [f"{n}:{o}#{last}@{subject_id}"]
        return None
