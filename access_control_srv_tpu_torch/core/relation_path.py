"""Relationship-path matching: the scalar ReBAC oracle.

Zanzibar-style relationship tuples (``object#relation@subject``) with
userset-rewrite rules, plus the path-expression grammar policy targets use
to require a relation between the request subject and the targeted
resource instances:

    expr  := alt ('|' alt)* ('!direct')?
    alt   := step ('.' step)*
    step  := relation name

``viewer`` requires the subject to reach the object through the
``viewer`` relation (rewrites and userset subjects included);
``parent.viewer`` first walks object-valued ``parent`` subjects, then
checks ``viewer`` on the reached objects; ``owner|editor`` passes on
either relation; a trailing ``!direct`` disables rewrite rules and
userset expansion (literal tuples only) — the relation analog of the
``hierarchicalRoleScoping=false`` owner-scope switch.

This module is the differential oracle for the packed-bitplane kernel
path (ops/relation.py): a deliberately naive recursive evaluator over a
plain tuple list, cycle-safe via a visited set, with none of the
memoization/incremental machinery of the serving store
(srv/relations.py).  Decisions must be bit-identical between the two.

Target-level semantics mirror the HR-scope check they ride next to
(check_hierarchical_scope): the relation requirement is carried as a
subject attribute (``urns['relation']``), the checked instances are the
request's resource-id attributes collected under the rule's sticky
entity-match state, a row with no collected instances passes vacuously,
and ALL collected instances must pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Union

from .common import get_field as _get
from .hierarchical_scope import regex_entity_compare

# normalized subject kinds
USER = 0      # plain subject id
OBJECT = 1    # object reference {"object": {"entity":..., "id":...}}
USERSET = 2   # object reference + "relation" (members of that userset)


@dataclass(frozen=True)
class RelationPath:
    """Parsed path expression: alternatives of step sequences."""

    alts: tuple[tuple[str, ...], ...]
    direct: bool = False

    @property
    def expr(self) -> str:
        text = "|".join(".".join(alt) for alt in self.alts)
        return text + ("!direct" if self.direct else "")


_PATH_CACHE: dict[str, RelationPath] = {}


def parse_path(expr: str) -> RelationPath:
    """Parse a path expression; raises ValueError on empty steps."""
    hit = _PATH_CACHE.get(expr)
    if hit is not None:
        return hit
    text = (expr or "").strip()
    direct = False
    if text.endswith("!direct"):
        direct = True
        text = text[: -len("!direct")].strip()
    alts = []
    for alt in text.split("|"):
        steps = tuple(s.strip() for s in alt.split("."))
        if not steps or any(not s for s in steps):
            raise ValueError(f"invalid relation path {expr!r}")
        alts.append(steps)
    if not alts:
        raise ValueError(f"invalid relation path {expr!r}")
    out = RelationPath(alts=tuple(alts), direct=direct)
    if len(_PATH_CACHE) < 65536:
        _PATH_CACHE[expr] = out
    return out


def normalize_subject(subject) -> tuple:
    """Wire subject -> (kind, ...) tuple.

    str                                   -> (USER, id)
    {"object": {"entity": e, "id": i}}    -> (OBJECT, e, i)
    ... + {"relation": r}                 -> (USERSET, e, i, r)
    """
    if isinstance(subject, tuple):
        return subject  # already normalized
    if isinstance(subject, str):
        return (USER, subject)
    obj = _get(subject, "object")
    if obj is None:
        sid = _get(subject, "id")
        if isinstance(sid, str):
            return (USER, sid)
        raise ValueError(f"malformed relation subject {subject!r}")
    ent = _get(obj, "entity")
    oid = _get(obj, "id")
    if not isinstance(ent, str) or not isinstance(oid, str):
        raise ValueError(f"malformed relation subject {subject!r}")
    rel = _get(subject, "relation")
    if rel:
        return (USERSET, ent, oid, rel)
    return (OBJECT, ent, oid)


# userset-rewrite rule kinds (the Zanzibar core three; enough for the
# document/folder/group sharing scenario)
THIS = ("this",)


def normalize_rule(rule) -> tuple:
    """Config-shaped rewrite rule -> internal tuple.

    ("this",) / ("computed_userset", rel) /
    ("tuple_to_userset", tupleset_rel, computed_rel); dict forms use a
    "kind" discriminator with "relation" / "tupleset" fields."""
    if isinstance(rule, (tuple, list)):
        out = tuple(rule)
    else:
        kind = _get(rule, "kind")
        if kind == "this":
            out = THIS
        elif kind == "computed_userset":
            out = ("computed_userset", _get(rule, "relation"))
        elif kind == "tuple_to_userset":
            out = ("tuple_to_userset", _get(rule, "tupleset"),
                   _get(rule, "relation"))
        else:
            raise ValueError(f"unknown rewrite rule {rule!r}")
    if out[0] not in ("this", "computed_userset", "tuple_to_userset"):
        raise ValueError(f"unknown rewrite rule {out!r}")
    if out[0] == "computed_userset" and len(out) != 2:
        raise ValueError(f"malformed rewrite rule {out!r}")
    if out[0] == "tuple_to_userset" and len(out) != 3:
        raise ValueError(f"malformed rewrite rule {out!r}")
    return out


@dataclass
class RelationGraph:
    """Plain in-memory tuple graph: the oracle's substrate.

    ``tuples``: (namespace, object_id, relation) -> list of normalized
    subjects in insertion order; ``rewrites``: (namespace, relation) ->
    list of normalized rewrite rules (absent -> [("this",)])."""

    tuples: dict[tuple[str, str, str], list[tuple]] = field(
        default_factory=dict
    )
    rewrites: dict[tuple[str, str], list[tuple]] = field(default_factory=dict)

    def add(self, namespace: str, object_id: str, relation: str, subject
            ) -> bool:
        """Insert one tuple; returns False when it was already present."""
        norm = normalize_subject(subject)
        key = (namespace, object_id, relation)
        bucket = self.tuples.setdefault(key, [])
        if norm in bucket:
            return False
        bucket.append(norm)
        return True

    def remove(self, namespace: str, object_id: str, relation: str, subject
               ) -> bool:
        norm = normalize_subject(subject)
        key = (namespace, object_id, relation)
        bucket = self.tuples.get(key)
        if not bucket or norm not in bucket:
            return False
        bucket.remove(norm)
        if not bucket:
            del self.tuples[key]
        return True

    def set_rewrite(self, namespace: str, relation: str, rules) -> None:
        self.rewrites[(namespace, relation)] = [
            normalize_rule(r) for r in rules
        ]

    def subjects_of(self, namespace: str, object_id: str, relation: str
                    ) -> list[tuple]:
        return self.tuples.get((namespace, object_id, relation), ())

    def rules_of(self, namespace: str, relation: str) -> list[tuple]:
        return self.rewrites.get((namespace, relation), (THIS,))


def _reach_users(graph: RelationGraph, ns: str, oid: str, rel: str,
                 direct: bool, visited: set) -> set[str]:
    """All plain user ids reachable from (ns, oid, rel).  ``direct``
    restricts to literal tuples (no rewrites, no userset expansion).
    Cycle-safe: a (ns, oid, rel) node expands at most once per query; the
    shared visited set is sound because every expansion's contribution is
    unioned into the same result regardless of which branch reached it."""
    key = (ns, oid, rel)
    if key in visited:
        return set()
    visited.add(key)
    out: set[str] = set()
    rules = (THIS,) if direct else graph.rules_of(ns, rel)
    for rule in rules:
        if rule[0] == "this":
            for s in graph.subjects_of(ns, oid, rel):
                if s[0] == USER:
                    out.add(s[1])
                elif s[0] == USERSET and not direct:
                    out |= _reach_users(graph, s[1], s[2], s[3], direct,
                                        visited)
        elif rule[0] == "computed_userset":
            out |= _reach_users(graph, ns, oid, rule[1], direct, visited)
        elif rule[0] == "tuple_to_userset":
            for s in graph.subjects_of(ns, oid, rule[1]):
                if s[0] in (OBJECT, USERSET):
                    out |= _reach_users(graph, s[1], s[2], rule[2], direct,
                                        visited)
    return out


def _reach_objects(graph: RelationGraph, ns: str, oid: str, rel: str,
                   direct: bool, visited: set) -> set[tuple[str, str]]:
    """All (namespace, object_id) pairs reachable from (ns, oid, rel):
    the intermediate-step traversal of multi-step paths.  Object-valued
    subjects are the frontier; userset subjects and rewrite rules expand
    like _reach_users unless ``direct``."""
    key = (ns, oid, rel)
    if key in visited:
        return set()
    visited.add(key)
    out: set[tuple[str, str]] = set()
    rules = (THIS,) if direct else graph.rules_of(ns, rel)
    for rule in rules:
        if rule[0] == "this":
            for s in graph.subjects_of(ns, oid, rel):
                if s[0] == OBJECT:
                    out.add((s[1], s[2]))
                elif s[0] == USERSET and not direct:
                    out |= _reach_objects(graph, s[1], s[2], s[3], direct,
                                          visited)
        elif rule[0] == "computed_userset":
            out |= _reach_objects(graph, ns, oid, rule[1], direct, visited)
        elif rule[0] == "tuple_to_userset":
            for s in graph.subjects_of(ns, oid, rule[1]):
                if s[0] in (OBJECT, USERSET):
                    out |= _reach_objects(graph, s[1], s[2], rule[2],
                                          direct, visited)
    return out


def check_relation_path(
    path: Union[str, RelationPath],
    namespace: str,
    object_id: str,
    subject_id: Optional[str],
    graph: Optional[RelationGraph],
) -> bool:
    """True when ``subject_id`` reaches (namespace, object_id) through any
    alternative of ``path``.  A missing graph behaves as an empty tuple
    set (fail-closed); a missing subject never matches."""
    if not isinstance(subject_id, str):
        return False
    if graph is None:
        return False
    p = parse_path(path) if isinstance(path, str) else path
    for alt in p.alts:
        frontier = {(namespace, object_id)}
        for step in alt[:-1]:
            visited: set = set()
            nxt: set[tuple[str, str]] = set()
            for n, o in frontier:
                nxt |= _reach_objects(graph, n, o, step, p.direct, visited)
            frontier = nxt
            if not frontier:
                break
        if not frontier:
            continue
        visited = set()
        last = alt[-1]
        if any(
            subject_id in _reach_users(graph, n, o, last, p.direct, visited)
            for n, o in frontier
        ):
            return True
    return False


def relation_paths(subjects, urns) -> list[str]:
    """The relation-path expressions carried by a target's subject
    attributes (id == urns['relation'])."""
    relation_urn = urns.get("relation")
    return [
        a.value for a in subjects or []
        if a is not None and a.id == relation_urn and a.value
    ]


def collect_target_instances(rule_target, request, urns
                             ) -> list[tuple[str, str]]:
    """(namespace, instance_id) pairs of the request resource-ids the
    relation requirement applies to, under the SAME sticky entity-match
    walk the HR-scope check uses (reference: hierarchicalScope.ts:64-102;
    kernel analog: ops/kernel._hr_collect_state) — only instances whose
    run the rule's entity attributes matched are checked.  The namespace
    is the REQUEST run's entity URN (the tuple-store namespace), not the
    rule's possibly-regex entity value."""
    entity_urn = urns.get("entity")
    resource_id_urn = urns.get("resourceID")
    req_resources = (request.target.resources or []) if request.target else []
    collected: list[tuple[str, str]] = []
    seen: set[tuple[str, str]] = set()
    for attribute in (rule_target.resources or []) if rule_target else []:
        if attribute.id != entity_urn:
            continue
        rule_value = attribute.value
        entities_match = False
        current_ns: Optional[str] = None
        for request_attribute in req_resources:
            if request_attribute.id == entity_urn:
                current_ns = request_attribute.value
                if request_attribute.value == rule_value:
                    entities_match = True
                else:
                    set_flag, prefix_mismatch = regex_entity_compare(
                        rule_value, request_attribute.value
                    )
                    if prefix_mismatch:
                        entities_match = False
                    if set_flag:
                        entities_match = True
            elif (
                request_attribute.id == resource_id_urn
                and entities_match
                and current_ns is not None
            ):
                pair = (current_ns, request_attribute.value)
                if pair not in seen:
                    seen.add(pair)
                    collected.append(pair)
    return collected


def request_subject_id(request) -> Optional[str]:
    """The request's subject id string as the tuple graph keys it, or
    None — the same extraction the target-level relation gate uses, so
    explain-mode witnesses query the graph with the exact key that
    decided the row."""
    subject = _get(request.context, "subject") if request.context else None
    subject_id = _get(subject, "id") if subject else None
    return subject_id if isinstance(subject_id, str) else None


def check_target_relations(
    rule_target,
    request,
    graph: Optional[RelationGraph],
    urns,
) -> bool:
    """The target-level relation gate: every path expression on the rule
    target must hold for EVERY collected instance; no relation attributes
    or no collected instances pass vacuously.  Rides the same two engine
    gate sites as check_hierarchical_scope (core/engine.py)."""
    paths = relation_paths(rule_target.subjects if rule_target else None,
                           urns)
    if not paths:
        return True
    instances = collect_target_instances(rule_target, request, urns)
    if not instances:
        return True
    subject_id = request_subject_id(request)
    if subject_id is None:
        return False
    for expr in paths:
        path = parse_path(expr)
        for ns, oid in instances:
            if not check_relation_path(path, ns, oid, subject_id, graph):
                return False
    return True
