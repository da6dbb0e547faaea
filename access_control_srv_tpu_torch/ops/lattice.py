"""Permission-lattice enumeration, combining-fold, snapshots and diffs.

A copy of the JAX package's ``ops/lattice.py`` (host-only: it never
touches the device; a sweep rides the reverse-query kernel through
``srv/audit_sweep.py``).

The policy-mining literature (PAPERS.md: LLMAC, DLBAC) consumes
*effective-permission matrices* -- "who can do what" over a subject x
resource x action lattice.  The reverse-query kernel (ops/reverse.py)
answers one lattice cell per request; this module supplies everything
around it that stays on the host:

- :class:`LatticeSpec` -- the three axes plus the attribute URNs used to
  synthesize one ``whatIsAllowed`` request per cell, with a chunked
  request iterator for bounded-memory sweeps.
- :func:`fold_reverse_query` -- collapses a ``ReverseQuery`` tree into a
  per-cell verdict by replaying the engine's combining algorithms
  (core/engine.py ``decide``) over the matched rules, carrying the
  deciding rule id into the snapshot.
- :class:`SnapshotWriter` / :func:`load_snapshot` -- a streamed JSONL
  snapshot (header + sparse cell lines + summary footer, axis values
  masked like the decision-audit log) and a packed 2-bit bitmap sidecar
  (4 cells/byte) for compact machine diffing.
- :func:`diff_snapshots` -- cross-version diff naming, per changed cell,
  the deciding rule on both sides.

Verdicts are an *optimistic* bound for conditional rules: ``whatIsAllowed``
returns matched rules without evaluating conditions, so any cell whose
winning tree contains a rule with a condition (or context query) is
flagged ``conditional`` and coded separately in the bitmap -- exactly the
caveat the reference PDP documents for whatIsAllowed consumers.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional

import numpy as np

from ..models.model import (
    Attribute,
    Decision,
    Effect,
    Request,
    ReverseQuery,
    Target,
)
from ..models.urns import DEFAULT_URNS

SNAPSHOT_KIND = "acs-lattice-snapshot"
SNAPSHOT_VERSION = 1

# 2-bit bitmap codes (4 cells per byte, subject-major cell order)
CODE_NOT_APPLICABLE = 0
CODE_PERMIT = 1
CODE_DENY = 2
CODE_CONDITIONAL = 3

_MASK = "***"

# combining-algorithm resolution: full XACML URNs (core/engine.py
# DEFAULT_COMBINING_ALGORITHMS), the loader's camelCase aliases, and the
# bare method names custom registrations commonly map to.
_COMBINING_METHODS = {
    "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides":
        "deny_overrides",
    "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides":
        "permit_overrides",
    "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable":
        "first_applicable",
    "denyOverrides": "deny_overrides",
    "permitOverrides": "permit_overrides",
    "firstApplicable": "first_applicable",
    "deny_overrides": "deny_overrides",
    "permit_overrides": "permit_overrides",
    "first_applicable": "first_applicable",
}


# attribute ids whose values are secrets (the JAX package's
# srv/telemetry.MASK_FIELDS, lowered)
_MASK_FIELDS = tuple(f.lower() for f in (
    "password", "token", "apiKey", "api_key", "authorization"))


def mask_value(attr_id: str, value: Any) -> Any:
    """The decision-audit-log masking rule (srv/tracing.DecisionAuditLog):
    a value whose attribute id names a secret is replaced with ``***``
    before it can reach an exported artifact."""
    lowered = str(attr_id).lower()
    if any(f in lowered for f in _MASK_FIELDS):
        return _MASK
    return value


# ------------------------------------------------------------------ lattice


@dataclass(frozen=True)
class LatticeSpec:
    """The audit lattice: ``subjects`` are ``(subject_id, role)`` pairs,
    ``resources`` are ``(resource_id, entity_urn)`` pairs, ``actions``
    are action URNs.  Cell order is subject-major:
    ``index = (si * len(resources) + ri) * len(actions) + ai``."""

    subjects: tuple
    resources: tuple
    actions: tuple
    subject_id_urn: str = DEFAULT_URNS["subjectID"]
    role_urn: str = DEFAULT_URNS["role"]
    entity_urn: str = DEFAULT_URNS["entity"]
    action_urn: str = DEFAULT_URNS["actionID"]

    @property
    def shape(self) -> tuple:
        return (len(self.subjects), len(self.resources), len(self.actions))

    @property
    def n_cells(self) -> int:
        s, r, a = self.shape
        return s * r * a

    def unravel(self, index: int) -> tuple:
        n_r, n_a = len(self.resources), len(self.actions)
        ai = index % n_a
        ri = (index // n_a) % n_r
        si = index // (n_a * n_r)
        return si, ri, ai

    def request(self, index: int) -> Request:
        """One wia request per cell, in the shape the reverse query's
        differential suite pins (role + subjectID subject attributes,
        entity resource attribute, actionID action attribute, and the
        role association mirrored into the context)."""
        si, ri, ai = self.unravel(index)
        subject_id, role = self.subjects[si]
        _, entity = self.resources[ri]
        action = self.actions[ai]
        subjects = []
        if role:
            subjects.append(Attribute(id=self.role_urn, value=role))
        subjects.append(Attribute(id=self.subject_id_urn, value=subject_id))
        return Request(
            target=Target(
                subjects=subjects,
                resources=[Attribute(id=self.entity_urn, value=entity)],
                actions=[Attribute(id=self.action_urn, value=action)],
            ),
            context={
                "resources": [],
                "subject": {
                    "id": subject_id,
                    "role_associations": (
                        [{"role": role, "attributes": []}] if role else []
                    ),
                    "hierarchical_scopes": [],
                },
            },
        )

    def chunks(self, chunk_size: int, start: int = 0) -> Iterator[list]:
        """Bounded-memory enumeration: yields lists of ``(index, Request)``
        of at most ``chunk_size`` cells; only one chunk is ever alive."""
        chunk_size = max(1, int(chunk_size))
        chunk: list = []
        for index in range(start, self.n_cells):
            chunk.append((index, self.request(index)))
            if len(chunk) >= chunk_size:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    # --------------------------------------------------------- constructors

    @classmethod
    def stress(
        cls,
        n_subjects: int,
        n_resources: int,
        actions: tuple = ("read",),
        roles: int = 97,
        entities: int = 64,
        urns=None,
    ) -> "LatticeSpec":
        """The synthetic-stress-tree lattice (bench_all._stress_doc):
        subjects cycle ``role-{0..roles-1}``, resources cycle the
        ``stress{0..entities-1}`` entity types, actions resolve through
        the URN registry (bare names like ``"read"`` or full URNs)."""
        from ..models import Urns

        urns = urns or Urns()
        subjects = tuple(
            (f"u{i}", f"role-{i % roles}") for i in range(int(n_subjects))
        )
        resources = tuple(
            (
                f"res{i}",
                "urn:restorecommerce:acs:model:"
                f"stress{i % entities}.Stress{i % entities}",
            )
            for i in range(int(n_resources))
        )
        resolved = tuple(
            a if ":" in a else urns[a] for a in tuple(actions)
        )
        return cls(subjects=subjects, resources=resources, actions=resolved)

    @classmethod
    def from_config(cls, block: dict, urns=None) -> "LatticeSpec":
        """Config-file lattice grammar (docs/AUDIT.md): each axis is
        either an integer (stress-shaped synthetic axis) or an explicit
        list — subjects ``{"id": ..., "role": ...}``, resources
        ``{"id": ..., "entity": ...}``, actions bare names or URNs.
        Optional ``*_urn`` keys override the attribute ids (masked like
        every audit attribute if they name a secret)."""
        from ..models import Urns

        urns = urns or Urns()
        block = block or {}

        raw_s = block.get("subjects", 16)
        if isinstance(raw_s, int):
            subjects = tuple((f"u{i}", f"role-{i % 97}") for i in range(raw_s))
        else:
            subjects = tuple(
                (str(s.get("id", f"u{i}")), s.get("role"))
                if isinstance(s, dict) else (str(s), None)
                for i, s in enumerate(raw_s)
            )
        raw_r = block.get("resources", 16)
        if isinstance(raw_r, int):
            resources = tuple(
                (
                    f"res{i}",
                    "urn:restorecommerce:acs:model:"
                    f"stress{i % 64}.Stress{i % 64}",
                )
                for i in range(raw_r)
            )
        else:
            resources = tuple(
                (str(r.get("id", f"res{i}")), str(r.get("entity", "")))
                if isinstance(r, dict) else (f"res{i}", str(r))
                for i, r in enumerate(raw_r)
            )
        raw_a = block.get("actions", ["read"])
        actions = tuple(a if ":" in a else urns[a] for a in raw_a)
        kwargs = {}
        for key in ("subject_id_urn", "role_urn", "entity_urn", "action_urn"):
            if block.get(key):
                kwargs[key] = str(block[key])
        return cls(
            subjects=subjects, resources=resources, actions=actions, **kwargs
        )

    def masked_axes(self) -> dict:
        """Axis metadata for the snapshot header, with every value passed
        through the audit-log masking rule keyed on its attribute URN —
        a secret-named subject-id URN (tokens as principals) can never
        leak principal values into an exported matrix."""
        return {
            "subjects": [
                {
                    "id": mask_value(self.subject_id_urn, sid),
                    "role": mask_value(self.role_urn, role),
                }
                for sid, role in self.subjects
            ],
            "resources": [
                {
                    "id": mask_value(self.entity_urn, rid),
                    "entity": mask_value(self.entity_urn, entity),
                }
                for rid, entity in self.resources
            ],
            "actions": [mask_value(self.action_urn, a) for a in self.actions],
        }


# --------------------------------------------------------------------- fold


@dataclass(frozen=True)
class CellVerdict:
    """One lattice cell: the folded decision, the deciding rule (or
    no-rules policy) id, and whether any contributing rule carries an
    unevaluated condition/context query (optimistic bound)."""

    decision: str
    rule_id: Optional[str] = None
    conditional: bool = False
    shed_code: Optional[int] = None

    @property
    def code(self) -> int:
        if self.conditional and self.decision in (
            Decision.PERMIT, Decision.DENY
        ):
            return CODE_CONDITIONAL
        if self.decision == Decision.PERMIT:
            return CODE_PERMIT
        if self.decision == Decision.DENY:
            return CODE_DENY
        return CODE_NOT_APPLICABLE


def _decide(algorithm: str, effects: list, combining_map) -> Optional[tuple]:
    """The engine's ``decide`` over ``(effect, source, conditional)``
    triples (core/engine.py:890-970 semantics, byte-for-byte):
    deny-overrides takes the FIRST DENY else the LAST effect,
    permit-overrides symmetrically, first-applicable the first.  The
    result is conditional when *any* collected effect is — a condition
    flipping any contributor could change which effect wins."""
    method = None
    if combining_map:
        method = combining_map.get(algorithm)
    if method is None:
        method = _COMBINING_METHODS.get(algorithm)
    if method is None:
        return None
    conditional = any(c for _, _, c in effects)
    if method == "first_applicable":
        chosen = effects[0]
    elif method == "deny_overrides":
        chosen = effects[-1]
        for e in effects:
            if e[0] == Effect.DENY:
                chosen = e
                break
    elif method == "permit_overrides":
        chosen = effects[-1]
        for e in effects:
            if e[0] == Effect.PERMIT:
                chosen = e
                break
    else:
        return None
    return (chosen[0], chosen[1], conditional)


def fold_reverse_query(
    rq: ReverseQuery, combining_map: Optional[dict] = None
) -> CellVerdict:
    """Collapse a ``whatIsAllowed`` tree to the decision ``isAllowed``
    would reach on the same request, replaying the engine's collection
    order: matched rules fold under the policy's combining algorithm,
    a matched no-rules policy contributes its own effect, policies fold
    under the set's algorithm, and across sets the LAST set with effects
    wins (the engine's cross-set overwrite).  ``combining_map`` extends
    URN resolution for custom registrations (ShadowEvaluator's
    ``combining_algorithms``); an unresolvable algorithm yields an
    honest INDETERMINATE, never a guess."""
    status = getattr(rq, "operation_status", None)
    if status is not None and getattr(status, "code", 200) != 200:
        return CellVerdict(
            Decision.INDETERMINATE, shed_code=int(status.code)
        )
    winning: Optional[tuple] = None
    unresolved = False
    for policy_set in rq.policy_sets:
        policy_effects: list = []
        for policy in policy_set.policies:
            if policy.rules:
                rule_effects = [
                    (
                        rule.effect,
                        rule.id,
                        bool(rule.condition) or rule.context_query is not None,
                    )
                    for rule in policy.rules
                    if rule.effect
                ]
                if rule_effects:
                    folded = _decide(
                        policy.combining_algorithm, rule_effects,
                        combining_map,
                    )
                    if folded is None:
                        unresolved = True
                    else:
                        policy_effects.append(folded)
            elif policy.effect and not policy.has_rules:
                # a rule-less policy matched on its own target: its
                # effect stands in for a rule (engine.py:285-292)
                policy_effects.append((policy.effect, policy.id, False))
        if policy_effects:
            folded = _decide(
                policy_set.combining_algorithm, policy_effects, combining_map
            )
            if folded is None:
                unresolved = True
            else:
                winning = folded
    if winning is None:
        return CellVerdict(Decision.INDETERMINATE, conditional=unresolved)
    return CellVerdict(
        Decision.from_effect(winning[0]), winning[1], winning[2]
    )


# ----------------------------------------------------------------- snapshot


class SnapshotWriter:
    """Streamed effective-permission snapshot: one JSONL file (header,
    sparse cell lines referencing axis *indices* only, summary footer)
    plus a packed 2-bit bitmap sidecar.  Memory is O(n_cells / 4) for
    the bitmap — never O(cells) of JSON — so a 1k x 1k sweep holds
    ~250 KiB regardless of how it is chunked."""

    def __init__(
        self,
        path: str,
        spec: LatticeSpec,
        source: str = "production",
        policy_epoch: Optional[int] = None,
        meta: Optional[dict] = None,
    ):
        self.path = str(path)
        self.bitmap_path = self.path + ".bits.npy"
        self.spec = spec
        self._codes = np.zeros(spec.n_cells, dtype=np.uint8)
        self._counts = {
            "cells": 0, "permit": 0, "deny": 0, "conditional": 0,
            "indeterminate": 0, "sheds": 0,
        }
        self._closed = False
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "w", encoding="utf-8")
        header = {
            "kind": SNAPSHOT_KIND,
            "version": SNAPSHOT_VERSION,
            "source": source,
            "policy_epoch": policy_epoch,
            "shape": list(spec.shape),
            "order": "subject-major",
            "bitmap": {
                "path": os.path.basename(self.bitmap_path),
                "bits_per_cell": 2,
                "codes": {
                    "not_applicable": CODE_NOT_APPLICABLE,
                    "permit": CODE_PERMIT,
                    "deny": CODE_DENY,
                    "conditional": CODE_CONDITIONAL,
                },
            },
            "axes": spec.masked_axes(),
        }
        if meta:
            header["meta"] = meta
        self._fh.write(json.dumps(header, default=repr) + "\n")

    def write(self, index: int, verdict: CellVerdict) -> None:
        """Record one cell.  NOT_APPLICABLE cells stay implicit (bitmap
        zero, no JSONL line) — the sparse encoding that keeps a mostly
        empty matrix small; sheds are written explicitly so an audit
        consumer can distinguish 'no access' from 'not measured'."""
        self._counts["cells"] += 1
        code = verdict.code
        self._codes[index] = code
        if verdict.shed_code is not None:
            self._counts["sheds"] += 1
            row = {
                "c": list(self.spec.unravel(index)),
                "d": verdict.decision,
                "s": verdict.shed_code,
            }
        elif code == CODE_NOT_APPLICABLE:
            self._counts["indeterminate"] += 1
            return
        else:
            key = {
                CODE_PERMIT: "permit", CODE_DENY: "deny",
                CODE_CONDITIONAL: "conditional",
            }[code]
            self._counts[key] += 1
            row = {
                "c": list(self.spec.unravel(index)),
                "d": verdict.decision,
                "r": verdict.rule_id,
            }
            if verdict.conditional:
                row["q"] = True
        self._fh.write(json.dumps(row) + "\n")

    def close(self) -> dict:
        if self._closed:
            return dict(self._counts)
        self._closed = True
        summary = {"kind": "acs-lattice-summary", **self._counts}
        self._fh.write(json.dumps(summary) + "\n")
        self._fh.close()
        np.save(self.bitmap_path, pack_codes(self._codes))
        return dict(self._counts)


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """2-bit pack: 4 cells per byte, cell ``i`` at bits ``2*(i%4)``."""
    codes = np.asarray(codes, dtype=np.uint8)
    pad = (-len(codes)) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)])
    lanes = codes.reshape(-1, 4)
    packed = np.zeros(len(lanes), dtype=np.uint8)
    for lane in range(4):
        packed |= (lanes[:, lane] & 0x3) << (2 * lane)
    return packed


def unpack_codes(packed: np.ndarray, n_cells: int) -> np.ndarray:
    packed = np.asarray(packed, dtype=np.uint8)
    out = np.zeros(len(packed) * 4, dtype=np.uint8)
    for lane in range(4):
        out[lane::4] = (packed >> (2 * lane)) & 0x3
    return out[:n_cells]


def load_bitmap(path: str, n_cells: int) -> np.ndarray:
    return unpack_codes(np.load(path), n_cells)


def load_snapshot(path: str) -> tuple:
    """Read a snapshot JSONL: ``(header, cells, summary)`` where cells
    maps ``(si, ri, ai)`` -> the sparse cell dict."""
    header: Optional[dict] = None
    summary: Optional[dict] = None
    cells: dict = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            if row.get("kind") == SNAPSHOT_KIND:
                header = row
            elif row.get("kind") == "acs-lattice-summary":
                summary = row
            else:
                cells[tuple(row["c"])] = row
    if header is None:
        raise ValueError(f"{path}: not an {SNAPSHOT_KIND} file")
    return header, cells, summary


# --------------------------------------------------------------------- diff


def diff_cells(cells_a: dict, cells_b: dict, limit: int = 4096) -> dict:
    """Cross-version diff over two sparse cell maps: every cell whose
    ``(decision, deciding rule)`` pair changed, with both sides named —
    the artifact a policy auditor reads to see exactly what a candidate
    tree would change.  ``limit`` bounds the enumerated cells (the
    summary counts stay exact); truncation is explicit, never silent."""
    changed = []
    transitions: dict = {}
    rules: set = set()
    truncated = 0
    for key in sorted(set(cells_a) | set(cells_b)):
        a, b = cells_a.get(key), cells_b.get(key)
        da = a.get("d", Decision.INDETERMINATE) if a else "NOT_APPLICABLE"
        db = b.get("d", Decision.INDETERMINATE) if b else "NOT_APPLICABLE"
        ra = a.get("r") if a else None
        rb = b.get("r") if b else None
        if da == db and ra == rb:
            continue
        transition = f"{da}->{db}"
        transitions[transition] = transitions.get(transition, 0) + 1
        for rule in (ra, rb):
            if rule:
                rules.add(rule)
        if len(changed) < limit:
            changed.append({
                "cell": list(key),
                "a": {"decision": da, "rule": ra},
                "b": {"decision": db, "rule": rb},
            })
        else:
            truncated += 1
    return {
        "cells_changed": sum(transitions.values()),
        "transitions": transitions,
        "rules": sorted(rules),
        "cells": changed,
        "truncated": truncated,
    }


def diff_snapshots(path_a: str, path_b: str, limit: int = 4096) -> dict:
    """Diff two snapshot files (same lattice shape required)."""
    header_a, cells_a, _ = load_snapshot(path_a)
    header_b, cells_b, _ = load_snapshot(path_b)
    if header_a.get("shape") != header_b.get("shape"):
        raise ValueError(
            "lattice shapes differ: "
            f"{header_a.get('shape')} vs {header_b.get('shape')}"
        )
    out = diff_cells(cells_a, cells_b, limit=limit)
    out["shape"] = header_a.get("shape")
    out["a"] = {
        "path": path_a,
        "source": header_a.get("source"),
        "policy_epoch": header_a.get("policy_epoch"),
    }
    out["b"] = {
        "path": path_b,
        "source": header_b.get("source"),
        "policy_epoch": header_b.get("policy_epoch"),
    }
    return out
