"""Policy compiler: lowers the PolicySet -> Policy -> Rule tree into dense
integer/bool tensors for the batched decision kernel.

Layout: a padded ``[S, KP, KR]`` tree (sets x max-policies x max-rules) so
the combining algorithms become masked reductions along static axes, plus a
flat target table of ``T`` rows (set/policy/rule targets) whose match bits
the kernel computes once per request and gathers per node.

Everything order-dependent in the reference is resolved at compile time:

- ``pol_eff_ctx``: the carried-over ``policyEffect`` visible when each
  policy's target is matched (reference: src/core/accessController.ts:130,
  138-148 — only ``policy.effect`` ever feeds it; the combining-algorithm
  branch is dead code);
- ``rule_cacheable_eff``: prefix-AND evaluation_cacheable semantics
  (reference: :202-211, 277-282);
- flat rule order for condition-abort priority (reference: :240-270 returns
  on the first aborting rule in set->policy->rule iteration order).

Trees outside the kernel's representable subset (attribute counts beyond
the caps, targets mixing multiple entities with properties, missing
combining algorithms on populated nodes) are flagged ``supported=False``
and served entirely by the scalar oracle.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.relation_path import parse_path
from ..models.model import PolicySet, Target
from ..models.urns import Urns
from .interner import ABSENT, StringInterner

# attribute-count caps per target row (tensor padding widths)
K_SUB = 6   # subject attribute pairs
K_ACT = 3   # action attribute pairs
K_ENT = 2   # entity attributes in resources
K_OP = 2    # operation attributes in resources
K_PROP = 12  # property attributes in resources

CA_CODES = {
    "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides": 0,
    "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides": 1,
    "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable": 2,
}

EFFECT_CODES = {None: 0, "": 0, "PERMIT": 1, "DENY": 2}

DECISION_NAMES = {0: "INDETERMINATE", 1: "PERMIT", 2: "DENY"}


@dataclass
class CompiledCondition:
    """A host-assisted rule predicate: the condition source plus its
    context query (pre-resolved per request before the kernel runs)."""

    rule_flat_index: int
    condition: str
    context_query: Optional[object] = None
    # identity path of the owning rule: ("rule", set_id, pol_key, rule_key)
    # — lets the delta patcher (ops/delta.py) re-home flat indices without
    # re-deriving ownership from the tree
    owner: Optional[tuple] = None


@dataclass
class CompiledPolicies:
    interner: StringInterner
    urns: Urns
    arrays: dict[str, np.ndarray]
    conditions: list[CompiledCondition]
    entity_vocab: list[str]          # distinct target entity values (regex rows)
    entity_vocab_ids: dict[int, int]  # interned value id -> vocab row
    # distinct relation-path expressions on target subjects (the ReBAC
    # bitplane vocabulary, ops/relation.py); host-only like entity_vocab
    rel_vocab: list[str] = field(default_factory=list)
    rel_vocab_ids: dict[int, int] = field(default_factory=dict)
    supported: bool = True
    unsupported_reason: str = ""
    S: int = 0
    KP: int = 0
    KR: int = 0
    T: int = 0
    version: int = 0
    # node identity -> target-table row, recorded during lowering
    # (("set", sid) / ("pol", sid, pkey) / ("rule", sid, pkey, rkey)):
    # the delta patcher's stable-slot map for in-place row rewrites
    target_owners: dict = field(default_factory=dict)

    @property
    def n_rules(self) -> int:
        return int(self.arrays["rule_valid"].sum()) if self.S else 0

    @property
    def has_hr_targets(self) -> bool:
        return bool(self.arrays["t_has_scoping"].any())

    @property
    def has_rel_targets(self) -> bool:
        t = self.arrays.get("t_rel_idx")
        return t is not None and bool((np.asarray(t) >= 0).any())


def _pad(values: list[int], width: int) -> list[int]:
    return (values + [ABSENT] * width)[:width]


# target-table column name -> (row dict key, numpy dtype); one source of
# truth shared by _TargetTable.to_arrays and the delta patcher's in-place
# row writer (ops/delta.py)
TARGET_COLUMNS: list[tuple[str, str, type]] = [
    ("t_n_subjects", "n_subjects", np.int32),
    ("t_role", "role", np.int32),
    ("t_has_role", "has_role", bool),
    ("t_scoping", "scoping", np.int32),
    ("t_has_scoping", "has_scoping", bool),
    ("t_hr_check", "hr_check", bool),
    ("t_skip_acl", "skip_acl", bool),
    ("t_sub_ids", "sub_ids", np.int32),
    ("t_sub_vals", "sub_vals", np.int32),
    ("t_act_ids", "act_ids", np.int32),
    ("t_act_vals", "act_vals", np.int32),
    ("t_ent_vals", "ent_vals", np.int32),
    ("t_ent_w", "ent_w", np.int32),
    ("t_ent_tails", "ent_tails", np.int32),
    ("t_op_vals", "op_vals", np.int32),
    ("t_prop_vals", "prop_vals", np.int32),
    ("t_prop_sfx", "prop_sfx", np.int32),
    ("t_has_props", "has_props", bool),
    ("t_n_res", "n_res", np.int32),
    # relation-path requirement (ReBAC, docs/REBAC.md): the interned path
    # expression (host-only routing, never shipped to device), its
    # relation-vocab row (gathers into the packed r_rel_bits planes) and
    # the !direct flag selecting the literal-tuples-only plane
    ("t_rel_path", "rel_path", np.int32),
    ("t_rel_idx", "rel_idx", np.int32),
    ("t_rel_direct", "rel_direct", bool),
]


def lower_target(
    target: Optional[Target],
    interner: StringInterner,
    urns: Urns,
    vocab_row,
    rel_row=None,
) -> tuple[dict, Optional[str]]:
    """Lower ONE target into its row dict (the closed-form per-row
    representation the kernel gathers from).  ``vocab_row(value) -> int``
    allocates/looks up the entity regex-vocab row — the fresh compiler
    appends, the delta patcher allocates inside a fixed capacity.
    ``rel_row(path) -> int`` does the same for the relation-path vocab
    (ops/relation.py bitplanes); None marks relation-bearing targets
    unsupported.

    Returns (row, unsupported_reason_or_None); shared by the from-scratch
    compile below and the in-place set relowering in ops/delta.py so the
    two paths are bit-identical by construction."""
    it = interner.intern
    row: dict = {}
    t = target or Target()
    unsupported: Optional[str] = None

    role_urn = urns.get("role")
    scoping_urn = urns.get("roleScopingEntity")
    skip_acl_urn = urns.get("skipACL")
    hr_urn = urns.get("hierarchicalRoleScoping")
    entity_urn = urns.get("entity")
    property_urn = urns.get("property")
    operation_urn = urns.get("operation")
    relation_urn = urns.get("relation")

    role = None
    scoping = None
    hr_check = "true"
    skip_acl = False
    sub_pairs = []
    rel_paths: list[str] = []
    for a in t.subjects or []:
        if a.id == relation_urn:
            # relation requirements gate through the packed bitplanes
            # (stage B analog), not the subject pair-subset match — the
            # scalar oracle filters them identically
            # (core/engine._check_subject_matches)
            rel_paths.append(a.value or "")
            continue
        sub_pairs.append((it(a.id), it(a.value)))
        if a.id == role_urn:
            role = a.value
        elif a.id == hr_urn:
            hr_check = a.value
        elif a.id == scoping_urn:
            scoping = a.value
        if a.id == skip_acl_urn:
            skip_acl = True

    act_pairs = [(it(a.id), it(a.value)) for a in (t.actions or [])]

    ent_vals, op_vals, prop_vals = [], [], []
    for a in t.resources or []:
        if a.id == entity_urn:
            ent_vals.append(a.value)
        elif a.id == operation_urn:
            op_vals.append(a.value)
        elif a.id == property_urn:
            prop_vals.append(a.value)
        # other resource attribute ids never match anything in the
        # reference matcher; they only affect nothing (ref :492-576)

    if len(sub_pairs) > K_SUB or len(act_pairs) > K_ACT:
        unsupported = "subject/action attribute count exceeds caps"
    if len(ent_vals) > K_ENT or len(op_vals) > K_OP or len(prop_vals) > K_PROP:
        unsupported = "resource attribute count exceeds caps"
    for v in ent_vals:
        try:
            re.compile(v[v.rfind(":") + 1:].split(".")[-1])
        except re.error:
            unsupported = f"invalid regex in entity value {v!r}"
    if len(ent_vals) > 1 and prop_vals:
        # requestEntityURN ambiguity: multiple entities + properties mix
        # per-attribute state the closed form cannot represent
        unsupported = "target mixes multiple entities with properties"

    rel_parsed = None
    if len(rel_paths) > 1:
        unsupported = "multiple relation attributes on one target"
    elif rel_paths:
        try:
            rel_parsed = parse_path(rel_paths[0])
        except ValueError:
            unsupported = f"invalid relation path {rel_paths[0]!r}"
        if rel_parsed is not None and rel_row is None:
            unsupported = "relation path without a relation vocab"

    ent_ids = [it(v) for v in ent_vals]
    row["n_subjects"] = len(t.subjects or [])
    row["role"] = it(role) if role is not None else ABSENT
    row["has_role"] = role is not None
    row["scoping"] = it(scoping) if scoping is not None else ABSENT
    row["has_scoping"] = scoping is not None
    row["hr_check"] = hr_check == "true"
    row["skip_acl"] = skip_acl
    row["sub_ids"] = _pad([p[0] for p in sub_pairs], K_SUB)
    row["sub_vals"] = _pad([p[1] for p in sub_pairs], K_SUB)
    row["act_ids"] = _pad([p[0] for p in act_pairs], K_ACT)
    row["act_vals"] = _pad([p[1] for p in act_pairs], K_ACT)
    row["ent_vals"] = _pad(ent_ids, K_ENT)
    row["ent_w"] = _pad([vocab_row(v) for v in ent_vals], K_ENT)
    row["ent_tails"] = _pad([interner.tail_id[i] for i in ent_ids], K_ENT)
    row["op_vals"] = _pad([it(v) for v in op_vals], K_OP)
    prop_ids = [it(v) for v in prop_vals]
    row["prop_vals"] = _pad(prop_ids, K_PROP)
    row["prop_sfx"] = _pad([interner.suffix_id[i] for i in prop_ids], K_PROP)
    row["has_props"] = len(prop_vals) > 0
    row["n_res"] = len(t.resources or [])
    if rel_parsed is not None and rel_row is not None and unsupported is None:
        row["rel_path"] = it(rel_paths[0])
        row["rel_idx"] = rel_row(rel_paths[0])
        row["rel_direct"] = rel_parsed.direct
    else:
        row["rel_path"] = ABSENT
        row["rel_idx"] = ABSENT
        row["rel_direct"] = False
    return row, unsupported


class _TargetTable:
    def __init__(self, interner: StringInterner, urns: Urns):
        self.interner = interner
        self.urns = urns
        self.rows: list[dict] = []
        self.entity_vocab: list[str] = []
        self.entity_vocab_ids: dict[int, int] = {}
        self.rel_vocab: list[str] = []
        self.rel_vocab_ids: dict[int, int] = {}
        self.unsupported: Optional[str] = None
        self.owners: dict[tuple, int] = {}

    def _vocab_row(self, value: str) -> int:
        vid = self.interner.intern(value)
        row = self.entity_vocab_ids.get(vid)
        if row is None:
            row = len(self.entity_vocab)
            self.entity_vocab.append(value)
            self.entity_vocab_ids[vid] = row
        return row

    def _rel_row(self, value: str) -> int:
        vid = self.interner.intern(value)
        row = self.rel_vocab_ids.get(vid)
        if row is None:
            row = len(self.rel_vocab)
            self.rel_vocab.append(value)
            self.rel_vocab_ids[vid] = row
        return row

    def add(self, target: Optional[Target], owner: Optional[tuple] = None) -> int:
        """Lower a target into a row; returns the row index."""
        row, unsupported = lower_target(
            target, self.interner, self.urns, self._vocab_row, self._rel_row
        )
        if unsupported:
            self.unsupported = unsupported
        self.rows.append(row)
        idx = len(self.rows) - 1
        if owner is not None:
            self.owners[owner] = idx
        return idx

    def row_info(self, idx: int) -> tuple[bool, list[int]]:
        """(has_props, padded entity value ids) of a lowered row — the
        policy-level denormalized columns the set lowerer copies."""
        row = self.rows[idx]
        return row["has_props"], row["ent_vals"]

    def to_arrays(self) -> dict[str, np.ndarray]:
        return {
            name: np.array([r[key] for r in self.rows], dtype=dtype)
            for name, key, dtype in TARGET_COLUMNS
        }


class _ConditionSink:
    """Append-only condition registry for the from-scratch compile; the
    delta patcher substitutes an identity-checked reuse sink
    (ops/delta.py) so patched trees keep the condition list — and the
    [C, B] device shapes derived from it — byte-stable."""

    def __init__(self):
        self.conditions: list[CompiledCondition] = []

    def add(self, owner: tuple, flat_index: int, condition: str,
            context_query) -> int:
        idx = len(self.conditions)
        self.conditions.append(
            CompiledCondition(
                rule_flat_index=flat_index,
                condition=condition,
                context_query=context_query,
                owner=owner,
            )
        )
        return idx


def lower_set_into(a, s, ps, table, cond_sink, KP: int, KR: int
                   ) -> Optional[str]:
    """Lower ONE policy set into slot ``s`` of the padded arrays ``a``.

    Factored out of compile_policies so the delta patcher (ops/delta.py)
    can relower a mutated set in place — same loop, same write order, so
    patched slots are value-identical to a from-scratch compile of the
    same subtree.  ``table.add`` allocates/reuses target rows, ``cond_sink
    .add`` allocates/reuses condition slots; returns the first unsupported
    reason found at set/policy granularity (target-level reasons land on
    ``table.unsupported``)."""
    unsupported: Optional[str] = None
    a["set_valid"][s] = True
    ca = CA_CODES.get(ps.combining_algorithm, ABSENT)
    a["set_ca"][s] = ca
    if ps.target is not None:
        a["set_has_target"][s] = True
        a["set_target"][s] = table.add(ps.target, owner=("set", ps.id))
    policies = list(ps.combinables.items())
    if ca == ABSENT and any(p is not None for _, p in policies):
        unsupported = f"unknown combining algorithm on set {ps.id!r}"
    eff_ctx = 0  # carried-over policyEffect, per set
    for kp, (pol_key, pol) in enumerate(policies):
        if pol is None:
            continue
        a["pol_valid"][s, kp] = True
        if pol.effect:
            eff_ctx = EFFECT_CODES.get(pol.effect, 0)
        a["pol_eff_ctx"][s, kp] = eff_ctx
        a["pol_ca"][s, kp] = CA_CODES.get(pol.combining_algorithm, ABSENT)
        a["pol_effect"][s, kp] = EFFECT_CODES.get(pol.effect, 0)
        a["pol_cacheable"][s, kp] = bool(pol.evaluation_cacheable)
        if pol.target is not None:
            a["pol_has_target"][s, kp] = True
            row_idx = table.add(pol.target, owner=("pol", ps.id, pol_key))
            a["pol_target"][s, kp] = row_idx
            a["pol_has_subjects"][s, kp] = bool(pol.target.subjects)
            has_props, ent_vals = table.row_info(row_idx)
            a["pol_has_props"][s, kp] = has_props
            a["pol_ent_vals"][s, kp] = ent_vals
        rules = list(pol.combinables.items())
        a["pol_n_rules"][s, kp] = len(rules)
        if a["pol_ca"][s, kp] == ABSENT and any(
            r is not None for _, r in rules
        ):
            unsupported = f"unknown combining algorithm on policy {pol.id!r}"
        cache_prefix = True
        for kr, (rule_key, rule) in enumerate(rules):
            if rule is None:
                continue
            a["rule_valid"][s, kp, kr] = True
            a["rule_effect"][s, kp, kr] = EFFECT_CODES.get(rule.effect, 0)
            raw = bool(rule.evaluation_cacheable)
            a["rule_cacheable_raw"][s, kp, kr] = raw
            cache_prefix = cache_prefix and raw
            a["rule_cacheable_eff"][s, kp, kr] = raw and cache_prefix
            if rule.target is not None:
                a["rule_has_target"][s, kp, kr] = True
                a["rule_target"][s, kp, kr] = table.add(
                    rule.target, owner=("rule", ps.id, pol_key, rule_key)
                )
            if rule.condition:
                a["rule_cond"][s, kp, kr] = cond_sink.add(
                    ("rule", ps.id, pol_key, rule_key),
                    (s * KP + kp) * KR + kr,
                    rule.condition,
                    rule.context_query,
                )
    return unsupported


def compile_policies(
    policy_sets: dict[str, Optional[PolicySet]] | list[PolicySet],
    urns: Urns | None = None,
    version: int = 0,
) -> CompiledPolicies:
    urns = urns or Urns()
    interner = StringInterner()
    table = _TargetTable(interner, urns)

    if isinstance(policy_sets, dict):
        sets = [ps for ps in policy_sets.values() if ps is not None]
    else:
        sets = [ps for ps in policy_sets if ps is not None]

    S = max(len(sets), 1)
    KP = max((len(ps.combinables) for ps in sets), default=0) or 1
    KR = 1
    for ps in sets:
        for pol in ps.combinables.values():
            if pol is not None:
                KR = max(KR, len(pol.combinables))

    unsupported: Optional[str] = None
    cond_sink = _ConditionSink()

    def zeros(dtype=np.int32, shape=None):
        return np.full(shape, ABSENT if dtype == np.int32 else False, dtype=dtype)

    a = {
        "set_valid": zeros(bool, (S,)),
        "set_ca": zeros(np.int32, (S,)),
        "set_has_target": zeros(bool, (S,)),
        "set_target": np.zeros((S,), np.int32),
        "pol_valid": zeros(bool, (S, KP)),
        "pol_ca": zeros(np.int32, (S, KP)),
        "pol_effect": np.zeros((S, KP), np.int32),
        "pol_cacheable": zeros(bool, (S, KP)),
        "pol_has_target": zeros(bool, (S, KP)),
        "pol_target": np.zeros((S, KP), np.int32),
        "pol_has_subjects": zeros(bool, (S, KP)),
        "pol_n_rules": np.zeros((S, KP), np.int32),
        "pol_eff_ctx": np.zeros((S, KP), np.int32),
        "pol_has_props": zeros(bool, (S, KP)),
        "pol_ent_vals": np.full((S, KP, K_ENT), ABSENT, np.int32),
        "rule_valid": zeros(bool, (S, KP, KR)),
        "rule_effect": np.zeros((S, KP, KR), np.int32),
        "rule_cacheable_raw": zeros(bool, (S, KP, KR)),
        "rule_cacheable_eff": zeros(bool, (S, KP, KR)),
        "rule_has_target": zeros(bool, (S, KP, KR)),
        "rule_target": np.zeros((S, KP, KR), np.int32),
        "rule_cond": np.full((S, KP, KR), ABSENT, np.int32),
    }

    for s, ps in enumerate(sets):
        reason = lower_set_into(a, s, ps, table, cond_sink, KP, KR)
        if reason:
            unsupported = reason

    if not table.rows:
        table.add(None)
    if table.unsupported:
        unsupported = table.unsupported

    arrays = dict(a)
    arrays.update(table.to_arrays())
    # (role, scoping) vocabulary for stage B: the owner-membership
    # verdicts are factored per distinct (t_role, t_scoping) pair —
    # typically far fewer than T — computed host-side at encode
    # (ops/encode.pack_owner_bitplanes) and gathered back per target row
    # through the packed bitplanes (kernel _hr_pass_from_bits).  The
    # vocab arrays are global (group-invariant under prefilter
    # compaction) and host-only; t_rs_idx is a regular target-table
    # column so row subsets keep it aligned.
    rs_pairs = np.stack(
        [arrays["t_role"], arrays["t_scoping"]], axis=1
    )
    rs_vocab, t_rs = np.unique(rs_pairs, axis=0, return_inverse=True)
    arrays["t_rs_idx"] = t_rs.reshape(-1).astype(np.int32)
    arrays["hrv_role"] = np.ascontiguousarray(rs_vocab[:, 0], np.int32)
    arrays["hrv_scope"] = np.ascontiguousarray(rs_vocab[:, 1], np.int32)
    # relation-path vocabulary (interned expressions, host-only like
    # hrv_*): t_rel_idx rows gather the packed r_rel_bits planes by this
    # order; the serving store builds its verdict tables in the same order
    # (srv/relations.RelationTupleStore.tables_for)
    arrays["relv_path"] = np.array(
        [interner.intern(v) for v in table.rel_vocab], np.int32
    )
    # interned URN ids the ACL kernel stage compares against (reference:
    # verifyACL.ts:37-44, 138-150): [role attr id, user entity, actionID
    # attr id, create, read, modify, delete]
    arrays["acl_consts"] = np.array(
        [
            interner.intern(urns.get("role")),
            interner.intern(urns.get("user")),
            interner.intern(urns.get("actionID")),
            interner.intern(urns.get("create")),
            interner.intern(urns.get("read")),
            interner.intern(urns.get("modify")),
            interner.intern(urns.get("delete")),
        ],
        np.int32,
    )

    compiled = CompiledPolicies(
        interner=interner,
        urns=urns,
        arrays=arrays,
        conditions=cond_sink.conditions,
        entity_vocab=table.entity_vocab,
        entity_vocab_ids=table.entity_vocab_ids,
        rel_vocab=table.rel_vocab,
        rel_vocab_ids=table.rel_vocab_ids,
        supported=unsupported is None,
        unsupported_reason=unsupported or "",
        S=S,
        KP=KP,
        KR=KR,
        T=len(table.rows),
        version=version,
        target_owners=table.owners,
    )
    return compiled
