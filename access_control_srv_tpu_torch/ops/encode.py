"""Request batch encoder: wire-shaped requests -> dense integer tensors.

Per-request Python cost is kept to attribute parsing + dict lookups; all
string work (interning, regex evaluation, substring-relevance verification)
is cached per *distinct* string across the batch.

A request is **kernel-eligible** only when its shape fits the closed-form
matcher the kernel implements; ineligible requests are flagged and served
by the scalar oracle instead (decisions stay bit-identical either way).
Ineligibility triggers:

- a subject token the host pipeline has NOT resolved (identity resolution
  / HR-scope rendezvous is a host protocol, reference:
  src/core/accessController.ts:110-123).  Resolved token rows — prepared
  by srv/evaluator.prepare_batch or engine.prepare_context — encode their
  resolved subject and stay on device; failed resolutions degrade per-row
  to the oracle;
- attribute counts beyond the padding caps (including ACL scoping-entity/
  instance counts and distinct HR-tree role counts);
- malformed property URNs, properties preceding their entity, or
  entity-name substring relevance diverging from id equality (the
  reference matches properties to entities by substring, reference:
  :515-516);
- conditions with context queries when a resource adapter is configured
  AND the row's walk could observe the reference's context merge (the
  reference mutates request.context across rules in that path, reference:
  :238-254).  Rows reaching exactly one query rule whose merge provably
  stays invisible get the query PREFETCHED host-side and ride the kernel
  (_prefetch_context_queries); see docs/ELIGIBILITY.md for the full
  taxonomy and degradation ladder.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..core.common import find_ctx_resource, get_field
from ..core.conditions import condition_matches
from ..core.hierarchical_scope import regex_entity_compare
from ..models.model import Request
from .compile import CompiledPolicies
from .interner import ABSENT

# per-request padding caps: FLOORS of the adaptive scheme.  Each batch is
# pre-scanned and every dimension is bucketed to the next power of two of
# the batch maximum (floor = these defaults, hard ceiling = _CAPS_CEIL),
# so deep-HR / wide-ACL traffic stays kernel-eligible instead of falling
# to the scalar oracle, while common traffic keeps one compiled shape.
# The native (C++) wire encoder takes the same caps at runtime: the wire
# path encodes at the floor and re-encodes over-cap rows (batch.overcap)
# at _CAPS_CEIL, so deep rows stay on the native fast path too.
NR = 4      # entity runs
NI = 4      # resource instances
NP = 8      # property attributes
NSUB = 8    # subject attribute pairs
NACT = 4    # action attribute pairs
NOP = 2     # operation attributes
NOWN = 4    # owner pairs per instance
NRA = 8     # role-association triples / pairs
NHR = 32    # flattened HR-scope pairs
NROLE = 4   # subject roles
NACLE = 4   # distinct ACL scoping entities per request
NACLI = 8   # ACL instances per scoping entity
NHRR = 8    # distinct HR-tree roles (verifyACL flatten) per request

_CAPS_FLOOR = {
    "NR": NR, "NI": NI, "NP": NP, "NSUB": NSUB, "NACT": NACT, "NOP": NOP,
    "NOWN": NOWN, "NRA": NRA, "NHR": NHR, "NROLE": NROLE, "NACLE": NACLE,
    "NACLI": NACLI, "NHRR": NHRR,
}
_CAPS_CEIL = {
    "NR": 16, "NI": 32, "NP": 64, "NSUB": 32, "NACT": 16, "NOP": 8,
    "NOWN": 32, "NRA": 128, "NHR": 1024, "NROLE": 16, "NACLE": 16,
    "NACLI": 64, "NHRR": 32,
}


def _pow2_at_least(n: int, floor: int) -> int:
    if n <= floor:
        return floor
    return 1 << (n - 1).bit_length()


def request_needs(request, urns) -> dict[str, int]:
    """Raw per-request padding needs (upper-bound estimates) for every cap
    dimension; compute_caps aggregates these over a batch, the evaluator
    uses them to split mixed traffic so deep/wide rows do not inflate the
    compiled shapes of the whole batch."""
    entity_urn = urns.get("entity")
    property_urn = urns.get("property")
    operation_urn = urns.get("operation")
    resource_id_urn = urns.get("resourceID")
    scoping_urn = urns.get("roleScopingEntity")
    scoping_inst_urn = urns.get("roleScopingInstance")
    owner_ent_urn = urns.get("ownerEntity")
    owner_inst_urn = urns.get("ownerInstance")
    acl_ind_urn = urns.get("aclIndicatoryEntity")

    need = dict.fromkeys(_CAPS_FLOOR, 0)

    def bump(key, val):
        if val > need[key]:
            need[key] = val

    target = request.target
    if not target:
        return need
    bump("NSUB", len(target.subjects or []))
    bump("NACT", len(target.actions or []))
    runs = props = ops = insts = 0
    seen_run = False
    for attr in target.resources or []:
        if attr.id == entity_urn:
            runs += 1
            seen_run = True
        elif attr.id == property_urn:
            props += 1
        elif attr.id == operation_urn:
            ops += 1
        elif attr.id == resource_id_urn and seen_run:
            insts += 1
    bump("NR", runs)
    bump("NP", props)
    bump("NOP", ops)
    bump("NI", insts)

    context = request.context
    subject = get_field(context, "subject") or {} if context else {}
    role_assocs = get_field(subject, "role_associations") or []
    roles, ra3, ra2 = set(), 0, set()
    for ra in role_assocs:
        role = get_field(ra, "role")
        if role is not None:
            roles.add(role)
        for ra_attr in get_field(ra, "attributes") or []:
            if get_field(ra_attr, "id") != scoping_urn:
                continue
            ent = get_field(ra_attr, "value")
            ra2.add((role, ent))
            for inst in get_field(ra_attr, "attributes") or []:
                if get_field(inst, "id") == scoping_inst_urn:
                    ra3 += 1
    bump("NROLE", len(roles))
    bump("NRA", max(ra3, len(ra2)))

    scopes = get_field(subject, "hierarchical_scopes")
    hr_pairs: list = []
    _flatten_hr(scopes, hr_pairs)
    bump("NHR", len(set(hr_pairs)))
    acl_hr: list = []
    _flatten_acl_hr(scopes, acl_hr)
    bump("NHR", len(set(acl_hr)))
    bump("NHRR", len({r for r, _ in acl_hr if r is not None}))

    acl_ents, acl_insts_total, own_max = set(), 0, 0
    for res in (get_field(context, "resources") or []) if context else []:
        meta = get_field(res, "meta")
        for acl in (get_field(meta, "acls") or []) if meta else []:
            if get_field(acl, "id") == acl_ind_urn:
                acl_ents.add(get_field(acl, "value"))
                acl_insts_total += len(get_field(acl, "attributes") or [])
        own = 0
        for owner in (get_field(meta, "owners") or []) if meta else []:
            if get_field(owner, "id") != owner_ent_urn:
                continue
            own += sum(
                1 for i in (get_field(owner, "attributes") or [])
                if get_field(i, "id") == owner_inst_urn
            )
        own_max = max(own_max, own)
    bump("NACLE", len(acl_ents))
    bump("NACLI", acl_insts_total)
    bump("NOWN", own_max)
    return need


def fits_floor(needs: dict[str, int]) -> bool:
    """True when a request's needs fit the floor caps (the steady-state
    compiled shape)."""
    return all(needs[k] <= _CAPS_FLOOR[k] for k in _CAPS_FLOOR)


def compute_caps(requests, urns) -> dict[str, int]:
    """Pre-scan the batch and bucket every padding dimension to the next
    power of two above the batch maximum (floor = module defaults, hard
    ceiling = _CAPS_CEIL).  Estimates only need to be upper bounds per
    dimension — the fill loop still marks genuinely over-cap rows
    ineligible, so an under-estimate degrades to oracle fallback, never to
    a wrong decision."""
    need = dict.fromkeys(_CAPS_FLOOR, 0)
    for request in requests:
        for key, val in request_needs(request, urns).items():
            if val > need[key]:
                need[key] = val
    return {
        key: min(_CAPS_CEIL[key], _pow2_at_least(need[key], _CAPS_FLOOR[key]))
        for key in _CAPS_FLOOR
    }


def urn_tail(value: str) -> str:
    """The reference's ``entity_name`` in the property-relevance check: the
    URN segment after the last ':' (accessController.ts:515-516).  Must match
    StringInterner.tail_id so r_prop_tail compares against t_ent_tails."""
    value = value or ""
    return value[value.rfind(":") + 1:] if ":" in value else value


@dataclass
class RequestBatch:
    B: int
    arrays: dict[str, np.ndarray]
    # regex matrices over (target entity vocab W) x (batch entity values E)
    rgx_set: np.ndarray
    pfx_neq: np.ndarray
    # host-assisted condition results [C, B]
    cond_true: np.ndarray
    cond_abort: np.ndarray
    cond_code: np.ndarray
    eligible: np.ndarray
    requests: list[Request] = field(default_factory=list)
    # per-reason counts for rows that fell back to the scalar oracle
    ineligible_reasons: dict[str, int] = field(default_factory=dict)
    # (condition index, row) -> error text for abort rows (the reference's
    # operation_status.message, recovered without an oracle re-run)
    cond_msg: dict = field(default_factory=dict)
    # rows ineligible ONLY because a padding cap overflowed (native wire
    # encoder); the serving path re-encodes them at the ceiling shapes
    overcap: Optional[np.ndarray] = None
    # pooled-staging lease (native zero-copy encode): a zero-arg callable
    # returning this batch's buffers to their arena.  MUST only run after
    # the consuming computation has materialized — on the CPU backend the
    # device arrays can alias these buffers zero-copy.  None for batches
    # built from fresh allocations.
    staging: Optional[object] = None

    def release_staging(self) -> None:
        release, self.staging = self.staging, None
        if release is not None:
            release()


class _RegexCache:
    """(target entity value, request entity value) -> regex-branch results,
    mirroring the reference comparison (reference: accessController.ts:526-566)."""

    def __init__(self, entity_vocab: list[str]):
        self.vocab = entity_vocab
        self.cache: dict[str, tuple[list[bool], list[bool]]] = {}

    def lookup(self, req_value: str) -> tuple[list[bool], list[bool]]:
        hit = self.cache.get(req_value)
        if hit is not None:
            return hit
        set_col, neq_col = [], []
        for rule_val in self.vocab:
            matched, prefix_mismatch = regex_entity_compare(rule_val, req_value)
            set_col.append(matched)
            neq_col.append(prefix_mismatch)
        self.cache[req_value] = (set_col, neq_col)
        return set_col, neq_col


def _flatten_hr(scopes, out: list[tuple[Optional[str], str]]):
    """(top-level role, node id) pairs for every node of each top-level
    subtree (reference: hierarchicalScope.ts:207-220 filters by top role
    then flattens the subtree)."""
    for top in scopes or []:
        role = get_field(top, "role")
        stack = [top]
        while stack:
            node = stack.pop()
            node_id = get_field(node, "id")
            if node_id:
                out.append((role, node_id))
            stack.extend(get_field(node, "children") or [])


def _flatten_acl_hr(nodes, out: list, role=None):
    """verifyACL's OWN tree flatten (reference: verifyACL.ts:119-129
    getRoleOrgMapping): pre-order, a node's ``role`` field overrides the
    inherited one for itself AND its subtree — unlike the HR matcher's
    flatten above, which keys every node by the top-level role only."""
    for node in nodes or []:
        key = get_field(node, "role")
        if key is None:
            key = role
        node_id = get_field(node, "id")
        if node_id:
            out.append((key, node_id))
        children = get_field(node, "children") or []
        if children:
            _flatten_acl_hr(children, out, key)


def alloc_row_arrays(B: int, caps: dict[str, int] | None = None
                     ) -> dict[str, np.ndarray]:
    """The per-request kernel row arrays; shared by the Python encoder
    (adaptive ``caps`` from compute_caps) and the native (C++) wire
    encoder, which fills the same buffers in place at the FLOOR shapes
    (the ctypes pointer order lives in native/__init__._ARRAY_ORDER)."""
    if caps is not None:
        NR = caps["NR"]; NI = caps["NI"]; NP = caps["NP"]
        NSUB = caps["NSUB"]; NACT = caps["NACT"]; NOP = caps["NOP"]
        NOWN = caps["NOWN"]; NRA = caps["NRA"]; NHR = caps["NHR"]
        NROLE = caps["NROLE"]; NACLE = caps["NACLE"]
        NACLI = caps["NACLI"]; NHRR = caps["NHRR"]
    else:
        NR, NI, NP, NSUB, NACT, NOP, NOWN, NRA, NHR, NROLE, NACLE, NACLI, \
            NHRR = (_CAPS_FLOOR[k] for k in (
                "NR", "NI", "NP", "NSUB", "NACT", "NOP", "NOWN", "NRA",
                "NHR", "NROLE", "NACLE", "NACLI", "NHRR"))
    return {
        "r_sub_ids": np.full((B, NSUB), ABSENT, np.int32),
        "r_sub_vals": np.full((B, NSUB), ABSENT, np.int32),
        "r_roles": np.full((B, NROLE), ABSENT, np.int32),
        "r_act_ids": np.full((B, NACT), ABSENT, np.int32),
        "r_act_vals": np.full((B, NACT), ABSENT, np.int32),
        "r_ent_vals": np.full((B, NR), ABSENT, np.int32),
        "r_ent_e": np.zeros((B, NR), np.int32),
        "r_ent_valid": np.zeros((B, NR), bool),
        "r_inst_run": np.full((B, NI), ABSENT, np.int32),
        "r_inst_id": np.full((B, NI), ABSENT, np.int32),
        "r_inst_valid": np.zeros((B, NI), bool),
        "r_inst_present": np.zeros((B, NI), bool),
        "r_inst_has_owners": np.zeros((B, NI), bool),
        "r_inst_owner_ent": np.full((B, NI, NOWN), ABSENT, np.int32),
        "r_inst_owner_inst": np.full((B, NI, NOWN), ABSENT, np.int32),
        "r_prop_vals": np.full((B, NP), ABSENT, np.int32),
        "r_prop_sfx": np.full((B, NP), ABSENT, np.int32),
        "r_prop_run": np.full((B, NP), ABSENT, np.int32),
        "r_prop_tail": np.full((B, NP), ABSENT, np.int32),
        "r_op_vals": np.full((B, NOP), ABSENT, np.int32),
        "r_op_present": np.zeros((B, NOP), bool),
        "r_op_has_owners": np.zeros((B, NOP), bool),
        "r_op_owner_ent": np.full((B, NOP, NOWN), ABSENT, np.int32),
        "r_op_owner_inst": np.full((B, NOP, NOWN), ABSENT, np.int32),
        "r_ra3": np.full((B, NRA, 3), ABSENT, np.int32),
        "r_ra2": np.full((B, NRA, 2), ABSENT, np.int32),
        "r_n_ra": np.zeros((B,), np.int32),
        "r_hr": np.full((B, NHR, 2), ABSENT, np.int32),
        "r_ctx_present": np.zeros((B,), bool),
        "r_n_entity_attrs": np.zeros((B,), np.int32),
        "r_has_props": np.zeros((B,), bool),
        "r_has_target": np.zeros((B,), bool),
        # verify_acl ACL-pair inputs (reference: verifyACL.ts:37-88,
        # 119-136, 148-248). acl_short: 0 = pairs mode, 1 = early all-clear
        # (a targeted resource without ACL metadata, :56-59), 2 = malformed
        # ACL fail (:72-82). Both encoders (Python and the C++ wire
        # encoder) fill these; only over-cap, ABSENT-valued or
        # malformed-JSON ACL shapes fall back to the scalar oracle.
        "r_acl_short": np.zeros((B,), np.int32),
        "r_acl_ent": np.full((B, NACLE), ABSENT, np.int32),
        "r_acl_inst": np.full((B, NACLE, NACLI), ABSENT, np.int32),
        # verifyACL's role->org flatten (per-node role override) and its
        # distinct role keys in first-occurrence order (:119-136)
        "r_acl_hr": np.full((B, NHR, 2), ABSENT, np.int32),
        "r_hr_roles": np.full((B, NHRR), ABSENT, np.int32),
        "r_subject_id": np.full((B,), ABSENT, np.int32),
    }


# arrays alloc_row_arrays fills with ABSENT (everything else zero-fills);
# reset_row_arrays must track alloc_row_arrays exactly so a recycled arena
# buffer is indistinguishable from a fresh allocation
_ABSENT_FILLED = frozenset({
    "r_sub_ids", "r_sub_vals", "r_roles", "r_act_ids", "r_act_vals",
    "r_ent_vals", "r_inst_run", "r_inst_id",
    "r_inst_owner_ent", "r_inst_owner_inst",
    "r_prop_vals", "r_prop_sfx", "r_prop_run", "r_prop_tail", "r_op_vals",
    "r_op_owner_ent", "r_op_owner_inst", "r_ra3", "r_ra2", "r_hr",
    "r_acl_ent", "r_acl_inst", "r_acl_hr", "r_hr_roles", "r_subject_id",
})


def reset_row_arrays(a: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Re-fill recycled row arrays in place to the alloc_row_arrays fill
    values (C-speed memset, zero allocation) — the native encoder writes
    only the slots a request uses and relies on the rest holding the
    fill value, so arena reuse must restore it."""
    for name, arr in a.items():
        arr.fill(ABSENT if name in _ABSENT_FILLED else 0)
    return a


def owner_bit_layout(rv: int, nru: int, nop: int) -> tuple[int, int, int, int]:
    """Packed owner-bitplane layout, shared by the host packer below and
    the kernel's unpack (ops/kernel._owner_bit_reader).

    Per (request row, role-scope-vocab entry) the packed verdicts are
    ``ebits = 2*nru + 2*nop`` bits, in order:

      [0, nru)            A: instance-group g fails when its run is
                          collected AND the target row has hr_check
                          (direct OR hierarchical owner match required)
      [nru, 2*nru)        B: same with hr_check disabled (direct only)
      [2*nru, 2*nru+nop)  opA: operation slot j fails when op-hit, with
                          hr_check
      [.., 2*nru+2*nop)   opB: same with hr_check disabled

    Returns (ebits, epw, wpe, nwords): when ebits <= 32 entries pack
    ``epw = 32 // ebits`` per int32 word (entry v -> word v // epw, bit
    offset (v % epw) * ebits) and ``wpe`` is 1; wider entries (ceiling
    caps) span ``wpe = ceil(ebits / 32)`` words each (bit k of entry v ->
    word v * wpe + k // 32, offset k % 32) and ``epw`` is 0."""
    ebits = 2 * (nru + nop)
    if ebits <= 32:
        epw = 32 // ebits
        return ebits, epw, 1, -(-rv // epw)
    wpe = -(-ebits // 32)
    return ebits, 0, wpe, rv * wpe


def owner_bits_needed(compiled: CompiledPolicies) -> bool:
    """Stage B runs only when some target row carries BOTH subjects and a
    scoping entity (mirrors ops/kernel.tree_needs_hr without importing the
    kernel module — kernel imports this one)."""
    a = compiled.arrays
    return bool(
        (np.asarray(a["t_has_scoping"]) & (np.asarray(a["t_n_subjects"]) > 0)).any()
    )


def _owner_verdicts(hrv_role, hrv_scope, ra3, ra2, hr, own_ent, own_inst):
    """Vectorized owner pair checks against role associations / HR closure
    at (row, role-scope-vocab entry, owner-bearing slot) granularity —
    the host-side replacement for the kernel's former stage-B device
    matmuls, identical semantics (reference: hierarchicalScope.ts:165-245).
    Counts stay exact in f32 (NRA/NHR < 2^24).  Returns (direct, hier)
    bool [b, RV, N]."""
    b, N, NOWN = own_ent.shape
    rv = hrv_role.shape[0]
    qe = own_ent.reshape(b, N * NOWN)
    qi = own_inst.reshape(b, N * NOWN)
    ent_m = (qe[:, None, :] == hrv_scope[None, :, None]) & (qe >= 0)[:, None, :]
    # direct: (role, scoping, owner-instance) in ra3
    ra3_valid = ra3[:, :, 1] >= 0
    rs3 = (
        (ra3[:, :, 0][:, :, None] == hrv_role[None, None, :])
        & (ra3[:, :, 1][:, :, None] == hrv_scope[None, None, :])
        & ra3_valid[:, :, None]
    )  # [b, NRA, RV]
    i3 = ra3[:, :, 2][:, :, None] == qi[:, None, :]  # [b, NRA, Q]
    dcnt = np.matmul(
        rs3.transpose(0, 2, 1).astype(np.float32), i3.astype(np.float32)
    )  # [b, RV, Q]
    direct = ent_m & (dcnt > 0)
    # hierarchical: (role, scoping) in ra2 and (role, owner-inst) in hr
    ra2_valid = ra2[:, :, 1] >= 0
    ra2_ok = (
        (ra2[:, :, 0][:, :, None] == hrv_role[None, None, :])
        & (ra2[:, :, 1][:, :, None] == hrv_scope[None, None, :])
        & ra2_valid[:, :, None]
    ).any(axis=1)  # [b, RV]
    hr_valid = hr[:, :, 1] >= 0
    rh = (
        hr[:, :, 0][:, :, None] == hrv_role[None, None, :]
    ) & hr_valid[:, :, None]  # [b, NHR, RV]
    ih = hr[:, :, 1][:, :, None] == qi[:, None, :]  # [b, NHR, Q]
    hcnt = np.matmul(
        rh.transpose(0, 2, 1).astype(np.float32), ih.astype(np.float32)
    )  # [b, RV, Q]
    hier = ent_m & (hcnt > 0) & ra2_ok[:, :, None]
    return (
        direct.reshape(b, rv, N, NOWN).any(axis=3),
        hier.reshape(b, rv, N, NOWN).any(axis=3),
    )


def pack_owner_bitplanes(
    arrays: dict[str, np.ndarray],
    compiled: CompiledPolicies,
    skip: bool = False,
) -> dict[str, np.ndarray]:
    """Host-precomputed stage-B owner verdicts, packed per
    ``owner_bit_layout``:

      r_own_runs [B, NRU] — the distinct instance-bearing entity runs per
          row (ABSENT-padded); bit group g of every vocab entry refers to
          run r_own_runs[g].
      r_own_bits [B, NWORDS] — the packed A/B/opA/opB fail bits per
          (row, vocab entry).

    Pure function of the raw encoder arrays, so BOTH encoders share it:
    the Python encoder calls it inline and the native (C++) wire encoder
    defers to it after filling the raw arrays (native/__init__.py) —
    bit-identity between the two paths is then structural.  ``skip=True``
    (or a tree without HR-bearing targets) emits 1-wide dummies that
    stage-B-free kernels never read."""
    B = arrays["r_ent_vals"].shape[0]
    if skip or not owner_bits_needed(compiled):
        return {
            "r_own_runs": np.full((B, 1), ABSENT, np.int32),
            "r_own_bits": np.zeros((B, 1), np.int32),
        }
    hrv_role = np.asarray(compiled.arrays["hrv_role"])
    hrv_scope = np.asarray(compiled.arrays["hrv_scope"])
    RV = hrv_role.shape[0]
    NOP = arrays["r_op_vals"].shape[1]

    inst_run = arrays["r_inst_run"]
    valid_i = arrays["r_inst_valid"] & (inst_run >= 0)  # [B, NI]
    # distinct instance-bearing runs per row, power-of-two bucketed so the
    # compiled kernel shapes stay bounded (almost always 1)
    big = np.int32(1 << 30)
    runs_sorted = np.sort(np.where(valid_i, inst_run, big), axis=1)
    fresh = np.ones(runs_sorted.shape, bool)
    fresh[:, 1:] = runs_sorted[:, 1:] != runs_sorted[:, :-1]
    fresh &= runs_sorted < big
    counts = fresh.sum(axis=1)
    nru = _pow2_at_least(int(counts.max()) if B else 1, 1)
    own_runs = np.full((B, nru), ABSENT, np.int32)
    b_idx, j_idx = np.nonzero(fresh)
    pos = (np.cumsum(fresh, axis=1) - 1)[b_idx, j_idx]
    own_runs[b_idx, pos] = runs_sorted[b_idx, j_idx]

    ebits, epw, wpe, nwords = owner_bit_layout(RV, nru, NOP)
    words = np.zeros((B, nwords), np.uint32)
    if B:
        # chunk the batch so the [b, RV, NHR]-scale broadcasts stay within
        # a fixed working-set budget even for deep-HR ceiling caps
        NHR = max(arrays["r_hr"].shape[1], 1)
        per_row = RV * max(NHR, arrays["r_inst_owner_ent"].shape[1] * 8) * 4
        chunk = max(64, min(B, (64 << 20) // max(per_row, 1)))
        miss_i = ~(arrays["r_inst_present"] & arrays["r_inst_has_owners"])
        op_valid = arrays["r_op_vals"] >= 0
        op_miss = ~(arrays["r_op_present"] & arrays["r_op_has_owners"])
        g_one = (
            inst_run[:, :, None] == own_runs[:, None, :]
        ) & valid_i[:, :, None]  # [B, NI, NRU]
        # within-word bit offsets / word index per flat (entry, bit) —
        # monotone in flat order, so packing reduces with one reduceat
        flat = np.arange(RV * ebits)
        v_of, k_of = flat // ebits, flat % ebits
        if epw:
            w_of = v_of // epw
            off = ((v_of % epw) * ebits + k_of).astype(np.uint64)
        else:
            w_of = v_of * wpe + k_of // 32
            off = (k_of % 32).astype(np.uint64)
        starts = np.nonzero(np.diff(w_of, prepend=-1))[0]
        for lo in range(0, B, chunk):
            hi = min(B, lo + chunk)
            sl = slice(lo, hi)
            dir_i, hier_i = _owner_verdicts(
                hrv_role, hrv_scope, arrays["r_ra3"][sl], arrays["r_ra2"][sl],
                arrays["r_hr"][sl], arrays["r_inst_owner_ent"][sl],
                arrays["r_inst_owner_inst"][sl],
            )  # [b, RV, NI]
            dir_o, hier_o = _owner_verdicts(
                hrv_role, hrv_scope, arrays["r_ra3"][sl], arrays["r_ra2"][sl],
                arrays["r_hr"][sl], arrays["r_op_owner_ent"][sl],
                arrays["r_op_owner_inst"][sl],
            )  # [b, RV, NOP]
            bad_a = valid_i[sl][:, None, :] & (
                miss_i[sl][:, None, :] | ~(dir_i | hier_i)
            )
            bad_b = valid_i[sl][:, None, :] & (miss_i[sl][:, None, :] | ~dir_i)
            g1 = g_one[sl].astype(np.float32)
            a_run = np.matmul(bad_a.astype(np.float32), g1) > 0  # [b, RV, NRU]
            b_run = np.matmul(bad_b.astype(np.float32), g1) > 0
            op_a = op_valid[sl][:, None, :] & (
                op_miss[sl][:, None, :] | ~(dir_o | hier_o)
            )
            op_b = op_valid[sl][:, None, :] & (op_miss[sl][:, None, :] | ~dir_o)
            bits3 = np.concatenate([a_run, b_run, op_a, op_b], axis=2)
            contrib = bits3.reshape(hi - lo, RV * ebits).astype(np.uint64) << off
            words[sl] = np.add.reduceat(contrib, starts, axis=1).astype(
                np.uint32
            )
    return {
        "r_own_runs": own_runs,
        "r_own_bits": np.ascontiguousarray(words).view(np.int32),
    }


def encode_requests(
    requests: list[Request],
    compiled: CompiledPolicies,
    resource_adapter=None,
    skip_conditions: bool = False,
    caps: dict[str, int] | None = None,
    skip_owner_bits: bool = False,
    relation_tables: Optional[dict] = None,
    skip_relation_bits: bool = False,
) -> RequestBatch:
    """``skip_conditions=True`` skips the host-assisted condition pre-pass
    (and its adapter-driven batch degradation): whatIsAllowed never
    evaluates conditions (the reverse query copies them verbatim into the
    RQ tree, reference accessController.ts:383-400), so its encoder calls
    must not pay for them.

    ``caps`` overrides the adaptive per-batch padding caps (the native
    wire encoder's fixed floor shapes use this for parity testing)."""
    urns = compiled.urns
    it = compiled.interner.intern
    B = len(requests)
    W = max(len(compiled.entity_vocab), 1)

    # adaptive per-batch padding caps (shadow the module floors; every
    # reference below uses the batch-bucketed values)
    if caps is None:
        caps = compute_caps(requests, urns)
    NR = caps["NR"]; NI = caps["NI"]; NP = caps["NP"]
    NSUB = caps["NSUB"]; NACT = caps["NACT"]; NOP = caps["NOP"]
    NOWN = caps["NOWN"]; NRA = caps["NRA"]; NHR = caps["NHR"]
    NROLE = caps["NROLE"]; NACLE = caps["NACLE"]; NACLI = caps["NACLI"]
    NHRR = caps["NHRR"]

    entity_urn = urns.get("entity")
    property_urn = urns.get("property")
    operation_urn = urns.get("operation")
    resource_id_urn = urns.get("resourceID")
    role_urn = urns.get("role")
    scoping_urn = urns.get("roleScopingEntity")
    scoping_inst_urn = urns.get("roleScopingInstance")
    owner_ent_urn = urns.get("ownerEntity")
    owner_inst_urn = urns.get("ownerInstance")
    acl_ind_urn = urns.get("aclIndicatoryEntity")
    acl_inst_urn = urns.get("aclInstance")

    rgx = _RegexCache(compiled.entity_vocab)
    batch_entity_values: list[str] = []
    batch_entity_idx: dict[str, int] = {}
    # substring-relevance verification cache: (vocab tail, prop value)
    relevance_ok: dict[tuple[str, str], bool] = {}
    vocab_tails = [urn_tail(v) for v in compiled.entity_vocab]
    # two distinct target entity values sharing a tail would make substring
    # relevance ambiguous against id equality
    tails_ambiguous = len(set(vocab_tails)) != len(vocab_tails)

    def batch_entity(value: str) -> int:
        idx = batch_entity_idx.get(value)
        if idx is None:
            idx = len(batch_entity_values)
            batch_entity_idx[value] = idx
            batch_entity_values.append(value)
        return idx

    a = alloc_row_arrays(B, caps)
    eligible = np.ones((B,), bool)
    ineligible_reasons: dict[str, int] = {}

    def mark(b, reason="other"):
        eligible[b] = False
        ineligible_reasons[reason] = ineligible_reasons.get(reason, 0) + 1

    for b, request in enumerate(requests):
        target = request.target
        if not target:
            mark(b, "no-target")  # host-side 400 DENY
            continue
        a["r_has_target"][b] = True
        context = request.context
        raw_subject = get_field(context, "subject")
        subject = raw_subject or {}
        if get_field(subject, "token"):
            # Token-bearing rows stay kernel-eligible once the host
            # pipeline has resolved them (srv/evaluator.prepare_batch /
            # core/engine.prepare_context): resolution mutates the subject
            # in place and the oracle's own prepare_context is a no-op
            # afterwards, so kernel and oracle evaluate the identical
            # resolved context by construction.  Unprepared rows (wire/
            # native path, direct encodes) and failed resolutions degrade
            # per-row to the oracle exactly as before.
            if not getattr(request, "_context_prepared", False):
                mark(b, "token-subject")
                continue
            if not getattr(request, "_token_resolved", False):
                mark(b, "token-unresolved")
                continue
        if raw_subject is None:
            # quirk parity: a matched rule's ACL check dereferences
            # context.subject without a guard in the reference
            # (verifyACL.ts:112) unless a resourceID/operation
            # attribute's missing ACL metadata triggered the early
            # all-clear (:56-59) — subject-less rows can therefore throw,
            # which the kernel formula cannot represent.  ALL subject-less
            # rows go to the oracle (conservative: some could stay on
            # device via the early pass, but this is error-path traffic
            # and the simple rule is mirrored bit-for-bit by the native
            # C++ encoder)
            mark(b, "no-subject")
            continue

        # ---- subject / roles / actions
        subs = target.subjects or []
        acts = target.actions or []
        if len(subs) > NSUB or len(acts) > NACT:
            mark(b, "subject-action-cap")
            continue
        for j, attr in enumerate(subs):
            a["r_sub_ids"][b, j] = it(attr.id)
            a["r_sub_vals"][b, j] = it(attr.value)
        for j, attr in enumerate(acts):
            a["r_act_ids"][b, j] = it(attr.id)
            a["r_act_vals"][b, j] = it(attr.value)

        role_assocs = get_field(subject, "role_associations") or []
        roles = []
        for ra in role_assocs:
            role = get_field(ra, "role")
            if role is not None and role not in roles:
                roles.append(role)
        if len(roles) > NROLE:
            mark(b, "role-cap")
            continue
        for j, role in enumerate(roles):
            a["r_roles"][b, j] = it(role)

        # ---- resources: parse (entity, id*, prop*) runs / operations
        runs: list[dict] = []
        props: list[tuple[str, Optional[dict]]] = []
        ops: list[str] = []
        current_run: Optional[dict] = None
        ok = True
        for attr in target.resources or []:
            if attr.id == entity_urn:
                current_run = {"value": attr.value, "instances": []}
                runs.append(current_run)
            elif attr.id == resource_id_urn:
                if current_run is None:
                    # ids before any entity are never collected by the
                    # matcher/HR loops; ignore for the kernel
                    continue
                current_run["instances"].append(attr.value)
            elif attr.id == property_urn:
                # run index -1 when the property precedes any entity attr:
                # the reference never checks it (entityMatch still false)
                props.append((attr.value or "", len(runs) - 1))
            elif attr.id == operation_urn:
                ops.append(attr.value)
            else:
                ok = False  # unknown resource attribute id
                break
        if not ok or len(runs) > NR or len(props) > NP or len(ops) > NOP:
            mark(b, "resource-shape")
            continue
        if sum(len(r["instances"]) for r in runs) > NI:
            mark(b, "instance-cap")
            continue
        if tails_ambiguous and props:
            mark(b, "ambiguous-entity-tails")
            continue
        # verify substring relevance == tail equality for every
        # (vocab entity, request property) pair
        relevance_broken = False
        for value, _run_idx in props:
            for vt in vocab_tails:
                key = (vt, value)
                good = relevance_ok.get(key)
                if good is None:
                    prop_tail = urn_tail(value.split("#", 1)[0])
                    good = (vt in value) == (vt == prop_tail)
                    relevance_ok[key] = good
            # any pair breaking the equivalence disqualifies the request
            if any(not relevance_ok[(vt, value)] for vt in vocab_tails):
                relevance_broken = True
                break
        if relevance_broken:
            mark(b, "property-relevance")
            continue

        ctx_resources = get_field(context, "resources") or [] if context else []

        # ---- ACL pair collection (reference: verifyACL.ts:49-88): walk the
        # targeted resource attributes in order; the first one without ACL
        # metadata is the early all-clear, a malformed ACL fails, otherwise
        # (entity -> instances) accumulate across resources
        acl_short = 0
        acl_ents: list[int] = []
        acl_insts: list[list[int]] = []
        acl_ent_pos: dict[int, int] = {}
        for attr in target.resources or []:
            if attr.id != resource_id_urn and attr.id != operation_urn:
                continue
            ctx_res = find_ctx_resource(ctx_resources, attr.value)
            acl_list = None
            if ctx_res is not None:
                meta = get_field(ctx_res, "meta")
                acls = get_field(meta, "acls") if meta else None
                if acls and len(acls) > 0:
                    acl_list = acls
            if not acl_list:
                acl_short = 1  # no ACL metadata: verification passes
                break
            malformed = False
            for acl in acl_list:
                if get_field(acl, "id") == acl_ind_urn:
                    ent_id = it(get_field(acl, "value"))
                    pos = acl_ent_pos.get(ent_id)
                    if pos is None:
                        pos = len(acl_ents)
                        acl_ent_pos[ent_id] = pos
                        acl_ents.append(ent_id)
                        acl_insts.append([])
                    acl_attrs = get_field(acl, "attributes")
                    if not acl_attrs:
                        malformed = True  # missing ACL instances
                        break
                    for attribute in acl_attrs:
                        if get_field(attribute, "id") == acl_inst_urn:
                            acl_insts[pos].append(
                                it(get_field(attribute, "value"))
                            )
                        else:
                            malformed = True  # missing ACL instance value
                            break
                    if malformed:
                        break
                else:
                    malformed = True  # missing ACL indicatory entity
                    break
            if malformed:
                acl_short = 2
                break
        if acl_short == 0 and (
            len(acl_ents) > NACLE
            or any(len(insts) > NACLI for insts in acl_insts)
        ):
            mark(b, "acl-cap")  # oracle fallback
            continue
        if acl_short == 0 and (
            any(e < 0 for e in acl_ents)
            or any(i < 0 for insts in acl_insts for i in insts)
        ):
            # a None/missing ACL entity or instance value interns to ABSENT;
            # the kernel's validity masks would silently drop it and pass
            # where the reference fails closed (verifyACL.ts keys its map on
            # undefined) -- fall back to the oracle instead
            mark(b, "acl-absent-value")
            continue
        a["r_acl_short"][b] = acl_short
        if acl_short == 0:
            for j, ent_id in enumerate(acl_ents):
                a["r_acl_ent"][b, j] = ent_id
                for k, inst_id in enumerate(acl_insts[j]):
                    a["r_acl_inst"][b, j, k] = inst_id
        sid = get_field(subject, "id")
        a["r_subject_id"][b] = it(sid) if isinstance(sid, str) else ABSENT

        a["r_ctx_present"][b] = bool(context)
        a["r_n_entity_attrs"][b] = len(runs)
        a["r_has_props"][b] = len(props) > 0

        inst_slot = 0
        overflow = False
        for j, run in enumerate(runs):
            a["r_ent_vals"][b, j] = it(run["value"])
            a["r_ent_e"][b, j] = batch_entity(run["value"])
            a["r_ent_valid"][b, j] = True
            for inst in run["instances"]:
                ctx_res = find_ctx_resource(ctx_resources, inst)
                a["r_inst_run"][b, inst_slot] = j
                a["r_inst_id"][b, inst_slot] = (
                    it(inst) if isinstance(inst, str) else ABSENT
                )
                a["r_inst_valid"][b, inst_slot] = True
                if ctx_res is not None:
                    a["r_inst_present"][b, inst_slot] = True
                    owners = get_field(get_field(ctx_res, "meta"), "owners") or []
                    a["r_inst_has_owners"][b, inst_slot] = len(owners) > 0
                    if not _encode_owners(
                        a["r_inst_owner_ent"], a["r_inst_owner_inst"],
                        (b, inst_slot), owners, owner_ent_urn,
                        owner_inst_urn, it, NOWN,
                    ):
                        overflow = True
                inst_slot += 1
        for j, (value, run_idx) in enumerate(props):
            vid = it(value)
            a["r_prop_vals"][b, j] = vid
            a["r_prop_sfx"][b, j] = compiled.interner.suffix_id[vid]
            a["r_prop_run"][b, j] = run_idx
            prefix = value.split("#", 1)[0]
            a["r_prop_tail"][b, j] = it(urn_tail(prefix))
        for j, op_value in enumerate(ops):
            a["r_op_vals"][b, j] = it(op_value)
            ctx_res = None
            for res in ctx_resources:
                if get_field(res, "id") == op_value:
                    ctx_res = res
                    break
            if ctx_res is not None:
                a["r_op_present"][b, j] = True
                owners = get_field(get_field(ctx_res, "meta"), "owners") or []
                a["r_op_has_owners"][b, j] = len(owners) > 0
                if not _encode_owners(
                    a["r_op_owner_ent"], a["r_op_owner_inst"],
                    (b, j), owners, owner_ent_urn, owner_inst_urn, it, NOWN,
                ):
                    overflow = True

        # ---- role-association triples / pairs + HR closure
        ra3, ra2 = [], []
        for ra in role_assocs:
            role_id = it(get_field(ra, "role"))
            for ra_attr in get_field(ra, "attributes") or []:
                if get_field(ra_attr, "id") != scoping_urn:
                    continue
                ent_id = it(get_field(ra_attr, "value"))
                pair = (role_id, ent_id)
                if pair not in ra2:
                    ra2.append(pair)
                for inst in get_field(ra_attr, "attributes") or []:
                    if get_field(inst, "id") == scoping_inst_urn:
                        ra3.append((role_id, ent_id, it(get_field(inst, "value"))))
        hierarchical_scopes = get_field(subject, "hierarchical_scopes")
        if hierarchical_scopes is None and len(role_assocs) > 0:
            # with role associations present the oracle raises
            # InvalidRequestContext for a missing scope list (the reference
            # throws in both verifyACL and the HR phase); keep such
            # requests on the oracle path
            mark(b, "missing-hr-scopes")
            continue
        hr_pairs: list[tuple[Optional[str], str]] = []
        _flatten_hr(hierarchical_scopes, hr_pairs)
        hr_enc = []
        for role, org in hr_pairs:
            entry = (it(role) if role is not None else ABSENT, it(org))
            if entry not in hr_enc:
                hr_enc.append(entry)
        # verifyACL's own flatten: per-node role override, pre-order; the
        # distinct role keys (None excluded — it can never be a rule's
        # scoped role) keep first-occurrence order because the create-path
        # scan is order-sensitive (reference: verifyACL.ts:160-171)
        acl_hr_pairs: list = []
        _flatten_acl_hr(hierarchical_scopes, acl_hr_pairs)
        acl_hr_enc: list[tuple[int, int]] = []
        hr_roles: list[int] = []
        for role, org in acl_hr_pairs:
            rid = it(role) if role is not None else ABSENT
            entry = (rid, it(org))
            if entry not in acl_hr_enc:
                acl_hr_enc.append(entry)
            if role is not None and rid not in hr_roles:
                hr_roles.append(rid)
        if (
            len(ra3) > NRA or len(ra2) > NRA or len(hr_enc) > NHR
            or len(acl_hr_enc) > NHR or len(hr_roles) > NHRR or overflow
        ):
            mark(b, "hr-cap")
            continue
        for j, t3 in enumerate(ra3):
            a["r_ra3"][b, j] = t3
        for j, t2 in enumerate(ra2):
            a["r_ra2"][b, j] = t2
        for j, t2 in enumerate(hr_enc):
            a["r_hr"][b, j] = t2
        for j, t2 in enumerate(acl_hr_enc):
            a["r_acl_hr"][b, j] = t2
        for j, rid in enumerate(hr_roles):
            a["r_hr_roles"][b, j] = rid
        a["r_n_ra"][b] = len(role_assocs)

    # ---- regex matrices [W, E]
    E = max(len(batch_entity_values), 1)
    rgx_set = np.zeros((W, E), bool)
    pfx_neq = np.zeros((W, E), bool)
    for e, value in enumerate(batch_entity_values):
        set_col, neq_col = rgx.lookup(value)
        if set_col:
            rgx_set[:, e] = set_col
            pfx_neq[:, e] = neq_col

    # ---- host-assisted condition pre-pass [C, B]
    C = len(compiled.conditions)
    cond_true = np.zeros((C, B), bool)
    cond_abort = np.zeros((C, B), bool)
    cond_code = np.full((C, B), 200, np.int32)
    cand_cache: dict[tuple, np.ndarray] = {}
    cond_msg: dict[tuple[int, int], str] = {}
    cond_list = [] if skip_conditions else compiled.conditions
    query_cis: set[int] = set()
    if resource_adapter is not None:
        query_cis = {
            ci for ci, cc in enumerate(cond_list)
            if cc.context_query is not None and (
                getattr(cc.context_query, "filters", None)
                or getattr(cc.context_query, "query", None)
            )
        }
    if query_cis:
        # adapter-driven context queries pull resources inside the rule
        # loop and MERGE the result into request.context for the rule's own
        # condition (and everything evaluated after it — reference:
        # accessController.ts:227-254).  The prefetch plan keeps a row on
        # device when that merge provably cannot leak into any later
        # context read (see _prefetch_context_queries); every other
        # candidate row degrades per-row to the oracle as before.
        _prefetch_context_queries(
            compiled, cond_list, sorted(query_cis), a, eligible, mark,
            rgx_set, cand_cache, requests, resource_adapter,
            cond_true, cond_abort, cond_code, cond_msg,
        )
    for ci, cc in enumerate(cond_list):
        if ci in query_cis:
            continue  # handled by the prefetch plan above
        for b, request in enumerate(requests):
            if not eligible[b]:
                continue
            try:
                cond_true[ci, b] = bool(condition_matches(cc.condition, request))
            except Exception as err:  # deny-by-default with the error code
                code = getattr(err, "code", 500)
                cond_abort[ci, b] = True
                cond_code[ci, b] = code if isinstance(code, int) else 500
                # the reference surfaces the error text in
                # operation_status.message (accessController.ts:259-270);
                # cached here so abort rows need no oracle re-run
                cond_msg[(ci, b)] = str(err) or "Unknown Error!"

    # host-precomputed stage-B owner bitplanes: the kernels consume these
    # packed verdicts instead of the raw ra3/ra2/hr/owner-pair arrays
    # (which stay allocated for the ACL stage and the native ABI)
    a.update(pack_owner_bitplanes(a, compiled, skip=skip_owner_bits))
    # relation-closure bitplanes (ReBAC, ops/relation.py): packed against
    # the serving store's flat verdict tables; fail-closed without them
    from .relation import pack_relation_bitplanes

    a.update(pack_relation_bitplanes(
        a, compiled, relation_tables, skip=skip_relation_bits
    ))

    return RequestBatch(
        B=B,
        arrays=a,
        rgx_set=rgx_set,
        pfx_neq=pfx_neq,
        cond_true=cond_true,
        cond_abort=cond_abort,
        cond_code=cond_code,
        eligible=eligible,
        requests=requests,
        ineligible_reasons=ineligible_reasons,
        cond_msg=cond_msg,
    )


def _row_candidates(compiled, a, b, rgx_set, cand_cache):
    """(signature key, candidate target-row vector [T]) for request row
    ``b`` — ops/prefilter.py candidacy, a sound over-approximation of the
    kernel's target match, cached per distinct resource/action signature.
    Candidacy depends only on ``request.target`` (never on context), so it
    is invariant under the reference's context merge."""
    from .prefilter import candidate_rows

    ents = a["r_ent_vals"][b]
    cols = a["r_ent_e"][b]
    valid = ents >= 0
    ent_ids = np.unique(ents[valid])
    ent_cols = np.array(
        [cols[valid][ents[valid] == e][0] for e in ent_ids], np.int64
    )
    ops = a["r_op_vals"][b]
    op_ids = np.unique(ops[ops >= 0])
    acts = a["r_act_vals"][b]
    act_vals = np.unique(acts[acts >= 0])
    key = (tuple(ent_ids.tolist()), tuple(op_ids.tolist()),
           tuple(act_vals.tolist()))
    cand = cand_cache.get(key)
    if cand is None:
        cand = candidate_rows(
            compiled, ent_ids, ent_cols, op_ids, act_vals, rgx_set
        )
        cand_cache[key] = cand
    return key, cand


def _merge_safe(compiled, flat_index, s_r, kp_r, cand, row_acl_ok) -> bool:
    """True when prefetching query rule R's context pull on the host
    provably cannot change any decision for this row signature.

    The reference's pull replaces ``request.context`` with the merged
    ``{"target", "context", "_queryResult"}`` object, so everything
    evaluated AFTER R in walk order loses ``context.subject`` and
    ``context.resources``.  The kernel encodes every stage from the
    ORIGINAL context, so a row is fusable only when no node after R can
    read the context at all:

    - a rule after R reads context through its role-gated subject match,
      its HR-scope check (scoping entity), its condition, or its
      post-match ACL verification (which, with the merged context, early
      all-clears when the row's original ACL state was the no-metadata
      all-clear ``r_acl_short == 1``, and diverges otherwise);
    - a policy evaluated after R's policy reads context when its target is
      role-gated or carries a scoping entity (policy_subject_match);
    - a later set's target match reads context only through a role-gated
      subject.

    Nodes whose targets are not candidates for the row's signature cannot
    match in either world (candidacy is context-free), so they are safe by
    construction."""
    arr = compiled.arrays
    S, KP, KR = compiled.S, compiled.KP, compiled.KR
    rt = arr["rule_target"]
    rht = arr["rule_has_target"]
    has_role = arr["t_has_role"]
    has_scoping = arr["t_has_scoping"]
    skip_acl = arr["t_skip_acl"]
    has_cond = arr["rule_cond"] >= 0
    later = np.arange(S * KP * KR).reshape(S, KP, KR) > flat_index
    reach_t = rht & cand[rt]
    ctx_read = (
        (~rht & has_cond)
        | (reach_t & (
            has_role[rt] | has_scoping[rt] | has_cond
            | ~(skip_acl[rt] | row_acl_ok)
        ))
    )
    if (arr["rule_valid"] & later & ctx_read).any():
        return False
    pol_later = np.arange(S * KP).reshape(S, KP) > (s_r * KP + kp_r)
    pt = arr["pol_target"]
    pol_ctx = (
        arr["pol_valid"] & arr["pol_has_target"] & cand[pt]
        & (has_role[pt] | has_scoping[pt])
    )
    if (pol_ctx & pol_later).any():
        return False
    st = arr["set_target"]
    set_ctx = (
        arr["set_valid"] & arr["set_has_target"] & cand[st] & has_role[st]
    )
    if (set_ctx & (np.arange(S) > s_r)).any():
        return False
    return True


def _prefetch_context_queries(
    compiled, cond_list, query_cis, a, eligible, mark, rgx_set, cand_cache,
    requests, adapter, cond_true, cond_abort, cond_code, cond_msg,
) -> None:
    """Stage (b) of the host eligibility pipeline: for every row that can
    reach exactly ONE adapter-backed context-query rule R and whose later
    walk provably never reads the merged context (_merge_safe), pull R's
    context query concurrently over the pooled transport and evaluate R's
    condition against the SAME merged view the reference builds
    (accessController.ts:227-254, pull_context_resources) — the row then
    rides the kernel.  Rows reaching several query rules, rows whose later
    walk could observe the merge, and rows whose prefetch fails (after the
    adapter's one transient retry, srv/adapters.py) degrade per-row to the
    scalar oracle, never to a changed decision."""
    arr = compiled.arrays
    KP, KR = compiled.KP, compiled.KR
    rule_pos = []
    for ci in query_cis:
        flat = cond_list[ci].rule_flat_index
        s, rem = divmod(flat, KP * KR)
        kp, kr = divmod(rem, KR)
        rule_pos.append((ci, flat, s, kp, kr))
    safety_cache: dict[tuple, bool] = {}
    jobs: list[tuple[int, int]] = []
    for b in np.nonzero(eligible)[0]:
        b = int(b)
        key, cand = _row_candidates(compiled, a, b, rgx_set, cand_cache)
        reach = []
        for ci, flat, s, kp, kr in rule_pos:
            if arr["rule_has_target"][s, kp, kr]:
                if cand[int(arr["rule_target"][s, kp, kr])]:
                    reach.append((ci, flat, s, kp, kr))
            else:
                reach.append((ci, flat, s, kp, kr))  # reachable everywhere
        if not reach:
            continue  # provably never pulls: pre-pass results stay exact
        if len(reach) > 1:
            # a second pull would see the first pull's merged context (and
            # resolve its filters against it); not replayable host-side
            mark(b, "context-query")
            continue
        ci, flat, s, kp, kr = reach[0]
        row_acl_ok = int(a["r_acl_short"][b]) == 1
        if arr["rule_has_target"][s, kp, kr]:
            # R's own ACL verification runs on the MERGED context in the
            # reference (verifyACL after the condition): only rows whose
            # original ACL state is the no-metadata early all-clear (or a
            # skipACL rule) behave identically in both worlds
            rt = int(arr["rule_target"][s, kp, kr])
            if not (bool(arr["t_skip_acl"][rt]) or row_acl_ok):
                mark(b, "context-query")
                continue
        skey = (key, ci, row_acl_ok)
        safe = safety_cache.get(skey)
        if safe is None:
            safe = _merge_safe(compiled, flat, s, kp, cand, row_acl_ok)
            safety_cache[skey] = safe
        if not safe:
            mark(b, "context-query")
            continue
        jobs.append((ci, b))
    if not jobs:
        return
    # concurrent prefetch: filters resolve against the ORIGINAL request
    # (no earlier pull can reach these rows), exactly as the reference's
    # first pull would
    pairs = [(cond_list[ci].context_query, requests[b]) for ci, b in jobs]
    if hasattr(adapter, "query_many"):
        results = adapter.query_many(pairs)
    else:
        results = []
        for cq, request in pairs:
            try:
                results.append(adapter.query(cq, request))
            except Exception as err:  # noqa: BLE001 — per-row fallback
                results.append(err)
    for (ci, b), result in zip(jobs, results):
        if isinstance(result, Exception):
            mark(b, "context-query-error")
            continue
        request = requests[b]
        merged = copy.copy(request)
        # the reference's pull_context_resources merge shape, verbatim
        merged.context = {
            "target": request.target,
            "context": request.context,
            "_queryResult": result,
        }
        cc = cond_list[ci]
        try:
            cond_true[ci, b] = bool(condition_matches(cc.condition, merged))
        except Exception as err:  # deny-by-default with the error code
            code = getattr(err, "code", 500)
            cond_abort[ci, b] = True
            cond_code[ci, b] = code if isinstance(code, int) else 500
            cond_msg[(ci, b)] = str(err) or "Unknown Error!"


def _encode_owners(
    ent_out, inst_out, index, owners, owner_ent_urn, owner_inst_urn, it,
    nown=NOWN,
) -> bool:
    """Flatten owner entries into (owner-entity-value, owner-instance)
    pairs; only well-formed entries participate in matching."""
    slot = 0
    for owner in owners:
        if get_field(owner, "id") != owner_ent_urn:
            continue
        val = it(get_field(owner, "value"))
        for inst_attr in get_field(owner, "attributes") or []:
            if get_field(inst_attr, "id") == owner_inst_urn:
                if slot >= nown:
                    return False
                ent_out[index + (slot,)] = val
                inst_out[index + (slot,)] = it(get_field(inst_attr, "value"))
                slot += 1
    return True
