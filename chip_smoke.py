#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives ``access_control_srv_tpu_torch`` (never JAX, never the JAX package)
through its main path and checks every kernel on it against its plain
PyTorch version:

1. device: the card's name and power limit;
2. build: every CUDA source of the path, compiled with nvcc at first use;
3. kernel vs plain: the dense decision kernel against ``kernel_ref`` on
   the card, exactly equal, on every supported fixture tree, the seed data
   and the 511-rule scoped tree, in all four with_acl x with_hr variants;
4. kernel vs the port's scalar oracle on a 1024-row sample per tree;
5. end to end (the main path): ``HybridEvaluator(engine).is_allowed_batch``
   on 4096 mixed requests against the 511-rule tree, every response equal
   to ``engine.is_allowed`` on the same request (ineligible rows are served
   by the oracle inside the evaluator);
6. throughput: the seed tree at 2^18 rows and the scoped tree at 2^16 rows
   (kernel and plain version timed with CUDA events), and the evaluator at
   4096 rows.

Any mismatch or error exits non-zero.  The line before the last is the
kernel table as one JSON object; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA it exits non-zero before
printing any result.  Run from the repository root::

    python3 chip_smoke.py
"""

from __future__ import annotations

import copy
import json
import os
import random
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from access_control_srv_tpu_torch.core import (
    AccessController,
    load_policy_sets,
    load_policy_sets_from_file,
    load_seed_files,
)
from access_control_srv_tpu_torch.models import Attribute, Request, Target, Urns
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops import kernel as kmod
from access_control_srv_tpu_torch.ops.carry import batch_from_numpy, tables_from_numpy
from access_control_srv_tpu_torch.ops.encode import (
    _CAPS_FLOOR,
    RequestBatch,
    fits_floor,
    request_needs,
)
from access_control_srv_tpu_torch.ops.kernel_ref import decide_dense_ref
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator

REPO = os.path.dirname(os.path.abspath(__file__))
URNS = Urns()

ORG = "urn:restorecommerce:acs:model:organization.Organization"
USER = "urn:restorecommerce:acs:model:user.User"
ADDR = "urn:restorecommerce:acs:model:address.Address"
LOC = "urn:restorecommerce:acs:model:location.Location"
WIDGET = "urn:restorecommerce:acs:model:widget.Widget"
BUCKET = "urn:restorecommerce:acs:model:bucket.Bucket"
PO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides"
DO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides"

SUBJECTS = ["ada", "ben", "gil", "dee", "eva", "kai", "zoe", "Alice"]
ROLES = ["member", "manager", "guest", "Admin", "SimpleUser", "supervisor"]
ENTITIES = [ORG, USER, ADDR, LOC, WIDGET, BUCKET]
ACTIONS = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"],
           URNS["execute"]]
PROPS = [ORG + "#name", ORG + "#secret_field", USER + "#name",
         USER + "#password", ADDR + "#street", LOC + "#address",
         LOC + "#id", LOC + "#description", ORG + "#id", ORG + "#description"]
OWNERS = ["Org1", "Org2", "Org3", "Org4", "SuperOrg1", "otherOrg"]
STRESS_ENTITIES = [
    f"urn:restorecommerce:acs:model:stress{k}.Stress{k}" for k in range(64)
]
STRESS_ROLES = [f"role-{k}" for k in range(97)]
DEC_CODE = {"INDETERMINATE": 0, "PERMIT": 1, "DENY": 2}

KERNEL_SOURCE = "access_control_srv_tpu_torch/ops/csrc/decide_dense.cu"
KERNEL_REPLACES = "access_control_srv_tpu/ops/kernel.py:1015"
# H100 SXM peaks (NVIDIA data sheet): HBM rate, and the scalar (non-tensor
# core) float32 rate used for the kernel's int32 compare/logic operations
PEAK_BYTES_PER_S = 3.35e12
PEAK_SCALAR_OPS_PER_S = 67e12
ITERS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


# -------------------------------------------------------------- policy trees


def stress_doc(n_rules: int, scoped: bool = False):
    """The synthetic stress tree as a nested ``policy_sets`` document:
    deny-overrides set of permit-overrides policies, role/entity/action-
    targeted rules with interleaved PERMIT/DENY (every third rule DENY).
    ``scoped=True`` adds a roleScopingEntity to every rule's role subject.
    A copy of the JAX package's bench generator (bench_all._stress_doc
    with its defaults for the other options)."""
    n_policies = max(1, n_rules // 400)
    per_policy = n_rules // n_policies
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    policies = []
    rid = 0
    for p in range(n_policies):
        rules = []
        for q in range(per_policy):
            entity = STRESS_ENTITIES[(p * 31 + q) % len(STRESS_ENTITIES)]
            subjects = [{"id": URNS["role"], "value": f"role-{rid % 97}"}]
            if scoped:
                subjects.append({
                    "id": URNS["roleScopingEntity"],
                    "value": ORG,
                })
            effect = "PERMIT" if rid % 3 else "DENY"
            rules.append(
                {
                    "id": f"r{rid}",
                    "target": {
                        "subjects": subjects,
                        "resources": [{"id": URNS["entity"], "value": entity}],
                        "actions": [
                            {"id": URNS["actionID"],
                             "value": actions[rid % len(actions)]}
                        ],
                    },
                    "effect": effect,
                    "evaluation_cacheable": False,
                }
            )
            rid += 1
        policies.append(
            {"id": f"p{p}", "combining_algorithm": PO, "rules": rules}
        )
    doc = {
        "policy_sets": [
            {"id": "stress", "combining_algorithm": DO, "policies": policies}
        ]
    }
    return doc


def engine_for(name: str) -> AccessController:
    engine = AccessController()
    if name == "scoped_511":
        sets = load_policy_sets(stress_doc(511, scoped=True))
    elif name == "seed_data":
        seed = os.path.join(REPO, "data", "seed_data")
        sets = load_seed_files(
            os.path.join(seed, "policy_sets.yaml"),
            os.path.join(seed, "policies.yaml"),
            os.path.join(seed, "rules.yaml"),
        )
    else:
        sets = load_policy_sets_from_file(
            os.path.join(REPO, "tests", "fixtures", name))
    for ps in sets:
        engine.update_policy_set(ps)
    return engine


def tree_names() -> list[str]:
    fixtures = sorted(
        n for n in os.listdir(os.path.join(REPO, "tests", "fixtures"))
        if n.endswith(".yml")
    )
    return fixtures + ["seed_data", "scoped_511"]


# ----------------------------------------------------------------- requests


def _listify(value) -> list:
    if value is None:
        return []
    if isinstance(value, (list, tuple)):
        return list(value)
    return [value]


def build_request(subject_id=None, subject_role=None,
                  role_scoping_entity=None, role_scoping_instance=None,
                  resource_type=None, resource_id=None,
                  resource_property=None, action_type=None,
                  owner_indicatory_entity=None, owner_instance=None,
                  acl_indicatory_entity=None, acl_instances=None,
                  multiple_acl_indicatory_entity=None, org_instances=None,
                  subject_instances=None, hierarchical_scopes=None) -> Request:
    """The canonical request/context shape the service receives (subject
    [role, subject-id]; (entity, resource-id, properties...) runs or
    operations; owners, ACLs, role associations and HR scopes in the
    context)."""
    subjects = [
        Attribute(id=URNS["role"], value=subject_role or "member"),
        Attribute(id=URNS["subjectID"], value=subject_id or ""),
    ]
    resources: list[Attribute] = []
    types = _listify(resource_type)
    ids = _listify(resource_id)
    props = _listify(resource_property)
    if action_type == URNS["execute"]:
        for operation_name in types:
            resources.append(Attribute(id=URNS["operation"], value=operation_name))
    else:
        for i, rtype in enumerate(types):
            resources.append(Attribute(id=URNS["entity"], value=rtype))
            resources.append(Attribute(
                id=URNS["resourceID"], value=ids[i] if i < len(ids) else ""))
            for prop in props:
                resources.append(Attribute(id=URNS["property"], value=prop))
    actions = [Attribute(id=URNS["actionID"], value=action_type or "")]

    acls: list[dict] = []
    if acl_indicatory_entity and acl_instances:
        acls = [{
            "id": URNS["aclIndicatoryEntity"], "value": acl_indicatory_entity,
            "attributes": [{"id": URNS["aclInstance"], "value": inst}
                           for inst in acl_instances],
        }]
    elif multiple_acl_indicatory_entity and org_instances and subject_instances:
        acls = [
            {"id": URNS["aclIndicatoryEntity"],
             "value": multiple_acl_indicatory_entity[0],
             "attributes": [{"id": URNS["aclInstance"], "value": inst}
                            for inst in org_instances]},
            {"id": URNS["aclIndicatoryEntity"],
             "value": multiple_acl_indicatory_entity[1],
             "attributes": [{"id": URNS["aclInstance"], "value": inst}
                            for inst in subject_instances]},
        ]
    owner_instances = _listify(owner_instance)
    ctx_resources: list[dict] = []
    for i, rid in enumerate(ids if action_type != URNS["execute"] else types):
        owners = []
        if owner_indicatory_entity and owner_instances:
            inst = owner_instances[min(i, len(owner_instances) - 1)]
            owners = [{
                "id": URNS["ownerIndicatoryEntity"],
                "value": owner_indicatory_entity,
                "attributes": [{"id": URNS["ownerInstance"], "value": inst}],
            }]
        ctx_resources.append({"id": rid, "meta": {"owners": owners, "acls": acls}})
    role_associations = []
    if subject_role and role_scoping_entity and role_scoping_instance:
        role_associations = [{
            "role": subject_role,
            "attributes": [{
                "id": URNS["roleScopingEntity"], "value": role_scoping_entity,
                "attributes": [{"id": URNS["roleScopingInstance"], "value": inst}
                               for inst in _listify(role_scoping_instance)],
            }],
        }]
    if hierarchical_scopes is None:
        hierarchical_scopes = [{
            "id": "SuperOrg1", "role": subject_role,
            "children": [{"id": "Org1", "children": [
                {"id": "Org2", "children": [{"id": "Org3"}]}]}],
        }] if role_scoping_entity and role_scoping_instance else []
    return Request(
        target=Target(subjects=subjects, resources=resources, actions=actions),
        context={
            "resources": ctx_resources,
            "subject": {
                "id": subject_id,
                "role_associations": role_associations,
                "hierarchical_scopes": hierarchical_scopes,
            },
        },
    )


def grid_requests(rng: random.Random, n: int, stress: bool = False,
                  acl: bool = True) -> list[Request]:
    """A randomized sweep over the request option space: single and multi
    entity rows, properties, owners in and out of scope, ACL pairs (when
    ``acl``) and execute operations.  ``stress`` draws entities and roles
    from the stress tree's vocabulary."""
    entities = STRESS_ENTITIES if stress else ENTITIES
    roles = STRESS_ROLES if stress else ROLES
    actions = ACTIONS[:4] if stress else ACTIONS
    out = []
    for _ in range(n):
        action = rng.choice(actions)
        multi = rng.random() < 0.3 and action != URNS["execute"]
        if action == URNS["execute"]:
            rtype = rng.choice(["mutation.runPipeline", "mutation.other"])
            rid = rtype
        elif multi:
            rtype = rng.sample(entities, 2)
            rid = [f"id-{i}" for i in range(2)]
        else:
            rtype = rng.choice(entities)
            rid = "id-0"
        prop = None
        if not stress and rng.random() < 0.5 and action != URNS["execute"]:
            prop = rng.sample(PROPS, rng.randint(1, 2))
        owner = owner_ent = None
        if rng.random() < 0.7:
            owner_ent = ORG
            owner = ([rng.choice(OWNERS) for _ in range(2)] if multi
                     else rng.choice(OWNERS))
        subject = rng.choice(SUBJECTS)
        acl_kwargs = {}
        roll = rng.random() if acl else 1.0
        if roll < 0.2:
            acl_kwargs = dict(
                acl_indicatory_entity=rng.choice([ORG, USER]),
                acl_instances=rng.sample(OWNERS + SUBJECTS, rng.randint(1, 3)),
            )
        elif roll < 0.35:
            acl_kwargs = dict(
                multiple_acl_indicatory_entity=[ORG, USER],
                org_instances=rng.sample(OWNERS, rng.randint(1, 3)),
                subject_instances=rng.sample([subject] + SUBJECTS, 2),
            )
        out.append(build_request(
            subject_id=subject, subject_role=rng.choice(roles),
            role_scoping_entity=ORG, role_scoping_instance=rng.choice(OWNERS),
            resource_type=rtype, resource_id=rid, resource_property=prop,
            action_type=action, owner_indicatory_entity=owner_ent,
            owner_instance=owner, **acl_kwargs,
        ))
    return out


def odd_requests(rng: random.Random, stress: bool = False) -> list[Request]:
    """Rows the kernel cannot represent, served by the oracle: no target,
    an unresolved token subject, role associations without HR scopes, a
    subject list beyond the widest padding, and entity runs beyond the
    floor caps (kernel-eligible at the wider shape)."""
    entities = STRESS_ENTITIES if stress else ENTITIES
    roles = STRESS_ROLES if stress else ROLES
    out = [Request(target=None, context={"subject": {"id": "ada"}})]
    tok = build_request(subject_id="ada", subject_role=rng.choice(roles),
                        role_scoping_entity=ORG, role_scoping_instance="Org1",
                        resource_type=rng.choice(entities), resource_id="id-0",
                        action_type=URNS["read"])
    tok.context["subject"]["token"] = "opaque-token"
    out.append(tok)
    noscope = build_request(subject_id="ben", subject_role=rng.choice(roles),
                            role_scoping_entity=ORG,
                            role_scoping_instance="Org2",
                            resource_type=rng.choice(entities),
                            resource_id="id-0", action_type=URNS["modify"])
    del noscope.context["subject"]["hierarchical_scopes"]
    out.append(noscope)
    wide = build_request(subject_id="gil", subject_role=rng.choice(roles),
                         resource_type=rng.choice(entities),
                         resource_id="id-0", action_type=URNS["read"])
    wide.target.subjects += [Attribute(id=URNS["subjectID"], value=f"x{i}")
                             for i in range(40)]
    out.append(wide)
    deep = build_request(subject_id="dee", subject_role=rng.choice(roles),
                         role_scoping_entity=ORG, role_scoping_instance="Org1",
                         resource_type=rng.sample(entities, 6),
                         resource_id=[f"id-{i}" for i in range(6)],
                         action_type=URNS["read"],
                         owner_indicatory_entity=ORG, owner_instance="Org1")
    out.append(deep)
    return out


def bench_batch(compiled, base: int, total: int, stress: bool = False
                ) -> RequestBatch:
    """Encode ``base`` distinct requests, then tile to ``total`` rows at
    array level (the JAX package's bench.py shape: half the rows carry the
    super-admin role; ``stress`` draws the stress tree's vocabulary)."""
    entities = [ORG, USER, ADDR, LOC] if not stress else STRESS_ENTITIES
    actions = [URNS["read"], URNS["modify"], URNS["create"], URNS["delete"]]
    rng = np.random.default_rng(42)
    requests = []
    for i in range(base):
        if stress:
            role = f"role-{int(rng.integers(97))}"
        else:
            role = "superadministrator-r-id" if i % 2 == 0 else f"role-{i % 7}"
        entity = entities[int(rng.integers(len(entities)))]
        org = OWNERS[int(rng.integers(len(OWNERS)))]
        ras = [{"role": role, "attributes": []}]
        resources = []
        if stress:
            ras = [{"role": role, "attributes": [{
                "id": URNS["roleScopingEntity"], "value": ORG,
                "attributes": [{"id": URNS["roleScopingInstance"],
                                "value": org}]}]}]
            resources = [{"id": f"res-{i % 1024}", "meta": {"owners": [{
                "id": URNS["ownerIndicatoryEntity"], "value": ORG,
                "attributes": [{"id": URNS["ownerInstance"],
                                "value": OWNERS[int(rng.integers(4))]}]}]}}]
        requests.append(Request(
            target=Target(
                subjects=[
                    Attribute(id=URNS["role"], value=role),
                    Attribute(id=URNS["subjectID"], value=f"user-{i % 512}"),
                ],
                resources=[
                    Attribute(id=URNS["entity"], value=entity),
                    Attribute(id=URNS["resourceID"], value=f"res-{i % 1024}"),
                ],
                actions=[Attribute(
                    id=URNS["actionID"],
                    value=actions[int(rng.integers(len(actions)))])],
            ),
            context={
                "resources": resources,
                "subject": {
                    "id": f"user-{i % 512}",
                    "role_associations": ras,
                    "hierarchical_scopes": [{
                        "id": "SuperOrg1", "role": role,
                        "children": [{"id": "Org1", "children": [
                            {"id": "Org2"}]}]}] if stress else [],
                },
            },
        ))
    batch = encode_requests(requests, compiled)
    if not batch.eligible.all():
        raise AssertionError("bench requests must be kernel-eligible")
    reps = -(-total // base)
    arrays = {k: np.tile(v, (reps,) + (1,) * (v.ndim - 1))[:total]
              for k, v in batch.arrays.items()}
    return RequestBatch(
        B=total, arrays=arrays, rgx_set=batch.rgx_set, pfx_neq=batch.pfx_neq,
        cond_true=np.tile(batch.cond_true, (1, reps))[:, :total],
        cond_abort=np.tile(batch.cond_abort, (1, reps))[:, :total],
        cond_code=np.tile(batch.cond_code, (1, reps))[:, :total],
        eligible=np.ones((total,), bool),
    )


# ------------------------------------------------------------ measurements


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def device_inputs(compiled, batch, device):
    """(tables, real rows, batch tensors, with_acl, with_hr) on ``device``
    as DecisionKernel carries them."""
    c = tables_from_numpy(compiled.arrays, device, keys=kmod.TABLE_ARRAYS)
    b, r = batch_from_numpy(batch, device, keys=kmod.ROW_ARRAYS)
    with_acl = bool((batch.arrays["r_acl_ent"] >= 0).any())
    return c, b, r, with_acl, kmod.tree_needs_hr(compiled.arrays)


def time_ms(fn, iters: int = ITERS) -> float:
    """Mean milliseconds per call on the device (CUDA events), after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(c: dict, r: dict) -> tuple[float, str, int, int]:
    """The least time the card could take for one call: the larger of the
    bytes the kernel must move (every input once, outputs once) over the
    HBM rate and the int32 compare/logic operations of its loops at these
    shapes over the scalar peak.  Returns (ms, bound_by, bytes, ops)."""
    d = kmod._dims(c, r)
    nbytes = sum(int(c[k].nbytes) for k in kmod.TABLE_ARRAYS)
    nbytes += sum(int(r[k].nbytes) for k in kmod.ROW_ARRAYS + kmod.BATCH_ARRAYS)
    nbytes += 3 * 4 * d["B"]
    per_target = (
        d["KS"] * d["NSUB"] + d["NROLE"] + d["KA"] * d["NACT"]
        + 3 * d["KE"] * d["NR"] + d["KO"] * d["NOP"]
        + d["NP"] * (d["KE"] + 2 * d["KPR"]) + 4 * d["NR"] + 16
    )
    per_rule, per_policy = 12, 16 + d["KE"] * d["NR"]
    per_row = (d["T"] * per_target + d["S"] * d["KP"] * d["KR"] * per_rule
               + d["S"] * d["KP"] * per_policy)
    ops = d["B"] * per_row
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_SCALAR_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def kernel_vs_plain(c, r, with_acl, with_hr):
    """Kernel and plain version on the same device tensors: (kernel out,
    plain out), int32 [3, B] each."""
    got = kmod.decide_dense(c, r, with_acl, with_hr)
    want = torch.stack(decide_dense_ref(c, r, with_acl, with_hr))
    torch.cuda.synchronize()
    return got, want


def response_key(resp):
    st = resp.operation_status
    return (resp.decision, resp.evaluation_cacheable, st.code, st.message,
            [o.to_dict() if hasattr(o, "to_dict") else o
             for o in (resp.obligations or [])])


# ------------------------------------------------------------------ phases


def phase_kernel_vs_plain(device, n_rows: int, stats: dict) -> dict:
    """Phase 3 and 4 over every tree; returns per-variant row counts."""
    variants: dict[tuple, int] = {}
    seen = set()
    n_inel = 0
    for name in tree_names():
        engine = engine_for(name)
        compiled = compile_policies(engine.policy_sets, engine.urns)
        if not compiled.supported or compiled.n_rules == 0:
            log(f"  {name}: not kernel-supported "
                f"({compiled.unsupported_reason or 'no rules'}), skipped")
            continue
        if kmod.tree_needs_rel(compiled.arrays):
            log(f"  {name}: relation-path targets (not ported yet), skipped")
            continue
        rng = random.Random(zlib.crc32(name.encode()))
        stress = name == "scoped_511"
        with_pairs = grid_requests(rng, n_rows, stress) + odd_requests(rng, stress)
        no_pairs = grid_requests(rng, n_rows, stress, acl=False)
        for reqs in (with_pairs, no_pairs):
            batch = encode_requests(reqs, compiled)
            n_inel += int((~batch.eligible).sum())
            c, b, r, with_acl, with_hr = device_inputs(compiled, batch, device)
            got, want = kernel_vs_plain(c, r, with_acl, with_hr)
            err = int((got.long() - want.long()).abs().max())
            stats["max_abs_err"] = max(stats["max_abs_err"], err)
            if err != 0:
                bad = (got != want).any(0).nonzero().flatten()[:5].tolist()
                raise AssertionError(
                    f"{name}: kernel != plain at rows {bad}: "
                    f"{got[:, bad].tolist()} vs {want[:, bad].tolist()}")
            key = (with_acl, with_hr)
            variants[key] = variants.get(key, 0) + b
            dec = got[0, :b].cpu().numpy()
            elig = batch.eligible
            seen.update(int(x) for x in np.unique(dec[elig]))
            # phase 4: the port's scalar oracle on the eligible rows of a
            # 1024-row sample
            host = got[:, :b].cpu().numpy()
            n_checked = 0
            for i in range(min(1024, b)):
                if not elig[i]:
                    continue
                resp = engine.is_allowed(reqs[i])
                cach = resp.evaluation_cacheable
                want_row = (DEC_CODE[resp.decision],
                            -1 if cach is None else int(bool(cach)),
                            resp.operation_status.code)
                if tuple(int(x) for x in host[:, i]) != want_row:
                    raise AssertionError(
                        f"{name}: kernel row {i} {host[:, i].tolist()} "
                        f"!= oracle {want_row}")
                n_checked += 1
            log(f"  {name} with_acl={with_acl} with_hr={with_hr}: {b} rows "
                f"equal to the plain version, {n_checked} equal to the oracle")
    if seen != {0, 1, 2}:
        raise AssertionError(f"decisions seen {sorted(seen)}: need all three")
    if n_inel == 0:
        raise AssertionError("no ineligible rows were generated")
    if len(variants) != 4:
        raise AssertionError(f"variants run: {sorted(variants)}")
    return variants


def phase_end_to_end(device, n_rows: int, stats: dict):
    """Phase 5, the main path: the evaluator on mixed traffic against the
    511-rule scoped tree, every response held against the oracle."""
    engine = engine_for("scoped_511")
    rng = random.Random(5)
    reqs = grid_requests(rng, n_rows - 5, stress=True) + odd_requests(rng, True)
    oracle_reqs = copy.deepcopy(reqs)
    evaluator = HybridEvaluator(engine, device=device)
    kmod.LAUNCHES["decide_dense"] = 0
    responses = evaluator.is_allowed_batch(reqs)
    launches = kmod.LAUNCHES["decide_dense"]
    if launches < 1:
        raise AssertionError("the main path launched no decide_dense kernel")
    for i, (resp, req) in enumerate(zip(responses, oracle_reqs)):
        want = engine.is_allowed(req)
        if response_key(resp) != response_key(want):
            raise AssertionError(
                f"end to end row {i}: {response_key(resp)} != "
                f"{response_key(want)}")
    compiled = evaluator._compiled
    probe = encode_requests(copy.deepcopy(reqs), compiled)
    decisions = {}
    for resp in responses:
        decisions[resp.decision] = decisions.get(resp.decision, 0) + 1
    log(f"  {len(reqs)} responses equal to the oracle; {launches} kernel "
        f"launches; {int((~probe.eligible).sum())} rows served by the oracle;"
        f" decisions {decisions}")
    # the kernel's shapes on this path: the floor-caps sub-batch
    floor = [r for r in copy.deepcopy(reqs)
             if fits_floor(request_needs(r, compiled.urns))]
    batch = encode_requests(floor, compiled, caps=dict(_CAPS_FLOOR))
    c, b, r, with_acl, with_hr = device_inputs(compiled, batch, device)
    got, want = kernel_vs_plain(c, r, with_acl, with_hr)
    if not torch.equal(got, want):
        raise AssertionError("main-path batch: kernel != plain")
    ms = time_ms(lambda: kmod.decide_dense(c, r, with_acl, with_hr))
    plain_ms = time_ms(lambda: decide_dense_ref(c, r, with_acl, with_hr), 2)
    bms, by, nbytes, ops = bound_ms(c, r)
    stats["main"] = dict(launches=launches, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, rows=int(r["r_n_ra"].shape[0]),
                         bytes=nbytes, ops=ops)
    # end-to-end evaluator throughput (host clock; each call ends in a
    # device sync inside materialize)
    evaluator.is_allowed_batch(reqs)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        evaluator.is_allowed_batch(reqs)
    dt = (time.perf_counter() - t0) / ITERS
    # where that time goes: the host encode and the host-to-device copy of
    # the same two sub-batches, timed alone; the kernel from CUDA events;
    # the rest is decode, oracle rows and launch overhead
    ext = [r for r in copy.deepcopy(reqs)
           if not fits_floor(request_needs(r, compiled.urns))]
    t0 = time.perf_counter()
    batches = [encode_requests(floor, compiled, caps=dict(_CAPS_FLOOR)),
               encode_requests(ext, compiled)]
    t_encode = time.perf_counter() - t0
    t0 = time.perf_counter()
    for bt in batches:
        batch_from_numpy(bt, device, keys=kmod.ROW_ARRAYS)
    torch.cuda.synchronize()
    t_carry = time.perf_counter() - t0
    stages = {"encode": t_encode * 1e3, "carry": t_carry * 1e3,
              "kernel_floor_batch": ms}
    stages["rest"] = dt * 1e3 - sum(stages.values())
    stats["e2e"] = dict(rows=len(reqs), seconds=dt,
                        decisions_per_s=len(reqs) / dt, stages_ms=stages)


def phase_throughput(device, name: str, total: int, card: str) -> dict:
    """Phase 6: the kernel and the plain version on one large batch."""
    engine = engine_for(name)
    compiled = compile_policies(engine.policy_sets, engine.urns)
    stress = name == "scoped_511"
    batch = bench_batch(compiled, 4096, total, stress=stress)
    torch.cuda.reset_peak_memory_stats()
    c, b, r, with_acl, with_hr = device_inputs(compiled, batch, device)
    got, want = kernel_vs_plain(c, r, with_acl, with_hr)
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel != plain at {total} rows")
    dec = got[0].cpu().numpy()
    shares = {k: float((dec == v).mean()) for k, v in DEC_CODE.items()}
    if not stress and not 0.45 <= shares["PERMIT"] <= 0.55:
        raise AssertionError(f"seed PERMIT share {shares['PERMIT']}")
    ms = time_ms(lambda: kmod.decide_dense(c, r, with_acl, with_hr))
    plain_ms = time_ms(lambda: decide_dense_ref(c, r, with_acl, with_hr), 2)
    bms, by, nbytes, ops = bound_ms(c, r)
    out = dict(config=name, rows=total, kernel_ms=ms,
               kernel_decisions_per_s=total / (ms / 1e3), plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, bytes=nbytes, ops=ops,
               shares=shares, max_memory_allocated=torch.cuda.max_memory_allocated(),
               card=card)
    log("  " + json.dumps(out))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    stats = {"max_abs_err": 0}

    log("phase 1: device")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {kind} count {torch.cuda.device_count()}")
    log(card)

    log("phase 2: build")
    t0 = time.perf_counter()
    cuda_build.build(["decide_dense"])
    kmod._library()
    log(f"  decide_dense built in {time.perf_counter() - t0:.1f} s")
    for line in cuda_build.BUILD_LOG.get("decide_dense", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    log("phase 3-4: kernel vs plain version, kernel vs oracle")
    variants = phase_kernel_vs_plain(device, 1024, stats)
    for (acl, hr), n in sorted(variants.items()):
        log(f"  variant with_acl={acl} with_hr={hr}: {n} rows checked")

    log("phase 5: end to end (HybridEvaluator.is_allowed_batch)")
    phase_end_to_end(device, 4096, stats)

    log("phase 6: throughput")
    seed = phase_throughput(device, "seed_data", 1 << 18, card)
    scoped = phase_throughput(device, "scoped_511", 1 << 16, card)
    e2e = stats["e2e"]
    log(f"  evaluator end to end: {e2e['decisions_per_s']:.0f} decisions/s "
        f"at {e2e['rows']} rows ({e2e['seconds'] * 1e3:.3f} ms per batch) "
        f"on {card}")
    log(f"  evaluator batch stages (ms): {json.dumps(e2e['stages_ms'])}")
    log(f"  kernel: {seed['kernel_decisions_per_s']:.0f} decisions/s "
        f"(seed, 2^18 rows), {scoped['kernel_decisions_per_s']:.0f} "
        f"decisions/s (scoped_511, 2^16 rows) on {card}")
    log(f"  max_memory_allocated {torch.cuda.max_memory_allocated()} bytes "
        f"on {card}")
    log("  kernels: [\"decide_dense\"]")

    main_stats = stats["main"]
    print(json.dumps({"kernels": [{
        "name": "decide_dense",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": main_stats["launches"],
        "max_abs_err": stats["max_abs_err"],
        "ms": main_stats["ms"],
        "plain_ms": main_stats["plain_ms"],
        "bound_ms": main_stats["bound_ms"],
        "bound_by": main_stats["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
