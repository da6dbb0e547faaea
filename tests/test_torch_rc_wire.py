"""The restorecommerce wire aliases of the port's server against the JAX
server's.

A client speaking the ``io.restorecommerce.*`` service names and message
shapes (the rc stubs under ``srv/gen/rc``) drives a JAX worker and a port
worker (``device="cpu"``) over raw byte channels (``torch_serving.Rig``)
and gets equal response bytes: ``IsAllowed`` / ``WhatIsAllowed`` over a
numpy-seeded role and action mix, rule / policy / policy-set CRUD with
the decision it flips, filtered and paginated reads, the command
interface and the standard health service.  Excepted fields, cleared by
``clear_rc_meta``: each CRUD item's ``meta.created`` / ``meta.modified``
stamps.
"""

import json

import numpy as np
import pytest

from access_control_srv_tpu.srv.gen.rc import access_control_pb2 as rc_ac
from access_control_srv_tpu.srv.gen.rc import commandinterface_pb2 as rc_ci
from access_control_srv_tpu.srv.gen.rc import health_pb2 as rc_health
from access_control_srv_tpu.srv.gen.rc import policy_pb2 as rc_policy
from access_control_srv_tpu.srv.gen.rc import policy_set_pb2 as rc_ps
from access_control_srv_tpu.srv.gen.rc import resource_base_pb2 as rc_rb
from access_control_srv_tpu.srv.gen.rc import rule_pb2 as rc_rule

from .torch_serving import ORG, SEED_ACTIONS, SEED_ROLES, Rig, seed_cfg
from .utils import URNS

RC_AC = "/io.restorecommerce.access_control.AccessControlService/"
RC_RULES = "/io.restorecommerce.rule.RuleService/"
RC_POLICIES = "/io.restorecommerce.policy.PolicyService/"
RC_SETS = "/io.restorecommerce.policy_set.PolicySetService/"


@pytest.fixture(scope="module")
def rig():
    rig = Rig(seed_cfg())
    yield rig
    rig.close()


def rc_request(role, action="read", prop=None) -> bytes:
    msg = rc_ac.Request()
    msg.target.subjects.add(id=URNS["role"], value=role)
    msg.target.subjects.add(id=URNS["subjectID"], value="u1")
    msg.target.resources.add(id=URNS["entity"], value=ORG)
    for p in prop or ():
        msg.target.resources.add(id=URNS["property"], value=ORG + p)
    msg.target.actions.add(id=URNS["actionID"], value=URNS[action])
    msg.context.subject.value = json.dumps({
        "id": "u1",
        "role_associations": [{"role": role, "attributes": []}],
        "hierarchical_scopes": [],
    }).encode()
    return msg.SerializeToString()


def clear_rc_meta(raw: bytes, resp_cls) -> bytes:
    """The response with every item's ``meta.created`` and
    ``meta.modified`` cleared (the two servers stamp their own times)."""
    msg = resp_cls.FromString(raw)
    for item in msg.items:
        if item.payload.HasField("meta"):
            item.payload.meta.ClearField("created")
            item.payload.meta.ClearField("modified")
    return msg.SerializeToString()


def both_crud(rig, path, msg, resp_cls):
    want, got = rig.both(path, msg.SerializeToString())
    assert clear_rc_meta(got, resp_cls) == clear_rc_meta(want, resp_cls), \
        path
    out = resp_cls.FromString(got)
    assert out.operation_status.code == 200, (path, out.operation_status)
    return out


def decision(rig, role, **kw):
    want, got = rig.both(RC_AC + "IsAllowed", rc_request(role, **kw))
    assert got == want
    return rc_ac.Response.FromString(got).decision


def test_decisions_and_reverse_queries(rig):
    rng = np.random.default_rng(61)
    for i in range(32):
        role = SEED_ROLES[int(rng.integers(len(SEED_ROLES)))]
        action = SEED_ACTIONS[int(rng.integers(len(SEED_ACTIONS)))]
        msg = rc_request(role, action=action)
        for method in ("IsAllowed", "WhatIsAllowed"):
            want, got = rig.both(RC_AC + method, msg)
            assert got == want, (i, method)
    assert decision(rig, "superadministrator-r-id") == rc_ac.Response.PERMIT


def _seed_policy(rig):
    raw = rig.port.call(RC_POLICIES + "Read",
                        rc_rb.ReadRequest().SerializeToString())
    assert clear_rc_meta(raw, rc_policy.PolicyListResponse) == clear_rc_meta(
        rig.jax.call(RC_POLICIES + "Read",
                     rc_rb.ReadRequest().SerializeToString()),
        rc_policy.PolicyListResponse)
    pol = rc_policy.Policy()
    pol.CopyFrom(rc_policy.PolicyListResponse.FromString(raw).items[0]
                 .payload)
    return pol


def _update_policy(rig, pol):
    upd = rc_policy.PolicyList()
    upd.items.add().CopyFrom(pol)
    both_crud(rig, RC_POLICIES + "Update", upd, rc_policy.PolicyListResponse)


def test_rule_crud_flips_the_decision(rig):
    rules = rc_rule.RuleList()
    rule = rules.items.add(id="rc-wire-rule", name="rc-wire",
                           effect=rc_rule.PERMIT)
    rule.target.subjects.add(id=URNS["role"], value="rc-wire-role")
    rule.target.resources.add(id=URNS["entity"], value=ORG)
    both_crud(rig, RC_RULES + "Create", rules, rc_rule.RuleListResponse)
    assert decision(rig, "rc-wire-role") == rc_ac.Response.INDETERMINATE
    pol = _seed_policy(rig)
    pol.rules.append("rc-wire-rule")
    _update_policy(rig, pol)
    assert decision(rig, "rc-wire-role") == rc_ac.Response.PERMIT

    req = rc_rb.ReadRequest()
    req.filters.add().filters.add(
        field="id", operation=rc_rb.Filter.Operation.Value("eq"),
        value="rc-wire-rule")
    read = both_crud(rig, RC_RULES + "Read", req, rc_rule.RuleListResponse)
    assert [i.payload.id for i in read.items] == ["rc-wire-rule"]

    dreq = rc_rb.DeleteRequest(ids=["rc-wire-rule"])
    want, got = rig.both(RC_RULES + "Delete", dreq.SerializeToString())
    assert got == want
    assert decision(rig, "rc-wire-role") == rc_ac.Response.INDETERMINATE
    pol.rules.pop()
    _update_policy(rig, pol)


def test_obligations_cross_the_reference_wire(rig):
    rules = rc_rule.RuleList()
    rule = rules.items.add(id="rc-prop-rule", name="rc-prop",
                           effect=rc_rule.PERMIT)
    rule.target.subjects.add(id=URNS["role"], value="rc-prop-role")
    rule.target.resources.add(id=URNS["entity"], value=ORG)
    rule.target.resources.add(id=URNS["property"], value=ORG + "#name")
    both_crud(rig, RC_RULES + "Create", rules, rc_rule.RuleListResponse)
    pol = _seed_policy(rig)
    pol.rules.append("rc-prop-rule")
    _update_policy(rig, pol)
    try:
        msg = rc_request("rc-prop-role", prop=("#name", "#secret"))
        want, got = rig.both(RC_AC + "WhatIsAllowed", msg)
        assert got == want
        assert rc_ac.ReverseQuery.FromString(got).obligations
        want, got = rig.both(RC_AC + "IsAllowed", msg)
        assert got == want
    finally:
        rig.both(RC_RULES + "Delete", rc_rb.DeleteRequest(
            ids=["rc-prop-rule"]).SerializeToString())
        pol.rules.pop()
        _update_policy(rig, pol)


def test_read_pagination_and_sort(rig):
    rules = rc_rule.RuleList()
    for i in range(5):
        rule = rules.items.add(id=f"rc-page-{i}", name=f"page-{i}",
                               effect=rc_rule.PERMIT)
        rule.target.subjects.add(id=URNS["role"], value=f"pg-{i}")
    both_crud(rig, RC_RULES + "Create", rules, rc_rule.RuleListResponse)
    try:
        req = rc_rb.ReadRequest(limit=2, offset=1)
        group = req.filters.add()
        group.operator = rc_rb.FilterOp.Operator.Value("or")
        for i in range(5):
            group.filters.add(field="id",
                              operation=rc_rb.Filter.Operation.Value("eq"),
                              value=f"rc-page-{i}")
        req.sorts.add(field="id", order=rc_rb.Sort.DESCENDING)
        read = both_crud(rig, RC_RULES + "Read", req,
                         rc_rule.RuleListResponse)
        assert [i.payload.id for i in read.items] == ["rc-page-3",
                                                      "rc-page-2"]
    finally:
        want, got = rig.both(RC_RULES + "Delete", rc_rb.DeleteRequest(
            ids=[f"rc-page-{i}" for i in range(5)]).SerializeToString())
        assert got == want


def test_policy_set_crud(rig):
    sets = rc_ps.PolicySetList()
    ps = sets.items.add(
        id="rc-ps", name="rc-ps",
        combining_algorithm="urn:oasis:names:tc:xacml:3.0:"
                            "rule-combining-algorithm:deny-overrides")
    both_crud(rig, RC_SETS + "Create", sets, rc_ps.PolicySetListResponse)
    try:
        ps.name = "rc-ps-renamed"
        upd = rc_ps.PolicySetList()
        upd.items.add().CopyFrom(ps)
        out = both_crud(rig, RC_SETS + "Upsert", upd,
                        rc_ps.PolicySetListResponse)
        assert out.items[0].payload.name == "rc-ps-renamed"
        assert decision(rig, "superadministrator-r-id") == \
            rc_ac.Response.PERMIT
    finally:
        want, got = rig.both(RC_SETS + "Delete", rc_rb.DeleteRequest(
            ids=["rc-ps"]).SerializeToString())
        assert got == want


def test_command_and_health_under_reference_names(rig):
    want, got = rig.both(
        "/io.restorecommerce.commandinterface.CommandInterfaceService/"
        "Command", rc_ci.CommandRequest(name="version").SerializeToString())
    assert got == want
    assert "version" in json.loads(
        rc_ci.CommandResponse.FromString(got).result.value)
    want, got = rig.both("/grpc.health.v1.Health/Check",
                         rc_health.HealthCheckRequest().SerializeToString())
    assert got == want
    assert rc_health.HealthCheckResponse.FromString(got).status == \
        rc_health.HealthCheckResponse.SERVING
