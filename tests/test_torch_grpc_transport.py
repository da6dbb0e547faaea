"""The port's gRPC serving shell against the JAX package's, byte for byte.

A JAX ``Worker`` and a port ``Worker(device="cpu")`` serve the seed tree
behind their own ``GrpcServer`` on ``127.0.0.1:0`` (``torch_serving.Rig``);
the same request bytes, made from a numpy seed, go to both, and the
response bytes must be equal: ``IsAllowed``, ``IsAllowedBatch`` on the
native path (and on the pb path with explain on), ``IsAllowedStream``,
``WhatIsAllowed`` / ``WhatIsAllowedBatch``, CRUD on rules, policies and
policy sets with the decisions that follow, ``Command`` and ``Health``.
Both workers run at the default ``delta_enabled`` (CRUD deltas patch
capacity-bucketed tables) and with it off (a full recompile per
mutation).  Excepted fields, each named where it is cleared: the CRUD
items' ``meta.created`` / ``meta.modified`` stamps and the health
report's timings.
"""

import json

import numpy as np
import pytest

from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu.srv.transport_grpc import (
    serialize_batch_response as jax_serialize,
)
from access_control_srv_tpu_torch.srv.transport_grpc import (
    _SER_CHUNK,
    serialize_batch_response,
)

from .torch_serving import (
    AC,
    PO,
    Rig,
    batch_bytes,
    clear_meta_times,
    seed_cfg,
    seed_request,
    traffic,
)
from .utils import URNS

RULES = "/acstpu.RuleService/"
POLICIES = "/acstpu.PolicyService/"
SETS = "/acstpu.PolicySetService/"


@pytest.fixture(scope="module", params=["delta-default", "delta-off"])
def rig(request):
    cfg = seed_cfg(evaluator={"delta_enabled": False}) \
        if request.param == "delta-off" else seed_cfg()
    rig = Rig(cfg)
    rig.mode = request.param
    yield rig
    rig.close()


def test_serialize_batch_response_bytes():
    """The port's batch serializer writes the JAX serializer's bytes
    across the chunking threshold."""
    rng = np.random.default_rng(3)
    for n in (0, 1, 5, _SER_CHUNK, _SER_CHUNK + 1, 2 * _SER_CHUNK + 17):
        rows = [pb.Response(
            decision=[pb.PERMIT, pb.DENY, pb.INDETERMINATE][int(d)],
            evaluation_cacheable=bool(c),
            operation_status=pb.OperationStatus(
                code=int(code), message="m" * int(k)))
            for d, c, code, k in zip(rng.integers(3, size=n),
                                     rng.integers(2, size=n),
                                     rng.choice([200, 403, 500], size=n),
                                     rng.integers(7, size=n))]
        assert serialize_batch_response(rows) == jax_serialize(rows), n


def test_is_allowed_bytes(rig):
    for i, msg in enumerate(traffic(48, seed=21)):
        want, got = rig.both(AC + "IsAllowed", msg)
        assert got == want, i


def test_batch_native_bytes(rig):
    ev = rig.port.worker.evaluator
    assert ev.native_active and rig.jax.worker.evaluator.native_active
    before = dict(rig.port.worker.telemetry.paths.snapshot())
    for seed in (5, 6):
        payload = batch_bytes(traffic(96, seed=seed))
        want, got = rig.both(AC + "IsAllowedBatch", payload)
        assert got == want, seed
        assert len(pb.BatchResponse.FromString(got).responses) == 96
    paths = rig.port.worker.telemetry.paths.snapshot()
    assert paths.get("native-wire", 0) > before.get("native-wire", 0)
    assert "native-wire-error" not in paths


def test_stream_bytes(rig):
    frames = [batch_bytes(traffic(n, seed=40 + n)) for n in (8, 33, 1, 64)]
    want, got = rig.stream_both(AC + "IsAllowedStream", frames)
    assert len(got) == len(frames)
    assert got == want
    # each frame answers as the unary batch call does
    for frame, out in zip(frames, got):
        assert rig.port.call(AC + "IsAllowedBatch", frame) == out
    assert "stream-wire-error" not in \
        rig.port.worker.telemetry.paths.snapshot()


def test_what_is_allowed_bytes(rig):
    messages = traffic(24, seed=9)
    for i, msg in enumerate(messages):
        want, got = rig.both(AC + "WhatIsAllowed", msg)
        assert got == want, i
    want, got = rig.both(AC + "WhatIsAllowedBatch", batch_bytes(messages))
    assert got == want
    assert len(pb.BatchReverseQuery.FromString(got).responses) == 24


def _crud(rig, path, msg):
    want, got = rig.both(path, msg.SerializeToString())
    assert got == want, path
    status = pb.MutationResponse.FromString(got).operation_status
    assert status.code == 200, (path, status)


def _read(rig, path, resp_cls, ids, n_items=None):
    """Read on both sides; the items' meta timestamps are cleared
    (``clear_meta_times``), the rest of the bytes must be equal."""
    want, got = rig.both(path, pb.ReadRequest(ids=ids).SerializeToString())
    want, got = resp_cls.FromString(want), resp_cls.FromString(got)
    assert len(got.items) == (len(ids) if n_items is None else n_items)
    assert all(i.meta.created > 0 for i in got.items)
    clear_meta_times(want)
    clear_meta_times(got)
    assert got.SerializeToString() == want.SerializeToString(), path


def _decisions(rig, role):
    msg = seed_request(role=role).SerializeToString()
    want, got = rig.both(AC + "IsAllowed", msg)
    assert got == want
    batch = batch_bytes([msg] * 12 + traffic(20, seed=77))
    want_b, got_b = rig.both(AC + "IsAllowedBatch", batch)
    assert got_b == want_b
    return pb.Response.FromString(got).decision


def test_crud_all_kinds_then_decisions(rig):
    tag = rig.mode.replace("-", "_")
    role = f"wire-role-{tag}"
    rid, pid, sid = f"r_{tag}", f"p_{tag}", f"ps_{tag}"
    assert _decisions(rig, role) == pb.INDETERMINATE

    rule = pb.Rule(id=rid, effect="PERMIT")
    rule.target.subjects.add(id=URNS["role"], value=role)
    _crud(rig, RULES + "Create", pb.RuleList(items=[rule]))
    _crud(rig, POLICIES + "Create", pb.PolicyList(items=[pb.Policy(
        id=pid, combining_algorithm=PO, rules=[rid])]))
    _crud(rig, SETS + "Create", pb.PolicySetList(items=[pb.PolicySet(
        id=sid, combining_algorithm=PO, policies=[pid])]))
    assert _decisions(rig, role) == pb.PERMIT

    _read(rig, RULES + "Read", pb.RuleListResponse, [rid])
    _read(rig, POLICIES + "Read", pb.PolicyListResponse, [pid])
    _read(rig, SETS + "Read", pb.PolicySetListResponse, [sid])

    # update flips the effect, upsert flips it back
    rule.effect = "DENY"
    _crud(rig, RULES + "Update", pb.RuleList(items=[rule]))
    assert _decisions(rig, role) == pb.DENY
    rule.effect = "PERMIT"
    _crud(rig, RULES + "Upsert", pb.RuleList(items=[rule]))
    assert _decisions(rig, role) == pb.PERMIT

    # a policy update that drops the rule, then the set's delete
    _crud(rig, POLICIES + "Update", pb.PolicyList(items=[pb.Policy(
        id=pid, combining_algorithm=PO, rules=[])]))
    assert _decisions(rig, role) == pb.INDETERMINATE
    _crud(rig, POLICIES + "Upsert", pb.PolicyList(items=[pb.Policy(
        id=pid, combining_algorithm=PO, rules=[rid])]))
    assert _decisions(rig, role) == pb.PERMIT
    _crud(rig, SETS + "Delete", pb.DeleteRequest(ids=[sid]))
    assert _decisions(rig, role) == pb.INDETERMINATE
    _crud(rig, POLICIES + "Delete", pb.DeleteRequest(ids=[pid]))
    _crud(rig, RULES + "Delete", pb.DeleteRequest(ids=[rid]))
    _read(rig, RULES + "Read", pb.RuleListResponse, [rid], n_items=0)


def _command(rig, name, payload=None):
    msg = pb.CommandRequest(name=name,
                            payload=json.dumps(payload or {}).encode())
    return rig.both("/acstpu.CommandInterface/Command",
                    msg.SerializeToString())


def test_command_and_health_bytes(rig):
    want, got = rig.both("/acstpu.Health/Check",
                         pb.HealthCheckRequest().SerializeToString())
    assert got == want
    assert pb.HealthCheckResponse.FromString(got).status == "SERVING"
    want, got = _command(rig, "version")
    assert got == want
    want, got = _command(rig, "health_check")
    want = json.loads(pb.CommandResponse.FromString(want).payload)
    got = json.loads(pb.CommandResponse.FromString(got).payload)
    # excepted: the timings (uptime, latency percentiles, the admission
    # controller's batch-latency estimate, the policy_update block's
    # last time to visibility)
    for report in (want, got):
        report.pop("uptime_s")
        report.pop("latency", None)
        report["admission"].pop("batch_latency_estimate_ms")
        report["policy_update"].pop("last_visibility_ms")
    assert got == want
    assert got["status"] == "SERVING"
    # the patch path engaged at the default (the CRUD test ran first)
    pu = got["policy_update"]
    assert pu["enabled"] is (rig.mode == "delta-default")
    assert pu["full_compiles"] > 0
    assert (pu["patches"] > 0) is (rig.mode == "delta-default")
    want, got = _command(rig, "program_identity")
    want = json.loads(pb.CommandResponse.FromString(want).payload)
    got = json.loads(pb.CommandResponse.FromString(got).payload)
    assert got["table_fingerprint"] == want["table_fingerprint"]
    assert got["table_fingerprint"] is not None


def test_explain_pb_path_bytes_and_trailers():
    """Explain on: the native path is off on both sides, so
    ``IsAllowedBatch`` takes the pb path; unary responses carry the
    ``x-acs-explain`` trailer."""
    rig = Rig(seed_cfg(explain={"enabled": True}))
    try:
        assert not rig.port.worker.evaluator.native_active
        payload = batch_bytes(traffic(48, seed=13))
        want, got = rig.both(AC + "IsAllowedBatch", payload)
        assert got == want
        for i, msg in enumerate(traffic(12, seed=14)):
            want = rig.jax.call(AC + "IsAllowed", msg, with_trailers=True)
            got = rig.port.call(AC + "IsAllowed", msg, with_trailers=True)
            assert got == want, i
        assert "native-wire" not in rig.port.worker.telemetry.paths.snapshot()
    finally:
        rig.close()
