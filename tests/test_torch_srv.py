"""The port's service facade, micro-batcher and admission control against
the JAX package's.

A JAX ``Worker`` and a port ``Worker(device="cpu")`` load the same
fixture tree (local YAML mode) or the seed tree (database mode); the same
requests, made from a numpy seed and carried as ``acstpu.Request`` bytes,
go through each side's ``AccessControlService`` (its unary path through
the ``MicroBatcher``, its batch and reverse paths), and the responses
must serialize to equal bytes.  Admission control: the shed statuses and
messages under a forced queue-full overload, a drain, and an expired
deadline are the JAX worker's, byte for byte, over gRPC with the shed
trailer.  The refusals of this slice raise ``NotImplementedError``
naming their slice.
"""

import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from access_control_srv_tpu.srv import transport_grpc as jtg
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu_torch.srv import transport_grpc as ttg
from access_control_srv_tpu_torch.srv.admission import BULK, INTERACTIVE
from access_control_srv_tpu_torch.srv.worker import Worker

from .torch_serving import AC, Rig, local_cfg, seed_cfg, traffic

TREES = ["basic_policies.yml", "role_scopes.yml", "acl_policies.yml",
         "props_multi_rules_entities.yml", "conditions.yml"]


def requests_of(side, messages):
    """The side's own Request objects, as its transport parses them."""
    tg = jtg if side == "jax" else ttg
    return [tg.request_from_pb(pb.Request.FromString(m)) for m in messages]


def response_bytes(side, responses):
    tg = jtg if side == "jax" else ttg
    return [tg.response_to_pb(r).SerializeToString() for r in responses]


def reverse_bytes(side, rqs):
    tg = jtg if side == "jax" else ttg
    return [tg.reverse_query_to_pb(rq).SerializeToString() for rq in rqs]


@pytest.fixture(scope="module", params=TREES + ["seed_data"])
def rig(request):
    cfg = seed_cfg() if request.param == "seed_data" \
        else local_cfg(request.param)
    rig = Rig(cfg)
    rig.tree = request.param
    yield rig
    rig.close()


def test_service_unary_through_batcher(rig):
    messages = traffic(40, seed=31)
    out = {}
    for side in ("jax", "port"):
        service = getattr(rig, side).worker.service
        assert service.batcher is not None
        out[side] = response_bytes(side, [
            service.is_allowed(r) for r in requests_of(side, messages)])
    assert out["port"] == out["jax"]


def test_service_batch_and_reverse(rig):
    messages = traffic(64, seed=32)
    out = {}
    for side in ("jax", "port"):
        service = getattr(rig, side).worker.service
        reqs = requests_of(side, messages)
        out[side] = (
            response_bytes(side, service.is_allowed_batch(reqs)),
            reverse_bytes(side, service.what_is_allowed_batch(
                requests_of(side, messages[:16]))),
            reverse_bytes(side, [service.what_is_allowed(r)
                                 for r in requests_of(side, messages[:8])]),
        )
    assert out["port"] == out["jax"]


def test_batcher_concurrent_submits(rig):
    """64 concurrent submits collect into micro-batches; every future
    resolves to the answer the JAX batcher gives the same request."""
    messages = traffic(64, seed=33)
    out = {}
    for side in ("jax", "port"):
        batcher = getattr(rig, side).worker.batcher
        reqs = requests_of(side, messages)
        with ThreadPoolExecutor(16) as pool:
            futures = list(pool.map(batcher.submit, reqs))
        out[side] = response_bytes(side, [f.result(timeout=60)
                                          for f in futures])
    assert out["port"] == out["jax"]


# ------------------------------------------------------------ admission


@pytest.fixture(scope="module")
def admission_rig():
    rig = Rig(seed_cfg(admission={"enabled": True,
                                  "max_queue_interactive": 2,
                                  "max_queue_bulk": 1}))
    yield rig
    rig.close()


def _both_admit(rig, cls, n):
    for side in (rig.jax, rig.port):
        ctl = side.worker.admission
        for _ in range(n):
            assert ctl.admit(cls) is None


def _both_release(rig, cls, n):
    for side in (rig.jax, rig.port):
        side.worker.admission.release(cls, n)


def test_queue_full_shed_bytes(admission_rig):
    """A full interactive queue sheds ``IsAllowed`` with 429 and the
    queue-full message, a full bulk queue sheds ``WhatIsAllowed`` and
    ``WhatIsAllowedBatch``; the shed trailer rides the unary answer."""
    rig = admission_rig
    msg = traffic(1, seed=50)[0]
    _both_admit(rig, INTERACTIVE, 2)
    try:
        want = rig.jax.call(AC + "IsAllowed", msg, with_trailers=True)
        got = rig.port.call(AC + "IsAllowed", msg, with_trailers=True)
        assert got == want
        resp = pb.Response.FromString(got[0])
        assert resp.operation_status.code == 429
        assert resp.operation_status.message == "interactive queue full (2)"
        assert resp.decision == pb.INDETERMINATE
        assert got[1].get("x-acs-shed") == "1"
    finally:
        _both_release(rig, INTERACTIVE, 2)
    _both_admit(rig, BULK, 1)
    try:
        for method, payload in (
                ("WhatIsAllowed", msg),
                ("WhatIsAllowedBatch", pb.BatchRequest(
                    requests=[pb.Request.FromString(msg)] * 3
                ).SerializeToString())):
            want, got = rig.both(AC + method, payload)
            assert got == want, method
            assert b"bulk queue full (1)" in got
    finally:
        _both_release(rig, BULK, 1)
    # admitted again once the queues drain
    want, got = rig.both(AC + "IsAllowed", msg)
    assert got == want
    assert pb.Response.FromString(got).operation_status.code == 200
    stats = rig.port.worker.admission.stats()
    assert stats["shed_queue_full"] == \
        rig.jax.worker.admission.stats()["shed_queue_full"] >= 3


def test_expired_deadline_shed_bytes(admission_rig):
    """Rows whose deadline passed before evaluation answer 504 with the
    deadline message, and are not cached."""
    rig = admission_rig
    messages = traffic(24, seed=51)
    out = {}
    stores = rig.port.worker.decision_cache.stats()["stores"]
    for side in ("jax", "port"):
        worker = getattr(rig, side).worker
        past = time.monotonic() - 1.0
        out[side] = response_bytes(side, worker.service.is_allowed_batch(
            requests_of(side, messages), deadline=past))
        reqs = requests_of(side, messages[:4])
        for r in reqs:
            r._deadline = past
        out[side] += response_bytes(
            side, worker.evaluator.is_allowed_batch(reqs))
    assert out["port"] == out["jax"]
    shed = pb.Response.FromString(out["port"][0])
    assert shed.operation_status.code == 504
    assert shed.operation_status.message == \
        "deadline expired before evaluation"
    paths = rig.port.worker.telemetry.paths.snapshot()
    assert paths["deadline-expired"] == 28
    assert rig.port.worker.decision_cache.stats()["stores"] == stores


def test_drain_shed_bytes(admission_rig):
    """A draining controller sheds every new request with 503."""
    rig = admission_rig
    msg = traffic(1, seed=52)[0]
    for side in (rig.jax, rig.port):
        side.worker.admission.begin_drain()
    try:
        want, got = rig.both(AC + "IsAllowed", msg)
        assert got == want
        resp = pb.Response.FromString(got)
        assert (resp.operation_status.code,
                resp.operation_status.message) == (503, "shutting down")
    finally:
        for side in (rig.jax, rig.port):
            side.worker.admission._draining = False


def test_admission_on_serves_the_same_bytes_as_off():
    """Admission enabled but not saturated changes no answer."""
    messages = traffic(32, seed=53)
    rig = Rig(seed_cfg(admission={"enabled": True}))
    try:
        for i, msg in enumerate(messages):
            want, got = rig.both(AC + "IsAllowed", msg)
            assert got == want, i
        batch = pb.BatchRequest(
            requests=[pb.Request.FromString(m) for m in messages]
        ).SerializeToString()
        want, got = rig.both(AC + "IsAllowedBatch", batch)
        assert got == want
    finally:
        rig.close()


# -------------------------------------------------------------- refusals


@pytest.mark.parametrize("key,value,slice_name", [
    ("tenancy", {"enabled": True}, "tenancy"),
    ("shadow", {"enabled": True, "candidate_paths": ["x.yml"]}, "tenancy"),
    ("profiling", {"xla_dump_dir": "/nonexistent"}, "torch.profiler"),
])
def test_worker_refusals(key, value, slice_name):
    worker = Worker()
    with pytest.raises(NotImplementedError, match=slice_name):
        worker.start(seed_cfg(**{key: value}), device="cpu")
    assert worker.batcher is None and worker.evaluator is None


@pytest.fixture(scope="module")
def broker():
    from access_control_srv_tpu_torch.srv.broker import BrokerServer

    server = BrokerServer().start()
    yield server
    server.stop()


@pytest.mark.parametrize("replication", [True, False])
def test_worker_starts_over_a_broker(broker, replication):
    """Over a broker the bus, offsets and subject cache are the socket
    backends; with replication on (the default) the replicator has
    caught up with the journal before ``start`` returns, so the policy
    epoch counts every journaled CRUD frame."""
    from access_control_srv_tpu_torch.srv import broker as tb
    from access_control_srv_tpu_torch.srv.store import PolicyReplicator

    bus = tb.SocketEventBus(broker.address)
    journaled = sum(bus.topic(f"io.restorecommerce.{k}s.resource").offset
                    for k in ("rule", "policy", "policy_set"))
    bus.close()
    cfg = seed_cfg(events={"broker": {"address": broker.address}})
    if not replication:
        cfg["replication"] = {"enabled": False}
    worker = Worker().start(cfg, device="cpu")
    try:
        assert isinstance(worker.bus, tb.SocketEventBus)
        assert isinstance(worker.offset_store, tb.SocketOffsetStore)
        assert isinstance(worker.subject_cache, tb.SocketSubjectCache)
        if replication:
            assert isinstance(worker.replicator, PolicyReplicator)
            assert worker.replicator.epoch >= journaled
            assert worker.policy_epoch() == worker.replicator.epoch
        else:
            assert worker.replicator is None
    finally:
        worker.stop()


def test_cluster_enabled_is_accepted():
    """``cluster:enabled`` is read by nothing beyond its default (as in
    JAX): the Worker starts and serves as without it."""
    worker = Worker().start(seed_cfg(cluster={"enabled": True}),
                            device="cpu")
    try:
        assert worker.replicator is None and worker.mesh is None
        assert worker.command_interface.command(
            "health_check", {})["status"] == "SERVING"
    finally:
        worker.stop()


def test_audit_enabled_builds_a_manager(tmp_path):
    from access_control_srv_tpu_torch.srv.audit_sweep import (
        AuditSweepManager,
    )

    worker = Worker().start(seed_cfg(audit={
        "enabled": True, "out_dir": str(tmp_path)}), device="cpu")
    try:
        assert isinstance(worker.audit, AuditSweepManager)
        assert worker.audit.batcher is worker.batcher
        assert worker.command_interface.command(
            "audit_sweep", {"action": "status"})["enabled"] is True
    finally:
        worker.stop()
    assert worker.audit is None


def test_worker_defaults_to_cuda(monkeypatch):
    """``device=None`` is the CUDA device: without one, start raises."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Worker().start(seed_cfg())


def test_refused_subsystems_are_none_when_off():
    worker = Worker().start(seed_cfg(), device="cpu")
    try:
        assert worker.tenancy is None and worker.shadow is None
        assert worker.audit is None and worker.replicator is None
        assert worker.mesh is None
        assert worker.evaluator.device.type == "cpu"
        assert worker.evaluator.kernel_active
    finally:
        worker.stop()
