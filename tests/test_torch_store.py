"""The port's policy store and background compile against the JAX
package's.

- Carry-over: a JAX worker with a ``database:snapshot_dir`` applies CRUD
  over gRPC and stops; a port worker started on that directory (no seed
  data) answers the fixture traffic with the bytes the JAX worker gave,
  and the other way round: what the port journals, a JAX worker reads.
- The CRUD-event half of ``ops/delta.py``: ``event_is_noop`` and
  ``footprint_from_events`` give the JAX answers on seeded random events.
- ``evaluator:async_compile``: a CRUD flip reaches the port's answers
  once the debounced compile thread has swapped, the answers then equal
  the JAX worker's, and ``Worker.stop`` joins the thread.
- Hot updates through the delta patcher: the same ``RuleService`` /
  ``PolicyService`` sequence over gRPC leaves the two workers'
  ``IsAllowedBatch`` bytes, ``program_identity`` table fingerprints and
  ``health_check`` ``policy_update`` blocks equal after every call;
  ``evaluator:delta_enabled: false`` takes the full recompile.
"""

import copy
import json
import os
import time

import numpy as np
import pytest

from access_control_srv_tpu.ops import delta as jdelta
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu.srv.store import Collection as JaxCollection
from access_control_srv_tpu_torch.models.urns import Urns
from access_control_srv_tpu_torch.ops import delta as tdelta
from access_control_srv_tpu_torch.srv.store import Collection

from .torch_serving import (
    AC,
    PO,
    Rig,
    Side,
    batch_bytes,
    seed_cfg,
    seed_request,
    traffic,
)
from .utils import URNS

RULES = "/acstpu.RuleService/"
POLICIES = "/acstpu.PolicyService/"
SETS = "/acstpu.PolicySetService/"


def _start(kind, cfg):
    if kind == "jax":
        from access_control_srv_tpu.srv import Worker
        from access_control_srv_tpu.srv.transport_grpc import GrpcServer

        worker = Worker().start(copy.deepcopy(cfg))
    else:
        from access_control_srv_tpu_torch.srv.transport_grpc import (
            GrpcServer,
        )
        from access_control_srv_tpu_torch.srv.worker import Worker

        worker = Worker().start(copy.deepcopy(cfg), device="cpu")
    return Side(worker, GrpcServer(worker, "127.0.0.1:0").start())


def _mutate(side, tag, role):
    """CRUD on all three kinds over gRPC; returns the MutationResponse
    bytes."""
    rule = pb.Rule(id=f"r_{tag}", effect="PERMIT")
    rule.target.subjects.add(id=URNS["role"], value=role)
    out = [
        side.call(RULES + "Create", pb.RuleList(items=[rule])
                  .SerializeToString()),
        side.call(POLICIES + "Create", pb.PolicyList(items=[pb.Policy(
            id=f"p_{tag}", combining_algorithm=PO, rules=[f"r_{tag}"])])
            .SerializeToString()),
        side.call(SETS + "Create", pb.PolicySetList(items=[pb.PolicySet(
            id=f"ps_{tag}", combining_algorithm=PO,
            policies=[f"p_{tag}"])]).SerializeToString()),
    ]
    rule.effect = "DENY"
    out.append(side.call(RULES + "Update", pb.RuleList(items=[rule])
                         .SerializeToString()))
    out.append(side.call(RULES + "Delete", pb.DeleteRequest(
        ids=["super_admin_rule_missing"]).SerializeToString()))
    return out


def _answers(side, roles):
    probes = [seed_request(role=r).SerializeToString() for r in roles]
    messages = traffic(48, seed=81) + probes
    return ([side.call(AC + "IsAllowed", m) for m in probes]
            + [side.call(AC + "IsAllowedBatch", batch_bytes(messages)),
               side.call(AC + "WhatIsAllowedBatch", batch_bytes(probes))])


def test_snapshot_journal_carry_over(tmp_path):
    snap = str(tmp_path / "db")
    roles = ["role-from-jax", "role-from-port", "superadministrator-r-id",
             "nobody"]
    jax = _start("jax", seed_cfg(database={"snapshot_dir": snap}))
    try:
        jax_mut = _mutate(jax, "jax", "role-from-jax")
        want = _answers(jax, roles)
    finally:
        jax.close()
    assert os.path.exists(os.path.join(snap, "rule.journal")) or \
        os.path.exists(os.path.join(snap, "rule.json"))

    # the port reads the JAX worker's snapshot + journal: no seed data
    cfg = {"policies": {"type": "database"},
           "database": {"snapshot_dir": snap}}
    port = _start("port", cfg)
    try:
        assert _answers(port, roles) == want
        port_mut = _mutate(port, "port", "role-from-port")
        assert [pb.MutationResponse.FromString(b).operation_status.code
                for b in port_mut] == \
            [pb.MutationResponse.FromString(b).operation_status.code
             for b in jax_mut]
        want_port = _answers(port, roles)
    finally:
        port.close()

    # and a JAX worker reads what the port journaled
    jax = _start("jax", cfg)
    try:
        assert _answers(jax, roles) == want_port
    finally:
        jax.close()
    assert pb.Response.FromString(want_port[1]).decision == pb.DENY
    for name in ("rule", "policy", "policy_set"):
        assert Collection(name, snapshot_dir=snap).all() == \
            JaxCollection(name, snapshot_dir=snap).all()


def _random_doc(rng, kind, i):
    urns = Urns()
    if kind == "rule":
        target = None
        if rng.random() < 0.8:
            target = {
                "subjects": [{"id": urns.get("role"),
                              "value": f"role-{int(rng.integers(3))}"}],
                "resources": [{"id": urns.get("entity"),
                               "value": f"urn:e:{int(rng.integers(3))}"}]
                if rng.random() < 0.7 else [],
                "actions": [{"id": urns.get("actionID"),
                             "value": urns.get("read")}]
                if rng.random() < 0.5 else [],
            }
        return {"id": f"r{i}", "effect": ["PERMIT", "DENY"][
                    int(rng.integers(2))],
                "target": target,
                "evaluation_cacheable": bool(rng.integers(2)),
                "meta": {"modified": float(rng.integers(100))}}
    if kind == "policy":
        return {"id": f"p{i}", "combining_algorithm": PO,
                "effect": ["PERMIT", "DENY", None][int(rng.integers(3))],
                "rules": [f"r{int(j)}" for j in rng.integers(6, size=2)],
                "target": None}
    return {"id": f"s{i}", "combining_algorithm": PO,
            "policies": [f"p{int(j)}" for j in rng.integers(4, size=2)]}


def test_footprints_match_jax():
    rng = np.random.default_rng(82)
    urns = Urns()
    for trial in range(40):
        store = {k: {} for k in ("rule", "policy", "policy_set")}
        for kind, n in (("rule", 6), ("policy", 4), ("policy_set", 2)):
            for i in range(n):
                doc = _random_doc(rng, kind, i)
                store[kind][doc["id"]] = doc
        events = {"jax": [], "port": []}
        for _ in range(int(rng.integers(1, 4))):
            kind = ("rule", "policy", "policy_set")[int(rng.integers(3))]
            ids = list(store[kind])
            op = ("create", "update", "delete", "delete_all")[
                int(rng.integers(4)) if trial % 5 else int(rng.integers(3))]
            i = int(rng.integers(len(ids)))
            old = store[kind][ids[i]]
            new = _random_doc(rng, kind, i) if op != "delete" else None
            if op == "update" and rng.random() < 0.3:
                new = copy.deepcopy(old)
                new["meta"] = {"modified": 1e9}  # a metadata-only restamp
            if new is not None:
                store[kind][new["id"]] = new
            for side, mod in (("jax", jdelta), ("port", tdelta)):
                events[side].append(mod.CrudEvent(
                    kind, op, ids[i], copy.deepcopy(old),
                    copy.deepcopy(new)))

        def get_doc(kind, doc_id):
            return store[kind].get(doc_id)

        def all_docs(kind):
            return list(store[kind].values())

        want = jdelta.footprint_from_events(events["jax"], urns, get_doc,
                                            all_docs)
        got = tdelta.footprint_from_events(events["port"], urns, get_doc,
                                           all_docs)
        assert (got.global_, got.empty) == (want.global_, want.empty), trial
        assert [s.__dict__ for s in got.scopes] == \
            [s.__dict__ for s in want.scopes], trial
        assert [tdelta.event_is_noop(e) for e in events["port"]] == \
            [jdelta.event_is_noop(e) for e in events["jax"]], trial


def test_async_compile_flip_and_join():
    rig = Rig(seed_cfg(evaluator={"async_compile": True,
                                  "delta_enabled": False}))
    try:
        ev = rig.port.worker.evaluator
        deadline = time.time() + 60
        while not ev.kernel_active and time.time() < deadline:
            time.sleep(0.01)
        assert ev.kernel_active
        probe = batch_bytes([seed_request(role="async-role")
                             .SerializeToString()] * 8)
        rule = pb.Rule(id="r_async", effect="PERMIT")
        rule.target.subjects.add(id=URNS["role"], value="async-role")
        for side in (rig.jax, rig.port):
            for path, msg in (
                    (RULES + "Create", pb.RuleList(items=[rule])),
                    (POLICIES + "Create", pb.PolicyList(items=[pb.Policy(
                        id="p_async", combining_algorithm=PO,
                        rules=["r_async"])])),
                    (SETS + "Create", pb.PolicySetList(items=[pb.PolicySet(
                        id="ps_async", combining_algorithm=PO,
                        policies=["p_async"])]))):
                side.call(path, msg.SerializeToString())

        def decided(side):
            out = pb.BatchResponse.FromString(
                side.call(AC + "IsAllowedBatch", probe))
            return {r.decision for r in out.responses}

        deadline = time.time() + 60
        while decided(rig.port) != {pb.PERMIT} and time.time() < deadline:
            time.sleep(0.01)
        while decided(rig.jax) != {pb.PERMIT} and time.time() < deadline:
            time.sleep(0.01)
        want, got = rig.both(AC + "IsAllowedBatch", probe)
        assert got == want
        assert {r.decision for r in pb.BatchResponse.FromString(
            got).responses} == {pb.PERMIT}
        stats = ev.delta_stats()
        assert stats["full_compiles"] >= 2 and stats["enabled"] is False
        assert rig.port.worker.telemetry.delta.snapshot()["full-compile"] \
            == stats["full_compiles"]
    finally:
        rig.close()
    thread = ev._compile_thread
    assert thread is None or not thread.is_alive()
    assert ev._shutdown


def test_refresh_after_shutdown_starts_no_thread():
    from access_control_srv_tpu_torch.srv.worker import Worker

    worker = Worker().start(seed_cfg(evaluator={"async_compile": True}),
                            device="cpu")
    ev = worker.evaluator
    worker.stop()
    ev.refresh()
    assert ev._compile_thread is None or not ev._compile_thread.is_alive()


@pytest.mark.parametrize("backend", ["hybrid", "oracle"])
def test_refresh_cache_bumps(backend):
    """The JAX evaluator's bumps when no patch applies (``delta_enabled``
    off): whole before a full recompile; scoped by the footprint, or none
    for a certified-empty one, on the oracle backend."""
    from access_control_srv_tpu.core.engine import (
        AccessController as JaxController,
    )
    from access_control_srv_tpu.srv.decision_cache import (
        DecisionCache as JaxCache,
    )
    from access_control_srv_tpu.srv.evaluator import (
        HybridEvaluator as JaxEvaluator,
    )
    from access_control_srv_tpu_torch.core.engine import AccessController
    from access_control_srv_tpu_torch.srv.decision_cache import DecisionCache
    from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator

    stats = []
    for side in ("jax", "port"):
        if side == "jax":
            cache, mod = JaxCache(), jdelta
            ev = JaxEvaluator(JaxController(), backend=backend,
                              decision_cache=cache, delta_enabled=False)
        else:
            cache, mod = DecisionCache(), tdelta
            ev = HybridEvaluator(AccessController(), backend=backend,
                                 decision_cache=cache, device="cpu")
        seen = [cache.stats()]
        for fp in (mod.Footprint(scopes=[mod.RuleScope(ops=("x",))]),
                   mod.Footprint(), mod.Footprint(global_=True), None):
            ev.refresh(events=[], footprint=fp)
            seen.append(cache.stats())
        stats.append(seen)
    assert stats[1] == stats[0]
    epochs = [st["epoch"] for st in stats[1]]
    assert epochs == sorted(epochs) and epochs[-1] > epochs[0]


def _health(side) -> dict:
    msg = pb.CommandRequest(name="health_check", payload=b"{}")
    out = json.loads(pb.CommandResponse.FromString(side.call(
        "/acstpu.CommandInterface/Command", msg.SerializeToString()))
        .payload)
    return out


def _fingerprint(side) -> str:
    msg = pb.CommandRequest(name="program_identity", payload=b"{}")
    return json.loads(pb.CommandResponse.FromString(side.call(
        "/acstpu.CommandInterface/Command", msg.SerializeToString()))
        .payload)["table_fingerprint"]


def _read_rule(side, rid: str):
    return pb.RuleListResponse.FromString(side.call(
        RULES + "Read", pb.ReadRequest(ids=[rid]).SerializeToString())
    ).items[0]


def test_rule_updates_patch_like_jax():
    """Each mutation over gRPC on both workers: a rule's effect flipped
    and flipped back (patches), the same document again (a noop), a rule
    created and attached to a policy (a noop, then a patch), a policy's
    combining algorithm changed (a fallback).  After each, the batch
    answers are equal bytes, the table fingerprints equal, and the
    ``policy_update`` blocks equal but for the time to visibility."""
    rig = Rig(seed_cfg())
    try:
        messages = batch_bytes(traffic(32, seed=83) + [
            seed_request(role="delta-role").SerializeToString()])
        rule = _read_rule(rig.port, "super_admin_rule")
        flipped = pb.Rule()
        flipped.CopyFrom(rule)
        flipped.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
        extra = pb.Rule(id="r_delta", effect="PERMIT")
        extra.target.subjects.add(id=URNS["role"], value="delta-role")
        policy = pb.PolicyListResponse.FromString(rig.port.call(
            POLICIES + "Read", pb.ReadRequest(
                ids=["super_admin_policy"]).SerializeToString())).items[0]
        attached = pb.Policy()
        attached.CopyFrom(policy)
        attached.rules.append("r_delta")
        other_ca = pb.Policy()
        other_ca.CopyFrom(attached)
        other_ca.combining_algorithm = PO if \
            policy.combining_algorithm != PO else \
            "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:" \
            "deny-overrides"
        steps = [
            (RULES + "Update", pb.RuleList(items=[flipped]), "patches"),
            (RULES + "Update", pb.RuleList(items=[rule]), "patches"),
            (RULES + "Update", pb.RuleList(items=[rule]), "noops"),
            (RULES + "Create", pb.RuleList(items=[extra]), "noops"),
            (POLICIES + "Update", pb.PolicyList(items=[attached]),
             "patches"),
            (POLICIES + "Update", pb.PolicyList(items=[other_ca]),
             "fallbacks"),
        ]
        for path, msg, moved in steps:
            before = rig.port.worker.evaluator.delta_stats()[moved]
            want, got = rig.both(path, msg.SerializeToString())
            assert got == want, path
            stats = rig.port.worker.evaluator.delta_stats()
            assert stats[moved] == before + 1, (path, moved, stats)
            want, got = rig.both(AC + "IsAllowedBatch", messages)
            assert got == want, path
            assert _fingerprint(rig.port) == _fingerprint(rig.jax), path
            jpu, tpu = (_health(side)["policy_update"]
                        for side in (rig.jax, rig.port))
            jpu.pop("last_visibility_ms")
            tpu.pop("last_visibility_ms")
            assert tpu == jpu, path
        assert tpu["fallback_reasons"] == {"combining-algorithm-changed": 1}
    finally:
        rig.close()


def test_worker_delta_disabled_recompiles_in_full():
    from access_control_srv_tpu_torch.srv.transport_grpc import GrpcServer
    from access_control_srv_tpu_torch.srv.worker import Worker

    worker = Worker().start(seed_cfg(evaluator={"delta_enabled": False}),
                            device="cpu")
    side = Side(worker, GrpcServer(worker, "127.0.0.1:0").start())
    try:
        ev = worker.evaluator
        assert ev.delta_enabled is False
        base = ev.delta_stats()
        rule = _read_rule(side, "super_admin_rule")
        rule.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
        side.call(RULES + "Update", pb.RuleList(items=[rule])
                  .SerializeToString())
        stats = ev.delta_stats()
        assert stats["enabled"] is False and "capacities" not in stats
        assert stats["patches"] == stats["noops"] == 0
        assert stats["full_compiles"] == base["full_compiles"] + 1
        assert _health(side)["policy_update"]["full_compiles"] == \
            stats["full_compiles"]
    finally:
        side.close()
