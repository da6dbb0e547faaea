"""The mesh-worker differential's rig and its per-layout cases.

A port world is four processes on the CPU, each started through the entry
point (``python -m access_control_srv_tpu_torch --device cpu``, the
``cluster:distributed`` block, ``ACS_CLUSTER_PROCESS_ID``;
``parallel.cluster.MeshWorld``): rank 0 serves gRPC, ranks 1-3 run the
follower loop.  The reference is a JAX Worker in the test process with
the same ``parallel`` block on the conftest's 8 virtual devices.  Both
hold the seed data and a 600-rule stress tree (the signature path's
size).

The ``test_*`` functions here run against a module-scoped ``pair``
fixture (one world per layout, shared by the layout's cases) that each
test file defines over its own layouts and imports them from here:
``IsAllowedBatch`` bytes equal JAX's; a rule's effect flipped and flipped
back over gRPC ``Update`` is visible with equal bytes, every rank's table
fingerprint equal to the others' and to the JAX Worker's after each
step (on the pod layouts the step is a patch in ``delta_stats``); a
combining-algorithm change (a full recompile, which the followers build
in the background) under concurrent traffic; then ``WhatIsAllowedBatch``
bytes.
"""

import copy
import json
import os
import threading
import time

import grpc
import numpy as np
import pytest
import yaml

import bench_all
from access_control_srv_tpu.srv import Worker as JaxWorker
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu.srv.transport_grpc import GrpcServer as JaxServer
from access_control_srv_tpu_torch.parallel.cluster import MeshWorld

from .torch_serving import AC, SEED, Side, batch_bytes, traffic
from .utils import URNS

RULES = "/acstpu.RuleService/"
POLICIES = "/acstpu.PolicyService/"
COMMAND = "/acstpu.CommandInterface/Command"
STRESS_RULES = 600
# r1 of the stress tree: PERMIT for role-1 on Stress1 / modify
FLIP_RULE = "r1"
FA = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable"
WORLD_TIMEOUT_S = 120.0


def _store_docs(doc) -> dict:
    """A nested ``policy_sets`` document as the store keeps it."""
    out = {"policy_sets": [], "policies": [], "rules": []}
    for ps in doc["policy_sets"]:
        out["policy_sets"].append({**{k: v for k, v in ps.items()
                                      if k != "policies"},
                                   "policies": [p["id"]
                                                for p in ps["policies"]]})
        for pol in ps["policies"]:
            out["policies"].append({**{k: v for k, v in pol.items()
                                       if k != "rules"},
                                    "rules": [r["id"] for r in pol["rules"]]})
            out["rules"].extend(pol["rules"])
    return out


@pytest.fixture(scope="module")
def tree_cfg(tmp_path_factory):
    """The seed data followed by ``STRESS_RULES`` stress rules, as seed
    YAML files both workers load."""
    base = tmp_path_factory.mktemp("mesh-tree")
    stress = _store_docs(bench_all._stress_doc(STRESS_RULES)[0])
    paths = {}
    for kind in ("policy_sets", "policies", "rules"):
        with open(os.path.join(SEED, f"{kind}.yaml")) as fh:
            docs = [d for d in yaml.safe_load_all(fh) if d]
        flat = [x for d in docs for x in (d if isinstance(d, list) else [d])]
        paths[kind] = str(base / f"{kind}.yaml")
        with open(paths[kind], "w") as fh:
            yaml.safe_dump(flat + stress[kind], fh)
    return {"policies": {"type": "database"}, "seed_data": paths}


def command(side, name: str, payload: bytes = b"{}") -> dict:
    msg = pb.CommandRequest(name=name, payload=payload)
    return json.loads(pb.CommandResponse.FromString(side.call(
        COMMAND, msg.SerializeToString())).payload)


class PortWorld:
    """A ``MeshWorld`` of 4 CPU ranks with a raw byte channel to rank 0."""

    def __init__(self, cfg: dict, base_dir: str):
        self.world = MeshWorld(cfg, 4, base_dir, device="cpu",
                               timeout_s=WORLD_TIMEOUT_S)

    def start(self) -> "PortWorld":
        self.world.start()
        self.channel = grpc.insecure_channel(self.world.addr)
        return self

    def call(self, path: str, payload: bytes, timeout: float = 60.0):
        return self.channel.unary_unary(path)(payload, timeout=timeout)

    def close(self) -> None:
        if getattr(self, "channel", None) is not None:
            self.channel.close()
        self.world.stop()
        assert all(p.poll() is not None for p in self.world.procs)


class Pair:
    """The JAX Worker (in this process) and the port world, on one
    config."""

    def __init__(self, cfg: dict, base_dir: str):
        self.port = PortWorld(cfg, base_dir)
        # the world's ranks boot while the JAX worker compiles here
        self.port.world.launch()
        self.jax = None
        try:
            jw = JaxWorker().start(copy.deepcopy(cfg))
            self.jax = Side(jw, JaxServer(jw, "127.0.0.1:0").start())
            self.port.world.wait_ready()
            self.port.channel = grpc.insecure_channel(self.port.world.addr)
        except BaseException:
            self.close()
            raise

    def both(self, path: str, payload: bytes):
        return self.jax.call(path, payload), self.port.call(path, payload)

    def close(self) -> None:
        if self.jax is not None:
            self.jax.close()
        self.port.close()


def layout_pair(request, tree_cfg, tmp_path_factory, layouts: dict):
    """The ``pair`` fixture's body: a ``Pair`` on ``layouts[param]``."""
    cfg = {**tree_cfg, "parallel": layouts[request.param]}
    rig = Pair(cfg, str(tmp_path_factory.mktemp(request.param)))
    rig.layout = request.param
    return rig


def _wide(n: int, seed: int) -> list[bytes]:
    msg = bench_all._serving_batch_msg(n, np.random.default_rng(seed),
                                       wide=True)
    return [r.SerializeToString() for r in msg.requests]


def _probe(role="role-1", k=1, action="modify") -> bytes:
    """A request that ``FLIP_RULE`` decides."""
    msg = pb.Request()
    msg.target.subjects.add(id=URNS["role"], value=role)
    msg.target.subjects.add(id=URNS["subjectID"], value="u-probe")
    entity = f"urn:restorecommerce:acs:model:stress{k}.Stress{k}"
    msg.target.resources.add(id=URNS["entity"], value=entity)
    msg.target.actions.add(id=URNS["actionID"], value=URNS[action])
    msg.context.subject.value = (
        b'{"id": "u-probe", "role_associations": [{"role": "%s", '
        b'"attributes": []}], "hierarchical_scopes": []}' % role.encode())
    return msg.SerializeToString()


def _identity_check(rig, label: str) -> dict:
    """Every rank's fingerprint equal, and equal to the JAX worker's."""
    want = command(rig.jax, "program_identity")["table_fingerprint"]
    got = command(rig.port, "program_identity")
    fps = got["mesh"]["table_fingerprints"]
    n_ranks = 1
    for size in got["mesh"]["shape"].values():
        n_ranks *= size
    assert len(fps) == n_ranks and set(fps) == {want}, (label, fps, want)
    assert got["table_fingerprint"] == want, label
    return got


def test_layout_and_identity(pair):
    """The layout the port builds from the block (the world's 4 ranks
    under JAX's clamps), the sharding block JAX reports, and every
    rank on the JAX worker's tables."""
    got = _identity_check(pair, "boot")
    shape = {"data4": {"data": 4}, "model2x2": {"data": 2, "model": 2},
             "pod4": {"data": 1, "model": 4},
             "pod2x2": {"data": 2, "model": 2}}[pair.layout]
    assert got["mesh"]["shape"] == shape and got["mesh"]["world"] == 4
    jax_ident = command(pair.jax, "program_identity")
    if pair.layout.startswith("pod"):
        assert got["sharding"]["n_shards"] == shape["model"]
        assert got["sharding"]["pod_fingerprint"] == \
            jax_ident["sharding"]["pod_fingerprint"]
    else:
        assert "sharding" not in got and "sharding" not in jax_ident


@pytest.mark.parametrize("seed", [5, 6])
def test_is_allowed_batch_bytes(pair, seed):
    messages = traffic(48, seed=seed) + _wide(48, seed) + [_probe()]
    want, got = pair.both(AC + "IsAllowedBatch", batch_bytes(messages))
    assert got == want
    decisions = {r.decision for r in
                 pb.BatchResponse.FromString(got).responses}
    assert len(decisions) > 1


def test_rule_flip_through_update(pair):
    """``FLIP_RULE``'s effect flipped and flipped back over gRPC: after
    each step the probe answers flip, the batch bytes equal JAX's, every
    rank holds the same tables, and on the pod layouts the step is a
    patch."""
    rule = pb.RuleListResponse.FromString(pair.port.call(
        RULES + "Read", pb.ReadRequest(ids=[FLIP_RULE])
        .SerializeToString())).items[0]
    flipped = pb.Rule()
    flipped.CopyFrom(rule)
    flipped.effect = "DENY" if rule.effect == "PERMIT" else "PERMIT"
    messages = batch_bytes(traffic(24, seed=9) + _wide(24, 9)
                           + [_probe()] * 4)
    seen = []
    for step, msg in (("flip", flipped), ("flip-back", rule)):
        before = command(pair.port, "health_check")["policy_update"]
        want, got = pair.both(RULES + "Update", pb.RuleList(items=[msg])
                              .SerializeToString())
        assert pb.MutationResponse.FromString(got).operation_status.code \
            == 200, step
        want, got = pair.both(AC + "IsAllowedBatch", messages)
        assert got == want, step
        seen.append(pb.BatchResponse.FromString(got).responses[-1].decision)
        _identity_check(pair, step)
        after = command(pair.port, "health_check")["policy_update"]
        if pair.layout.startswith("pod"):
            assert after["patches"] == before["patches"] + 1, step
            assert sum(after["sharding"]["applied_patches"]) == sum(
                before["sharding"]["applied_patches"]) + 1, step
    assert seen[0] != seen[1]


def test_recompile_under_traffic(pair):
    """A policy's combining algorithm changed and restored (full
    recompiles: the followers build each in the background while the old
    tables keep serving) while another thread keeps sending batches:
    every call answers, none with an error status, and afterwards the
    bytes equal JAX's."""
    policy = pb.PolicyListResponse.FromString(pair.port.call(
        POLICIES + "Read", pb.ReadRequest(ids=["p0"]).SerializeToString())
    ).items[0]
    other = pb.Policy()
    other.CopyFrom(policy)
    other.combining_algorithm = FA
    payload = batch_bytes(_wide(32, 11) + [_probe()])
    stop = threading.Event()
    codes: list = []

    def hammer():
        while not stop.is_set():
            resp = pb.BatchResponse.FromString(
                pair.port.call(AC + "IsAllowedBatch", payload))
            codes.extend(r.operation_status.code for r in resp.responses)

    thread = threading.Thread(target=hammer, daemon=True)
    thread.start()
    try:
        for msg in (other, policy):
            time.sleep(0.2)
            want, got = pair.both(POLICIES + "Update", pb.PolicyList(
                items=[msg]).SerializeToString())
            assert pb.MutationResponse.FromString(got) \
                .operation_status.code == 200
    finally:
        time.sleep(0.2)
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert codes and set(codes) == {200}
    want, got = pair.both(AC + "IsAllowedBatch", payload)
    assert got == want
    _identity_check(pair, "after the recompiles")


def test_what_is_allowed_batch_bytes(pair):
    """Reverse queries run on rank 0 alone (K5); sent after the
    fingerprint checks, as they intern their strings."""
    messages = batch_bytes(traffic(16, seed=13) + _wide(16, 13))
    want, got = pair.both(AC + "WhatIsAllowedBatch", messages)
    assert got == want


