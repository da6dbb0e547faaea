"""The port's cluster tier against the JAX package's.

A JAX ``LocalCluster`` and a port ``LocalCluster(device="cpu")``, each a
broker process, two replica processes and a router, are seeded from
``data/seed_data/`` through their journals.  The same CRUD sequence goes
through each router (create, an effect flip, a delete, a combining-
algorithm change); after each step both clusters converge, and then the
routed ``IsAllowedBatch`` bytes are equal, every replica of both clusters
reports one ``table_fingerprint``, and the port replicas' ``delta_stats``
moved as the JAX replicas' did (the replica that served the RPC patched
locally, the other through its ``PolicyReplicator``).  ``restart_replica``
brings a replica killed on both sides back by journal replay.

The router cases of ``tests/test_router.py`` run against port replicas
in this process (port ``Worker``s behind port ``GrpcServer``s, no
broker): load balancing and epoch trailers, drain, retry after a replica
stops, shed migration, streams with failover and Command forwarding.
Every wait polls with a deadline."""

import json
import os
import queue
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import grpc
import pytest

import bench_all
from access_control_srv_tpu.parallel.cluster import LocalCluster as JaxCluster
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu_torch.parallel.cluster import LocalCluster
from access_control_srv_tpu_torch.srv.broker import SocketEventBus
from access_control_srv_tpu_torch.srv.router import (
    POLICY_EPOCH_METADATA_KEY,
    SHED_METADATA_KEY,
    ClusterRouter,
)
from access_control_srv_tpu_torch.srv.transport_grpc import (
    GrpcClient,
    GrpcServer,
)
from access_control_srv_tpu_torch.srv.worker import Worker

from .cluster_util import (
    PO,
    command_over,
    reader_rule_doc,
    rule_to_pb,
    seed_paths,
    wait_converged,
    wire_request,
)
from .torch_serving import AC, batch_bytes, seed_cfg, traffic

RULES = "/acstpu.RuleService/"
POLICIES = "/acstpu.PolicyService/"
SETS = "/acstpu.PolicySetService/"
DO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:deny-overrides"
CRUD_TOPICS = tuple(f"io.restorecommerce.{k}s.resource"
                    for k in ("rule", "policy", "policy_set"))
ROUTER_CFG = {"health_interval_s": 0.3, "max_retries": 1}


# ------------------------------------------------- the two clusters, in step


class Clusters:
    """Both clusters, driven in step through their routers."""

    def __init__(self, tmp):
        jax_cluster = JaxCluster(
            n_replicas=2, seed_cfg=seed_paths(), router_cfg=ROUTER_CFG,
            base_dir=str(tmp / "jax"))
        port_cluster = LocalCluster(
            n_replicas=2, seed_cfg=seed_paths(), router_cfg=ROUTER_CFG,
            base_dir=str(tmp / "port"), device="cpu")
        self.sides = {"jax": jax_cluster, "port": port_cluster}
        # both boot at once; a side that fails stops what it started
        with ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(c.start) for c in self.sides.values()]
        errors = [f.exception() for f in futures if f.exception()]
        if errors:
            self.stop()
            raise errors[0]
        self.channels = {name: grpc.insecure_channel(c.router.addr)
                         for name, c in self.sides.items()}

    def call(self, name: str, path: str, payload: bytes) -> bytes:
        return self.channels[name].unary_unary(path)(payload, timeout=60)

    def both(self, path: str, payload: bytes) -> dict:
        return {name: self.call(name, path, payload) for name in self.sides}

    def addrs(self, name: str) -> list:
        return [r.addr for r in self.sides[name].replicas]

    def journaled(self, name: str) -> int:
        bus = SocketEventBus(self.sides[name].broker_addr)
        try:
            return sum(bus.topic(t).offset for t in CRUD_TOPICS)
        finally:
            bus.close()

    def converge(self) -> dict:
        """Wait until every replica of each cluster has applied its whole
        journal; returns the identities per side."""
        return {name: wait_converged(self.addrs(name), timeout_s=60.0,
                                     min_epoch=self.journaled(name))
                for name in self.sides}

    def stop(self) -> None:
        for channel in getattr(self, "channels", {}).values():
            channel.close()
        for cluster in self.sides.values():
            cluster.stop()


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_child():
    """Replica processes started here compute with one thread each (they
    share the host with the other test workers); this process keeps its
    own setting."""
    before = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if before is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = before


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    both = Clusters(tmp_path_factory.mktemp("clusters"))
    yield both
    both.stop()


DELTA_COUNTS = ("patches", "noops", "fallbacks", "full_compiles",
                "recompiles_avoided")


def policy_updates(addrs) -> list:
    """Each replica's ``policy_update`` block (``delta_stats``)."""
    out = []
    for addr in addrs:
        channel = grpc.insecure_channel(addr)
        try:
            out.append(command_over(channel, "health_check")[
                "policy_update"])
        finally:
            channel.close()
    return out


def delta_moves(before: list, after: list) -> list:
    """Each replica's ``delta_stats`` move between two reads (the counts
    and the fallback reasons), sorted: which replica serves an RPC is the
    router's choice.  Moves, not totals: a JAX replica's debounced boot
    replay can take one full compile more than the port's one-sync
    replay."""
    out = []
    for b, a in zip(before, after):
        move = {k: a[k] - b[k] for k in DELTA_COUNTS if a[k] != b[k]}
        reasons = {k: v - b["fallback_reasons"].get(k, 0)
                   for k, v in a["fallback_reasons"].items()
                   if v != b["fallback_reasons"].get(k, 0)}
        if reasons:
            move["reasons"] = reasons
        out.append(json.dumps(move, sort_keys=True))
    return sorted(out)


def probe_bytes() -> bytes:
    """Seed traffic plus the reader role the CRUD sequence adds."""
    return batch_bytes(traffic(24, seed=91) + [
        wire_request(role="reader-role").SerializeToString(),
        wire_request(role="reader-role", resource_id="O2")
        .SerializeToString()])


def _rule(effect: str) -> bytes:
    rl = pb.RuleList(items=[rule_to_pb(reader_rule_doc("r_cluster",
                                                       effect=effect))])
    rl.subject.id = "root"
    return rl.SerializeToString()


def _policy(algorithm: str, rules=("r_cluster",)) -> bytes:
    pol = pb.PolicyList()
    item = pol.items.add()
    item.id = "p_r_cluster"
    item.combining_algorithm = algorithm
    item.rules.extend(rules)
    pol.subject.id = "root"
    return pol.SerializeToString()


def _policy_set() -> bytes:
    pset = pb.PolicySetList()
    item = pset.items.add()
    item.id = "ps_r_cluster"
    item.combining_algorithm = PO
    item.policies.append("p_r_cluster")
    pset.subject.id = "root"
    return pset.SerializeToString()


def _delete(rid: str) -> bytes:
    req = pb.DeleteRequest(ids=[rid])
    req.subject.id = "root"
    return req.SerializeToString()


CRUD_STEPS = [
    ("create", [(RULES + "Upsert", _rule("PERMIT")),
                (POLICIES + "Upsert", _policy(PO)),
                (SETS + "Upsert", _policy_set())]),
    ("flip", [(RULES + "Upsert", _rule("DENY"))]),
    ("delete", [(RULES + "Delete", _delete("r_cluster"))]),
    ("algorithm", [(RULES + "Upsert", _rule("PERMIT")),
                   (POLICIES + "Upsert", _policy(DO))]),
]


@pytest.mark.cluster(timeout=240)
def test_crud_sequence_converges_like_jax(clusters):
    probe = probe_bytes()
    ids = clusters.converge()
    first = clusters.both(AC + "IsAllowedBatch", probe)
    assert first["port"] == first["jax"]
    moves, decisions = {}, {}
    for step, rpcs in CRUD_STEPS:
        before = {name: policy_updates(clusters.addrs(name))
                  for name in clusters.sides}
        for path, payload in rpcs:
            out = clusters.both(path, payload)
            codes = {name: pb.MutationResponse.FromString(raw)
                     .operation_status.code for name, raw in out.items()}
            assert codes == {"jax": 200, "port": 200}, (step, path)
            # one frame at a time: a replicator that found two frames
            # in one debounce window would apply them in one sync, and
            # its delta_stats would count one patch for two
            ids = clusters.converge()
        fingerprints = {i["table_fingerprint"] for side in ids.values()
                        for i in side}
        assert len(fingerprints) == 1, (step, ids)
        assert [i["policy_epoch"] for i in ids["port"]] == \
            [i["policy_epoch"] for i in ids["jax"]], step
        routed = clusters.both(AC + "IsAllowedBatch", probe)
        assert routed["port"] == routed["jax"], step
        after = {name: policy_updates(clusters.addrs(name))
                 for name in clusters.sides}
        moved = {name: delta_moves(before[name], after[name])
                 for name in clusters.sides}
        assert moved["port"] == moved["jax"], step
        moves[step] = [json.loads(m) for m in moved["port"]]
        decisions[step] = pb.BatchResponse.FromString(
            routed["port"]).responses[-1].decision
    # the reader rule's decision moved with the steps
    assert decisions["create"] == pb.PERMIT
    assert decisions["flip"] == pb.DENY
    assert decisions["algorithm"] == pb.PERMIT
    # every replica moved at every step: the one that served the RPC
    # locally, the other through its replicator
    assert all(all(m) for m in moves.values()), moves
    assert all(m.get("patches") for m in moves["flip"]), moves
    assert all(m.get("reasons", {}).get("combining-algorithm-changed")
               for m in moves["algorithm"]), moves


@pytest.mark.cluster(timeout=240)
def test_restart_replica_converges_by_journal_replay(clusters):
    """The port cluster's replica 1 killed, the reader rule flipped through
    both routers while it is down, the replica restarted: it replays the
    journal and converges on the survivor's fingerprint, which is the JAX
    replicas' (they applied the flip live), and answers the flip
    directly with the JAX cluster's bytes.  (A JAX replica's own restart
    replays through the debounced sync, whose cut points can change its
    capacity buckets: ROADMAP §C.)"""
    clusters.converge()
    port = clusters.sides["port"]
    port.replicas[1].kill()
    out = clusters.both(RULES + "Upsert", _rule("DENY"))
    assert {pb.MutationResponse.FromString(raw).operation_status.code
            for raw in out.values()} == {200}
    old = port.replicas[1].addr
    restarted = port.restart_replica(1)
    assert restarted.addr != old
    routed_addrs = {r["addr"] for r in port.router.status()["replicas"]}
    assert restarted.addr in routed_addrs and old not in routed_addrs
    ids = clusters.converge()
    assert len({i["table_fingerprint"] for side in ids.values()
                for i in side}) == 1
    probe = probe_bytes()
    channel = grpc.insecure_channel(restarted.addr)
    try:
        answer = channel.unary_unary(AC + "IsAllowedBatch")(probe,
                                                           timeout=60)
    finally:
        channel.close()
    routed = clusters.both(AC + "IsAllowedBatch", probe)
    assert answer == routed["port"] == routed["jax"]
    assert pb.BatchResponse.FromString(answer).responses[-1].decision == \
        pb.DENY


def test_replica_fails_start_without_cuda(tmp_path, monkeypatch):
    """``device=None`` is the CUDA device: a replica that cannot get it
    exits at startup and ``start`` raises, leaving no process behind."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    cluster = LocalCluster(n_replicas=1, base_dir=str(tmp_path))
    assert cluster.device is None
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster.start()
    assert cluster.broker_proc.poll() is not None
    assert cluster.replicas and not any(r.alive for r in cluster.replicas)


# ------------------------------------------- the router over port replicas


@pytest.fixture()
def replica_pair():
    workers, servers = [], []
    for _ in range(2):
        worker = Worker().start(seed_cfg(), device="cpu")
        workers.append(worker)
        servers.append(GrpcServer(worker, "127.0.0.1:0").start())
    router = ClusterRouter([s.addr for s in servers],
                           cfg={"health_interval_s": 0.2,
                                "max_retries": 1}).start()
    client = GrpcClient(router.addr)
    yield workers, servers, router, client
    client.close()
    router.stop()
    for server in servers:
        server.stop()
    for worker in workers:
        worker.stop()


def test_balancing_and_epoch_trailers(replica_pair):
    workers, servers, router, client = replica_pair
    for _ in range(10):
        resp = client.is_allowed(wire_request())
        assert resp.operation_status.code == 200
        assert resp.decision == pb.PERMIT
    status = router.status()
    assert all(r["calls"] > 0 for r in status["replicas"]), status
    assert [r["policy_epoch"] for r in status["replicas"]] == [0, 0]
    assert status["converged"] is True
    direct = grpc.insecure_channel(servers[0].addr)
    try:
        _, call = direct.unary_unary(AC + "IsAllowed").with_call(
            wire_request().SerializeToString())
        trailers = dict(call.trailing_metadata() or ())
        assert trailers.get(POLICY_EPOCH_METADATA_KEY) == "0"
        assert SHED_METADATA_KEY not in trailers
    finally:
        direct.close()


def test_drain_undrain_and_all_drained(replica_pair):
    workers, servers, router, client = replica_pair
    addr0 = servers[0].addr
    assert command_over(client.channel, "cluster_drain",
                        {"addr": addr0})["status"] == "draining"
    before = {r["addr"]: r["calls"] for r in router.status()["replicas"]}
    for _ in range(6):
        assert client.is_allowed(wire_request()).operation_status.code == 200
    after = {r["addr"]: r["calls"] for r in router.status()["replicas"]}
    assert after[addr0] == before[addr0]
    assert after[servers[1].addr] == before[servers[1].addr] + 6
    assert command_over(client.channel, "cluster_undrain",
                        {"addr": addr0})["status"] == "serving"
    command_over(client.channel, "cluster_drain", {})
    with pytest.raises(grpc.RpcError) as excinfo:
        client.is_allowed(wire_request())
    assert excinfo.value.code() == grpc.StatusCode.UNAVAILABLE
    command_over(client.channel, "cluster_undrain", {})
    assert client.is_allowed(wire_request()).operation_status.code == 200


def test_retry_after_a_replica_stops(replica_pair):
    workers, servers, router, client = replica_pair
    servers[0].stop(grace=0)
    for _ in range(8):
        assert client.is_allowed(wire_request()).operation_status.code == 200
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        by = {r["addr"]: r for r in router.status()["replicas"]}
        if not by[servers[0].addr]["healthy"]:
            break
        time.sleep(0.05)
    assert not by[servers[0].addr]["healthy"]
    assert by[servers[1].addr]["calls"] >= 8 - by[servers[0].addr][
        "failures"]


def test_command_forwarding(replica_pair):
    workers, servers, router, client = replica_pair
    health = command_over(client.channel, "health_check")
    assert health["status"] == "SERVING" and health["policy_epoch"] == 0
    identity = command_over(client.channel, "program_identity")
    assert identity["table_fingerprint"] == \
        workers[0].evaluator.table_fingerprint()
    launches = command_over(client.channel, "kernel_launches")
    assert set(launches["launches"]) >= {"sig_decide", "wia_planes"}
    status = command_over(client.channel, "cluster_status")
    assert len(status["replicas"]) == 2


def test_stream_through_the_router(replica_pair):
    workers, servers, router, client = replica_pair
    frames = [pb.BatchRequest(requests=[wire_request(), wire_request()])
              for _ in range(4)]
    responses = list(client.is_allowed_stream(iter(frames), timeout=60))
    assert len(responses) == 4
    assert all(r.operation_status.code == 200
               for frame in responses for r in frame.responses)


def test_stream_failover_replays_the_unanswered_tail(replica_pair):
    workers, servers, router, client = replica_pair
    router.set_drain(servers[1].addr, True)
    frame_q: "queue.Queue" = queue.Queue()
    results: list = []
    errors: list = []

    def gen():
        while True:
            item = frame_q.get()
            if item is None:
                return
            yield item

    def consume():
        try:
            for resp in client.is_allowed_stream(gen(), timeout=120):
                results.append(resp)
        except BaseException as err:  # noqa: BLE001
            errors.append(err)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    frame = pb.BatchRequest(requests=[wire_request()])
    frame_q.put(frame)
    deadline = time.monotonic() + 30
    while not results and time.monotonic() < deadline:
        time.sleep(0.02)
    assert len(results) == 1
    router.set_drain(servers[1].addr, False)
    servers[0].stop(grace=0)
    for _ in range(3):
        frame_q.put(frame)
    frame_q.put(None)
    consumer.join(timeout=60)
    assert not consumer.is_alive() and not errors, errors
    assert len(results) == 4
    assert all(r.responses[0].operation_status.code == 200 for r in results)


@pytest.mark.parametrize("all_shed", [False, True])
def test_shed_migration(all_shed):
    """A replica that sheds everything (queue bounds 0): the router moves
    the call to the other replica; when both shed, the caller gets the
    honest shed (429), never a made-up decision."""
    shedding = seed_cfg(admission={"enabled": True,
                                   "max_queue_interactive": 0,
                                   "max_queue_bulk": 0})
    workers = [Worker().start(shedding, device="cpu"),
               Worker().start(shedding if all_shed else seed_cfg(),
                              device="cpu")]
    servers = [GrpcServer(w, "127.0.0.1:0").start() for w in workers]
    router = ClusterRouter([s.addr for s in servers],
                           cfg={"health_interval_s": 0.5,
                                "max_retries": 1}).start()
    client = GrpcClient(router.addr)
    try:
        if all_shed:
            assert client.is_allowed(
                wire_request()).operation_status.code == 429
            return
        router.set_drain(servers[1].addr, True)
        direct = GrpcClient(servers[0].addr)
        assert direct.is_allowed(wire_request()).operation_status.code == 429
        direct.close()
        router.set_drain(servers[1].addr, False)
        codes = [client.is_allowed(wire_request()).operation_status.code
                 for _ in range(6)]
        assert codes == [200] * 6
        by = {r["addr"]: r for r in router.status()["replicas"]}
        assert by[servers[0].addr]["sheds"] >= 1
        assert by[servers[1].addr]["retries_absorbed"] >= 1
    finally:
        client.close()
        router.stop()
        for s in servers:
            s.stop()
        for w in workers:
            w.stop()


IMPORT_GUARD = r"""
import sys
for name in ("jax", "jaxlib", "access_control_srv_tpu"):
    sys.modules[name] = None  # any import of these raises ImportError
import importlib
importlib.import_module(sys.argv[1])
bad = [m for m in sys.modules if sys.modules[m] is not None
       and m.split(".")[0] in ("jax", "jaxlib", "access_control_srv_tpu")]
assert not bad, bad
print("ok")
"""


@pytest.mark.parametrize("module", [
    "access_control_srv_tpu_torch.srv.broker",
    "access_control_srv_tpu_torch.srv.router",
    "access_control_srv_tpu_torch.parallel.cluster",
])
def test_modules_import_without_jax(module):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", IMPORT_GUARD, module],
                          cwd=repo, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stderr[-2000:]


# ------------------------------------------------ the replicator's boot replay


def _stress_frames(bus, n_rules: int, origin: str = "elsewhere") -> int:
    """``n_rules`` stress rules, their policies and set as remote Created
    frames on ``bus``'s CRUD topics; returns the frame count."""
    doc, _ = bench_all._stress_doc(n_rules)
    frames = 0
    for ps in doc["policy_sets"]:
        for pol in ps["policies"]:
            for rule in pol["rules"]:
                bus.topic(CRUD_TOPICS[0]).emit(
                    "ruleCreated", {"payload": rule, "origin": origin})
                frames += 1
            bus.topic(CRUD_TOPICS[1]).emit("policyCreated", {
                "payload": {**{k: v for k, v in pol.items() if k != "rules"},
                            "rules": [r["id"] for r in pol["rules"]]},
                "origin": origin})
            frames += 1
        bus.topic(CRUD_TOPICS[2]).emit("policySetCreated", {
            "payload": {**{k: v for k, v in ps.items() if k != "policies"},
                        "policies": [p["id"] for p in ps["policies"]]},
            "origin": origin})
        frames += 1
    return frames


def test_boot_replay_is_one_sync():
    """The frames journaled when the replicator starts are applied in ONE
    sync (one ``store.load`` with every frame's event), whatever the
    timing of their delivery; a live frame afterwards syncs on its own."""
    from access_control_srv_tpu_torch.srv.store import PolicyReplicator

    worker = Worker().start({"policies": {"type": "database"}},
                            device="cpu")
    try:
        frames = _stress_frames(worker.bus, 600)
        loads = []
        real_load = worker.store.load
        worker.store.load = lambda events=None: (
            loads.append(len(events or ())), real_load(events))[1]
        rep = PolicyReplicator(worker.store, worker.bus, debounce_s=0.0)
        rep.start()
        assert rep.wait_caught_up(timeout_s=60)
        assert loads == [frames] and rep.epoch == frames
        assert not rep._boot_tail
        assert worker.evaluator._compiled.n_rules == 600
        rule = dict(worker.store.collections["rule"].get("r0"),
                    effect="PERMIT")
        worker.bus.topic(CRUD_TOPICS[0]).emit(
            "ruleModified", {"payload": rule, "origin": "elsewhere"})
        deadline = time.monotonic() + 30
        while rep.epoch < frames + 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loads == [frames, 1] and rep.epoch == frames + 1
        rep.stop()
    finally:
        worker.store.load = real_load
        worker.stop()


def test_replicas_of_one_journal_share_a_fingerprint():
    """Two Workers over one broker whose journal holds a 2,000-rule tree
    (a replay long enough that a debounced sync would cut it) boot on one
    ``table_fingerprint``."""
    from access_control_srv_tpu_torch.srv.broker import BrokerServer

    server = BrokerServer().start()
    workers = []
    try:
        bus = SocketEventBus(server.address)
        frames = _stress_frames(bus, 2000)
        bus.close()
        cfg = {"policies": {"type": "database"},
               "events": {"broker": {"address": server.address}}}
        with ThreadPoolExecutor(2) as pool:
            workers = list(pool.map(
                lambda _: Worker().start(cfg, device="cpu"), range(2)))
        assert [w.policy_epoch() for w in workers] == [frames, frames]
        fps = {w.evaluator.table_fingerprint() for w in workers}
        assert len(fps) == 1
        assert [w.evaluator.delta_stats()["patches"] for w in workers] == \
            [0, 0]
    finally:
        for w in workers:
            w.stop()
        server.stop()


def test_start_broker_then_start_with_document_lists(tmp_path):
    """``start_broker`` seeds the journal ahead of the replicas (here
    from lists of documents rather than YAML paths); ``start`` then
    spawns the replica, which boots by replaying exactly that journal."""
    from access_control_srv_tpu_torch.srv.worker import _yaml_list

    docs = {k: _yaml_list(p) for k, p in seed_paths().items()}
    cluster = LocalCluster(n_replicas=1, seed_cfg=docs,
                           base_dir=str(tmp_path), device="cpu")
    try:
        cluster.start_broker()
        assert cluster.replicas == [] and cluster.router is None
        assert cluster.seeded_at >= cluster.broker_ready_at
        bus = SocketEventBus(cluster.broker_addr)
        frames = sum(bus.topic(t).offset for t in CRUD_TOPICS)
        bus.close()
        assert frames == sum(len(v) for v in docs.values())
        cluster.start()
        replica = cluster.replicas[0]
        assert replica.ready_at >= replica.spawned_at >= cluster.seeded_at
        ids = wait_converged([replica.addr], timeout_s=60.0,
                             min_epoch=frames)
        assert ids[0]["policy_epoch"] == frames
    finally:
        cluster.stop()
    assert not cluster.replicas[0].alive
    assert cluster.broker_proc.poll() is not None
