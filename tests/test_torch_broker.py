"""The port's cross-process broker (``srv/broker.py``) against the JAX
package's.

The protocol cases run on every pairing of a server and a client side
(port/port, a port client on the JAX server, a JAX client on the port
server): the wire frames are the same, so each pairing must behave as the
JAX pair does.  The durability cases (CRC replay of a torn or flipped
journal, snapshot and compaction) run on the port's server; the journal
cases show that a journal either broker writes replays in the other with
the same topics, offsets and KV, and that both write the same bytes.  The
HR-scope rendezvous runs with the responder in a second OS process."""

import json
import os
import subprocess
import sys
import time

import pytest

from access_control_srv_tpu.srv import Worker as JaxWorker
from access_control_srv_tpu.srv import broker as jbroker
from access_control_srv_tpu_torch.models import Decision
from access_control_srv_tpu_torch.srv import broker as tbroker
from access_control_srv_tpu_torch.srv.faults import REGISTRY
from access_control_srv_tpu_torch.srv.worker import Worker

from .utils import URNS

ORG = "urn:restorecommerce:acs:model:organization.Organization"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = os.path.join(REPO, "data", "seed_data")
SIDES = {"port": tbroker, "jax": jbroker}
# (server side, client side)
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]


def wait_until(pred, timeout_s: float = 5.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


@pytest.fixture(scope="module")
def servers():
    """One in-process broker per side for the protocol cases (each case
    uses topics and keys of its own)."""
    out = {side: mod.BrokerServer().start() for side, mod in SIDES.items()}
    yield out
    for server in out.values():
        server.stop()


@pytest.fixture(params=PAIRS, ids=["-".join(p) for p in PAIRS])
def pair(request, servers):
    server_side, client_side = request.param
    return (servers[server_side].address, SIDES[client_side],
            f"{server_side}-{client_side}")


# ----------------------------------------------------------------- protocol


def test_emit_read_offset_and_subscribe(pair):
    """emit / read / offset, then a subscription from offset 0: the
    replay of the log, then live frames, each with its offset."""
    address, mod, tag = pair
    a = mod.SocketEventBus(address)
    b = mod.SocketEventBus(address)
    try:
        topic = a.topic(f"t.{tag}")
        assert [topic.emit("e", {"i": i}) for i in range(3)] == [0, 1, 2]
        assert topic.offset == 3
        assert topic.read(1) == [("e", {"i": 1}), ("e", {"i": 2})]
        got = []
        b.topic(f"t.{tag}").on(
            lambda e, m, ctx: got.append((e, m["i"], ctx["offset"])),
            starting_offset=0)
        assert wait_until(lambda: len(got) == 3)
        a.topic(f"t.{tag}").emit("live", {"i": 3})
        assert wait_until(lambda: len(got) == 4)
        assert got == [("e", 0, 0), ("e", 1, 1), ("e", 2, 2), ("live", 3, 3)]
    finally:
        a.close()
        b.close()


def test_replay_from_offset(pair):
    address, mod, tag = pair
    a = mod.SocketEventBus(address)
    b = mod.SocketEventBus(address)
    try:
        for i in range(5):
            a.topic(f"r.{tag}").emit("e", i)
        got = []
        b.topic(f"r.{tag}").on(lambda e, m, ctx: got.append(m),
                               starting_offset=3)
        assert wait_until(lambda: len(got) == 2)
        assert got == [3, 4]
    finally:
        a.close()
        b.close()


def test_cache_and_offset_ops(pair):
    address, mod, tag = pair
    c1 = mod.SocketSubjectCache(address)
    c2 = mod.SocketSubjectCache(address)
    o1 = mod.SocketOffsetStore(address)
    o2 = mod.SocketOffsetStore(address)
    try:
        key = f"cache:{tag}:hrScopes"
        c1.set(key, [{"id": "Org1"}])
        assert c2.get(key) == [{"id": "Org1"}]
        assert c2.exists(key)
        assert c2.evict_prefix(f"cache:{tag}:") == 1
        assert not c1.exists(key)
        assert c1.get(key) is None
        o1.commit(f"topic.{tag}", 41)
        assert o2.get(f"topic.{tag}") == 41
        assert o2.get(f"missing.{tag}") is None
    finally:
        for x in (c1, c2, o1, o2):
            x.close()


def test_bad_frames_and_disconnects(pair):
    """A malformed frame gets an error reply; abrupt disconnects of an
    RPC and a subscription connection leave the broker serving."""
    import socket as socketlib

    address, mod, tag = pair
    host, port = address.rsplit(":", 1)
    raw = socketlib.create_connection((host, int(port)))
    raw.sendall(b"not json\n")
    assert b"error" in raw.makefile("rb").readline()
    raw.close()
    sub = mod.SocketEventBus(address)
    sub.topic(f"err.{tag}").on(lambda e, m, c: None)
    time.sleep(0.05)
    sub.close()
    bus = mod.SocketEventBus(address)
    try:
        assert bus.topic(f"err.{tag}").emit("still-alive", 1) == 0
        assert bus.topic(f"err.{tag}").read() == [("still-alive", 1)]
    finally:
        bus.close()


@pytest.mark.parametrize("server_side,client_side", PAIRS)
def test_secret_refused_without_accepted_with(server_side, client_side):
    server = SIDES[server_side].BrokerServer(secret="hunter2").start()
    mod = SIDES[client_side]
    try:
        with pytest.raises(ConnectionError, match="auth"):
            mod.SocketSubjectCache(server.address).get("k")
        with pytest.raises(ConnectionError, match="auth"):
            mod.SocketSubjectCache(server.address, secret="wrong")
        cache = mod.SocketSubjectCache(server.address, secret="hunter2")
        cache.set("k", 1)
        assert cache.get("k") == 1
        cache.close()
        bus = mod.SocketEventBus(server.address, secret="hunter2")
        got = []
        # from offset 0: the frame arrives whether the subscription is
        # registered before the emit or after it
        bus.topic("authed").on(lambda e, m, ctx: got.append(m),
                               starting_offset=0)
        bus.topic("authed").emit("ev", {"x": 1})
        assert wait_until(lambda: got == [{"x": 1}])
        bus.close()
    finally:
        server.stop()


# --------------------------------------------------------------- durability


def _write_state(address: str, mod) -> None:
    """One sequence of every journaled operation."""
    bus = mod.SocketEventBus(address)
    offsets = mod.SocketOffsetStore(address)
    cache = mod.SocketSubjectCache(address)
    try:
        for i in range(5):
            bus.topic("durable.a").emit("thing", {"i": i})
        bus.topic("durable.b").emit("other", ["x", {"y": None}])
        offsets.commit("durable.a", 3)
        cache.set("cache:u1:subject", {"id": "u1"})
        cache.set("cache:gone:subject", {"id": "gone"})
        cache.evict_prefix("cache:gone")
    finally:
        bus.close()
        offsets.close()
        cache.close()


def _read_state(address: str, mod) -> dict:
    bus = mod.SocketEventBus(address)
    offsets = mod.SocketOffsetStore(address)
    cache = mod.SocketSubjectCache(address)
    try:
        return {
            "a": bus.topic("durable.a").read(0),
            "b": bus.topic("durable.b").read(0),
            "offsets": (bus.topic("durable.a").offset,
                        bus.topic("durable.b").offset),
            "committed": offsets.get("durable.a"),
            "kv": (cache.get("cache:u1:subject"),
                   cache.exists("cache:gone:subject")),
        }
    finally:
        bus.close()
        offsets.close()
        cache.close()


WANT_STATE = {
    "a": [("thing", {"i": i}) for i in range(5)],
    "b": [("other", ["x", {"y": None}])],
    "offsets": (5, 1), "committed": 3,
    "kv": ({"id": "u1"}, False),
}


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_journal_replays_in_the_other_broker(tmp_path, writer, reader):
    """A journal one broker writes replays in the other: the same topics,
    offsets, committed consumer offsets and KV (evictions included)."""
    data_dir = str(tmp_path / "broker")
    server = SIDES[writer].BrokerServer(data_dir=data_dir).start()
    try:
        _write_state(server.address, SIDES[writer])
    finally:
        server.stop()
    server = SIDES[reader].BrokerServer(data_dir=data_dir).start()
    try:
        assert not server.recovered
        assert _read_state(server.address, SIDES[reader]) == WANT_STATE
    finally:
        server.stop()


def test_both_brokers_write_the_same_journal_bytes(tmp_path):
    journals = []
    for side in ("jax", "port"):
        data_dir = str(tmp_path / side)
        server = SIDES[side].BrokerServer(data_dir=data_dir).start()
        try:
            _write_state(server.address, SIDES[side])
        finally:
            server.stop()
        with open(os.path.join(data_dir, "broker.journal"), "rb") as fh:
            journals.append(fh.read())
    assert journals[0] == journals[1] and journals[0].count(b"\n") == 10
    line = journals[1].split(b"\n")[0].decode() + "\n"
    assert tbroker._decode_journal_line(line) == \
        jbroker._decode_journal_line(line)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_replays_in_the_port_broker(tmp_path, writer):
    """A snapshot plus a journal tail (compaction every 5 records),
    written by either broker, recovers in the port's."""
    data_dir = str(tmp_path / "snap")
    server = SIDES[writer].BrokerServer(data_dir=data_dir,
                                        snapshot_every=5).start()
    try:
        _write_state(server.address, SIDES[writer])
        status = SIDES[writer].SocketEventBus(server.address)
        st = status.snapshot_status()
        status.close()
        assert st["exists"] and st["watermark"] == 10
        assert st["tail_records"] == 0
    finally:
        server.stop()
    server = tbroker.BrokerServer(data_dir=data_dir, snapshot_every=5).start()
    try:
        assert _read_state(server.address, tbroker) == WANT_STATE
        bus = tbroker.SocketEventBus(server.address)
        bus.topic("durable.a").emit("thing", {"i": 5})
        st = bus.snapshot_status()
        assert st["watermark"] == 10 and st["tail_records"] == 1
        forced = bus.snapshot()
        assert forced["exists"] and forced["tail_records"] == 0
        bus.close()
        assert os.path.getsize(os.path.join(data_dir, "broker.journal")) == 0
    finally:
        server.stop()


def test_kill_restart_resumes_subscriber_from_commit(tmp_path):
    data_dir = str(tmp_path / "broker")
    server = tbroker.BrokerServer(data_dir=data_dir).start()
    try:
        _write_state(server.address, tbroker)
    finally:
        server.stop()
    server = tbroker.BrokerServer(data_dir=data_dir).start()
    try:
        bus = tbroker.SocketEventBus(server.address)
        offsets = tbroker.SocketOffsetStore(server.address)
        got = []
        topic = bus.topic("durable.a")
        topic.on(lambda e, m, ctx: got.append((m["i"], ctx["offset"])),
                 starting_offset=offsets.get("durable.a"))
        topic.emit("thing", {"i": 5})
        assert wait_until(lambda: len(got) == 3)
        assert got == [(3, 3), (4, 4), (5, 5)]
        bus.close()
        offsets.close()
    finally:
        server.stop()


@pytest.mark.parametrize("damage", ["torn-tail", "flipped-byte",
                                    "torn-failpoint"])
def test_crc_replay_keeps_the_consistent_prefix(tmp_path, damage):
    """A torn append or a flipped byte fails the record's CRC: replay
    keeps the records before it, truncates there, reports the drop."""
    data_dir = str(tmp_path / "crc")
    server = tbroker.BrokerServer(data_dir=data_dir).start()
    try:
        bus = tbroker.SocketEventBus(server.address)
        for i in range(4):
            bus.topic("t").emit("thing", {"i": i})
        if damage == "torn-failpoint":
            with REGISTRY.arm([{"site": "broker.journal.write",
                                "action": "torn", "torn_frac": 0.4}]):
                bus.topic("t").emit("thing", {"i": 4})
            # live in memory, torn on disk
            assert [m["i"] for _, m in bus.topic("t").read(0)] == \
                [0, 1, 2, 3, 4]
        bus.close()
    finally:
        server.stop()
    path = os.path.join(data_dir, "broker.journal")
    if damage == "torn-tail":
        with open(path, "a") as fh:
            fh.write('{"k": "emit", "t": "t", "e": "b"')
        want = [0, 1, 2, 3]
    elif damage == "flipped-byte":
        lines = open(path).readlines()
        lines[2] = lines[2].replace('"i": 2', '"i": 7')
        open(path, "w").writelines(lines)
        want = [0, 1]
    else:
        want = [0, 1, 2, 3]
    server = tbroker.BrokerServer(data_dir=data_dir).start()
    try:
        if damage != "torn-tail":
            assert server.recovered["dropped_bytes"] > 0
        bus = tbroker.SocketEventBus(server.address)
        assert [m["i"] for _, m in bus.topic("t").read(0)] == want
        bus.close()
    finally:
        server.stop()


def test_corrupt_snapshot_fails_closed(tmp_path):
    data_dir = str(tmp_path / "corrupt")
    server = tbroker.BrokerServer(data_dir=data_dir).start()
    try:
        bus = tbroker.SocketEventBus(server.address)
        bus.topic("t").emit("a", {"n": 1})
        bus.snapshot()
        bus.close()
    finally:
        server.stop()
    path = os.path.join(data_dir, "broker.snapshot")
    blob = json.load(open(path))
    blob["state"] = blob["state"].replace('"n":1', '"n":9')
    json.dump(blob, open(path, "w"))
    server = tbroker.BrokerServer(data_dir=data_dir).start()
    try:
        assert "snapshot_error" in (server.recovered or {})
        bus = tbroker.SocketEventBus(server.address)
        assert bus.topic("t").read(0) == []
        bus.close()
    finally:
        server.stop()


def test_dead_subscriber_reaped_on_idle_topic(monkeypatch):
    monkeypatch.setattr(tbroker, "HEARTBEAT_INTERVAL", 0.2)
    server = tbroker.BrokerServer().start()
    try:
        bus = tbroker.SocketEventBus(server.address)
        bus.topic("idle").on(lambda e, m, c: None)
        assert wait_until(lambda: len(server._subscribers.get("idle", []))
                          == 1)
        bus.close()
        assert wait_until(lambda: not server._subscribers.get("idle"), 10)
    finally:
        server.stop()


# ------------------------------------------------- the rendezvous and worker


RESPONDER = """
import sys
sys.path.insert(0, {repo!r})
from access_control_srv_tpu_torch.srv.broker import SocketEventBus

bus = SocketEventBus({address!r})
auth = bus.topic("io.restorecommerce.authentication")

def respond(event_name, message, ctx):
    if event_name != "hierarchicalScopesRequest":
        return
    auth.emit("hierarchicalScopesResponse", {{
        "token": message["token"],
        "subject_id": "ada",
        "interactive": True,
        "hierarchical_scopes": [{{"id": "OrgX"}}],
    }})

# from offset 0: a request emitted before the subscription registers is
# still answered
auth.on(respond, starting_offset=0)
print("ready", flush=True)
sys.stdin.read()
"""


def seed_worker_cfg(address: str, **extra) -> dict:
    cfg = {
        "policies": {"type": "database"},
        "seed_data": {k: os.path.join(SEED, f"{k}.yaml")
                      for k in ("policy_sets", "policies", "rules")},
        "events": {"broker": {"address": address}},
    }
    cfg.update(extra)
    return cfg


def test_hr_rendezvous_across_os_processes():
    """A port Worker on the socket bus parks an HR-scope request; a
    second OS process answers it over the broker; the decision resolves
    and the scopes land in the shared cache."""
    from access_control_srv_tpu_torch.models import (
        Attribute,
        Request,
        Target,
    )

    server = tbroker.BrokerServer().start()
    responder = subprocess.Popen(
        [sys.executable, "-c",
         RESPONDER.format(repo=REPO, address=server.address)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        assert responder.stdout.readline().strip() == "ready"
        worker = Worker().start(seed_worker_cfg(
            server.address, authorization={"hrReqTimeout": 10_000}),
            device="cpu")
        try:
            assert isinstance(worker.bus, tbroker.SocketEventBus)
            assert isinstance(worker.subject_cache,
                              tbroker.SocketSubjectCache)
            assert isinstance(worker.offset_store, tbroker.SocketOffsetStore)
            worker.identity_client.register("xp-tok-1", {
                "id": "ada",
                "tokens": [{"token": "xp-tok-1", "interactive": True}],
                "role_associations": [
                    {"role": "superadministrator-r-id", "attributes": []}],
            })
            request = Request(
                target=Target(
                    subjects=[Attribute(id=URNS["role"],
                                        value="superadministrator-r-id"),
                              Attribute(id=URNS["subjectID"], value="ada")],
                    resources=[Attribute(id=URNS["entity"], value=ORG),
                               Attribute(id=URNS["resourceID"],
                                         value="O1")],
                    actions=[Attribute(id=URNS["actionID"],
                                       value=URNS["read"])]),
                context={"subject": {"token": "xp-tok-1"},
                         "resources": [{"id": "O1",
                                        "meta": {"owners": []}}]})
            assert worker.service.is_allowed(request).decision == \
                Decision.PERMIT
            assert worker.subject_cache.get("cache:ada:hrScopes") == \
                [{"id": "OrgX"}]
        finally:
            worker.stop()
    finally:
        responder.kill()
        responder.wait()
        server.stop()


def test_worker_passes_the_broker_secret():
    server = tbroker.BrokerServer(secret="s3cr3t").start()
    try:
        worker = Worker().start({
            "events": {"broker": {"address": server.address,
                                  "secret": "s3cr3t"}},
            "policies": {"type": "database"}}, device="cpu")
        worker.bus.topic("x").emit("ping", {"ok": True})
        assert worker.bus.topic("x").read(0) == [("ping", {"ok": True})]
        worker.stop()
        with pytest.raises(ConnectionError, match="auth"):
            Worker().start({
                "events": {"broker": {"address": server.address,
                                      "secret": "nope"}},
                "policies": {"type": "database"}}, device="cpu")
    finally:
        server.stop()


def test_relation_tuples_ride_the_broker():
    """With a broker, the relation tuple topic is the shared tuple store:
    a tuple one port Worker writes reaches a second port Worker and a
    JAX Worker on the same broker, and a Worker started later boots on
    the journal to the same store fingerprint."""
    ns = "urn:restorecommerce:acs:model:document.Document"
    server = tbroker.BrokerServer().start()
    cfg = {"policies": {"type": "database"},
           "events": {"broker": {"address": server.address}},
           "relations": {"enabled": True}}
    workers = []
    try:
        writer = Worker().start(dict(cfg), device="cpu")
        workers.append(writer)
        reader = Worker().start(dict(cfg), device="cpu")
        workers.append(reader)
        jax_reader = JaxWorker().start(dict(cfg))
        workers.append(jax_reader)
        writer.relation_store.create([(ns, "doc1", "viewer", "alice"),
                                      (ns, "doc2", "viewer", "bob")])
        writer.relation_store.delete([(ns, "doc2", "viewer", "bob")])
        stores = [w.relation_store for w in workers]
        assert wait_until(lambda: len({s.fingerprint() for s in stores})
                          == 1, 10)
        assert all(s.check("viewer", ns, "doc1", "alice") for s in stores)
        assert not any(s.check("viewer", ns, "doc2", "bob") for s in stores)
        late = Worker().start(dict(cfg), device="cpu")
        workers.append(late)
        assert late.relation_store.fingerprint() == \
            writer.relation_store.fingerprint()
        # the writer applied each of its own frames once
        assert writer.relation_store.generation == 3
    finally:
        for w in workers:
            w.stop()
        server.stop()
