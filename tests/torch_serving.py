"""Shared rig of the serving-shell differentials.

A ``Rig`` starts a JAX ``Worker`` and a port ``Worker`` (``device="cpu"``)
on the same config, each behind its own ``GrpcServer`` on
``127.0.0.1:0``, and calls both over raw byte channels: the same request
bytes go to both servers and the tests compare the response bytes.
Traffic is made from a numpy seed (``traffic``) over the request grid of
``tests/test_kernel_differential.py`` and the seed tree's role set.
"""

from __future__ import annotations

import copy
import json
import os

import grpc
import numpy as np

from access_control_srv_tpu.srv import Worker as JaxWorker
from access_control_srv_tpu.srv.faults import REGISTRY as JAX_FAULTS
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu.srv.transport_grpc import GrpcServer as JaxServer
from access_control_srv_tpu.srv.transport_grpc import request_to_pb
from access_control_srv_tpu_torch.srv.faults import REGISTRY as PORT_FAULTS
from access_control_srv_tpu_torch.srv.transport_grpc import (
    GrpcServer as PortServer,
)
from access_control_srv_tpu_torch.srv.worker import Worker as PortWorker

from .test_kernel_differential import grid_requests
from .utils import URNS, fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = os.path.join(REPO, "data", "seed_data")
ORG = "urn:restorecommerce:acs:model:organization.Organization"
PO = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:permit-overrides"
AC = "/acstpu.AccessControlService/"


def seed_cfg(**overrides) -> dict:
    """The seed tree in database mode (the store's seed path), the
    compile synchronous unless an override says otherwise."""
    cfg = {
        "policies": {"type": "database"},
        "seed_data": {
            "policy_sets": os.path.join(SEED, "policy_sets.yaml"),
            "policies": os.path.join(SEED, "policies.yaml"),
            "rules": os.path.join(SEED, "rules.yaml"),
        },
    }
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(cfg.get(key), dict):
            cfg[key] = {**cfg[key], **value}
        else:
            cfg[key] = value
    return cfg


def local_cfg(*names, **overrides) -> dict:
    """Fixture trees in local (YAML) mode."""
    cfg = {"policies": {"type": "local",
                        "paths": [fixture(n) for n in names]}}
    cfg.update(overrides)
    return cfg


def seed_request(role="superadministrator-r-id", action=None, rid="O1",
                 entity=ORG, subject="root") -> pb.Request:
    """The gRPC tests' request on the seed tree."""
    msg = pb.Request()
    msg.target.subjects.add(id=URNS["role"], value=role)
    msg.target.subjects.add(id=URNS["subjectID"], value=subject)
    msg.target.resources.add(id=URNS["entity"], value=entity)
    msg.target.resources.add(id=URNS["resourceID"], value=rid)
    msg.target.actions.add(id=URNS["actionID"],
                           value=action or URNS["read"])
    msg.context.subject.value = json.dumps({
        "id": subject,
        "role_associations": [{"role": role, "attributes": []}],
        "hierarchical_scopes": [],
    }).encode()
    entry = msg.context.resources.add()
    entry.value = json.dumps({"id": rid, "meta": {"owners": []}}).encode()
    return msg


SEED_ROLES = ("superadministrator-r-id", "administrator-r-id", "user-r-id",
              "nobody", "wire-role")
SEED_ACTIONS = ("read", "modify", "create", "delete")


def traffic(n: int, seed: int) -> list[bytes]:
    """``n`` serialized ``acstpu.Request`` messages chosen with a numpy
    seed: half from the fixture request grid, half seed-tree requests
    over its roles, actions and resource ids."""
    rng = np.random.default_rng(seed)
    pool = [request_to_pb(r).SerializeToString()
            for r in grid_requests(n=max(16, n), seed=int(seed))]
    out = []
    for i in range(n):
        if rng.random() < 0.5:
            out.append(pool[int(rng.integers(len(pool)))])
        else:
            out.append(seed_request(
                role=SEED_ROLES[int(rng.integers(len(SEED_ROLES)))],
                action=URNS[SEED_ACTIONS[int(rng.integers(4))]],
                rid=f"O{int(rng.integers(4))}",
            ).SerializeToString())
    return out


def batch_bytes(messages: list[bytes]) -> bytes:
    return pb.BatchRequest(
        requests=[pb.Request.FromString(m) for m in messages]
    ).SerializeToString()


class Side:
    """One worker behind its server, with a raw byte channel."""

    def __init__(self, worker, server):
        self.worker = worker
        self.server = server
        self.channel = grpc.insecure_channel(server.addr)

    def call(self, path: str, payload: bytes, metadata=None,
             timeout: float = 60.0, with_trailers: bool = False):
        rpc = self.channel.unary_unary(path)
        if not with_trailers:
            return rpc(payload, metadata=metadata, timeout=timeout)
        out, call = rpc.with_call(payload, metadata=metadata,
                                  timeout=timeout)
        return out, dict(call.trailing_metadata() or ())

    def stream(self, path: str, payloads: list[bytes],
               timeout: float = 60.0) -> list[bytes]:
        rpc = self.channel.stream_stream(path)
        return list(rpc(iter(payloads), timeout=timeout))

    def close(self) -> None:
        self.channel.close()
        self.server.stop(0)
        self.worker.stop()


class Rig:
    """A JAX side and a port side on the same config (``jax_cfg``
    overrides the JAX side's: its ``delta_enabled`` setting, which the
    port reads from no config)."""

    def __init__(self, cfg: dict, jax_cfg: dict | None = None):
        # both failpoint registries are process-wide (and report their
        # hits in health_check): each rig starts them disarmed, no hits
        JAX_FAULTS.configure([])
        PORT_FAULTS.configure([])
        self.jax = None
        self.port = None
        try:
            jw = JaxWorker().start(copy.deepcopy(jax_cfg or cfg))
            self.jax = Side(jw, JaxServer(jw, "127.0.0.1:0").start())
            tw = PortWorker().start(copy.deepcopy(cfg), device="cpu")
            self.port = Side(tw, PortServer(tw, "127.0.0.1:0").start())
        except BaseException:
            self.close()
            raise

    def both(self, path: str, payload: bytes, **kw):
        """(JAX response bytes, port response bytes)."""
        return self.jax.call(path, payload, **kw), \
            self.port.call(path, payload, **kw)

    def stream_both(self, path: str, payloads: list[bytes], **kw):
        return self.jax.stream(path, payloads, **kw), \
            self.port.stream(path, payloads, **kw)

    def close(self) -> None:
        for side in (self.port, self.jax):
            if side is not None:
                side.close()
        self.jax = self.port = None


def clear_meta_times(msg) -> None:
    """Zero the ``meta.created`` / ``meta.modified`` timestamps of every
    item of a CRUD list response (the one field pair that differs
    between two servers by construction)."""
    for item in getattr(msg, "items", []):
        if item.HasField("meta"):
            item.meta.created = 0
            item.meta.modified = 0
