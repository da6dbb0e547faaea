"""The port evaluator's native wire path against the JAX evaluator's.

``HybridEvaluator.is_allowed_batch_wire`` takes serialized
``acstpu.Request`` bytes (from the JAX package's ``request_to_pb``), encodes
them with the native encoder and decides them on the kernel; rows past the
floor caps are re-encoded at ``_CAPS_CEIL``.  The port (``device="cpu"``)
must return the JAX evaluator's (decision, cacheable, status) on every
eligible row and the same ``eligible`` mask, with a relation store too
(tables in the native id space), and None in the same cases.  The wire
writer of ``chip_smoke.py`` must write the bytes ``request_to_pb`` does.
"""

import numpy as np
import pytest

import access_control_srv_tpu_torch.models as tmodels
import chip_smoke
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu.srv.relations import (
    RelationTupleStore as JaxStore,
)
from access_control_srv_tpu.srv.transport_grpc import request_to_pb
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.relations import RelationTupleStore

from .test_kernel_differential import grid_requests
from .test_native_encoder import _deep_hr_request, wire_roundtrip
from .test_torch_carryover import build_request, make_engines, request_spec
from .utils import URNS
from .utils import build_request as jax_build_request

DOC = "urn:restorecommerce:acs:model:document.Document"


def evaluators(name: str, **kw):
    jeng, teng = make_engines(name)
    return (JaxEvaluator(jeng, delta_enabled=False, **kw),
            HybridEvaluator(teng, device="cpu", **kw))


def assert_wire_equal(jev, tev, messages, what):
    want = jev.is_allowed_batch_wire(messages)
    got = tev.is_allowed_batch_wire(messages)
    assert want is not None and got is not None, what
    assert np.array_equal(got[0].eligible, want[0].eligible), what
    rows = np.flatnonzero(want[0].eligible)
    for k, field in ((1, "decision"), (2, "cacheable"), (3, "status")):
        assert np.array_equal(np.asarray(got[k])[rows],
                              np.asarray(want[k])[rows]), (what, field)
    return got


@pytest.mark.parametrize("name", [
    "basic_policies.yml", "role_scopes.yml", "acl_policies.yml",
    "props_multi_rules_entities.yml", "seed_data",
])
def test_wire_matches_jax(name):
    jev, tev = evaluators(name)
    assert jev.native_active and tev.native_active
    messages, _ = wire_roundtrip(grid_requests(n=96, seed=17))
    got = assert_wire_equal(jev, tev, messages, name)
    assert got[0].eligible.sum() > 40


def test_deep_hr_rows_through_the_ceiling():
    jev, tev = evaluators("role_scopes.yml")
    reqs = [_deep_hr_request(64, owner="org-40-n"),
            _deep_hr_request(3, owner="org-1-n"),
            _deep_hr_request(50, owner="nowhere")]
    reqs += grid_requests(n=13, seed=3)
    messages, twins = wire_roundtrip(reqs)
    got = assert_wire_equal(jev, tev, messages, "deep HR")
    batch = got[0]
    assert batch.overcap[[0, 2]].all() and batch.eligible[:3].all()
    for b in range(3):
        want = tev.engine.is_allowed(build_request(request_spec(twins[b]),
                                                   tmodels))
        assert int(got[1][b]) == chip_smoke.DEC_CODE[want.decision], b


def _stores():
    """The same tuples in the JAX store and the port's."""
    out = []
    for cls in (JaxStore, RelationTupleStore):
        store = cls()
        store.set_rewrite(DOC, "viewer",
                          [("this",), ("computed_userset", "owner")])
        store.create([
            (DOC, "doc1", "owner", "alice"),
            (DOC, "doc2", "viewer", "bob"),
            (DOC, "doc3", "viewer",
             {"object": {"entity": "group", "id": "g"},
              "relation": "member"}),
            ("group", "g", "member", "carol"),
        ])
        out.append(store)
    return out


def test_relation_store_native_tables():
    jev, tev = evaluators("relation_policies.yml")
    jstore, tstore = _stores()
    jev.attach_relation_store(jstore)
    tev.attach_relation_store(tstore)
    reqs = [jax_build_request(subject_id=s, resource_type=DOC,
                              resource_id=r, action_type=URNS["read"])
            for s in ("alice", "bob", "carol", "mallory")
            for r in ("doc1", "doc2", "doc3", ["doc1", "doc3"])]
    messages, _ = wire_roundtrip(reqs)
    got = assert_wire_equal(jev, tev, messages, "relations")
    assert got[0].eligible.sum() >= len(reqs) - 1
    # tuple churn changes the wire decisions with no new encoder
    encoder = tev._native_encoder
    jstore.create([(DOC, "doc2", "viewer", "mallory")])
    tstore.create([(DOC, "doc2", "viewer", "mallory")])
    assert_wire_equal(jev, tev, messages, "relations after churn")
    assert tev._native_encoder is encoder and tev.relation_churn == 1


@pytest.mark.parametrize("case", ["explain", "conditions", "oracle"])
def test_wire_path_off_on_both_sides(case):
    name, kw = {"explain": ("role_scopes.yml", {"explain": True}),
                "conditions": ("conditions.yml", {}),
                "oracle": ("role_scopes.yml", {"backend": "oracle"})}[case]
    jev, tev = evaluators(name, **kw)
    messages, _ = wire_roundtrip(grid_requests(n=8, seed=1))
    assert not jev.native_active and not tev.native_active
    assert jev.is_allowed_batch_wire(messages) is None
    assert tev.is_allowed_batch_wire(messages) is None


def test_writer_bytes_fixture_grid():
    reqs = grid_requests(n=200, seed=31)
    for i, r in enumerate(reqs):
        want = request_to_pb(r).SerializeToString()
        assert chip_smoke.wire_bytes(
            build_request(request_spec(r), tmodels)) == want, i


def test_writer_bytes_serving_batch():
    """``chip_smoke.py``'s serve-20k traffic is ``bench_all``'s
    ``_serving_batch_msg(n, default_rng(11), wide=True)``, byte for
    byte."""
    import bench_all

    n = 96
    msg = bench_all._serving_batch_msg(n, np.random.default_rng(11),
                                       wide=True)
    want = [m.SerializeToString() for m in msg.requests]
    got = [chip_smoke.wire_bytes(r)
           for r in chip_smoke.stress_traffic(n, seed=11)]
    assert got == want


GUARD = r"""
import json, sys
for name in ("jax", "jaxlib", "access_control_srv_tpu", "google",
             "google.protobuf", "grpc"):
    sys.modules[name] = None  # any import of these raises ImportError
import access_control_srv_tpu_torch
import access_control_srv_tpu_torch.native as native
import access_control_srv_tpu_torch.srv.gen
import access_control_srv_tpu_torch.srv.adapters
import access_control_srv_tpu_torch.srv.cache
import access_control_srv_tpu_torch.srv.decision_cache
import access_control_srv_tpu_torch.srv.faults
import access_control_srv_tpu_torch.srv.identity as identity
import access_control_srv_tpu_torch.srv.telemetry
import chip_smoke
from access_control_srv_tpu_torch.ops import compile_policies
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
try:
    import access_control_srv_tpu_torch.srv.gen.access_control_pb2
    raise SystemExit("the pb2 module imported without protobuf")
except ImportError:
    pass
try:
    identity.MockIdentityServer()
    raise SystemExit("the mock server started without grpc")
except ImportError:
    pass
messages = [bytes.fromhex(h) for h in json.loads(sys.argv[1])]
engine = chip_smoke.engine_for("role_scopes.yml")
enc = native.NativeBatchEncoder(
    compile_policies(engine.policy_sets, engine.urns))
batch = enc.encode_wire(messages)
ev = HybridEvaluator(engine, device="cpu")
out, dec, cach, status = ev.is_allowed_batch_wire(messages)
bad = [m for m in sys.modules if sys.modules[m] is not None and (
       m.split(".")[0] in ("jax", "jaxlib", "access_control_srv_tpu",
                           "grpc") or m.startswith("google.protobuf"))]
assert not bad, bad
print(json.dumps({"eligible": batch.eligible.tolist(),
                  "wire_eligible": out.eligible.tolist(),
                  "decision": dec.tolist(), "status": status.tolist()}))
"""


def test_import_guard_and_wire_path_without_protobuf():
    """With ``jax``, the JAX package, ``google.protobuf`` and ``grpc``
    unavailable, the port and every module of this slice import, a
    ``NativeBatchEncoder`` encodes wire bytes and the evaluator's wire
    path runs on the CPU, answering as the JAX evaluator does."""
    import json
    import os
    import subprocess
    import sys

    messages, _ = wire_roundtrip(grid_requests(n=24, seed=4))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", GUARD, json.dumps([m.hex() for m in messages])],
        cwd=repo, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    jev, _ = evaluators("role_scopes.yml")
    batch, dec, _, status = jev.is_allowed_batch_wire(messages)
    assert got["eligible"] == got["wire_eligible"] == batch.eligible.tolist()
    rows = np.flatnonzero(batch.eligible)
    assert [got["decision"][b] for b in rows] == dec[rows].tolist()
    assert [got["status"][b] for b in rows] == status[rows].tolist()
    assert len(rows) > 10
