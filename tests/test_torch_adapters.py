"""The port's resource adapters against the JAX package's.

``srv/adapters.py`` (``GraphQLAdapter`` with its keep-alive pool and retry,
``create_adapter``) is a host-only copy.  On a local HTTP stub, as in
``tests/test_adapter_transport.py``, the port's adapter must send the
request bodies the JAX one sends and return the same results.
``engine.create_resource_adapter`` now builds the port's adapter (before
this module existed in the port it always raised
``UnsupportedResourceAdapter``), the ``adapter.http`` failpoint fires
through the port's registry, and the evaluator's adapter-backed oracle rows
answer as the JAX evaluator's.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import pytest

import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.core import AccessController as JaxController
from access_control_srv_tpu.core import errors as jerrors
from access_control_srv_tpu.core.loader import load_policy_sets as jax_load
from access_control_srv_tpu.srv import adapters as jadapters
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.core import AccessController
from access_control_srv_tpu_torch.core import errors as terrors
from access_control_srv_tpu_torch.core.loader import load_policy_sets
from access_control_srv_tpu_torch.srv import adapters as tadapters
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.faults import REGISTRY

from .test_adapter_transport import GQL_BODY
from .test_token_pipeline import ORG, URNS, WIDGET, cq_tree
from .test_torch_carryover import build_request
from .test_torch_evaluator import response_key


class _Recorder(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    bodies: list = []

    def do_POST(self):
        self.bodies.append(
            self.rfile.read(int(self.headers.get("Content-Length", 0))))
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(GQL_BODY)))
        self.end_headers()
        self.wfile.write(GQL_BODY)

    def log_message(self, *args):
        pass


@pytest.fixture()
def gql_stub():
    handler = type("Handler", (_Recorder,), {"bodies": []})
    server = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{server.server_address[1]}/graphql", handler
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)


CASES = {
    "plain": ([], [], {}),
    "literal filters": ([{"field": "id", "operation": "eq", "value": "r1"},
                         {"field": "name", "value": "x"}], [], {}),
    "resolved from resources": (
        [{"field": "owner", "operation": "in", "value": "$meta.owner.id"},
         {"field": "id", "value": "$id"}],
        [{"id": "res-7", "meta": {"owner": {"id": "org-3"}}}], {}),
    "unresolved reference": ([{"field": "id", "value": "$missing.deep"}],
                             [{"id": "res-7"}], {}),
    "client headers": ([], [], {"headers": {"X-Tenant": "t1"}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphql_adapter_matches_jax(case, gql_stub):
    url, handler = gql_stub
    filters, resources, opts = CASES[case]
    cq = SimpleNamespace(query="query q { all { id } }", filters=filters)
    results = []
    for mod, models in ((jadapters, jmodels), (tadapters, tmodels)):
        adapter = mod.GraphQLAdapter(url, client_opts=dict(opts))
        request = models.Request(
            target=models.Target(subjects=[], resources=[], actions=[]),
            context={"resources": resources})
        try:
            results.append(adapter.query(cq, request))
        finally:
            adapter.close()
    assert results[0] == results[1] == [{"id": "res-1"}]
    assert len(handler.bodies) == 2
    assert handler.bodies[0] == handler.bodies[1]
    sent = json.loads(handler.bodies[1])
    assert sent["query"] == cq.query
    assert [f["field"] for f in sent["variables"].get("filters", [])] == \
        [f["field"] for f in filters]


def test_create_resource_adapter_builds_graphql():
    """The repair: the port's engine builds a ``GraphQLAdapter`` from the
    same config as the JAX engine, with the same transport knobs."""
    config = {"graphql": {"url": "http://127.0.0.1:9/graphql",
                          "clientOpts": {"headers": {"X-A": "1"}},
                          "retry_count": 3},
              "timeout_s": 2.5, "max_concurrency": 5}
    jeng, teng = JaxController(), AccessController()
    jeng.create_resource_adapter(config)
    teng.create_resource_adapter(config)
    assert isinstance(teng.resource_adapter, tadapters.GraphQLAdapter)
    knobs = ("url", "client_opts", "timeout_s", "max_concurrency",
             "retry_transient", "retry_backoff_s", "retry_count")
    assert {k: getattr(teng.resource_adapter, k) for k in knobs} == \
        {k: getattr(jeng.resource_adapter, k) for k in knobs}
    with pytest.raises(terrors.UnsupportedResourceAdapter):
        teng.create_resource_adapter({"rest": {}})
    with pytest.raises(jerrors.UnsupportedResourceAdapter):
        jeng.create_resource_adapter({"rest": {}})


def test_adapter_http_failpoint_fires_through_port_registry(gql_stub):
    url, handler = gql_stub
    adapter = tadapters.GraphQLAdapter(url, retry_count=1,
                                       retry_backoff_s=0.0)
    cq = SimpleNamespace(query="q", filters=[])
    request = tmodels.Request(target=tmodels.Target(), context={})
    try:
        with REGISTRY.arm([{"site": "adapter.http", "action": "error"}]):
            with pytest.raises(terrors.ContextQueryTransportError) as err:
                adapter.query(cq, request)
            assert REGISTRY.hits("adapter.http") == 2  # first try + retry
        assert err.value.code == 599
        assert handler.bodies == []  # the transport was never reached
        assert adapter.query(cq, request) == [{"id": "res-1"}]
    finally:
        adapter.close()


def cq_spec(i: int) -> dict:
    """Every other row reads a WIDGET, the context-query rule's entity."""
    role = f"role-{i % 6}"

    def attr(key, value):
        return {"id": URNS[key], "value": value, "attributes": []}

    return {
        "target": {
            "subjects": [attr("role", role), attr("subjectID", f"u{i}")],
            "resources": [attr("entity", WIDGET if i % 2 else ORG),
                          attr("resourceID", f"res-{i}")],
            "actions": [attr("actionID", URNS["read"])]},
        "context": {"resources": [], "subject": {
            "id": f"u{i}", "hierarchical_scopes": [],
            "role_associations": [{"role": role, "attributes": []}]}},
    }


def test_adapter_backed_oracle_rows_match_jax(gql_stub):
    """Context-query rows a later rule could observe go to the oracle,
    which fans their walks out over the adapter's concurrency bound:
    the port's responses and the stub's request bodies equal the JAX
    evaluator's."""
    url, handler = gql_stub
    doc = cq_tree(with_later_reader=True)
    config = {"graphql": {"url": url}, "max_concurrency": 4}
    specs = [cq_spec(i) for i in range(24)]
    out = []
    for controller, load, evaluator, models, kw in (
            (JaxController, jax_load, JaxEvaluator, jmodels,
             {"delta_enabled": False}),
            (AccessController, load_policy_sets, HybridEvaluator, tmodels,
             {"device": "cpu"})):
        engine = controller()
        for ps in load(json.loads(json.dumps(doc))):
            engine.update_policy_set(ps)
        engine.create_resource_adapter(config)
        ev = evaluator(engine, **kw)
        handler.bodies.clear()
        try:
            responses = ev.is_allowed_batch(
                [build_request(s, models) for s in specs])
        finally:
            engine.resource_adapter.close()
        out.append(([response_key(r) for r in responses],
                    sorted(handler.bodies)))
    assert out[1] == out[0]
    assert len(out[1][1]) >= 12  # the WIDGET rows queried the stub
