"""The port's host carry-over against the JAX package.

The port (``access_control_srv_tpu_torch``) keeps its own copies of the
data model, the oracle, the compiler and the encoder.  These tests hold
the copies byte-equal to the reference on every fixture tree, the seed
data and the 511-rule scoped tree, and check that the port imports with
``jax`` and the reference package both unavailable.

The two packages have their own ``Request`` classes, so every request is
built from one dict spec in both (``request_spec`` / ``build_request``).
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest

import access_control_srv_tpu_torch.core as tcore
import access_control_srv_tpu_torch.models as tmodels
from access_control_srv_tpu import core as jcore
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.ops import encode_requests as jencode
from access_control_srv_tpu_torch.ops import compile_policies as tcompile
from access_control_srv_tpu_torch.ops import encode_requests as tencode

from .test_kernel_differential import grid_requests
from .utils import fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "access_control_srv_tpu_torch")

FIXTURE_TREES = [
    "basic_policies.yml", "policy_targets.yml", "policy_set_targets.yml",
    "role_scopes.yml", "hr_disabled.yml", "conditions.yml",
    "acl_policies.yml", "props_single.yml", "props_rules_noprop.yml",
    "props_multi_rules.yml", "props_multi_rules_entities.yml",
    "ops_multi.yml", "default_policies.yml", "relation_policies.yml",
]
ALL_TREES = FIXTURE_TREES + ["seed_data", "scoped_511"]


# ------------------------------------------------------------ shared helpers


def _attr_spec(attr) -> dict:
    return {"id": attr.id, "value": attr.value,
            "attributes": [_attr_spec(a) for a in attr.attributes]}


def request_spec(request) -> dict:
    """One package-neutral dict spec of a request (target attributes with
    their values as they are, context deep-copied)."""
    target = request.target
    return {
        "target": None if target is None else {
            side: [_attr_spec(a) for a in getattr(target, side)]
            for side in ("subjects", "resources", "actions")
        },
        "context": copy.deepcopy(request.context),
    }


def build_request(spec: dict, models):
    """A request of ``models`` (either package's data model) from a spec."""
    def attr(s):
        return models.Attribute(id=s["id"], value=s["value"],
                                attributes=[attr(a) for a in s["attributes"]])

    t = spec["target"]
    target = None if t is None else models.Target(
        **{side: [attr(a) for a in t[side]] for side in t}
    )
    return models.Request(target=target,
                          context=copy.deepcopy(spec["context"]))


def tree_doc(name: str):
    """Nested policy-set document of a named test tree, or None for the
    fixture files (loaded through the loaders)."""
    if name == "scoped_511":
        import chip_smoke

        return chip_smoke.stress_doc(511, scoped=True)
    return None


def make_engines(name: str):
    """(JAX engine, port engine) holding the same tree."""
    engines = []
    for core in (jcore, tcore):
        engine = core.AccessController()
        doc = tree_doc(name)
        if doc is not None:
            sets = core.load_policy_sets(doc)
        elif name == "seed_data":
            seed = os.path.join(REPO, "data", "seed_data")
            sets = core.load_seed_files(
                os.path.join(seed, "policy_sets.yaml"),
                os.path.join(seed, "policies.yaml"),
                os.path.join(seed, "rules.yaml"),
            )
        else:
            sets = core.load_policy_sets_from_file(fixture(name))
        for ps in sets:
            engine.update_policy_set(ps)
        engines.append(engine)
    return engines


def spec_grid(n=None, seed=7) -> list[dict]:
    return [request_spec(r) for r in grid_requests(n=n, seed=seed)]


def assert_arrays_equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert x.tobytes() == y.tobytes(), (what, k)


# ------------------------------------------------------------------ imports


def test_port_imports_with_jax_and_reference_blocked():
    code = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "access_control_srv_tpu"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Refuse())
import access_control_srv_tpu_torch
import access_control_srv_tpu_torch.ops
import access_control_srv_tpu_torch.ops.kernel
import access_control_srv_tpu_torch.ops.cuda_build
import access_control_srv_tpu_torch.srv.evaluator
import access_control_srv_tpu_torch.ops.reverse
import access_control_srv_tpu_torch.ops.reverse_ref
import access_control_srv_tpu_torch.ops.lattice
import access_control_srv_tpu_torch.core.candidate_index
import access_control_srv_tpu_torch.srv.audit_sweep
import access_control_srv_tpu_torch.srv.events
import access_control_srv_tpu_torch.srv.relations
import access_control_srv_tpu_torch.parallel
import access_control_srv_tpu_torch.parallel.cluster
import access_control_srv_tpu_torch.parallel.mesh
import access_control_srv_tpu_torch.parallel.pod_shard
import access_control_srv_tpu_torch.parallel.rule_shard
import access_control_srv_tpu_torch.ops.shard_ref
import access_control_srv_tpu_torch.ops.delta
import access_control_srv_tpu_torch.srv
import access_control_srv_tpu_torch.srv.clock
import access_control_srv_tpu_torch.srv.config
import access_control_srv_tpu_torch.srv.telemetry
import access_control_srv_tpu_torch.srv.tracing
import access_control_srv_tpu_torch.srv.admission
import access_control_srv_tpu_torch.srv.watchdog
import access_control_srv_tpu_torch.srv.store
import access_control_srv_tpu_torch.srv.service
import access_control_srv_tpu_torch.srv.batcher
import access_control_srv_tpu_torch.srv.command
import access_control_srv_tpu_torch.srv.pipeline
import access_control_srv_tpu_torch.srv.transport_grpc
import access_control_srv_tpu_torch.srv.transport_rc
import access_control_srv_tpu_torch.srv.worker
import access_control_srv_tpu_torch.srv.gen.rc.health_pb2
import access_control_srv_tpu_torch.__main__
import access_control_srv_tpu_torch.healthcheck
import tests.torch_world
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "access_control_srv_tpu")]
assert not bad, bad
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_reference_import_lines():
    pattern = re.compile(
        r"^\s*(import|from) (jax|access_control_srv_tpu)(\.|\s|$)", re.M
    )
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tests", "torch_world.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    assert {os.path.join(PORT, "srv", n) for n in ("events.py", "relations.py")
            } <= set(files)
    assert {os.path.join(PORT, "parallel", n) for n in (
        "__init__.py", "cluster.py", "mesh.py", "pod_shard.py",
        "rule_shard.py")} <= set(files)
    assert os.path.join(PORT, "ops", "shard_ref.py") in files
    # the serving shell
    assert {os.path.join(PORT, "srv", n + ".py") for n in (
        "clock", "config", "telemetry", "tracing", "admission", "watchdog",
        "store", "service", "batcher", "command", "pipeline",
        "transport_grpc", "transport_rc", "worker")} <= set(files)
    assert {os.path.join(PORT, n) for n in ("__main__.py", "healthcheck.py")
            } <= set(files)
    assert os.path.join(PORT, "srv", "gen", "rc", "health_pb2.py") in files
    for path in files:
        with open(path) as fh:
            assert not pattern.search(fh.read()), path


def test_scoped_tree_matches_bench_generator():
    """chip_smoke's copy of the 511-rule scoped generator builds the same
    document as bench_all._stress_doc."""
    import bench_all
    import chip_smoke

    assert chip_smoke.stress_doc(511, scoped=True) == \
        bench_all._stress_doc(511, scoped=True)[0]


# ----------------------------------------------------------------- compiler


@pytest.mark.parametrize("name", ALL_TREES)
def test_compile_byte_equal(name):
    jeng, teng = make_engines(name)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    assert (jc.supported, jc.unsupported_reason) == \
        (tc.supported, tc.unsupported_reason)
    assert (jc.S, jc.KP, jc.KR, jc.T) == (tc.S, tc.KP, tc.KR, tc.T)
    assert jc.entity_vocab == tc.entity_vocab
    assert jc.rel_vocab == tc.rel_vocab
    assert [(c.rule_flat_index, c.condition) for c in jc.conditions] == \
        [(c.rule_flat_index, c.condition) for c in tc.conditions]
    assert_arrays_equal(jc.arrays, tc.arrays, name)


# ------------------------------------------------------------------ encoder


@pytest.mark.parametrize("name", FIXTURE_TREES + ["seed_data"])
def test_encode_byte_equal(name):
    jeng, teng = make_engines(name)
    jc = jcompile(jeng.policy_sets, jeng.urns)
    tc = tcompile(teng.policy_sets, teng.urns)
    specs = spec_grid()
    jb = jencode([build_request(s, jmodels) for s in specs], jc)
    tb = tencode([build_request(s, tmodels) for s in specs], tc)
    assert_arrays_equal(jb.arrays, tb.arrays, name)
    for k in ("rgx_set", "pfx_neq", "cond_true", "cond_abort", "cond_code",
              "eligible"):
        assert_arrays_equal({k: getattr(jb, k)}, {k: getattr(tb, k)}, name)
    assert jb.ineligible_reasons == tb.ineligible_reasons
    assert jb.cond_msg == tb.cond_msg
    assert jb.eligible.sum() > 0
