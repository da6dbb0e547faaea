"""The port's data-parallel kernels against the JAX package's.

``parallel.mesh.ShardedDecisionKernel`` (K6) decides each rank's row slice
with ``decide_dense`` and all-gathers the outputs over ``data``;
``PrefilteredKernel(mesh=...)`` delegates to it below ``MIN_RULES`` and
above shards K4's rows and K3's slots over ``data``.  The ranks are a
4-rank gloo world on the CPU (``tests/torch_world.py``, plain versions of
the kernels); the JAX kernels run on the conftest's virtual CPU devices
over a 4-device ``data`` mesh.  Decision, cacheable and status must be
equal on the eligible rows (tolerance 0) and every rank must hold the
whole batch.  The trees: the fixture trees on grid traffic, the
550-rule relation tree (above ``MIN_RULES``: the signature path, and with
an ACL row the per-row path), and ``HybridEvaluator(mesh=...)``.

Single-process pieces: the mesh without a process group, ``pad_batch``,
``shard_bucket``, the cluster hook, and the local launcher failing the
world when a rank raises.
"""

import numpy as np
import pytest
from jax.sharding import Mesh

from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import PrefilteredKernel as JaxPrefiltered
from access_control_srv_tpu.ops import compile_policies as jcompile
from access_control_srv_tpu.parallel.mesh import (
    ShardedDecisionKernel as JaxSharded,
)
from access_control_srv_tpu.parallel.mesh import pad_batch as jax_pad_batch
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.parallel import (
    launch_local,
    make_mesh,
    make_mesh2,
    maybe_initialize_distributed,
    pad_batch,
)
from access_control_srv_tpu_torch.parallel.mesh import shard_bucket

from .test_torch_carryover import build_request, spec_grid
from .test_torch_evaluator import response_key
from .test_torch_relations import (
    ORG,
    rel_specs,
    rel_stress_doc,
    rel_stress_specs,
    stress_store_ops,
)
from .test_torch_rule_shard import assert_world_equal, jax_tree
from .torch_world import run_world

FIXTURES = ["role_scopes.yml", "props_multi_rules_entities.yml",
            "conditions.yml", "acl_policies.yml"]


def jax_data_mesh(n: int) -> Mesh:
    import jax

    return Mesh(np.array(jax.devices()[:n]), ("data",))


class JaxK6:
    """JAX's ShardedDecisionKernel on a 1-axis mesh of the layout's data
    size (the shape ``assert_world_equal`` builds kernels by)."""

    def __init__(self, compiled, mesh2):
        self.k = JaxSharded(compiled, jax_data_mesh(mesh2.shape["data"]))

    def evaluate(self, batch):
        return self.k.evaluate(batch)


class JaxPrefilteredMesh(JaxK6):
    def __init__(self, compiled, mesh2):
        self.k = JaxPrefiltered(compiled,
                                mesh=jax_data_mesh(mesh2.shape["data"]))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    specs = spec_grid(n=96, seed=53)
    cases = [{"id": name, "kind": "k6", "tree": {"fixture": name},
              "specs": specs, "layouts": [(4, 1)]} for name in FIXTURES]
    cases.append({"id": "small-prefilter", "kind": "prefilter",
                  "tree": {"fixture": "role_scopes.yml"}, "specs": specs,
                  "layouts": [(4, 1)]})
    doc, entities, actions = rel_stress_doc(False)
    ops = stress_store_ops(entities)
    sig = rel_stress_specs(entities, actions, 40, 5, False)
    acl = rel_specs(["alice"], ["doc1"], acl_indicatory_entity=ORG,
                    acl_instances=["Org1"])
    cases.append({"id": "large-sig", "kind": "prefilter",
                  "tree": {"doc": doc}, "specs": sig, "store_ops": ops,
                  "layouts": [(4, 1)]})
    cases.append({"id": "large-rows", "kind": "prefilter",
                  "tree": {"doc": doc}, "specs": sig + acl,
                  "store_ops": ops, "layouts": [(4, 1)]})
    cases.append({"id": "evaluator", "kind": "evaluator",
                  "tree": {"fixture": "role_scopes.yml"},
                  "specs": spec_grid(n=64, seed=21), "layouts": [(4, 1)]})
    return cases, run_world(tmp_path_factory.mktemp("mesh4"), 4, cases)[0]


@pytest.mark.parametrize("name", FIXTURES)
def test_sharded_dense_kernel(world4, name):
    cases, results = world4
    case = next(c for c in cases if c["id"] == name)
    got, _, _ = assert_world_equal(JaxK6, results, case, (4, 1))
    assert got["collectives"] == {"all_reduce": 0, "all_gather": 1,
                                  "bytes": 3 * 4 * shard_bucket(96, 4)}


def test_prefiltered_below_min_rules_delegates(world4):
    cases, results = world4
    case = next(c for c in cases if c["id"] == "small-prefilter")
    assert_world_equal(JaxPrefilteredMesh, results, case, (4, 1))


@pytest.mark.parametrize("case_id", ["large-sig", "large-rows"])
def test_prefiltered_above_min_rules(world4, case_id):
    """550 relation rules: K3's slots over ``data`` (one SUM of the
    request-order outputs), or with an ACL row K4's rows (one gather)."""
    cases, results = world4
    case = next(c for c in cases if c["id"] == case_id)
    got, _, el = assert_world_equal(JaxPrefilteredMesh, results, case,
                                    (4, 1))
    assert el.sum() >= len(case["specs"]) - 1
    if case_id == "large-sig":
        assert got["collectives"]["all_reduce"] == 1
        assert got["collectives"]["all_gather"] == 0
    else:
        assert got["collectives"]["all_reduce"] == 0
        assert got["collectives"]["all_gather"] == 1


def test_evaluator_mesh(world4):
    cases, results = world4
    case = next(c for c in cases if c["id"] == "evaluator")
    got = results[("evaluator", (4, 1))]
    assert got["kernel"] == "PrefilteredKernel"
    jev = JaxEvaluator(jax_tree(case["tree"]), delta_enabled=False,
                       mesh=jax_data_mesh(4))
    want = jev.is_allowed_batch([build_request(s, jmodels)
                                 for s in case["specs"]])
    assert got["responses"] == [response_key(w) for w in want]


def test_mesh_without_process_group():
    """A process without a process group is a 1-rank mesh: no groups,
    collectives are the identity; a larger layout is refused."""
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0}
    assert mesh.groups == {"data": None} and mesh.backend is None
    m2 = make_mesh2(1, 1, device="cpu")
    assert m2.axis_names == ("data", "model")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh2(2, 2, device="cpu")


def test_pad_batch_and_bucket():
    rng = np.random.default_rng(3)
    arrays = {"a": rng.integers(0, 9, (5, 3)).astype(np.int32),
              "b": rng.integers(0, 2, (5,)).astype(bool)}
    for multiple in (1, 2, 4, 8):
        want, wb = jax_pad_batch(arrays, 5, multiple)
        got, gb = pad_batch(arrays, 5, multiple)
        assert gb == wb
        for k in arrays:
            assert got[k].tobytes() == want[k].tobytes()
    assert [shard_bucket(b, 4) for b in (1, 9, 96, 100)] == [32, 32, 128,
                                                             128]


def test_cluster_hook_off():
    assert not maybe_initialize_distributed({})
    assert not maybe_initialize_distributed(
        {"cluster": {"distributed": {"enabled": False}}})


def test_launcher_fails_when_a_rank_raises():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        launch_local(2, "tests.torch_world:fail_on_rank_one",
                     timeout_s=120)
