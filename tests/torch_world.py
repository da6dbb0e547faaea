"""Rank programs of the port's multi-device tests (never imports JAX).

The tests start an N-rank gloo world on the CPU with the port's
``parallel.cluster.launch_local`` and run ``run_job`` in every rank.  A job
is a pickle the test writes: a list of cases, each a tree (a fixture file
name or a policy-set document), request specs (``test_torch_carryover.
request_spec``), optional relation-store operations, the kernel to run
(with its keyword arguments, e.g. ``explain``) and its mesh layouts; or, for ``patch`` cases, compiled arrays made by the JAX
package's delta patcher.  Each rank builds the engine, the compile and the
batch with the port's own code and runs the port's kernel at every layout;
every rank writes its outputs (``<out>.<rank>``), so the test checks both
the outputs against the JAX kernels and that every rank holds the whole
batch.
"""

from __future__ import annotations

import copy
import os
import pickle

import numpy as np

from access_control_srv_tpu_torch import core as tcore
from access_control_srv_tpu_torch import models as tmodels
from access_control_srv_tpu_torch.ops import (
    PrefilteredKernel,
    compile_policies,
    encode_requests,
)
from access_control_srv_tpu_torch.ops import cuda_build
from access_control_srv_tpu_torch.ops.compile import CompiledPolicies
from access_control_srv_tpu_torch.ops.encode import RequestBatch
from access_control_srv_tpu_torch.parallel import (
    PodShardedKernel,
    RuleShardedKernel,
    ShardedDecisionKernel,
    make_mesh2,
)
from access_control_srv_tpu_torch.parallel import mesh as tmesh
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
from access_control_srv_tpu_torch.srv.relations import RelationTupleStore

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = os.path.join(os.path.dirname(HERE), "data", "seed_data")


def build_request(spec: dict):
    """A port request from a spec (``test_torch_carryover.request_spec``)."""
    def attr(s):
        return tmodels.Attribute(id=s["id"], value=s["value"],
                                 attributes=[attr(a) for a in s["attributes"]])

    t = spec["target"]
    target = None if t is None else tmodels.Target(
        **{side: [attr(a) for a in t[side]] for side in t})
    return tmodels.Request(target=target,
                           context=copy.deepcopy(spec["context"]))


def port_engine(tree: dict) -> tcore.AccessController:
    """The port's engine on ``{"fixture": name}`` (a tests/fixtures file,
    or "seed_data") or ``{"doc": policy-set document}``."""
    if "doc" in tree:
        sets = tcore.load_policy_sets(tree["doc"])
    elif tree["fixture"] == "seed_data":
        sets = tcore.load_seed_files(
            os.path.join(SEED, "policy_sets.yaml"),
            os.path.join(SEED, "policies.yaml"),
            os.path.join(SEED, "rules.yaml"))
    else:
        sets = tcore.load_policy_sets_from_file(
            os.path.join(HERE, "fixtures", tree["fixture"]))
    engine = tcore.AccessController()
    for ps in sets:
        engine.update_policy_set(ps)
    return engine


def port_store(ops) -> RelationTupleStore:
    store = RelationTupleStore()
    for name, *args in ops:
        getattr(store, name)(*args)
    return store


def compiled_from(d: dict) -> CompiledPolicies:
    """A compile carried as arrays (the kernels read only these)."""
    return CompiledPolicies(
        interner=None, urns=None, arrays=d["arrays"], conditions=[],
        entity_vocab=[], entity_vocab_ids={}, S=d["S"], KP=d["KP"],
        KR=d["KR"], T=d["T"])


def batch_from(d: dict) -> RequestBatch:
    return RequestBatch(**d)


def _kernel(kind: str, compiled, mesh, **kw):
    if kind == "k6":
        return ShardedDecisionKernel(compiled, mesh, **kw)
    if kind == "k7":
        return RuleShardedKernel(compiled, mesh, **kw)
    if kind == "k8":
        return PodShardedKernel(compiled, mesh, **kw)
    return PrefilteredKernel(compiled, mesh=mesh, **kw)


def explain_key(resp):
    """A response's provenance: ``_rule_id`` and ``_explain``."""
    return (getattr(resp, "_rule_id", None), getattr(resp, "_explain", None))


def response_key(resp):
    """As ``test_torch_evaluator.response_key``."""
    st = resp.operation_status
    return (resp.decision, resp.evaluation_cacheable, st.code, st.message,
            [o.to_dict() for o in resp.obligations or []])


def _patch_case(case, mesh) -> dict:
    """K8's shard-local patch on JAX-made compiles: identities before and
    after, which shards' host and device tables were reused, the patched
    kernel's outputs, and the libraries built meanwhile."""
    k0 = PodShardedKernel(compiled_from(case["c0"]), mesh)
    builds = dict(cuda_build.BUILD_LOG)
    k1 = k0.patched(compiled_from(case["c1"]), case["slots"])
    out = k1.evaluate(batch_from(case["batch"]))
    return {
        "identity0": k0.shard_identity(),
        "identity1": k1.shard_identity(),
        "reused": [a is b for a, b in zip(k0.shards, k1.shards)],
        "device_reused": k1._c is k0._c,
        "new_builds": sorted(set(cuda_build.BUILD_LOG) - set(builds)),
        "out": tuple(np.asarray(o) for o in out),
    }


def fail_on_rank_one(rank: int, world: int) -> None:
    """A rank program that raises on rank 1 (the launcher's failure
    test)."""
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")


def run_job(rank: int, world: int, job_path: str) -> None:
    # a world's ranks yield the host's cores to the test processes that
    # run beside them (some of those measure wall-clock pauses)
    os.nice(10)
    with open(job_path, "rb") as fh:
        job = pickle.load(fh)
    meshes = {}

    def mesh(layout):
        # every rank creates the same groups in the same order
        if layout not in meshes:
            meshes[layout] = make_mesh2(*layout, device="cpu")
        return meshes[layout]

    results = {}
    for case in job["cases"]:
        for layout in case["layouts"]:
            layout = tuple(layout)
            key = (case["id"], layout)
            if case["kind"] == "patch":
                results[key] = _patch_case(case, mesh(layout))
                continue
            engine = port_engine(case["tree"])
            store = None
            if case.get("store_ops"):
                store = port_store(case["store_ops"])
            if case["kind"] == "evaluator":
                ev = HybridEvaluator(engine, mesh=mesh(layout),
                                     **case.get("ev_kw", {}))
                if store is not None:
                    ev.attach_relation_store(store)
                reqs = [build_request(s) for s in case["specs"]]
                responses = ev.is_allowed_batch(reqs)
                results[key] = {
                    "responses": [response_key(r) for r in responses],
                    "explain": [explain_key(r) for r in responses],
                    "kernel": type(ev._kernel).__name__,
                    "identity": ev.shard_identity(),
                }
                continue
            compiled = compile_policies(engine.policy_sets, engine.urns)
            tables = None if store is None else store.tables_for(compiled)
            batch = encode_requests(
                [build_request(s) for s in case["specs"]], compiled,
                relation_tables=tables)
            before = dict(tmesh.COLLECTIVES)
            out = _kernel(case["kind"], compiled, mesh(layout),
                          **case.get("kernel_kw", {})).evaluate(batch)
            results[key] = {
                "out": tuple(np.asarray(o) for o in out),
                "eligible": np.asarray(batch.eligible),
                "collectives": {k: tmesh.COLLECTIVES[k] - before[k]
                                for k in before},
            }
    with open(f"{job['out']}.{rank}", "wb") as fh:
        pickle.dump(results, fh)


def run_world(tmp_dir, world: int, cases: list, timeout_s: float = 300.0
              ) -> list:
    """Run ``cases`` in a ``world``-rank gloo world on the CPU; returns
    every rank's results after checking that each rank's outputs and
    responses equal rank 0's (every rank holds the whole batch)."""
    from access_control_srv_tpu_torch.parallel import launch_local

    job = os.path.join(str(tmp_dir), f"job{world}.pkl")
    out = os.path.join(str(tmp_dir), f"out{world}")
    with open(job, "wb") as fh:
        pickle.dump({"cases": cases, "out": out}, fh)
    launch_local(world, "tests.torch_world:run_job", (job,),
                 timeout_s=timeout_s)
    ranks = []
    for rank in range(world):
        with open(f"{out}.{rank}", "rb") as fh:
            ranks.append(pickle.load(fh))
    for rank, res in enumerate(ranks[1:], 1):
        assert sorted(res) == sorted(ranks[0]), rank
        for key, want in ranks[0].items():
            got = res[key]
            if "out" in want:
                for w, g in zip(want["out"], got["out"]):
                    assert np.array_equal(w, g), (rank, key)
            if "responses" in want:
                assert got["responses"] == want["responses"], (rank, key)
                assert got["explain"] == want["explain"], (rank, key)
    return ranks


# the slow follower's build, and its control group's timeout: the build
# outlasts the timeout, which a blocking wait on it would trip
SLOW_BUILD_S = 4.0
SLOW_GROUP_TIMEOUT_S = 2.0


def slow_follower_build(rank: int, world: int, out: str) -> None:
    """Rank 0's ``Leader`` and rank 1's ``Follower`` over a 2-rank
    ``data_devices`` mesh, the control group's timeout cut to
    ``SLOW_GROUP_TIMEOUT_S`` and rank 1's tree build slowed past it.
    Rank 0 sends the seed tree, waits until rank 1 has built it, publishes
    it, reads rank 1's table fingerprint and stops it; it writes (JSON)
    whether the wait succeeded, how long it took, the longest single
    poll, the channel's state and both fingerprints."""
    import json
    import time

    from access_control_srv_tpu_torch.srv import follower as fmod
    from access_control_srv_tpu_torch.srv.config import Config
    from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator
    from access_control_srv_tpu_torch.srv.worker import build_mesh, mesh_layout

    fmod.DIST_TIMEOUT_S = SLOW_GROUP_TIMEOUT_S
    fmod.HEARTBEAT_S = SLOW_GROUP_TIMEOUT_S / 8
    cfg = Config({"parallel": {"data_devices": 2}})
    if rank == 1:
        build = fmod.Follower._build_tree

        def slow(self, *args):
            time.sleep(SLOW_BUILD_S)
            return build(self, *args)

        fmod.Follower._build_tree = slow
        fmod.Follower(cfg, "cpu").run()
        return
    leader = fmod.Leader(build_mesh(mesh_layout(cfg), "cpu"))
    engine = port_engine({"fixture": "seed_data"})
    polls = []
    query = leader.query

    def timed_query(name, **args):
        t0 = time.monotonic()
        try:
            return query(name, **args)
        finally:
            polls.append(time.monotonic() - t0)

    leader.query = timed_query
    t0 = time.monotonic()
    gen = leader.build("tree", pickle.dumps(engine.policy_sets), 1, None, 0)
    built = leader.await_built(gen)
    waited = time.monotonic() - t0
    leader.publish(gen, None)
    theirs = leader.query("fingerprint")
    lost = repr(leader.lost)
    leader.stop()
    own = HybridEvaluator(engine, device="cpu")._tables_digest(
        relations=False)
    with open(out, "w") as fh:
        json.dump({"built": built, "waited_s": waited,
                   "longest_poll_s": max(polls), "lost": lost,
                   "theirs": theirs, "own": own}, fh)
