"""The port's pod layouts through the Worker against the JAX Worker's:
``pod_shards: 4`` and ``pod_shards: 2, data_devices: 2`` (the cases of
``tests/torch_mesh_world.py``, one four-rank world per layout), then the
failure cases, which share a world of four ranks whose layout takes two:
the idle ranks run nothing, and a killed follower makes rank 0 answer
the degraded envelope and report NOT_SERVING; and a follower whose
build outlasts the control group's timeout, in a world of two."""

import json
import time

import pytest

from access_control_srv_tpu.srv import Worker as JaxWorker
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu.srv.transport_grpc import GrpcServer as JaxServer
from access_control_srv_tpu_torch.parallel.cluster import launch_local

from .torch_mesh_world import (  # noqa: F401 — the shared cases, collected here
    PortWorld,
    command,
    layout_pair,
    test_is_allowed_batch_bytes,
    test_layout_and_identity,
    test_recompile_under_traffic,
    test_rule_flip_through_update,
    test_what_is_allowed_batch_bytes,
    tree_cfg,
)
from .torch_serving import AC, Side, batch_bytes, seed_cfg, traffic
from .torch_world import SLOW_BUILD_S, SLOW_GROUP_TIMEOUT_S

LAYOUTS = {
    "pod4": {"pod_shards": 4},
    "pod2x2": {"pod_shards": 2, "data_devices": 2},
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def pair(request, tree_cfg, tmp_path_factory):
    rig = layout_pair(request, tree_cfg, tmp_path_factory, LAYOUTS)
    yield rig
    rig.close()


# -------------------------------------------------------- failure cases


@pytest.fixture(scope="module")
def small_world(tmp_path_factory):
    """Four ranks under ``data_devices: 2``: ranks 2 and 3 are outside
    the mesh."""
    cfg = seed_cfg(parallel={"data_devices": 2})
    port = PortWorld(cfg, str(tmp_path_factory.mktemp("small"))).start()
    yield port
    port.close()


def test_layout_smaller_than_world(small_world):
    """JAX's clamp on a world of 4: a mesh of the first 2 ranks, whose
    answers equal the JAX worker's at ``data_devices: 2``; the ranks
    outside it run no kernel and stay up."""
    jw = JaxWorker().start(seed_cfg(parallel={"data_devices": 2}))
    jax_side = Side(jw, JaxServer(jw, "127.0.0.1:0").start())
    try:
        payload = batch_bytes(traffic(40, seed=17))
        assert small_world.call(AC + "IsAllowedBatch", payload) == \
            jax_side.call(AC + "IsAllowedBatch", payload)
    finally:
        jax_side.close()
    ident = command(small_world, "program_identity")
    assert ident["mesh"]["shape"] == {"data": 2}
    assert len(set(ident["mesh"]["table_fingerprints"])) == 1
    assert len(ident["mesh"]["table_fingerprints"]) == 2
    launches = command(small_world, "kernel_launches")
    assert len(launches["by_rank"]) == 2
    assert all(r["collectives"]["all_gather"] >= 1
               for r in launches["by_rank"])
    assert all(p.poll() is None for p in small_world.world.procs)


def test_killed_follower_answers_degraded(small_world):
    """A follower killed mid-service: rank 0's next batch answers every
    row with the degraded envelope (INDETERMINATE, 503) within a bound,
    rank 0's health check turns NOT_SERVING (for good: a second batch is
    degraded too), and the world still stops."""
    assert command(small_world, "health_check")["status"] == "SERVING"
    small_world.world.kill(1)
    payload = batch_bytes(traffic(16, seed=19))
    t0 = time.monotonic()
    resp = pb.BatchResponse.FromString(
        small_world.call(AC + "IsAllowedBatch", payload, timeout=30.0))
    assert time.monotonic() - t0 < 30.0
    assert {(r.decision, r.operation_status.code)
            for r in resp.responses} == {(pb.INDETERMINATE, 503)}
    paths = command(small_world, "metrics")["paths"]
    assert paths.get("device-error-degraded", 0) >= 16
    health = command(small_world, "health_check")
    assert health["status"] == "NOT_SERVING"
    assert health["follower_channel"].startswith("lost: ")
    again = pb.BatchResponse.FromString(
        small_world.call(AC + "IsAllowedBatch", payload, timeout=30.0))
    assert {r.operation_status.code for r in again.responses} == {503}
    assert command(small_world, "health_check")["status"] == "NOT_SERVING"


def test_slow_follower_build_keeps_the_channel(tmp_path):
    """A follower whose build outlasts the control group's timeout: rank
    0 waits for it through polls that are each answered at once, then
    publishes; the channel is not lost, and the follower serves the same
    tables as a single-device evaluator on the tree."""
    out = tmp_path / "slow.json"
    launch_local(2, "tests.torch_world:slow_follower_build", (str(out),),
                 timeout_s=120)
    got = json.loads(out.read_text())
    assert got["built"] is True and got["lost"].startswith("None")
    assert got["waited_s"] >= SLOW_BUILD_S > SLOW_GROUP_TIMEOUT_S
    assert got["longest_poll_s"] < SLOW_GROUP_TIMEOUT_S
    assert got["theirs"] == [got["own"]]
