"""The port's mesh layouts through the Worker against the JAX Worker's:
``data_devices: 4`` and ``model_devices: 2, data_devices: 2`` (the cases
of ``tests/torch_mesh_world.py``, one four-rank world per layout), and
the layout validations' texts against JAX's, which need no world.
``tests/test_torch_mesh_worker_pod.py`` holds the pod layouts and the
failure cases."""

import copy

import jax
import pytest

from access_control_srv_tpu.srv import Worker as JaxWorker
from access_control_srv_tpu_torch.parallel import cluster
from access_control_srv_tpu_torch.srv.config import Config
from access_control_srv_tpu_torch.srv.worker import Worker, mesh_layout

from .torch_mesh_world import (  # noqa: F401 — the shared cases, collected here
    layout_pair,
    test_is_allowed_batch_bytes,
    test_layout_and_identity,
    test_recompile_under_traffic,
    test_rule_flip_through_update,
    test_what_is_allowed_batch_bytes,
    tree_cfg,
)
from .torch_serving import seed_cfg

LAYOUTS = {
    "data4": {"data_devices": 4},
    "model2x2": {"model_devices": 2, "data_devices": 2},
}


@pytest.fixture(scope="module", params=list(LAYOUTS))
def pair(request, tree_cfg, tmp_path_factory):
    rig = layout_pair(request, tree_cfg, tmp_path_factory, LAYOUTS)
    yield rig
    rig.close()


# ------------------------------------------------------------ validation


@pytest.mark.parametrize("block", [
    {"data_devices": "all"}, {"data_devices": "-1"}, {"data_devices": -1},
    {"data_devices": "auto"}, {"data_devices": -2}, {"data_devices": 0},
    {"data_devices": "2.5"}, {"model_devices": "all"},
    {"pod_shards": -1}, {"pod_shards": 2, "model_devices": 2},
])
def test_layout_validation_like_jax(block):
    """The port's reading of a ``parallel`` block without a process
    group: JAX's error text where JAX refuses it, else the JAX layout
    clamped to a world of 1."""
    cfg = seed_cfg(parallel=block)
    try:
        jw = JaxWorker().start(copy.deepcopy(cfg))
    except ValueError as err:
        want = str(err)
    else:
        want = None
        jax_mesh = jw.mesh
        jw.stop()
    if want is not None:
        with pytest.raises(ValueError) as got:
            mesh_layout(Config(cfg))
        assert str(got.value) == want
        worker = Worker()
        with pytest.raises(ValueError) as got:
            worker.start(cfg, device="cpu")
        assert str(got.value) == want
        assert worker.evaluator is None and worker.batcher is None
        return
    layout = mesh_layout(Config(cfg))
    assert (layout is None) == (jax_mesh is None), layout
    if layout is not None:
        assert jax_mesh.devices.size == len(jax.devices())
        assert layout["n_data"] == 1 and layout["available"] == 1




# ------------------------------------------------------- process bring-up


@pytest.mark.parametrize("device,cards,local_world,backend", [
    ("cpu", 1, None, "gloo"),
    (None, 1, None, "gloo"),      # four ranks on one card
    ("cuda", 2, "4", "gloo"),     # LOCAL_WORLD_SIZE ranks on this host
    (None, 4, None, "nccl"),      # a card per rank
    ("cuda", 8, "4", "nccl"),
])
def test_distributed_backend_rule(monkeypatch, device, cards, local_world,
                                  backend):
    """``maybe_initialize_distributed``: NCCL only when each of the host's
    ranks has a card of its own, the rank's card ``local rank %
    device_count`` made current, a finite timeout."""
    calls = {}
    monkeypatch.setattr(cluster.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cluster.torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(cluster.torch.cuda, "set_device",
                        lambda i: calls.setdefault("card", i))
    monkeypatch.setattr(cluster.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(cluster.dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    if local_world is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local_world)
    monkeypatch.setenv("ACS_CLUSTER_PROCESS_ID", "3")
    cfg = {"cluster": {"distributed": {"enabled": True,
                                       "coordinator": "127.0.0.1:1",
                                       "num_processes": 4}}}
    assert cluster.maybe_initialize_distributed(Config(cfg), device=device)
    assert calls["backend"] == backend
    assert (calls["rank"], calls["world_size"]) == (3, 4)
    assert calls["timeout"].total_seconds() == cluster.DIST_TIMEOUT_S
    assert calls.get("card") == (None if device == "cpu" else 3 % cards)
    assert not cluster.maybe_initialize_distributed({}, device=device)


def test_local_cluster_refuses_mesh_replicas(tmp_path):
    """Replicas that are each a mesh are the next slice's."""
    with pytest.raises(NotImplementedError, match="A.6 part 4"):
        cluster.LocalCluster(n_replicas=2, base_dir=str(tmp_path),
                             cfg_extra={"parallel": {"pod_shards": 2}})
