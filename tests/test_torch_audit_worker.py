"""The port's audit worker mode against the JAX package's.

A port ``Worker`` (``device="cpu"``) and a JAX ``Worker``, each started
with ``audit:enabled``, run the same lattice sweep through their Command
interface (``audit_sweep``): every cell goes through the worker's
``MicroBatcher.submit_reverse`` as BULK-class work.  The two snapshots
must diff empty (both ways, with either package's ``diff_snapshots``),
their bitmaps be byte-equal, their status counts and summaries equal, and
the ``audit`` telemetry counters equal.  The trees: the seed data over an
explicit lattice, and a 48-rule stress tree over the stress lattice with
the reverse-query kernel path forced on both sides and unforced.  Cancel
is driven by a chunk pause the cancel ends, never by timing."""

import os

import pytest
import yaml

import bench_all
from access_control_srv_tpu.ops import lattice as jlat
from access_control_srv_tpu.ops import reverse as jreverse
from access_control_srv_tpu.srv import Worker as JaxWorker
from access_control_srv_tpu_torch.ops import lattice as tlat
from access_control_srv_tpu_torch.ops import reverse as treverse
from access_control_srv_tpu_torch.srv import audit_sweep as taudit
from access_control_srv_tpu_torch.srv.worker import Worker

from .torch_serving import ORG, seed_cfg

SEED_LATTICE = {
    "subjects": [{"id": "root", "role": "superadministrator-r-id"},
                 {"id": "adm", "role": "administrator-r-id"},
                 {"id": "usr", "role": "user-r-id"},
                 {"id": "nobody", "role": "nobody"}],
    "resources": [{"id": f"O{i}", "entity": ORG} for i in range(3)]
    + [{"id": "U1", "entity": "urn:restorecommerce:acs:model:user.User"}],
    "actions": ["read", "modify", "create", "delete"],
}
STRESS_LATTICE = {"subjects": 12, "resources": 10,
                  "actions": ["read", "modify"]}


def stress_yaml(path) -> str:
    doc, _ = bench_all._stress_doc(48, flip_every=5)
    with open(path, "w") as fh:
        yaml.safe_dump(doc, fh)
    return str(path)


def audit_cfg(tree: str, out_dir: str, tmp_path, **audit) -> dict:
    block = {"enabled": True, "out_dir": out_dir, "chunk_size": 16,
             **audit}
    if tree == "seed":
        return seed_cfg(audit=block)
    return {"policies": {"type": "local",
                         "paths": [stress_yaml(tmp_path / "stress.yml")]},
            "audit": block}


def sweep(worker, lattice) -> dict:
    return worker.command_interface.command("audit_sweep", {
        "action": "start", "lattice": lattice, "wait": True,
        "wait_timeout_s": 120})


def status_counts(st: dict) -> dict:
    return {k: st[k] for k in ("state", "target", "cells_done",
                               "cells_total", "chunks_done", "sheds",
                               "retries", "summary")}


@pytest.mark.parametrize("tree,lattice,forced", [
    ("seed", SEED_LATTICE, False),
    ("stress", STRESS_LATTICE, True),
    ("stress", STRESS_LATTICE, False),
], ids=["seed", "stress-kernel", "stress-walk"])
def test_sweep_through_the_batcher_equals_jax(tmp_path, monkeypatch, tree,
                                              lattice, forced):
    if forced:
        monkeypatch.setattr(treverse, "REVERSE_MIN_RULES", 0)
        monkeypatch.setattr(jreverse, "REVERSE_MIN_RULES", 0)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    port = Worker().start(audit_cfg(tree, port_dir, tmp_path), device="cpu")
    jax_worker = None
    try:
        jax_worker = JaxWorker().start(audit_cfg(tree, jax_dir, tmp_path))
        assert isinstance(port.audit, taudit.AuditSweepManager)
        assert port.audit.batcher is port.batcher
        assert port.audit.worker is port
        assert port.audit.telemetry is port.telemetry
        got, want = sweep(port, lattice), sweep(jax_worker, lattice)
        assert got["state"] == "done", got
        assert status_counts(got) == status_counts(want)
        assert got["cells_done"] == got["cells_total"] > 0
        a, b = port.audit.status(got["job"]), jax_worker.audit.status(
            want["job"])
        pa = port.audit._job(got["job"]).snapshot_path
        pb = jax_worker.audit._job(want["job"]).snapshot_path
        for diff in (tlat.diff_snapshots(pa, pb), tlat.diff_snapshots(pb, pa),
                     jlat.diff_snapshots(pa, pb)):
            assert diff["cells_changed"] == 0, diff
        with open(pa + ".bits.npy", "rb") as f1, \
                open(pb + ".bits.npy", "rb") as f2:
            assert f1.read() == f2.read()
        assert a["summary"] == b["summary"]
        # the audit counters of both workers' telemetry
        tel = port.command_interface.command("metrics", {})["audit"]
        assert tel == jax_worker.command_interface.command(
            "metrics", {})["audit"]
        assert tel["jobs_started"] == tel["jobs_completed"] == 1
        assert tel["cells"] == got["cells_total"]
        # the forced cases answer from the reverse-query kernel's plain
        # version, the others by the scalar walk
        assert (port.evaluator._rq_kernel is not None) is forced
        # health_check carries the compact job list on both sides
        hp = port.command_interface.command("health_check", {})["audit"]
        hj = jax_worker.command_interface.command("health_check",
                                                  {})["audit"]
        assert hp == hj
    finally:
        port.stop()
        if jax_worker is not None:
            jax_worker.stop()
    assert port.audit is None


def test_pause_resume_and_cancel_finish_the_job(tmp_path):
    """A chunk pause far longer than the test holds the job after its
    first chunk; pause and resume answer through the Command interface,
    and cancel ends the pause at once: the job finishes ``cancelled``
    with fewer cells than the lattice, and its snapshot is closed."""
    worker = Worker().start(audit_cfg("stress", str(tmp_path / "out"),
                                      tmp_path, chunk_pause_ms=600_000),
                            device="cpu")
    try:
        ci = worker.command_interface
        started = ci.command("audit_sweep", {
            "action": "start", "lattice": STRESS_LATTICE})
        job = started["job"]
        assert started["state"] == "running"
        paused = ci.command("audit_sweep", {"action": "pause", "job": job})
        assert paused["paused"] is True
        resumed = ci.command("audit_sweep", {"action": "resume",
                                             "job": job})
        assert resumed["paused"] is False
        ci.command("audit_sweep", {"action": "cancel", "job": job})
        assert worker.audit._job(job).wait(60)
        st = ci.command("audit_sweep", {"action": "status", "job": job})
        assert st["state"] == "cancelled"
        assert st["cells_done"] < st["cells_total"]
        header, _, footer = tlat.load_snapshot(
            worker.audit._job(job).snapshot_path)
        assert footer is not None and footer["cells"] == st["cells_done"]
        tel = ci.command("metrics", {})["audit"]
        assert tel["jobs_cancelled"] == 1 and tel["jobs_paused"] == 1
        assert tel["jobs_resumed"] == 1
    finally:
        worker.stop()


def test_stop_cancels_sweeps_first(tmp_path):
    """``Worker.stop`` stops the audit manager before the batcher drains:
    a sweep held by its chunk pause ends cancelled, not failed."""
    worker = Worker().start(audit_cfg("stress", str(tmp_path / "out"),
                                      tmp_path, chunk_pause_ms=600_000),
                            device="cpu")
    manager = worker.audit
    job = manager.start_sweep(lattice=STRESS_LATTICE)
    worker.stop()
    assert job.wait(30)
    assert job.state == "cancelled"
    assert worker.audit is None


@pytest.mark.parametrize("action,payload,match", [
    ("start", {"target": "shadow"}, "shadow and tenancy"),
    ("twin", {}, "shadow and tenancy"),
])
def test_shadow_actions_refused(tmp_path, action, payload, match):
    worker = Worker().start(audit_cfg("seed", str(tmp_path / "out"),
                                      tmp_path), device="cpu")
    try:
        out = worker.command_interface.command(
            "audit_sweep", {"action": action, **payload})
        assert match in out["error"]
    finally:
        worker.stop()


def test_audit_off_by_default(tmp_path):
    worker = Worker().start(seed_cfg(), device="cpu")
    try:
        assert worker.audit is None
        assert worker.command_interface.command(
            "audit_sweep", {"action": "status"}) == {"enabled": False}
    finally:
        worker.stop()


def test_out_dir_default_is_under_the_temp_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    manager = taudit.from_config({"audit:enabled": True},
                                 evaluator=object())
    assert manager.out_dir == os.path.join(str(tmp_path), "acs-audit")
