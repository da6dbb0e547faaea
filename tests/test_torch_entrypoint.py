"""The port's process entry point: ``python -m access_control_srv_tpu_torch
--device cpu`` serves the gRPC surface from the shipped ``cfg/`` and stops
cleanly on SIGINT; its healthcheck module says ``SERVING``; without
``--device`` it serves on the CUDA device, and so fails at startup where
there is none; the broker, router and cluster modes print their ready
lines, serve and stop cleanly on SIGTERM."""

import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest

from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu_torch.__main__ import main
from access_control_srv_tpu_torch.srv.transport_grpc import GrpcClient

from .torch_serving import seed_request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULE = "access_control_srv_tpu_torch"


def _serve(*extra):
    """Start the entry point on the shipped cfg/; returns (process,
    address, the output lines queue)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", MODULE, "--config-dir", "cfg",
         "--addr", "127.0.0.1:0", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO,
    )
    lines: "queue.Queue[str]" = queue.Queue()

    def pump():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            line = lines.get(timeout=1)
        except queue.Empty:
            continue
        if line is None:
            break
        if line.startswith("serving on 127.0.0.1:"):
            return proc, line.strip().rsplit(" ", 1)[-1], lines
    proc.kill()
    proc.wait(timeout=15)
    raise AssertionError("the server never announced its address")


def _drain(lines) -> str:
    out = []
    while True:
        try:
            line = lines.get(timeout=30)
        except queue.Empty:
            break
        if line is None:
            break
        out.append(line)
    return "".join(out)


def test_serves_healthcheck_and_stops_on_sigint():
    proc, addr, lines = _serve("--device", "cpu")
    try:
        client = GrpcClient(addr)
        assert client.health() == "SERVING"
        batch = pb.BatchRequest(requests=[seed_request()] * 3 + [
            seed_request(role="nobody")])
        out = client.is_allowed_batch(batch)
        assert [r.decision for r in out.responses] == \
            [pb.PERMIT] * 3 + [pb.INDETERMINATE]
        client.close()
        rc = subprocess.run(
            [sys.executable, "-m", MODULE + ".healthcheck", addr],
            capture_output=True, text=True, cwd=REPO, timeout=60)
        assert rc.returncode == 0, rc.stderr
        assert rc.stdout.strip() == "SERVING"
    finally:
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
    out = _drain(lines)
    assert "shutting down" in out, out
    assert proc.returncode == 0


def test_default_device_is_cuda():
    """Without ``--device`` the worker asks for the CUDA device: where
    there is none, startup fails and the process exits 1."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    rc = subprocess.run(
        [sys.executable, "-m", MODULE, "--config-dir", "cfg",
         "--addr", "127.0.0.1:0"],
        capture_output=True, text=True, cwd=REPO, timeout=120, env=env)
    assert rc.returncode == 1, (rc.stdout, rc.stderr)
    assert "startup error" in rc.stderr and "CUDA" in rc.stderr


def test_healthcheck_reports_a_dead_address():
    rc = subprocess.run(
        [sys.executable, "-m", MODULE + ".healthcheck", "127.0.0.1:1"],
        capture_output=True, text=True, cwd=REPO, timeout=60)
    assert rc.returncode == 1
    assert "health check failed" in rc.stderr


def _mode(args, ready: str):
    """Start the entry point in one of its other modes; returns (process,
    the address of its ready line, the output lines queue)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", MODULE, *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=REPO)
    lines: "queue.Queue[str]" = queue.Queue()

    def pump():
        for ln in proc.stdout:
            lines.put(ln)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    seen = []
    deadline = time.time() + 120
    while time.time() < deadline:
        try:
            line = lines.get(timeout=1)
        except queue.Empty:
            continue
        if line is None:
            break
        seen.append(line)
        if line.startswith(ready):
            return proc, line[len(ready):].strip(), lines
    proc.kill()
    proc.wait(timeout=15)
    raise AssertionError(f"no {ready!r} line: {''.join(seen)!r}")


@pytest.mark.parametrize("mode", ["--broker", "--router", "--cluster"])
def test_broker_router_cluster_modes(mode, monkeypatch):
    """Each mode prints its ready line, does its work (the broker journals
    and answers, the router and the cluster route a batch to a port
    replica on the CPU) and stops cleanly on SIGTERM."""
    from access_control_srv_tpu_torch.srv.broker import SocketEventBus
    from access_control_srv_tpu_torch.srv.transport_grpc import GrpcServer
    from access_control_srv_tpu_torch.srv.worker import Worker

    from .torch_serving import seed_cfg

    worker = server = None
    if mode == "--broker":
        args = ["--broker", "--addr", "127.0.0.1:0"]
        ready = "broker listening on "
    elif mode == "--router":
        worker = Worker().start(seed_cfg(), device="cpu")
        server = GrpcServer(worker, "127.0.0.1:0").start()
        args = ["--router", "--replica", server.addr, "--addr",
                "127.0.0.1:0", "--config-dir", "cfg"]
        ready = "routing on "
    else:
        args = ["--cluster", "--replicas", "2", "--device", "cpu",
                "--config-dir", "cfg"]
        ready = "routing on "
        # the replica processes compute with one thread each
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
    try:
        proc, addr, lines = _mode(args, ready)
        try:
            if mode == "--broker":
                bus = SocketEventBus(addr)
                assert bus.topic("t").emit("e", {"x": 1}) == 0
                assert bus.topic("t").read(0) == [("e", {"x": 1})]
                bus.close()
            else:
                client = GrpcClient(addr)
                out = client.is_allowed_batch(pb.BatchRequest(
                    requests=[seed_request()] * 2
                    + [seed_request(role="nobody")]))
                assert [r.decision for r in out.responses] == \
                    [pb.PERMIT] * 2 + [pb.INDETERMINATE]
                client.close()
        finally:
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        assert proc.returncode == 0, _drain(lines)
    finally:
        if server is not None:
            server.stop(0)
            worker.stop()


@pytest.mark.parametrize("bad", ["localhost", "127.0.0.1:", "host:port"])
def test_rejects_malformed_addr(bad):
    with pytest.raises(SystemExit) as exc:
        main(["--device", "cpu", "--addr", bad])
    assert exc.value.code == 2
