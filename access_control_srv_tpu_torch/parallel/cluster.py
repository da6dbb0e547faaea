"""Process bring-up: the local cluster tier, the on-chip pod hook and a
local N-rank launcher.

``LocalCluster`` is the whole serving tier in one object, as in the JAX
package's ``parallel/cluster.py``: a durable broker process, N worker
replica processes (each a full Worker whose PolicyReplicator replays the
broker's journaled CRUD log at boot and applies live frames through the
delta path, ``srv/store.py``), and a ClusterRouter (``srv/router.py``)
front door.  Each replica is ``python -m access_control_srv_tpu_torch``
on ``device`` (None: the CUDA device, so a replica fails its start where
there is none; the tests pass ``"cpu"``).  The replicas of one start
boot in parallel: all are spawned before the first is waited for.

Convergence invariant: replicas that applied the same CRUD log prefix
hold byte-identical compiled tables — the ``program_identity`` command
(policy epoch + table fingerprint) is the probe.

``maybe_initialize_distributed`` is the JAX package's hook behind the
``cluster:distributed`` config block, here ``torch.distributed.
init_process_group`` with the coordinator address and process count from
the same keys, over NCCL only where every rank of the host has a card of
its own, with a finite timeout.  ``python -m access_control_srv_tpu_torch``
calls it before ``Worker.start``: rank 0 serves, every other rank runs
the follower loop (``srv/follower.py``).  A replica of ``LocalCluster``
that is itself a mesh is refused.

``launch_local`` starts an N-rank world on one machine: one Python
process per rank, a file store for the rendezvous (no port to race for),
the chosen backend.  It is how the tests and ``chip_smoke.py`` get N
ranks on one host, the counterpart of the JAX tests' virtual CPU devices.
A rank that raises fails the launch: the others are stopped and the
failing rank's error is raised in the caller.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

# the checkout root: child ranks import the package (and the caller's
# target module) from here
ROOT = Path(__file__).resolve().parents[2]


def _cfg_get(cfg, path: str, default=None):
    """``path`` ("a:b:c") of a dict or a ``srv/config.Config``."""
    if not isinstance(cfg, dict):
        return cfg.get(path, default)
    node = cfg
    for part in path.split(":"):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


# the rendezvous and every collective of a process group started here
# raise after this long instead of waiting for gloo's default (30 min):
# a missing or stuck peer fails the world
DIST_TIMEOUT_S = 120.0


def maybe_initialize_distributed(cfg, process_id: Optional[int] = None,
                                 device=None) -> bool:
    """``init_process_group`` behind the ``cluster:distributed`` config
    block (``enabled``, ``coordinator`` host:port, ``num_processes``).
    The rank is ``process_id`` or ``ACS_CLUSTER_PROCESS_ID``.  Returns
    True when it initialized the group; False when the block is off or a
    group exists already.  A failed rendezvous raises.

    On CUDA (``device`` None or a CUDA device) the rank's card is
    ``cuda:(local rank % device_count)``, made current; the backend is
    NCCL only when each of this host's ranks (``LOCAL_WORLD_SIZE``, else
    every rank of the world) has a card of its own, else gloo, whose
    collectives the mesh stages through the host (``parallel/mesh.py``
    ``_host_staged``): NCCL does not put two ranks of one communicator
    on one card.  The CPU is gloo.  The rendezvous and the group's
    collectives time out after ``DIST_TIMEOUT_S``."""
    if not _cfg_get(cfg, "cluster:distributed:enabled", False):
        return False
    if dist.is_initialized():
        return False
    coordinator = _cfg_get(cfg, "cluster:distributed:coordinator",
                           "127.0.0.1:8476")
    num_processes = int(_cfg_get(cfg, "cluster:distributed:num_processes", 1))
    if process_id is None:
        process_id = int(os.environ.get("ACS_CLUSTER_PROCESS_ID", "0"))
    on_cuda = torch.cuda.is_available() and (
        device is None or torch.device(device).type == "cuda")
    backend = "gloo"
    if on_cuda:
        cards = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=DIST_TIMEOUT_S))
    return True


def _popen(args: list[str], cwd: Optional[str] = None,
           env: Optional[dict] = None) -> subprocess.Popen:
    """Start a CLI subprocess, its stdout and stderr on one pipe."""
    # failpoint (srv/faults.py): replica/broker spawn — error models a
    # scheduler refusing the placement, delay a slow cold boot
    from ..srv.faults import REGISTRY as _faults

    _faults.fire("cluster.spawn")
    return subprocess.Popen(
        args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, cwd=cwd, env=env,
    )


def _await_ready(proc: subprocess.Popen, ready_prefix: str,
                 timeout_s: float) -> str:
    """Wait for ``proc``'s ``ready_prefix`` stdout line and return the
    address after it.  A drain thread keeps consuming stdout afterwards
    so the pipe never backpressures the child; a child that never
    reports is killed and its last lines raised."""
    addr = None
    deadline = time.monotonic() + timeout_s
    lines: list[str] = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith(ready_prefix):
            addr = line[len(ready_prefix):].strip()
            break
    if addr is None:
        proc.kill()
        proc.wait(timeout=5)
        raise RuntimeError(
            f"subprocess never reported {ready_prefix!r}: "
            f"{''.join(lines[-20:])!r}"
        )

    _drain(proc)
    return addr


def _drain(proc: subprocess.Popen) -> None:
    """Read ``proc``'s output to its end in a thread of its own, so the
    pipe never backpressures the child."""

    def drain(stream=proc.stdout):
        try:
            for _ in stream:
                pass
        except Exception:  # noqa: BLE001
            pass

    # named: a thread that only reads this child's pipe
    threading.Thread(target=drain, daemon=True,
                     name=f"cluster-drain-{proc.pid}").start()


def _spawn(args: list[str], ready_prefix: str, timeout_s: float,
           cwd: Optional[str] = None, env: Optional[dict] = None):
    """Start a CLI subprocess and wait for its ``ready_prefix`` stdout
    line; returns (process, address)."""
    proc = _popen(args, cwd=cwd, env=env)
    return proc, _await_ready(proc, ready_prefix, timeout_s)


class ReplicaProcess:
    """One worker replica as a child process: its own config dir (written
    here), its own gRPC port, booted through the ordinary CLI on
    ``device`` (None: the CUDA device) so the process is exactly what
    production runs; ``env`` is its environment (None: this process's)."""

    def __init__(self, config: dict, base_dir: str, name: str,
                 timeout_s: float = 120.0, device=None,
                 env: Optional[dict] = None):
        self.name = name
        self.config_dir = os.path.join(base_dir, name)
        os.makedirs(self.config_dir, exist_ok=True)
        with open(os.path.join(self.config_dir, "config.json"), "w") as fh:
            json.dump(config, fh, indent=1)
        self.timeout_s = timeout_s
        self.device = "cuda" if device is None else str(device)
        self.env = env
        self.proc: Optional[subprocess.Popen] = None
        self.addr: Optional[str] = None
        # time.monotonic() at the spawn and when its ready line was read
        self.spawned_at: Optional[float] = None
        self.ready_at: Optional[float] = None

    def launch(self) -> "ReplicaProcess":
        """Spawn the process without waiting for it (``wait_ready``)."""
        self.spawned_at = time.monotonic()
        self.proc = _popen(self.argv, cwd=str(ROOT), env=self.env)
        return self

    @property
    def argv(self) -> list[str]:
        return [sys.executable, "-m", "access_control_srv_tpu_torch",
                "--config-dir", self.config_dir, "--addr", "127.0.0.1:0",
                "--device", self.device]

    def wait_ready(self) -> "ReplicaProcess":
        """Wait for the ``serving on`` line: the replica has replayed the
        journal and serves."""
        self.addr = _await_ready(self.proc, "serving on ", self.timeout_s)
        self.ready_at = time.monotonic()
        return self

    def start(self) -> "ReplicaProcess":
        return self.launch().wait_ready()

    @property
    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the chaos path: no drain, no goodbye."""
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=10)

    def stop(self, timeout_s: float = 15.0) -> None:
        """SIGTERM — the graceful path (worker drains in-flight work)."""
        if self.proc is None:
            return
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


class LocalCluster:
    """Broker + N replicas + router, owned end to end.

    ``seed_cfg`` (``rules`` / ``policies`` / ``policy_sets``, each a seed
    YAML path or a list of documents) is loaded ONCE, by the cluster, as
    CRUD frames emitted straight into the broker's journaled topics
    before any replica boots — the journal, not the YAML, is the
    cluster's durable policy store, so every replica (first boot or
    chaos restart) converges by replaying the same log through its
    PolicyReplicator and all replicas report the same policy epoch."""

    def __init__(self, n_replicas: int = 2, seed_cfg: dict | None = None,
                 cfg_extra: dict | None = None,
                 router_cfg: dict | None = None,
                 base_dir: str | None = None,
                 replica_timeout_s: float = 120.0,
                 broker_snapshot_every: int | None = None,
                 device=None):
        if (cfg_extra or {}).get("parallel"):
            raise NotImplementedError(
                "LocalCluster cfg_extra 'parallel': replicas that are each "
                "a mesh are not ported yet (the mesh-replica slice, A.6 "
                "part 4)")
        self.n_replicas = int(n_replicas)
        self.seed_cfg = seed_cfg or {}
        self.cfg_extra = cfg_extra or {}
        self.router_cfg = router_cfg or {}
        self._own_base = base_dir is None
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="acs-cluster-")
        self.replica_timeout_s = replica_timeout_s
        # snapshot + journal-compaction cadence (srv/broker.py): None
        # keeps full-journal replay; a reused base_dir reboots the
        # cluster from snapshot + tail
        self.broker_snapshot_every = broker_snapshot_every
        # None: every replica on the CUDA device
        self.device = device
        self.broker_proc: Optional[subprocess.Popen] = None
        self.broker_addr: Optional[str] = None
        self.replicas: list[ReplicaProcess] = []
        self.router = None
        # time.monotonic() when the broker answered and when the journal
        # was seeded (the replicas carry their own spawn and ready times)
        self.broker_ready_at: Optional[float] = None
        self.seeded_at: Optional[float] = None

    # ---------------------------------------------------------- lifecycle

    def start(self) -> "LocalCluster":
        """Broker and seed (unless ``start_broker`` ran), replicas,
        router; a start that fails stops every process it started before
        it raises."""
        try:
            if self.broker_proc is None:
                self._start_broker()
            return self._start_replicas()
        except BaseException:
            self.stop()
            raise

    def start_broker(self) -> "LocalCluster":
        """The broker alone, its journal seeded: the host work of a start
        done ahead of it (``start`` then spawns the replicas)."""
        try:
            return self._start_broker()
        except BaseException:
            self.stop()
            raise

    def _start_broker(self) -> "LocalCluster":
        broker_dir = os.path.join(self.base_dir, "broker")
        os.makedirs(broker_dir, exist_ok=True)
        broker_args = [
            sys.executable, "-m", "access_control_srv_tpu_torch",
            "--broker", "--addr", "127.0.0.1:0",
            "--broker-data-dir", broker_dir,
        ]
        if self.broker_snapshot_every is not None:
            broker_args += [
                "--broker-snapshot-every", str(self.broker_snapshot_every)
            ]
        self.broker_proc, self.broker_addr = _spawn(
            broker_args, "broker listening on ", 30.0, cwd=str(ROOT),
        )
        self.broker_ready_at = time.monotonic()
        # reused base_dir (a reboot): the journal/snapshot already hold
        # the policy state — re-seeding would double every frame
        if self.seed_cfg and not self._journal_populated(broker_dir):
            self._seed_journal()
        self.seeded_at = time.monotonic()
        return self

    def _start_replicas(self) -> "LocalCluster":
        # every replica spawned before the first is waited for: they
        # replay the journal in parallel
        for i in range(self.n_replicas):
            self.replicas.append(ReplicaProcess(
                self._replica_config(i), self.base_dir, f"replica-{i}",
                self.replica_timeout_s, device=self.device,
            ).launch())
        for replica in self.replicas:
            replica.wait_ready()
        from ..srv.router import ClusterRouter

        self.router = ClusterRouter(
            [r.addr for r in self.replicas], cfg=self.router_cfg,
        ).start()
        return self

    @staticmethod
    def _journal_populated(broker_dir: str) -> bool:
        """True when the broker dir already carries durable state (a
        non-empty journal or a snapshot) — i.e. this start() is a reboot
        over an existing base_dir, not a first boot."""
        journal = os.path.join(broker_dir, "broker.journal")
        snapshot = os.path.join(broker_dir, "broker.snapshot")
        if os.path.exists(snapshot):
            return True
        try:
            return os.path.getsize(journal) > 0
        except OSError:
            return False

    def _seed_journal(self) -> None:
        """Write the seed documents into the broker's journaled CRUD
        topics as ordinary Created frames (the same wire shape
        store.ResourceService._emit produces) so every replica's boot
        replay — not a per-process YAML load — installs the seed state."""
        from ..srv.broker import SocketEventBus
        from ..srv.worker import _yaml_list

        kind_event = {"rule": "rule", "policy": "policy",
                      "policy_set": "policySet"}
        bus = SocketEventBus(self.broker_addr)
        try:
            for kind, key in (("rule", "rules"), ("policy", "policies"),
                              ("policy_set", "policy_sets")):
                source = self.seed_cfg.get(key)
                if not source:
                    continue
                docs = _yaml_list(source) if isinstance(source, str) \
                    else source
                topic = bus.topic(f"io.restorecommerce.{kind}s.resource")
                for doc in docs:
                    topic.emit(
                        f"{kind_event[kind]}Created",
                        {"payload": doc, "origin": "cluster-seed"},
                    )
        finally:
            bus.close()

    def _replica_config(self, index: int) -> dict:
        cfg: dict = {
            "policies": {"type": "database"},
            "events": {"broker": {"address": self.broker_addr}},
        }
        for key, value in self.cfg_extra.items():
            if isinstance(value, dict) and isinstance(cfg.get(key), dict):
                cfg[key] = {**cfg[key], **value}
            else:
                cfg[key] = value
        return cfg

    def restart_replica(self, index: int) -> ReplicaProcess:
        """Boot a fresh process for a dead replica slot (same config dir:
        the journal replay, not local state, restores its policy tree)
        and swap its new address into the router."""
        old = self.replicas[index]
        replacement = ReplicaProcess(
            self._replica_config(index), self.base_dir,
            old.name, self.replica_timeout_s, device=self.device,
        ).start()
        self.replicas[index] = replacement
        if self.router is not None:
            if old.addr:
                self.router.remove_replica(old.addr)
            self.router.add_replica(
                replacement.addr, self.router_cfg.get("breaker") or {}
            )
        return replacement

    def stop(self) -> None:
        if self.router is not None:
            self.router.stop()
        # every replica told at once, then each awaited
        for replica in self.replicas:
            if replica.alive:
                replica.proc.terminate()
        for replica in self.replicas:
            try:
                replica.stop()
            except Exception:  # noqa: BLE001
                pass
        if self.broker_proc is not None:
            self.broker_proc.terminate()
            try:
                self.broker_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.broker_proc.kill()
                self.broker_proc.wait(timeout=10)
        if self._own_base:
            shutil.rmtree(self.base_dir, ignore_errors=True)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on just now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class MeshWorld:
    """One Worker on an N-rank world, every rank started through
    ``python -m access_control_srv_tpu_torch --device D`` with
    ``ACS_CLUSTER_PROCESS_ID``: ``config`` (its ``parallel`` block
    choosing the layout) gains a ``cluster:distributed`` block on a free
    127.0.0.1 port.  Rank 0 is a ``ReplicaProcess``: it serves at
    ``addr`` once every rank has compiled.  The others follow
    (srv/follower.py), bind no port, and share rank 0's config dir.
    ``procs`` holds every rank's process, rank 0 first."""

    def __init__(self, config: dict, n_ranks: int, base_dir: str,
                 device=None, timeout_s: float = 120.0):
        self.n_ranks = int(n_ranks)
        config = dict(config)
        config["cluster"] = {**(config.get("cluster") or {}), "distributed": {
            "enabled": True, "coordinator": f"127.0.0.1:{free_port()}",
            "num_processes": self.n_ranks}}
        # one compute thread per rank: the ranks share the host's cores
        env = {"OMP_NUM_THREADS": "1", **os.environ,
               "ACS_CLUSTER_PROCESS_ID": "0"}
        self.rank0 = ReplicaProcess(config, base_dir, "rank0", timeout_s,
                                    device, env=env)
        self.procs: list[subprocess.Popen] = []

    addr = property(lambda self: self.rank0.addr)
    spawned_at = property(lambda self: self.rank0.spawned_at)
    ready_at = property(lambda self: self.rank0.ready_at)

    def launch(self) -> "MeshWorld":
        """Spawn every rank without waiting (``wait_ready``)."""
        self.procs = [self.rank0.launch().proc]
        for rank in range(1, self.n_ranks):
            proc = _popen(self.rank0.argv, cwd=str(ROOT), env={
                **self.rank0.env, "ACS_CLUSTER_PROCESS_ID": str(rank)})
            _drain(proc)
            self.procs.append(proc)
        return self

    def wait_ready(self) -> "MeshWorld":
        """Wait for rank 0's ready line; a world whose rank 0 does not
        report within the timeout is stopped and its last lines raised."""
        try:
            self.rank0.wait_ready()
        except BaseException:
            self.stop()
            raise
        return self

    def start(self) -> "MeshWorld":
        return self.launch().wait_ready()

    def kill(self, rank: int) -> None:
        """SIGKILL one rank: no goodbye to the others."""
        self.procs[rank].kill()
        self.procs[rank].wait(timeout=10)

    def stop(self, timeout_s: float = 30.0) -> None:
        """SIGTERM to rank 0 (it stops every follower), then every rank
        awaited; whatever is left after ``timeout_s`` is killed."""
        deadline = time.monotonic() + timeout_s
        self.rank0.stop(timeout_s)
        for proc in self.procs[1:]:
            try:
                proc.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)


def launch_local(world_size: int, target: str, args: tuple = (),
                 backend: str = "gloo", timeout_s: float = 600.0) -> None:
    """Run ``target`` ("module:function") in ``world_size`` rank processes
    of one process group: each calls ``function(rank, world_size, *args)``
    after ``init_process_group(backend)`` (``args`` must be JSON values).
    Raises when a rank fails or the world outlasts ``timeout_s``; every
    rank is stopped before this returns."""
    work = tempfile.mkdtemp(prefix="acs-world-")
    spec = {"world_size": world_size, "target": target, "args": list(args),
            "backend": backend, "store": os.path.join(work, "store")}
    child_env = dict(os.environ)
    # one compute thread per rank unless the caller says otherwise (as
    # torchrun does): N ranks share the host's cores
    child_env.setdefault("OMP_NUM_THREADS", "1")
    child_env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in child_env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    procs = []
    try:
        for rank in range(world_size):
            log = open(os.path.join(work, f"rank{rank}.log"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _CHILD, json.dumps(spec), str(rank)],
                stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT),
                env={**child_env, "LOCAL_RANK": str(rank)}), log))
        deadline = time.monotonic() + timeout_s
        pending = {rank for rank in range(world_size)}
        while pending:
            failed = [r for r in sorted(pending)
                      if procs[r][0].poll() not in (None, 0)]
            if failed:
                # the others fail in their next collective: give them a
                # moment, then report every failed rank's log
                time.sleep(1.0)
                failed = [r for r in range(world_size)
                          if procs[r][0].poll() not in (None, 0)]
                raise RuntimeError(
                    f"ranks {failed} of {world_size} ({target}) failed:\n"
                    + "\n".join(f"--- rank {r}:\n{_tail(work, r)}"
                                for r in failed))
            pending = {r for r in pending if procs[r][0].poll() is None}
            if pending and time.monotonic() > deadline:
                raise TimeoutError(
                    f"{target}: ranks {sorted(pending)} still running after "
                    f"{timeout_s} s:\n{_tail(work, min(pending))}")
            time.sleep(0.05)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            log.close()
    shutil.rmtree(work, ignore_errors=True)


def _tail(work: str, rank: int, n: int = 6000) -> str:
    with open(os.path.join(work, f"rank{rank}.log")) as fh:
        return fh.read()[-n:]


# a rank's process: its traceback goes to its log and fails the world
_CHILD = (
    "import sys\n"
    "from access_control_srv_tpu_torch.parallel.cluster import child_main\n"
    "child_main(sys.argv[1], sys.argv[2])\n"
)


def child_main(spec_json: str, rank: str) -> None:
    try:
        _child(json.loads(spec_json), int(rank))
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)


def _child(spec: dict, rank: int) -> None:
    """One rank of ``launch_local``."""
    dist.init_process_group(
        spec["backend"], init_method=f"file://{spec['store']}",
        world_size=spec["world_size"], rank=rank)
    try:
        module, func = spec["target"].split(":")
        fn = getattr(importlib.import_module(module), func)
        fn(rank, spec["world_size"], *spec["args"])
        dist.barrier()
    finally:
        dist.destroy_process_group()
