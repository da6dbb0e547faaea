"""Process-group bring-up: the on-chip pod hook and a local N-rank launcher.

``maybe_initialize_distributed`` is the JAX package's hook behind the
``cluster:distributed`` config block, here ``torch.distributed.
init_process_group`` with the coordinator address and process count from
the same keys.

``launch_local`` starts an N-rank world on one machine: one Python
process per rank, a file store for the rendezvous (no port to race for),
the chosen backend.  It is how the tests and ``chip_smoke.py`` get N
ranks on one host, the counterpart of the JAX tests' virtual CPU devices.
A rank that raises fails the launch: the others are stopped and the
failing rank's error is raised in the caller.

The JAX module's ``LocalCluster`` / ``ReplicaProcess`` (whole worker
replicas behind a router) wait for the serving shell.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

# the checkout root: child ranks import the package (and the caller's
# target module) from here
ROOT = Path(__file__).resolve().parents[2]


def _cfg_get(cfg: dict, path: str, default=None):
    node = cfg
    for part in path.split(":"):
        if not isinstance(node, dict) or part not in node:
            return default
        node = node[part]
    return node


def maybe_initialize_distributed(cfg, process_id: Optional[int] = None
                                 ) -> bool:
    """``init_process_group`` behind the ``cluster:distributed`` config
    block (``enabled``, ``coordinator`` host:port, ``num_processes``), over
    NCCL when CUDA is available, else gloo.  The rank is ``process_id`` or
    ``ACS_CLUSTER_PROCESS_ID``.  Returns True when it initialized the
    group; False when the block is off or a group exists already.  A
    failed rendezvous raises."""
    if not _cfg_get(cfg, "cluster:distributed:enabled", False):
        return False
    if dist.is_initialized():
        return False
    coordinator = _cfg_get(cfg, "cluster:distributed:coordinator",
                           "127.0.0.1:8476")
    num_processes = int(_cfg_get(cfg, "cluster:distributed:num_processes", 1))
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if process_id is None:
        process_id = int(os.environ.get("ACS_CLUSTER_PROCESS_ID", "0"))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


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
