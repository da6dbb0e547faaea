"""The follower loop: the ranks of a Worker's mesh besides the serving one.

This module has no counterpart in the JAX package.  The JAX worker drives
every device of its mesh from one process, and XLA runs the collectives
inside one program.  The port runs one process per rank
(``parallel/mesh.py``), and every rank's kernel takes part in the
collectives of every batch, so the ranks must call their kernels in step,
on the same batches in the same order.  Rank 0 runs the ``Worker``: the
gRPC server, the decision cache, token / HR preparation and the native
encode stay there.  Every other rank runs ``serve``: it builds the
Worker's mesh from the same config and then does what rank 0's kernel
calls need of it, in the order rank 0 sends.

The control channel is a gloo group of its own over the whole world
(never one of the mesh's axis groups, so its traffic never interleaves
with a kernel's collectives), point to point from rank 0.  Each message
is one pickle (its length, then its bytes), and rank 0 sends them one at
a time (``Leader``), so they reach every follower in one total order:

- ``("build", gen, "tree", tree, version, prev_caps, prev_t_cap)``: a
  full recompile begins on rank 0.  The follower compiles the same tree
  snapshot (the pickle bytes rank 0 copies its tree with) into the same
  capacity buckets, and builds its kernel, in the background.
- ``("build", gen, "patch", prev_gen, tables, slots)``: a delta patch.
  The patched tables come from rank 0 itself: its interner holds the
  strings its encodes met, so a patch lowered on another rank could
  number a new string otherwise.  The pod-sharded kernel re-slices only
  the owning shard (``PodShardedKernel.patched``).
- ``("swap", gen)`` / ``("drop", gen)``: rank 0 published that
  generation, or threw it away (a compile superseded or failed).  Rank 0
  sends a swap only once every follower reports that generation built
  (``Leader.await_built``, which polls the ``pending`` query), and a
  batch only for a published generation.  So a follower's loop never
  waits for a build: it keeps receiving, and running the old kernel's
  batches, however long a build takes, and no send or collective waits
  on a compile.
- ``("batch", gen, arrays)``: the encoded ``RequestBatch`` that rank 0's
  kernel of that generation is about to take, sent under rank 0's
  dispatch lock.
- ``("query", name, args)``: the follower answers at once (its table
  fingerprint, its launch and collective counts, or the generations it
  is still building).
- ``("ping",)`` keeps an idle follower inside the group's timeout;
  ``("stop",)`` ends it.

Every message also names the generations rank 0 let go of (their kernel
objects collected), which the followers free.  Relation tuples reach the
kernels only through the batch arrays that rank 0 encodes, so a tuple
change sends nothing.  whatIsAllowed (K5) and the lattice run on rank 0's
device alone, as in JAX, and send nothing either.  Ranks outside a
layout smaller than the world get only the pings and the stop.

A follower that dies (gloo reports the closed connection at once),
raises (it exits), leaves a send unanswered for the group's timeout
(``DIST_TIMEOUT_S``) or a build unfinished for ``BUILD_TIMEOUT_S`` makes
the channel lost, for good: rank 0's kernel batches raise
``FollowerLost``, which the evaluator answers with the degraded envelope,
never with its own shard's answer, and rank 0's health check reports
NOT_SERVING, so that a router or supervisor takes it out.  A follower
whose rank 0 is gone exits.
"""

from __future__ import annotations

import math
import pickle
import sys
import threading
import time
import traceback
import weakref
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from ..ops import kernel as kmod
from ..ops.encode import RequestBatch
from ..parallel import mesh as mmod
from ..parallel.cluster import DIST_TIMEOUT_S

# an idle channel still sends this often: far inside the group's timeout
HEARTBEAT_S = DIST_TIMEOUT_S / 8
# rank 0 asks the followers for their unfinished builds this often while
# it waits to publish, and gives up (the channel lost) after the second
BUILD_POLL_S = 0.02
BUILD_TIMEOUT_S = 600.0
# what a kernel reads of a RequestBatch
BATCH_FIELDS = ("B", "arrays", "rgx_set", "pfx_neq", "cond_true",
                "cond_abort", "cond_code", "eligible")


class FollowerLost(RuntimeError):
    """The control channel failed: a follower died, raised or stopped."""


def control_group():
    """The channel's gloo group over the whole world; every rank calls
    this once, after the mesh's groups."""
    return dist.new_group(list(range(dist.get_world_size())),
                          backend="gloo",
                          timeout=timedelta(seconds=DIST_TIMEOUT_S))


class Leader:
    """Rank 0's end of the channel.  ``members`` are the other ranks of
    the mesh, ``idle`` the ranks outside it.  Builds, swaps and drops
    never raise (a lost channel fails the next batch); ``batch`` and
    ``query`` raise ``FollowerLost``."""

    def __init__(self, mesh, logger=None):
        world = dist.get_world_size()
        need = math.prod(mesh.shape.values()) if mesh is not None else 1
        self.members = list(range(1, need))
        self.idle = list(range(need, world))
        self.logger = logger
        self.group = control_group()
        # one message at a time: the total order every follower sees
        self._lock = threading.Lock()
        self._gen = 0
        # generations whose kernel rank 0 let go of (weakref callbacks
        # append here, from any thread)
        self._retired: deque = deque()
        self.lost: Optional[BaseException] = None
        # batches sent, their bytes and the seconds their sends took
        self.stats = {"messages": 0, "bytes": 0, "batches": 0,
                      "batch_bytes": 0, "batch_s": 0.0}
        self._stopped = threading.Event()
        self._heart = threading.Thread(target=self._heartbeat, daemon=True,
                                       name="acs-follower-heartbeat")
        self._heart.start()

    # ---------------------------------------------------------- sending

    def _post(self, kind: str, *fields, to=None) -> int:
        """Send one message to ``to`` (the members by default); the
        caller holds ``_lock``.  Returns its bytes."""
        if self.lost is not None:
            raise FollowerLost(f"the follower channel is lost: {self.lost}")
        ranks = self.members if to is None else to
        if not ranks:
            return 0
        retired = []
        while self._retired:
            retired.append(self._retired.popleft())
        data = pickle.dumps((retired, kind) + fields,
                            pickle.HIGHEST_PROTOCOL)
        head = torch.tensor([len(data)], dtype=torch.int64)
        body = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        try:
            for rank in ranks:
                dist.send(head, rank, group=self.group)
                dist.send(body, rank, group=self.group)
        except Exception as err:  # noqa: BLE001 — the channel is lost
            self._lose(err)
            raise FollowerLost(f"a follower is lost: {err}") from err
        self.stats["messages"] += 1
        self.stats["bytes"] += len(data) * len(ranks)
        return len(data)

    def _lose(self, err: BaseException) -> None:
        if self.lost is None:
            self.lost = err
            if self.logger:
                self.logger.error("follower channel lost",
                                  extra={"error": repr(err)})

    def _notify(self, kind: str, *fields) -> None:
        with self._lock:
            try:
                self._post(kind, *fields)
            except FollowerLost:
                pass

    def build(self, how: str, *fields) -> int:
        """A build begins on rank 0: ``("tree", tree bytes, version,
        prev_caps, prev_t_cap)`` or ``("patch", the patched kernel's
        generation, tables, slots)``; returns its generation."""
        with self._lock:
            self._gen += 1
            gen = self._gen
            try:
                self._post("build", gen, how, *fields)
            except FollowerLost:
                pass
        return gen

    def publish(self, gen: int, kernel) -> None:
        """Rank 0 serves ``kernel`` (None: no kernel) of ``gen`` from
        now on."""
        if kernel is not None:
            kernel._follower_gen = gen
            weakref.finalize(kernel, self._retired.append, gen)
        self._notify("swap", gen)

    def drop(self, gen: Optional[int]) -> None:
        if gen is not None:
            self._notify("drop", gen)

    def batch(self, kernel, batch) -> None:
        """``batch`` is about to reach ``kernel``: every member runs its
        kernel of the same generation on it."""
        fields = {name: getattr(batch, name) for name in BATCH_FIELDS}
        t0 = time.perf_counter()
        with self._lock:
            n = self._post("batch", kernel._follower_gen, fields)
            self.stats["batches"] += 1
            self.stats["batch_bytes"] += n * len(self.members)
            self.stats["batch_s"] += time.perf_counter() - t0

    def query(self, name: str, **args) -> list:
        """Every member's answer to ``name``, in rank order."""
        with self._lock:
            self._post("query", name, args)
            try:
                return [_recv(self.group, rank)
                        for rank in self.members]
            except Exception as err:  # noqa: BLE001 — the channel is lost
                self._lose(err)
                raise FollowerLost(f"a follower is lost: {err}") from err

    def await_built(self, gen: Optional[int] = None) -> bool:
        """Wait until no member is still building ``gen`` (None: any
        generation), polling; each poll is answered at once, so the
        channel stays live however long a build takes.  False when the
        channel is lost, or becomes lost after ``BUILD_TIMEOUT_S``."""
        deadline = time.monotonic() + BUILD_TIMEOUT_S
        while True:
            try:
                pending = self.query("pending")
            except FollowerLost:
                return False
            if not any(p if gen is None else gen in p for p in pending):
                return True
            if time.monotonic() > deadline:
                with self._lock:
                    self._lose(TimeoutError(
                        f"a follower still builds {pending} after "
                        f"{BUILD_TIMEOUT_S} s"))
                return False
            time.sleep(BUILD_POLL_S)

    def sync(self) -> None:
        """Return once every member has finished every build sent;
        raises ``FollowerLost`` when the channel is lost."""
        if not self.await_built():
            raise FollowerLost(f"the follower channel is lost: {self.lost}")

    def stop(self) -> None:
        """Stop every follower (members and idle ranks) and the
        heartbeat; later calls raise ``FollowerLost``."""
        self._stopped.set()
        with self._lock:
            try:
                self._post("stop", to=self.members + self.idle)
            except FollowerLost:
                pass
            if self.lost is None:
                self.lost = FollowerLost("the followers were stopped")
        self._heart.join(timeout=5.0)

    def _heartbeat(self) -> None:
        while not self._stopped.wait(HEARTBEAT_S):
            with self._lock:
                if self._stopped.is_set() or self.lost is not None:
                    return
                try:
                    self._post("ping", to=self.members + self.idle)
                except FollowerLost:
                    return


def _recv(group, rank: int = 0):
    """One message from ``rank``."""
    head = torch.empty(1, dtype=torch.int64)
    dist.recv(head, rank, group=group)
    body = torch.empty(int(head), dtype=torch.uint8)
    dist.recv(body, rank, group=group)
    return pickle.loads(body.numpy())


def _reply(obj, group) -> None:
    data = pickle.dumps(obj, pickle.HIGHEST_PROTOCOL)
    dist.send(torch.tensor([len(data)], dtype=torch.int64), 0, group=group)
    dist.send(torch.frombuffer(bytearray(data), dtype=torch.uint8), 0,
              group=group)


class Follower:
    """A rank ≥1 of a Worker's world: the Worker's mesh from the same
    config, a ``HybridEvaluator`` on it whose compile and kernel
    construction are rank 0's own code, and the generations it was sent
    (``gen -> Future`` of (compiled, kernel, caps or None))."""

    def __init__(self, cfg, device=None):
        from ..core.engine import AccessController
        from ..models.urns import Urns
        from .evaluator import HybridEvaluator
        from .worker import build_mesh, mesh_layout

        layout = mesh_layout(cfg)
        self.mesh = build_mesh(layout, device) if layout else None
        self.group = control_group()
        self.evaluator = None
        if self.mesh is not None and self.mesh.member:
            if self.mesh.device.type == "cuda":
                kmod.load_libraries()
            self.evaluator = HybridEvaluator(
                AccessController(urns=Urns(
                    cfg.get("policies:options:urns") or {})),
                backend=cfg.get("evaluator:backend", "hybrid"),
                mesh=self.mesh, mesh_axis=layout["data_axis"],
                model_axis=(layout["model_axis"] if layout["n_model"]
                            else None),
                pod_shards=layout["pod_shards"],
                delta_enabled=bool(cfg.get("evaluator:delta_enabled", True)),
                explain=bool(cfg.get("explain:enabled", False)),
            )
        self.jobs: dict[int, Future] = {}
        self._build_pool = ThreadPoolExecutor(
            1, thread_name_prefix="acs-follower-build")

    # ------------------------------------------------------------ builds

    def _build_tree(self, tree: bytes, version: int, prev_caps,
                    prev_t_cap: int) -> tuple:
        ev = self.evaluator
        compiled, caps, _ = ev._compile_tables(pickle.loads(tree), version,
                                               prev_caps)
        kernel = None
        if compiled.supported and compiled.n_rules > 0:
            kernel = ev._make_kernel(compiled, prev_t_cap)
            ev._sync_upload()
        return compiled, kernel, caps

    def _build_patch(self, prev, patched, slots) -> tuple:
        ev = self.evaluator
        kernel, _ = ev._patch_kernel(prev, patched, slots)
        ev._sync_upload()
        return patched, kernel, None

    def _swap(self, gen: int) -> None:
        ev = self.evaluator
        compiled, kernel, caps = self.jobs[gen].result()
        with ev._lock:
            ev._compiled, ev._kernel = compiled, kernel
            if caps is not None:  # a full compile's buckets
                ev._caps = caps
        if kernel is None:
            del self.jobs[gen]

    # -------------------------------------------------------------- loop

    def run(self) -> None:
        """Follow rank 0 until its ``stop``; raises when the channel
        fails."""
        try:
            while True:
                retired, kind, *fields = _recv(self.group)
                for gen in retired:
                    job = self.jobs.pop(gen, None)
                    if job is not None:
                        job.cancel()
                if kind == "stop":
                    return
                if kind == "ping" or self.evaluator is None:
                    continue
                getattr(self, "_on_" + kind)(*fields)
        finally:
            self._build_pool.shutdown(wait=True, cancel_futures=True)

    def _on_build(self, gen: int, how: str, *args) -> None:
        if how == "tree":
            self.jobs[gen] = self._build_pool.submit(self._build_tree, *args)
        else:
            prev_gen, patched, slots = args
            prev = self.jobs[prev_gen].result()[1]
            self.jobs[gen] = self._build_pool.submit(self._build_patch, prev,
                                                  patched, slots)

    def _on_swap(self, gen: int) -> None:
        self._swap(gen)

    def _on_drop(self, gen: int) -> None:
        job = self.jobs.pop(gen, None)
        if job is not None:
            job.cancel()

    def _on_batch(self, gen: int, fields: dict) -> None:
        kernel = self.jobs[gen].result()[1]
        kernel.evaluate_async(RequestBatch(**fields))()

    def _on_query(self, name: str, args: dict) -> None:
        if name == "fingerprint":
            answer = self.evaluator.table_fingerprint()
        elif name == "pending":
            answer = [gen for gen, job in list(self.jobs.items())
                      if not job.done()]
        elif name == "launches":
            answer = {"launches": dict(kmod.LAUNCHES),
                      "collectives": dict(mmod.COLLECTIVES)}
            if args.get("reset"):
                for counts in (kmod.LAUNCHES, mmod.COLLECTIVES):
                    for key in counts:
                        counts[key] = 0
        else:
            raise ValueError(f"unknown follower query {name!r}")
        _reply(answer, self.group)


def serve(cfg, device=None) -> int:
    """``python -m access_control_srv_tpu_torch`` on a rank ≥1: follow
    rank 0 until it stops the world; 1 when the channel or a build
    failed."""
    follower = Follower(cfg, device)
    print(f"following rank 0 as rank {dist.get_rank()}", flush=True)
    try:
        follower.run()
    except BaseException:  # noqa: BLE001 — reported, then the rank exits
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    return 0
