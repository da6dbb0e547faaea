"""Bulk permission-lattice audit sweeps.

A copy of the JAX package's ``srv/audit_sweep.py``: a sweep walks a
subject x resource x action lattice (``ops/lattice.py``) in chunks, each
chunk answered by the reverse query (the ``wia_planes`` kernel on large
trees), folded to per-cell verdicts naming the deciding rule and streamed
into a masked JSONL + bitmap snapshot, so memory stays bounded by one
chunk regardless of lattice size.  Jobs expose pause / resume / cancel /
status, and two finished sweeps can be diffed.

Two modes, as in JAX: with a ``batcher`` (the worker mode, ``audit:
enabled`` in the Worker) every cell goes through
``MicroBatcher.submit_reverse`` as BULK-class work, so the interactive
queue never sees audit traffic; without one each chunk calls
``evaluator.what_is_allowed_batch`` directly.  ``telemetry`` counts the
jobs, chunks, cells, retries and sheds under its ``audit`` counter.

Not ported yet, and refused with ``NotImplementedError`` naming the
slice: ``target="shadow"`` and the learned-policy twin loop
``sweep_twin`` (the shadow and tenancy slice (A.7)).
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Optional

from ..ops.lattice import (
    LatticeSpec,
    SnapshotWriter,
    diff_snapshots,
    fold_reverse_query,
)

class SweepJob:
    """One lattice sweep: immutable plan + mutable progress, owned by a
    single worker thread in :class:`AuditSweepManager`."""

    def __init__(
        self,
        job_id: int,
        spec: LatticeSpec,
        target: str,
        snapshot_path: str,
        policy_epoch: Optional[int] = None,
    ):
        self.job_id = job_id
        self.spec = spec
        self.target = target
        self.snapshot_path = snapshot_path
        self.bitmap_path = snapshot_path + ".bits.npy"
        self.policy_epoch = policy_epoch
        self.state = "pending"        # guarded-by: _lock
        self.error: Optional[str] = None
        self.cells_done = 0           # guarded-by: _lock
        self.chunks_done = 0          # guarded-by: _lock
        self.sheds = 0                # guarded-by: _lock
        self.retries = 0              # guarded-by: _lock
        self.summary: Optional[dict] = None
        self.started_monotonic: Optional[float] = None
        self.wall_s: Optional[float] = None
        self._lock = threading.Lock()
        self._paused = threading.Event()
        self._cancel = threading.Event()
        self._finished = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def status(self) -> dict:
        with self._lock:
            out = {
                "job": self.job_id,
                "target": self.target,
                "state": self.state,
                "cells_total": self.spec.n_cells,
                "cells_done": self.cells_done,
                "chunks_done": self.chunks_done,
                "sheds": self.sheds,
                "retries": self.retries,
                "paused": self._paused.is_set(),
                "snapshot": self.snapshot_path,
                "bitmap": self.bitmap_path,
                "policy_epoch": self.policy_epoch,
            }
            if self.wall_s is not None:
                out["wall_s"] = round(self.wall_s, 3)
            if self.summary is not None:
                out["summary"] = self.summary
            if self.error is not None:
                out["error"] = self.error
        return out

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)


class AuditSweepManager:
    """Sweep-job lifecycle: start/pause/resume/cancel, chunked bulk
    dispatch and snapshot/diff plumbing.

    ``batcher`` present: production sweeps submit through the BULK class
    (the admission-fairness path — the serving deployment shape).
    ``batcher`` absent: chunks call ``evaluator.what_is_allowed_batch``
    directly (the offline/bench shape)."""

    def __init__(
        self,
        evaluator,
        batcher=None,
        worker=None,
        telemetry=None,
        logger: Optional[logging.Logger] = None,
        out_dir: Optional[str] = None,
        chunk_size: int = 256,
        cell_timeout_s: float = 60.0,
        max_retries: int = 3,
        chunk_pause_ms: float = 0.0,
        default_lattice: Optional[dict] = None,
    ):
        self.evaluator = evaluator
        self.batcher = batcher
        self.worker = worker
        self.telemetry = telemetry
        self.logger = logger or logging.getLogger("acs.audit")
        # the default lies under the process's temporary directory
        self.out_dir = str(out_dir or os.path.join(tempfile.gettempdir(),
                                                   "acs-audit"))
        self.chunk_size = max(1, int(chunk_size))
        self.cell_timeout_s = float(cell_timeout_s)
        self.max_retries = max(0, int(max_retries))
        self.chunk_pause_s = max(0.0, float(chunk_pause_ms) / 1e3)
        self.default_lattice = dict(default_lattice or {})
        self._jobs: dict[int, SweepJob] = {}   # guarded-by: _lock
        self._next_id = 1                      # guarded-by: _lock
        self._lock = threading.Lock()
        self._stopping = False                 # guarded-by: _lock

    # ------------------------------------------------------------- metrics

    def _count(self, event: str, by: int = 1) -> None:
        if self.telemetry is not None:
            self.telemetry.audit.inc(event, by)

    # ------------------------------------------------------------ lifecycle

    def start_sweep(
        self,
        spec: Optional[LatticeSpec] = None,
        target: str = "production",
        lattice: Optional[dict] = None,
        wait: bool = False,
        wait_timeout: float = 600.0,
    ) -> SweepJob:
        """Launch a sweep job over the production tree (bulk class
        through the batcher where there is one).  ``lattice`` overrides
        the configured default axes (``ops/lattice.LatticeSpec.
        from_config`` grammar)."""
        if target == "shadow":
            raise NotImplementedError(
                "target='shadow' (sweeping a shadow candidate tree): not "
                "ported yet (the shadow and tenancy slice (A.7))"
            )
        if target != "production":
            raise ValueError(f"unknown sweep target: {target!r}")
        if spec is None:
            block = lattice if lattice is not None else self.default_lattice
            spec = LatticeSpec.from_config(block, urns=self._urns())
        with self._lock:
            if self._stopping:
                raise RuntimeError("audit manager stopping")
            job_id = self._next_id
            self._next_id += 1
            path = os.path.join(
                self.out_dir, f"sweep-{job_id:04d}-{target}.jsonl"
            )
            job = SweepJob(
                job_id, spec, target, path, policy_epoch=self._epoch()
            )
            self._jobs[job_id] = job
            job._thread = threading.Thread(
                target=self._run, args=(job,),
                name=f"acs-audit-sweep-{job_id}", daemon=True,
            )
            with job._lock:
                job.state = "running"
            job._thread.start()
        self._count("jobs_started")
        if wait:
            if not job.wait(wait_timeout):
                raise TimeoutError(f"sweep {job_id} still running")
        return job

    def pause(self, job_id: int) -> dict:
        job = self._job(job_id)
        job._paused.set()
        self._count("jobs_paused")
        return job.status()

    def resume(self, job_id: int) -> dict:
        job = self._job(job_id)
        job._paused.clear()
        self._count("jobs_resumed")
        return job.status()

    def cancel(self, job_id: int) -> dict:
        job = self._job(job_id)
        job._cancel.set()
        job._paused.clear()
        return job.status()

    def status(self, job_id: Optional[int] = None) -> dict:
        if job_id is not None:
            return self._job(job_id).status()
        with self._lock:
            jobs = list(self._jobs.values())
        statuses = [j.status() for j in jobs]
        running = sum(1 for s in statuses if s["state"] == "running")
        return {
            "enabled": True,
            "jobs": statuses[-16:],
            "running": running,
        }

    def diff(self, job_a: int, job_b: int, limit: int = 4096) -> dict:
        a, b = self._job(job_a), self._job(job_b)
        for job in (a, b):
            state = job.status()["state"]
            if state != "done":
                raise RuntimeError(
                    f"sweep {job.job_id} is {state}, not done"
                )
        out = diff_snapshots(a.snapshot_path, b.snapshot_path, limit=limit)
        self._count("diffs")
        self._count("diff_cells", out["cells_changed"])
        return out

    def sweep_twin(self, *args, **kwargs) -> dict:
        raise NotImplementedError(
            "sweep_twin (production against a shadow candidate): not "
            "ported yet (the shadow and tenancy slice (A.7))"
        )

    def stop(self, timeout: float = 10.0) -> None:
        with self._lock:
            self._stopping = True
            jobs = list(self._jobs.values())
        for job in jobs:
            job._cancel.set()
            job._paused.clear()
        deadline = time.monotonic() + timeout
        for job in jobs:
            thread = job._thread
            if thread is not None and thread.is_alive():
                thread.join(max(0.0, deadline - time.monotonic()))

    # -------------------------------------------------------------- helpers

    def _job(self, job_id) -> SweepJob:
        key = int(job_id)
        with self._lock:
            job = self._jobs[key] if key in self._jobs else None
        if job is None:
            raise KeyError(f"unknown sweep job {job_id}")
        return job

    def _urns(self):
        engine = getattr(self.evaluator, "engine", None)
        return getattr(engine, "urns", None)

    def _epoch(self) -> Optional[int]:
        worker = self.worker
        if worker is not None:
            try:
                return int(worker.policy_epoch())
            except Exception:
                return None
        return None

    # ------------------------------------------------------------ the sweep

    def _run(self, job: SweepJob) -> None:
        job.started_monotonic = time.monotonic()
        writer: Optional[SnapshotWriter] = None
        try:
            writer = SnapshotWriter(
                job.snapshot_path, job.spec, source=job.target,
                policy_epoch=job.policy_epoch,
                meta={"job": job.job_id, "chunk_size": self.chunk_size},
            )
            for chunk in job.spec.chunks(self.chunk_size):
                # a paused job waits here; cancel ends the wait at once
                while job._paused.is_set() and not job._cancel.is_set():
                    job._cancel.wait(0.02)
                if job._cancel.is_set():
                    break
                if self.batcher is not None:
                    verdicts = self._eval_bulk(job, chunk)
                else:
                    verdicts = self._eval_direct(self.evaluator, chunk)
                for (index, _), verdict in zip(chunk, verdicts):
                    writer.write(index, verdict)
                with job._lock:
                    job.cells_done += len(chunk)
                    job.chunks_done += 1
                    job.sheds += sum(
                        1 for v in verdicts if v.shed_code is not None
                    )
                self._count("cells", len(chunk))
                self._count("chunks")
                if self.chunk_pause_s:
                    job._cancel.wait(self.chunk_pause_s)
            summary = writer.close()
            writer = None
            with job._lock:
                job.summary = summary
                job.wall_s = time.monotonic() - job.started_monotonic
                job.state = "cancelled" if job._cancel.is_set() else "done"
            self._count(
                "jobs_cancelled" if job._cancel.is_set()
                else "jobs_completed"
            )
        except Exception as exc:  # a failed audit must never take the
            # caller down with it -- the job records the error honestly
            with job._lock:
                job.state = "failed"
                job.error = f"{type(exc).__name__}: {exc}"
            self._count("jobs_failed")
            self.logger.warning(
                "audit sweep %d failed", job.job_id,
                extra={"error": job.error},
            )
        finally:
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass
            job._finished.set()

    def _eval_direct(self, evaluator, chunk: list) -> list:
        trees = evaluator.what_is_allowed_batch([r for _, r in chunk])
        return [fold_reverse_query(rq) for rq in trees]

    def _eval_bulk(self, job: SweepJob, chunk: list) -> list:
        """BULK-class dispatch: every cell goes through admission as the
        bulk class and waits out ``bulk_interval`` pacing under load —
        the interactive queue never sees audit traffic.  Shed cells
        (429/503/504) retry up to ``max_retries`` with a short backoff,
        then land in the snapshot as honest INDETERMINATE + shed code
        rather than a fabricated verdict."""
        futures = [
            self.batcher.submit_reverse(request) for _, request in chunk
        ]
        verdicts: list = []
        for slot, future in enumerate(futures):
            rq = future.result(timeout=self.cell_timeout_s)
            verdict = fold_reverse_query(rq)
            attempt = 0
            while (
                verdict.shed_code is not None
                and attempt < self.max_retries
                and not job._cancel.is_set()
            ):
                attempt += 1
                with job._lock:
                    job.retries += 1
                self._count("retries")
                # a cancel ends the backoff at once
                job._cancel.wait(0.005 * attempt)
                retry = self.batcher.submit_reverse(chunk[slot][1])
                verdict = fold_reverse_query(
                    retry.result(timeout=self.cell_timeout_s)
                )
            if verdict.shed_code is not None:
                self._count("sheds")
            verdicts.append(verdict)
        return verdicts


def from_config(
    cfg,
    worker=None,
    evaluator=None,
    batcher=None,
    telemetry=None,
    logger=None,
) -> Optional[AuditSweepManager]:
    """Build the manager from the ``audit`` config block (any object with
    ``.get``); None unless ``audit:enabled`` — the serving path stays
    byte-identical with the subsystem off (no manager object, no command
    surface, no threads)."""
    if not cfg.get("audit:enabled", False):
        return None
    evaluator = evaluator or getattr(worker, "evaluator", None)
    if evaluator is None:
        return None
    return AuditSweepManager(
        evaluator,
        batcher=batcher if batcher is not None
        else getattr(worker, "batcher", None),
        worker=worker,
        telemetry=telemetry,
        logger=logger,
        out_dir=cfg.get("audit:out_dir"),
        chunk_size=cfg.get("audit:chunk_size", 256),
        cell_timeout_s=cfg.get("audit:cell_timeout_s", 60.0),
        max_retries=cfg.get("audit:max_retries", 3),
        chunk_pause_ms=cfg.get("audit:chunk_pause_ms", 0.0),
        default_lattice=cfg.get("audit:lattice", {}) or {},
    )
