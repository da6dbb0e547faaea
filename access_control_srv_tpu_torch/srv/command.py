"""Command interface: operational commands over the service.

Framework analog of the reference's chassis CommandInterface subclass
(reference: src/accessControlService.ts:129-150 + chassis-srv command
interface): restore / reset / version / health_check / config_update /
flush_cache / set_api_key, each also invocable via the command topic.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

from .. import __version__


class CommandInterface:
    def __init__(self, cfg, service, store=None, bus=None, cache=None,
                 decision_cache=None, admission=None, observability=None,
                 logger=None, worker=None):
        self.cfg = cfg
        self.service = service
        self.store = store
        self.cache = cache
        self.decision_cache = decision_cache
        self.admission = admission
        self.observability = observability
        self.logger = logger
        self.worker = worker  # cluster-tier surfaces (epoch, identity)
        self.api_key: Optional[str] = None
        # acs-lint: ignore[wall-clock] human-facing uptime epoch stamp —
        # never used in deadline or TTL arithmetic
        self.start_time = time.time()
        if bus is not None:
            bus.topic("io.restorecommerce.command").on(self._on_command)

    def _on_command(self, event_name: str, message: Any, ctx: dict) -> None:
        # the reference fans every *Command event into the command interface
        # (reference: src/worker.ts:347, cfg events list incl.
        # flushCacheCommand/restoreCommand/...)
        if event_name != "command" and not event_name.endswith("Command"):
            return
        name = (message or {}).get("name")
        payload = (message or {}).get("payload")
        if isinstance(payload, dict) and "value" in payload:
            raw = payload["value"]
            if isinstance(raw, (bytes, bytearray)):
                raw = raw.decode()
            try:
                payload = json.loads(raw)
            except (TypeError, ValueError):
                payload = {}
        self.command(name, payload or {})

    def command(self, name: str, payload: dict | None = None) -> dict:
        payload = payload or {}
        handler = {
            "restore": self.restore,
            "reset": self.reset,
            "version": self.version,
            "health_check": self.health_check,
            "config_update": self.config_update,
            "flush_cache": self.flush_cache,
            "set_api_key": self.set_api_key,
            "metrics": self.metrics,
            "traces": self.traces,
            "profile": self.profile,
            "program_identity": self.program_identity,
            "stage_stats": self.stage_stats,
            "kernel_launches": self.kernel_launches,
            "faults": self.faults,
            "shadow_status": self.shadow_status,
            "audit_sweep": self.audit_sweep,
        }.get(name)
        if handler is None:
            return {"error": f"unknown command {name!r}"}
        return handler(payload)

    # -------------------------------------------------------------- commands

    def restore(self, payload: dict) -> dict:
        """Reload resource state, then clear + reload the in-memory policy
        tree (reference: accessControlService.ts:137-143)."""
        if self.store is not None:
            self.store.load()
        else:
            self.service.engine.clear_policies()
            self.service.load_policies()
        return {"status": "restored"}

    def reset(self, payload: dict) -> dict:
        """Clear state, then reload policies
        (reference: accessControlService.ts:144-149)."""
        self.service.engine.clear_policies()
        if self.store is not None:
            for collection in self.store.collections.values():
                collection.clear()
            self.store.load()
        if self.service.evaluator is not None:
            self.service.evaluator.refresh()
        return {"status": "reset"}

    def version(self, payload: dict) -> dict:
        return {"version": __version__, "name": self.cfg.get("service:name")}

    def health_check(self, payload: dict) -> dict:
        """Readiness = the policy tree is present and the evaluator answers
        (the Arango-readiness analog, reference: src/worker.ts:189-194)."""
        healthy = True
        detail = {}
        try:
            detail["policy_sets"] = len(self.service.engine.policy_sets)
            telemetry = getattr(self.service, "telemetry", None)
            if telemetry is not None:
                # interpolated percentile estimates, not raw bucket
                # arrays — the operator-facing latency signal
                latency = {}
                for name, hist in (
                    ("is_allowed", telemetry.is_allowed_latency),
                    ("what_is_allowed", telemetry.what_is_allowed_latency),
                    ("batch", telemetry.batch_latency),
                ):
                    snap = hist.snapshot()
                    if snap["count"]:
                        latency[name] = {
                            "count": snap["count"],
                            "p50_ms": round(snap["p50_s"] * 1e3, 3)
                            if snap["p50_s"] is not None else None,
                            "p95_ms": round(snap["p95_s"] * 1e3, 3)
                            if snap["p95_s"] is not None else None,
                            "p99_ms": round(snap["p99_s"] * 1e3, 3)
                            if snap["p99_s"] is not None else None,
                        }
                if latency:
                    detail["latency"] = latency
            followers = getattr(self.worker, "followers", None)
            if followers is not None and followers.lost is not None:
                # a mesh Worker whose follower channel is lost answers
                # every kernel batch degraded (srv/follower.py): out of
                # rotation until its world restarts
                healthy = False
                detail["follower_channel"] = f"lost: {followers.lost}"
            evaluator = self.service.evaluator
            if evaluator is not None:
                detail["kernel_active"] = evaluator.kernel_active
                if hasattr(evaluator, "delta_stats"):
                    # incremental policy-update efficacy: patch vs
                    # full-compile counts, fallback taxonomy, last
                    # mutation-to-visibility latency and the active
                    # capacity buckets (ops/delta.py)
                    detail["policy_update"] = evaluator.delta_stats()
                if hasattr(evaluator, "shard_identity"):
                    # pod-sharded tier (parallel/pod_shard.py): shard
                    # count, per-shard fingerprints/capacities and the
                    # applied-patch watermarks
                    sharding = evaluator.shard_identity()
                    if sharding is not None:
                        detail["sharding"] = sharding
            decision_cache = self.decision_cache
            if decision_cache is None and evaluator is not None:
                decision_cache = getattr(evaluator, "decision_cache", None)
            if decision_cache is not None:
                # hit/miss/eviction counters + hit ratio on the health
                # surface (the operator-facing cache-efficacy signal)
                detail["decision_cache"] = decision_cache.stats()
            identity_client = getattr(
                self.service.engine, "identity_client", None
            )
            if hasattr(identity_client, "cache_stats"):
                # token-resolution cache efficacy: the host eligibility
                # pipeline's per-batch RPC amortizer (srv/identity.py)
                detail["token_resolution_cache"] = \
                    identity_client.cache_stats()
            if self.admission is not None:
                # overload posture: admitted/shed/deadline counters, live
                # queue depths vs bounds, breaker states, latency
                # estimates (srv/admission.py)
                detail["admission"] = self.admission.stats()
            if self.worker is not None and hasattr(
                self.worker, "policy_epoch"
            ):
                # cluster tier: the replica's policy epoch (count of CRUD
                # log frames reflected in the serving tree) — the router's
                # per-replica convergence signal (srv/router.py)
                detail["policy_epoch"] = self.worker.policy_epoch()
            tenancy = getattr(self.worker, "tenancy", None)
            if tenancy is not None:
                # multi-tenant posture: tenant count, size-class
                # histogram, compiled-program count (the packing claim's
                # operator signal) and per-tenant epoch top-K
                # (srv/tenancy.py, docs/MULTITENANT.md)
                detail["tenancy"] = tenancy.stats()
            watchdog = getattr(self.worker, "watchdog", None)
            if watchdog is not None:
                # device-health posture: quarantine state, timeout/restore
                # counts, cumulative degraded seconds (srv/watchdog.py)
                detail["device_watchdog"] = watchdog.status()
            relation_store = getattr(self.worker, "relation_store", None)
            if relation_store is not None:
                # ReBAC posture: tuple/rewrite counts, store generation,
                # closure-cache size and the table fingerprint replicas
                # must agree on (srv/relations.py) — absent with
                # relations off, so the surface is unchanged
                detail["relations"] = relation_store.stats()
            shadow = getattr(self.worker, "shadow", None)
            if shadow is not None:
                # candidate-tree staging posture: epoch, queue depth,
                # evaluated/diff/drop counts (srv/shadow.py) — absent
                # with shadow off, so the surface is unchanged
                shadow_status = shadow.status()
                shadow_status.pop("samples", None)  # health stays compact
                detail["shadow"] = shadow_status
            audit = getattr(self.worker, "audit", None)
            if audit is not None:
                # sweep-job progress: running count + recent job states
                # (compact — snapshots/diffs stay behind audit_sweep)
                audit_status = audit.status()
                audit_status["jobs"] = [
                    {k: j.get(k) for k in
                     ("job", "target", "state", "cells_done",
                      "cells_total", "sheds")}
                    for j in audit_status.get("jobs", [])
                ]
                detail["audit"] = audit_status
            from .faults import REGISTRY as _faults

            fault_stats = _faults.stats()
            if fault_stats["enabled"] or fault_stats["hits_by_site"]:
                # only present when faults are (or were) armed — a clean
                # worker's health surface is unchanged
                detail["failpoints"] = fault_stats
            bus = getattr(self.worker, "bus", None)
            if hasattr(bus, "snapshot_status"):
                # broker durability posture: snapshot existence, offset
                # watermark, journal tail length, snapshot age (broker-
                # side RPC; unreachable broker must not fail the check)
                try:
                    detail["broker_snapshot"] = bus.snapshot_status()
                except Exception:  # noqa: BLE001 — health stays serving
                    pass
        except Exception as err:  # pragma: no cover
            healthy = False
            detail["error"] = str(err)
        return {
            "status": "SERVING" if healthy else "NOT_SERVING",
            # acs-lint: ignore[wall-clock] human-facing uptime display
            "uptime_s": round(time.time() - self.start_time, 3),
            **detail,
        }

    def config_update(self, payload: dict) -> dict:
        for path, value in (payload or {}).items():
            self.cfg.set(path, value)
        if self.decision_cache is not None and payload:
            # config can change decision semantics (authorization toggles,
            # adapter endpoints): logically flush cached decisions
            self.decision_cache.bump_epoch()
        return {"status": "updated", "keys": list((payload or {}).keys())}

    def flush_cache(self, payload: dict) -> dict:
        """Reference flush_cache payload semantics: ``{"data": {"db_index":
        N, "pattern": P}}`` — db_index selects which store flushes (the
        subject cache's Redis-DB-4 analog vs the decision cache's DB-5
        analog, cfg ``redis:db-indexes``); absent db_index flushes both;
        pattern narrows to a subject-id prefix (reference: chassis
        flush_cache + utils.ts flushACSCache).  A ``tenant`` key scopes
        the decision-cache flush to that tenant's namespace — without it
        a fleet-wide flush for one tenant's user churn would evict every
        OTHER tenant's cached decisions too (cross-tenant eviction is
        both a perf bug and an isolation leak)."""
        data = (payload or {}).get("data", payload) or {}
        pattern = data.get("pattern", "") or ""
        tenant = data.get("tenant")
        tenant = str(tenant) if tenant else None
        db_index = data.get("db_index")
        db_subject = int(self.cfg.get("redis:db-indexes:db-subject", 4))
        db_acs = int(self.cfg.get("redis:db-indexes:db-acs", 5))
        if db_index is not None:
            # loosely-typed JSON payloads send "5": coerce before routing
            # so a string index never silently flushes nothing
            try:
                db_index = int(db_index)
            except (TypeError, ValueError):
                return {"error": f"invalid db_index {db_index!r}"}
            if db_index not in (db_subject, db_acs):
                return {
                    "error": f"unrecognized db_index {db_index} "
                             f"(expected {db_subject} or {db_acs})"
                }
        evicted = 0
        flushed = {}
        if self.cache is not None and db_index in (None, db_subject):
            n = self.cache.evict_prefix(
                f"cache:{pattern}" if pattern else ""
            )
            flushed["subject"] = n
            evicted += n
        if self.decision_cache is not None and db_index in (None, db_acs):
            n = self.decision_cache.evict_pattern(pattern, tenant=tenant)
            flushed["decisions"] = n
            evicted += n
        return {"status": "flushed", "evicted": evicted, "flushed": flushed}

    def metrics(self, payload: dict) -> dict:
        """Latency histograms + decision/path counters (SURVEY.md §5:
        request-latency histograms at the serving shell).  Payload
        ``{"format": "prometheus"}`` renders the same registry in
        Prometheus text exposition format — the command-interface twin of
        the optional /metrics endpoint (observability:metrics_http)."""
        telemetry = getattr(self.service, "telemetry", None)
        if telemetry is None:
            return {"error": "telemetry not wired"}
        if (payload or {}).get("format") == "prometheus":
            from .telemetry import MetricsRegistry

            return {
                "content_type": MetricsRegistry.CONTENT_TYPE,
                "body": telemetry.prometheus(),
            }
        return telemetry.snapshot()

    def traces(self, payload: dict) -> dict:
        """Recent sampled span trees (observability:tracing, bounded ring
        buffer): ``{"n": K}`` limits to the most recent K."""
        obs = self.observability
        if obs is None or obs.tracer is None:
            return {"error": "tracing not enabled "
                             "(observability config absent or off)"}
        n = (payload or {}).get("n")
        return {"traces": obs.tracer.traces(int(n) if n else None)}

    def profile(self, payload: dict) -> dict:
        """Device profiler control: an operator starts / stops a
        ``torch.profiler`` trace (CPU and, where present, CUDA activity)
        at runtime to see where the microseconds go — {"action":
        "start"|"stop", "dir": path}.  ``stop`` writes a Chrome trace
        (Perfetto / chrome://tracing) into the directory."""
        action = (payload or {}).get("action")
        if action == "start":
            if getattr(self, "_profiler", None) is not None:
                return {"error": "trace start failed: a trace is running"}
            import tempfile

            import torch

            log_dir = (payload or {}).get("dir") or os.path.join(
                tempfile.gettempdir(), "acs-trace")
            try:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                os.makedirs(log_dir, exist_ok=True)
                prof = torch.profiler.profile(activities=activities)
                prof.__enter__()
            except Exception as err:
                return {"error": f"trace start failed: {err}"}
            self._profiler = prof
            self._trace_dir = log_dir
            return {"status": "tracing", "dir": log_dir}
        if action == "stop":
            prof = getattr(self, "_profiler", None)
            if prof is None:
                return {"error": "trace stop failed: no trace is running"}
            self._profiler = None
            log_dir = getattr(self, "_trace_dir", None)
            try:
                prof.__exit__(None, None, None)
                path = os.path.join(
                    log_dir, f"trace-{os.getpid()}-{time.monotonic_ns()}.json")
                prof.export_chrome_trace(path)
            except Exception as err:
                return {"error": f"trace stop failed: {err}"}
            out = {"status": "stopped", "dir": log_dir, "trace": path}
            self._trace_dir = None
            return out
        return {"error": f"unknown profile action {action!r}"}

    def program_identity(self, payload: dict) -> dict:
        """Cluster-tier convergence probe: the replica's policy epoch,
        its store origin, the pod-sharding breakdown where one serves and
        the device-health routing state and the compiled-table digest
        (``table_fingerprint``): two replicas that applied the same CRUD
        sequence report equal digests."""
        out: dict = {}
        if self.worker is not None and hasattr(self.worker, "policy_epoch"):
            out["policy_epoch"] = self.worker.policy_epoch()
        if self.store is not None:
            out["origin"] = self.store.origin
        evaluator = self.service.evaluator
        if evaluator is not None and hasattr(evaluator, "table_fingerprint"):
            out["table_fingerprint"] = evaluator.table_fingerprint()
        if evaluator is not None and hasattr(evaluator, "shard_identity"):
            # pod-sharded tier: the per-shard fingerprints roll into one
            # pod fingerprint (already folded into table_fingerprint
            # above, so the cluster convergence oracle checks it
            # transparently); the full breakdown rides along for the
            # audit row and operator drill-down
            sharding = evaluator.shard_identity()
            if sharding is not None:
                out["sharding"] = sharding
        if evaluator is not None:
            # device-health routing state: the chaos harness polls these
            # to assert quarantine entry and kernel-path restore
            out["kernel_active"] = evaluator.kernel_active
            out["quarantined"] = bool(getattr(evaluator, "quarantined",
                                              False))
        mesh = getattr(self.worker, "mesh", None)
        followers = getattr(self.worker, "followers", None)
        if mesh is not None or followers is not None:
            # the layout (srv/worker.mesh_layout) and every mesh rank's
            # digest of the tables it serves: equal after every swap
            import torch.distributed as dist

            out["mesh"] = {
                "shape": dict(mesh.shape) if mesh is not None else None,
                "world": dist.get_world_size() if dist.is_initialized()
                else 1,
                "table_fingerprints": evaluator.rank_fingerprints(),
            }
            if followers is not None:
                out["mesh"]["channel"] = dict(followers.stats)
        tenancy = getattr(self.worker, "tenancy", None)
        if tenancy is not None:
            # per-tenant convergence: replicas that applied the same
            # tenant journal report the same epoch digest; the fingerprint
            # map covers evaluators that are built (lazily, on traffic)
            out["tenancy"] = {
                "tenant_count": len(tenancy.tenant_ids()),
                "epoch_digest": tenancy.epoch_digest(),
                "compiled_programs": tenancy.compiled_program_count(),
            }
        return out

    def faults(self, payload: dict) -> dict:
        """Runtime failpoint control (srv/faults.py): ``configure`` arms
        a point list on a deterministic seed, ``clear`` disarms and
        releases any hung threads, ``status`` (the default) reports armed
        schedules and per-site hit counts."""
        from .faults import REGISTRY

        payload = payload or {}
        action = payload.get("action", "status")
        if action == "configure":
            try:
                REGISTRY.configure(
                    list(payload.get("points") or []),
                    seed=int(payload.get("seed", 0)),
                )
            except (KeyError, TypeError, ValueError) as err:
                return {"error": f"bad fault spec: {err}"}
            return {"status": "configured", **REGISTRY.stats()}
        if action == "clear":
            REGISTRY.clear()
            return {"status": "cleared"}
        if action == "status":
            return REGISTRY.stats()
        return {"error": f"unknown faults action {action!r}"}

    def shadow_status(self, payload: dict) -> dict:
        """Shadow-evaluation report (srv/shadow.py): candidate epoch,
        evaluated/diff/drop counts, diffs by decision transition, and the
        retained diff samples with deciding-node provenance on both
        sides.  ``{"drain": true}`` blocks briefly until the mirror queue
        empties (policy-CI runs read a settled count); ``{"reload":
        true}`` re-loads the candidate tree from its paths (or
        ``candidate_paths``) and bumps the shadow epoch — production
        serves on, untouched."""
        shadow = getattr(self.worker, "shadow", None)
        if shadow is None:
            return {"enabled": False}
        payload = payload or {}
        if payload.get("reload"):
            try:
                shadow.reload(payload.get("candidate_paths"))
            except Exception as err:  # noqa: BLE001 — report, keep serving
                return {"enabled": True, "error": str(err)}
        if payload.get("drain"):
            shadow.drain(float(payload.get("drain_timeout_s", 5.0)))
        return shadow.status()

    def audit_sweep(self, payload: dict) -> dict:
        """Permission-lattice audit control (srv/audit_sweep.py,
        docs/AUDIT.md).  Actions: ``start`` (``target`` production |
        shadow, optional ``lattice`` axes), ``pause`` / ``resume`` /
        ``cancel`` (``job``), ``status`` (optional ``job``), ``diff``
        (``a``/``b`` job ids), ``twin`` (sweep production + the loaded
        shadow candidate, report lattice diff beside the live-traffic
        diff).  Absent the ``audit:enabled`` config the subsystem does
        not exist and every action answers ``{"enabled": false}``."""
        audit = getattr(self.worker, "audit", None)
        if audit is None:
            return {"enabled": False}
        payload = payload or {}
        action = payload.get("action", "status")
        try:
            if action == "start":
                job = audit.start_sweep(
                    target=payload.get("target", "production"),
                    lattice=payload.get("lattice"),
                    wait=bool(payload.get("wait")),
                    wait_timeout=float(payload.get("wait_timeout_s", 600.0)),
                )
                return job.status()
            if action in ("pause", "resume", "cancel"):
                return getattr(audit, action)(payload["job"])
            if action == "status":
                return audit.status(payload.get("job"))
            if action == "diff":
                return audit.diff(
                    payload["a"], payload["b"],
                    limit=int(payload.get("limit", 4096)),
                )
            if action == "twin":
                return audit.sweep_twin(
                    lattice=payload.get("lattice"),
                    wait_timeout=float(payload.get("wait_timeout_s", 600.0)),
                    diff_limit=int(payload.get("limit", 4096)),
                )
        except Exception as err:  # noqa: BLE001 — report, keep serving
            return {"enabled": True, "error": str(err)}
        return {"error": f"unknown audit_sweep action {action!r}"}

    def stage_stats(self, payload: dict) -> dict:
        """Per-replica stage attribution for cluster benches: the stage
        histograms from srv/tracing.py (count / totals / percentiles per
        stage), optionally cleared first with ``{"clear": true}`` so a
        timed window excludes warmup compiles."""
        telemetry = getattr(self.service, "telemetry", None)
        if telemetry is None:
            return {"error": "telemetry not wired"}
        if (payload or {}).get("clear"):
            telemetry.stages.clear()
            return {"status": "cleared"}
        return {"stages": telemetry.snapshot().get("stages") or {}}

    def kernel_launches(self, payload: dict) -> dict:
        """The CUDA kernel launches this process has made, per kernel
        wrapper (``ops/kernel.LAUNCHES``: each wrapper counts where it
        launches its kernel, so a replica on the CPU reports zeros);
        ``{"reset": true}`` sets every count to 0 after reading it, so a
        caller can read the launches of one window of traffic.  On a mesh
        the launches are summed over the ranks, and ``by_rank`` holds
        each rank's launches and collectives (``parallel/mesh.
        COLLECTIVES``)."""
        from ..ops import kernel
        from ..parallel import mesh

        reset = bool((payload or {}).get("reset"))
        out = {"launches": dict(kernel.LAUNCHES)}
        followers = getattr(self.worker, "followers", None)
        if followers is not None:
            # a mesh worker: every rank's counts, and the launches summed
            # over ranks
            ranks = [{"launches": out["launches"],
                      "collectives": dict(mesh.COLLECTIVES)}]
            ranks += followers.query("launches", reset=reset)
            out = {"launches": {k: sum(r["launches"][k] for r in ranks)
                                for k in kernel.LAUNCHES},
                   "by_rank": ranks}
        if reset:
            for counts in (kernel.LAUNCHES, mesh.COLLECTIVES):
                for name in counts:
                    counts[name] = 0
        return out

    def set_api_key(self, payload: dict) -> dict:
        self.api_key = (payload or {}).get("authentication", {}).get("apiKey") or (
            payload or {}
        ).get("apiKey")
        return {"status": "set"}
