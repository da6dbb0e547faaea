"""Layered configuration with colon-path access.

Framework analog of the reference's nconf-style service-config
(reference: @restorecommerce/service-config usage, cfg.get('a:b:c') across
src/worker.ts and src/core): a base document overlaid with an environment
document (config_{ENV}.json) and runtime ``set`` mutations (tests mutate
config live, reference: test/microservice.spec.ts:91-93).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Any

DEFAULT_CONFIG: dict = {
    "service": {"name": "access-control-srv-tpu"},
    "authorization": {
        "enabled": False,
        "enforce": False,
        # reference default is 300 000 ms (accessController.ts:753) — far
        # too long to park a serving thread; operators can raise it back
        "hrReqTimeout": 15_000,
    },
    "policies": {
        "type": "local",  # local | database
        "options": {"urns": {}, "combiningAlgorithms": []},
    },
    "evaluator": {
        "backend": "hybrid",  # oracle | kernel | hybrid
        "micro_batch_window_ms": 2,
        "micro_batch_max": 4096,
        # device pipeline depth — the SINGLE source of truth for how many
        # batches may be in flight between collection and decode.  Read by
        # the micro-batcher (srv/batcher.py), the streaming wire pipeline
        # (srv/pipeline.py) and admission control's deadline-feasibility
        # estimate (srv/admission.py: pipeline_batches = depth + 1), so
        # rejection math always tracks the real in-flight count.  2 is
        # the legacy depth (one batch evaluating + one queued): the
        # serving path is then byte-identical to pre-pipeline behavior.
        # Depth N>2 turns on the dispatch/finalize split: H2D+eval of
        # batch i overlaps prep of i+1 and decode/serialize of i-1.
        "pipeline_depth": 2,
        # incremental policy updates (ops/delta.py): in-capacity CRUD
        # deltas patch capacity-bucketed tables; false recompiles in full
        # on every mutation.
        "delta_enabled": True,
        # device-hang watchdog (srv/watchdog.py, docs/FAULTS.md).
        # Disabled by default: materialize blocks exactly as before.
        # Enabled: every pipeline/batcher materialize gets a hard
        # deadline; timed-out batches resolve honestly (504 deadline shed
        # or 503 degraded — never a fabricated PERMIT/DENY, never the
        # oracle in the kernel's place), repeated timeouts trip the
        # device circuit breaker which quarantines the kernel path (503
        # degraded on its rows) while a background probe recompiles the
        # kernel and restores it.
        "watchdog": {
            "enabled": False,
            "materialize_timeout_s": 5.0,
            "probe_interval_s": 0.5,
            "breaker": {
                "window_s": 30.0,
                "min_volume": 2,
                "failure_ratio": 0.5,
                "open_s": 1.0,
                "half_open_probes": 1,
            },
        },
    },
    "seed_data": None,
    # device-mesh layout (srv/worker.py).  data_devices: batch-axis data
    # parallelism (int, -1/'all').  model_devices: rule-axis sharding
    # (parallel/rule_shard.py — delta patching disabled).  pod_shards:
    # set-axis pod sharding (parallel/pod_shard.py, docs/SHARDING.md —
    # delta patching stays shard-local); mutually exclusive with
    # model_devices.  This port's worker serves one device and refuses
    # all three (the mesh-serving slice).
    "parallel": {
        "data_devices": None,
        "model_devices": None,
        "pod_shards": None,
    },
    "server": {"transports": [{"provider": "grpc", "addr": "0.0.0.0:50061"}]},
    # db-acs mirrors the reference acs-client decision cache living in
    # Redis DB 5 (reference: cfg/config.json:254-259); flush_cache payloads
    # route on these indexes (srv/command.py)
    "redis": {"db-indexes": {"db-subject": 4, "db-acs": 5}},
    # server-side decision cache (srv/decision_cache.py); ttl_s mirrors the
    # reference's 3600 s TTL
    "decision_cache": {
        "enabled": True,
        "ttl_s": 3600,
        "max_entries": 65536,
        "shards": 16,
    },
    "adapter": {},
    # deadline-aware admission control + overload protection
    # (srv/admission.py, docs/ADMISSION.md).  Disabled by default: the
    # serving path is then byte-identical to pre-admission behavior.
    # Enabled, every request passes a bounded two-class queue (interactive
    # isAllowed vs bulk whatIsAllowed) with deadline-feasibility checks
    # against the batch-latency EWMA; sheds answer INDETERMINATE with the
    # overload operation_status (429 shed / 504 deadline / 503 shutdown),
    # never a fabricated PERMIT/DENY.
    "admission": {
        "enabled": False,
        "max_queue_interactive": 8192,
        "max_queue_bulk": 1024,
        # admit only when remaining budget > estimate * headroom
        "deadline_headroom": 1.2,
        "ewma_alpha": 0.2,
        "ewma_default_ms": 5.0,
        # adaptive max-batch: shrink the collection cap when batch
        # latency overshoots deadline_bound_ms, regrow when comfortable
        "adaptive_max_batch": True,
        "deadline_bound_ms": 50.0,
        "min_batch": 64,
        # graceful shutdown: how long Worker.stop flushes already-admitted
        # batches before failing the rest with the shutdown status
        "drain_deadline_s": 5.0,
        # two-class fairness: a bulk round runs at least every N
        # interactive rounds under saturation
        "bulk_interval": 4,
        # dependency circuit breakers (adapter context queries + identity
        # token resolution): closed/open/half-open with jittered probe
        "breakers": {
            "enabled": True,
            "window_s": 10.0,
            "min_volume": 8,
            "failure_ratio": 0.5,
            "open_s": 2.0,
            "half_open_probes": 2,
        },
        # per-tenant quotas (srv/tenancy.py, docs/MULTITENANT.md): an
        # inflight cap per tenant plus weighted fair sharing of the
        # interactive queue once it is contended (depth >= max_queue *
        # contention_ratio).  Only engages for requests carrying a tenant
        # id; untagged traffic never touches this block.
        "tenant": {
            "enabled": True,
            "max_inflight_per_tenant": 256,
            "default_weight": 1.0,
            # tenant id -> weight overrides for weighted fair sharing
            "weights": {},
            "contention_ratio": 0.5,
        },
    },
    # multi-tenant serving (srv/tenancy.py, docs/MULTITENANT.md).
    # Disabled by default: tenant-tagged requests are served from the
    # default domain exactly as before and no registry object exists.
    # Enabled: the x-acs-tenant metadata key routes each request to its
    # tenant's policy domain; tenants bucket onto fixed capacity classes
    # (SIZE_CLASSES) so same-class tenants share one compiled program per
    # kernel variant, and tenant CRUD journals through the broker topics
    # (boot-by-replay onboarding).
    "tenancy": {
        "enabled": False,
        # evaluator backend for tenant domains (defaults to
        # evaluator:backend)
        "backend": None,
        "max_tenants": 100000,
    },
    # observability (srv/tracing.py, docs/OBSERVABILITY.md).  Disabled by
    # default: with enabled false (or the block absent) NO tracer/audit/
    # exporter object is built and the serving path is byte-identical to
    # pre-observability behavior (tests/test_tracing.py differential).
    # Enabled: stage-span tracing fills Telemetry.stages (Prometheus
    # acs_stage_duration_seconds), sample_rate retains that fraction of
    # requests as full span trees (x-acs-trace-id metadata forces
    # sampling), audit_log.path turns on the sampled JSONL decision-audit
    # sink, metrics_http serves GET /metrics in Prometheus text format.
    "observability": {
        "enabled": False,
        "tracing": {"enabled": True, "sample_rate": 0.01,
                    "max_traces": 256},
        "metrics_http": {"enabled": False, "host": "127.0.0.1",
                         "port": 9464},
        "audit_log": {"path": None, "sample_rate": 0.01},
    },
    # cluster tier (srv/router.py, parallel/cluster.py, docs/CLUSTER.md).
    # Disabled by default: a single worker serves exactly as before.
    # Enabled: N replica processes (each a full Worker against the shared
    # broker, converging through the PolicyReplicator delta path) serve
    # behind a ClusterRouter that load-balances unary calls and whole
    # IsAllowedStream streams, retries shed/failed work on other replicas
    # within the deadline budget, and tracks per-replica policy epochs.
    # broker-backed policy replication (srv/store.PolicyReplicator).
    # catchup_timeout_s bounds the boot-time gate: a (re)starting replica
    # replays the journaled CRUD log and refuses to open its serving port
    # until the tail observed at boot is reflected in its tree, so the
    # router never routes to a half-replayed tree.
    "replication": {
        "enabled": True,
        "catchup_timeout_s": 60.0,
    },
    "cluster": {
        "enabled": False,
        "replicas": 2,
        # router placement + behavior
        "router": {
            "addr": "127.0.0.1:0",
            # health/epoch poll cadence against each replica
            "health_interval_s": 1.0,
            # per-replica circuit breaker (reuses admission breakers'
            # closed/open/half-open machine, srv/admission.py)
            "breaker": {
                "window_s": 5.0,
                "min_volume": 4,
                "failure_ratio": 0.5,
                "open_s": 1.0,
                "half_open_probes": 1,
            },
            # retry a shed/failed unary call on another replica only when
            # this much of the deadline budget remains (fraction)
            "retry_budget_fraction": 0.2,
            "max_retries": 1,
        },
        # multi-process distributed serving per replica; refused by this
        # port's worker (the broker and cluster slice)
        "distributed": {
            "enabled": False,
            "coordinator": "127.0.0.1:8476",
            "num_processes": 1,
        },
    },
    # deterministic fault injection (srv/faults.py, docs/FAULTS.md).
    # Disabled by default: every fire() site is one boolean test and the
    # serving path is byte-identical (tests/test_admission.py
    # differential).  Enabled: `points` arm named sites with
    # error/delay/hang/torn actions on seeded deterministic schedules;
    # the `faults` command (srv/command.py) re-arms/clears at runtime.
    "faults": {
        "enabled": False,
        "seed": 0,
        "points": [],
    },
    # explain mode (srv/explain.py, docs/EXPLAIN.md).  Disabled by
    # default: the kernels run their explain-off variants.  Enabled:
    # every kernel row carries one extra int32 naming the deciding node,
    # decoded host-side onto the response (``_rule_id`` matching the
    # oracle's EffectEvaluation.source bit-for-bit, plus the richer
    # ``_explain`` dict) and into the decision-audit JSONL.
    "explain": {"enabled": False},
    # shadow evaluation (srv/shadow.py, docs/EXPLAIN.md): load a
    # candidate policy tree beside production (refused by this port's
    # worker until the shadow and tenancy slice) and replay live traffic against
    # it off the response path, reporting decision diffs via the
    # ``shadow_status`` command and acs_shadow_diffs_total.  A shadow
    # decision can never alter, delay, or be cached as a production one.
    "shadow": {
        "enabled": False,
        # YAML policy files forming the candidate tree
        "candidate_paths": [],
        # scope mirroring to one tenant's traffic (None = all)
        "tenant": None,
        # retained diff records with both-sides provenance
        "sample_diffs": 32,
        # bounded mirror queue (batches); overflow drops + counts
        "queue_batches": 64,
    },
    # permission-lattice audit sweeps (srv/audit_sweep.py, docs/AUDIT.md).
    # Disabled by default: the worker builds no manager, no threads, no
    # command surface — the serving path is byte-identical.  Enabled:
    # bulk "who-can-do-what" sweeps ride the batcher's BULK class
    # (admission-paced, never the interactive queue) and stream masked
    # JSONL + bitmap snapshots under ``out_dir``.
    "audit": {
        "enabled": False,
        # snapshot artifacts land here (JSONL + .bits.npy sidecars)
        "out_dir": "/tmp/acs-audit",
        # cells per bulk submission round; bounds sweep memory and the
        # bulk queue footprint (must stay under admission:max_queue_bulk)
        "chunk_size": 256,
        # per-cell future wait before the job fails honestly
        "cell_timeout_s": 60.0,
        # shed cells (429/503/504) retry this many times, then land in
        # the snapshot as INDETERMINATE + shed code
        "max_retries": 3,
        # optional extra pacing between chunks on top of bulk_interval
        "chunk_pause_ms": 0.0,
        # default lattice axes (ops/lattice.LatticeSpec.from_config
        # grammar: ints for synthetic stress-shaped axes, or explicit
        # subject/resource/action lists)
        "lattice": {"subjects": 16, "resources": 16, "actions": ["read"]},
    },
    # ReBAC relation tuples (srv/relations.py, docs/REBAC.md).  Disabled
    # by default: no store is built, and relation-bearing policy targets
    # fail closed on every path (oracle and kernel agree).  Enabled: a
    # Zanzibar-style tuple store feeds the stage-B bit-reader's relation
    # planes; tuple CRUD rides the journaled topic below (broker bus =
    # shared durable tuple store, replayed at boot, origin-skip live).
    "relations": {
        "enabled": False,
        "topic": "io.restorecommerce.relation-tuples.resource",
    },
    "logger": {"maskFields": ["password", "token"]},
}


def _deep_merge(base: dict, overlay: dict) -> dict:
    out = copy.deepcopy(base)
    for key, value in overlay.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _deep_merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


class Config:
    def __init__(self, data: dict | None = None, env: str | None = None):
        self._data = _deep_merge(DEFAULT_CONFIG, data or {})
        self.env = env or os.environ.get("ACS_ENV", "")

    @classmethod
    def load(cls, directory: str, env: str | None = None) -> "Config":
        env = env or os.environ.get("ACS_ENV", "")
        data: dict = {}
        base = os.path.join(directory, "config.json")
        if os.path.exists(base):
            with open(base) as fh:
                data = json.load(fh)
        if env:
            overlay_path = os.path.join(directory, f"config_{env}.json")
            if os.path.exists(overlay_path):
                with open(overlay_path) as fh:
                    data = _deep_merge(data, json.load(fh))
        return cls(data, env=env)

    def get(self, path: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in path.split(":"):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, path: str, value: Any) -> None:
        parts = path.split(":")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def as_dict(self) -> dict:
        return copy.deepcopy(self._data)
