"""Composition root: wires the engine, evaluator, store, cache, command
interface and event listeners into a running service
(reference: src/worker.ts Worker.start/stop:105-372).

The port's copy of the JAX package's ``srv/worker.py`` for one device:
``Worker.start(cfg, device=None)`` serves on the CUDA device (raising
without one, as ``ops.kernel.resolve_device`` does) or on the device
named; on the CUDA device it loads every kernel library of its path
at start, so a replica whose libraries fail to load fails at boot.
``evaluator:delta_enabled`` (default true) turns on the evaluator's
incremental updates (CRUD deltas patch capacity-bucketed tables,
ops/delta.py); false recompiles in full on every mutation.

``events:broker:address`` switches the event bus, the offset store and
the subject cache to the broker's socket backends (``srv/broker.py``), so
the HR-scope rendezvous runs across processes; over a broker,
``replication:enabled`` (default true) starts the ``PolicyReplicator``,
which replays the journaled CRUD log before ``start`` returns and then
applies other replicas' frames through ``PolicyStore.load(events=...)``,
the same delta path a local CRUD takes.  ``audit:enabled`` builds the
audit-sweep manager in its worker mode (BULK-class cells through the
batcher).  ``cluster:enabled`` is read by nothing beyond its default,
as in JAX.

``parallel:data_devices`` / ``model_devices`` / ``pod_shards`` build
the JAX worker's mesh layouts (the same parsing, validation texts and
clamps; the devices counted are the ranks of the ``torch.distributed``
world, which ``python -m access_control_srv_tpu_torch`` joins under
``cluster:distributed`` before the worker starts, and a worker with a
layout and no process group has a world of 1).  The worker is rank 0:
it serves, and every batch, build and swap that reaches its kernel goes
in one order to the follower loop of every other rank
(``srv/follower.py``).  ``start`` returns once every rank has compiled
the tree; ``stop`` stops every follower.

Refused with ``NotImplementedError`` naming the slice that brings them:
tenancy and shadow evaluation (``tenancy:enabled``, ``shadow:enabled``).
With each of them off, as in ``cfg/config.json``, the worker holds None
in its place, as the JAX worker does.
"""

from __future__ import annotations

import threading
from datetime import timedelta
from typing import Optional

import torch.distributed as dist

from ..core.engine import AccessController
from ..ops.kernel import load_libraries, resolve_device
from ..models.model import Decision
from ..models.urns import Urns
from .admission import AdmissionController
from .batcher import MicroBatcher
from .cache import HRScopeProvider, SubjectCache, compare_role_associations
from .command import CommandInterface
from .config import Config
from .decision_cache import from_config as decision_cache_from_config
from .evaluator import HybridEvaluator
from .events import CRUD_TOPICS, EventBus, OffsetStore, on_topics
from .identity import StaticIdentityClient
from .service import AccessControlService
from .store import PolicyStore
from .telemetry import Telemetry, make_logger


def _yaml_list(path: str) -> list[dict]:
    import yaml

    with open(path) as fh:
        docs = list(yaml.safe_load_all(fh))
    items: list[dict] = []
    for doc in docs:
        if isinstance(doc, list):
            items.extend(doc)
        elif doc:
            items.append(doc)
    return items


# config switches whose subsystems this port does not carry yet, with the
# slice that brings each (ROADMAP A.7)
_UNPORTED = (
    ("tenancy:enabled", "multi-tenant serving (srv/tenancy.py)",
     "the shadow and tenancy slice (A.7)"),
    ("shadow:enabled", "shadow evaluation (srv/shadow.py)",
     "the shadow and tenancy slice (A.7)"),
)


def parse_devices(cfg: Config, key: str) -> Optional[int]:
    """A ``parallel:*`` device count as the JAX worker reads it: None when
    unset, -1 for ``"all"`` / ``-1``, else a positive integer."""
    n_req = cfg.get(key)
    if not n_req:
        return None
    if isinstance(n_req, str):
        n_req = n_req.strip().lower()
    if n_req in ("all", "-1", -1):
        return -1
    try:
        n_req = int(n_req)
    except (TypeError, ValueError):
        raise ValueError(
            f"{key} must be a positive integer, -1, or 'all'; "
            f"got {n_req!r}"
        ) from None
    if n_req <= 0:
        raise ValueError(
            f"{key} must be a positive integer, -1, or 'all'; "
            f"got {n_req!r}"
        )
    return n_req


def mesh_layout(cfg: Config) -> Optional[dict]:
    """The JAX worker's layout of ``parallel:*`` (its validations and
    clamps, the device count being the world's ranks): None for one
    device, else ``{"kind": "pod" | "rule" | "data", "n_data", "n_model"
    (None on the data layout), "data_axis", "model_axis", "pod_shards",
    "available"}``.  Raises the JAX worker's ``ValueError`` texts."""
    n_data_req = parse_devices(cfg, "parallel:data_devices")
    n_model_req = parse_devices(cfg, "parallel:model_devices")
    n_pod_req = parse_devices(cfg, "parallel:pod_shards")
    if n_model_req == -1:
        raise ValueError(
            "parallel:model_devices must be an explicit integer "
            "(the rule-axis shard count is a layout choice, not "
            "'all available')"
        )
    if n_pod_req == -1:
        raise ValueError(
            "parallel:pod_shards must be an explicit integer "
            "(the set-axis shard count is a layout choice, not "
            "'all available')"
        )
    if n_pod_req and n_model_req:
        raise ValueError(
            "parallel:pod_shards (set-axis) and "
            "parallel:model_devices (rule-axis) are mutually "
            "exclusive layouts for the model mesh axis"
        )
    avail = dist.get_world_size() if dist.is_initialized() else 1
    data_axis = cfg.get("parallel:axis", "data")
    model_axis = cfg.get("parallel:model_axis", "model")
    layout = {"data_axis": data_axis, "model_axis": model_axis,
              "pod_shards": None, "n_model": None, "available": avail}
    n_shard = n_pod_req or (
        n_model_req if n_model_req and n_model_req > 1 else None)
    if n_shard:
        # pod-sharded (the SET axis over the model axis; n_pod_req == 1
        # still builds the mesh) or rule-sharded: a 2-axis mesh
        if n_data_req in (None, -1):
            n_data = max(1, avail // n_shard)
        else:
            # same clamp-to-available contract as the single-axis path
            n_data = max(1, min(n_data_req, avail // n_shard))
        layout.update(kind="pod" if n_pod_req else "rule", n_data=n_data,
                      n_model=n_shard, pod_shards=n_pod_req)
        return layout
    if n_data_req:
        n = avail if n_data_req == -1 else min(n_data_req, avail)
        layout.update(kind="data", n_data=n)
        return layout
    return None


_LAYOUT_ACTIVE = {"pod": "pod-sharded mesh active",
                  "rule": "rule-sharded mesh active",
                  "data": "data-parallel mesh active"}


def build_mesh(layout: dict, device=None):
    """This rank's ``parallel.Mesh`` of a ``mesh_layout``; its
    collectives time out as the world's do (``DIST_TIMEOUT_S``)."""
    from ..parallel import make_mesh, make_mesh2
    from ..parallel.cluster import DIST_TIMEOUT_S

    timeout = timedelta(seconds=DIST_TIMEOUT_S)
    if layout["n_model"] is None:
        return make_mesh(layout["n_data"], axis=layout["data_axis"],
                         device=device, timeout=timeout)
    return make_mesh2(layout["n_data"], layout["n_model"],
                      data_axis=layout["data_axis"],
                      model_axis=layout["model_axis"], device=device,
                      timeout=timeout)


def _refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for a config that turns on a
    subsystem this port does not carry yet; ``profiling:xla_dump_dir``
    has no CUDA counterpart."""
    for key, what, slice_name in _UNPORTED:
        if cfg.get(key):
            raise NotImplementedError(
                f"{key}: {what} is not ported yet ({slice_name})"
            )
    if cfg.get("profiling:xla_dump_dir"):
        raise NotImplementedError(
            "profiling:xla_dump_dir: there is no compiler dump on CUDA; "
            "trace the device with the Command 'profile' action "
            "(torch.profiler, {\"action\": \"start\", \"dir\": ...})"
        )


class Worker:
    def __init__(self):
        self.cfg: Optional[Config] = None
        self.telemetry: Optional[Telemetry] = None
        self.engine: Optional[AccessController] = None
        self.evaluator: Optional[HybridEvaluator] = None
        self.store: Optional[PolicyStore] = None
        self.service: Optional[AccessControlService] = None
        self.command_interface: Optional[CommandInterface] = None
        self.batcher: Optional[MicroBatcher] = None
        self.wire_pipeline = None  # srv/pipeline.DevicePipeline
        self.bus: Optional[EventBus] = None
        self.subject_cache: Optional[SubjectCache] = None
        self.decision_cache = None
        self.admission: Optional[AdmissionController] = None
        self.hr_provider: Optional[HRScopeProvider] = None
        self.identity_client = None
        self.offset_store: Optional[OffsetStore] = None
        self.logger = None
        self.mesh = None
        # srv/follower.Leader: the other ranks' follower loops (None on
        # one process)
        self.followers = None
        self.obs = None  # srv/tracing.Observability (None = disabled)
        self.replicator = None
        self.relation_store = None  # srv/relations.RelationTupleStore
        self.tenancy = None  # srv/tenancy.TenantRegistry (None = off)
        self.watchdog = None  # srv/watchdog.DeviceWatchdog (None = off)
        self.shadow = None  # srv/shadow (not ported: always None)
        self.audit = None  # srv/audit_sweep.AuditSweepManager (worker mode)
        self.device = None  # the torch.device the evaluator serves on
        self._faults_armed = False
        # live CRUD-offset watermark per topic (policy_epoch fallback for
        # workers without a replicator)
        self._epoch_lock = threading.Lock()
        self._crud_offsets: dict = {}  # guarded-by: _epoch_lock

    def start(
        self,
        cfg: Config | dict | None = None,
        logger=None,
        identity_client=None,
        device=None,
    ) -> "Worker":
        self.cfg = cfg if isinstance(cfg, Config) else Config(cfg or {})
        cfg = self.cfg
        # the port's refusals and the layout's validation come before any
        # thread, socket or file is opened, so a refused start leaves
        # nothing to stop
        _refuse_unported(cfg)
        layout = mesh_layout(cfg)
        if dist.is_initialized() and dist.get_rank() != 0:
            raise ValueError(
                f"rank {dist.get_rank()} of a distributed world runs the "
                "follower loop (srv/follower.serve), not a Worker")
        # None = the CUDA device; raises without one
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every kernel library of the single-device path, loaded (or
            # built, where none is in _build/) before anything is served:
            # a library that fails to load fails the start
            load_libraries()
        json_sink = cfg.get("logging:json_sink")
        if logger is None:
            import logging as _logging

            pre = set(
                id(h) for h in
                _logging.getLogger("access-control-srv-tpu").handlers
            )
            self.logger = make_logger(json_sink=json_sink)
            # close on stop ONLY the handlers THIS start call installed:
            # a second worker sharing the sink keeps logging through the
            # handler it found already attached
            self._log_handlers = [
                h for h in self.logger.handlers
                if id(h) not in pre
                and getattr(h, "_acs_json_sink", None) == json_sink
            ]
        else:
            self.logger = logger
            self._log_handlers = []
        self.telemetry = Telemetry()

        # observability hub (srv/tracing.py, docs/OBSERVABILITY.md):
        # stage-span tracing, sampled decision-audit log and the optional
        # /metrics endpoint.  None unless the `observability` config block
        # is enabled — absent/disabled, the serving path stays
        # byte-identical to pre-observability behavior (differential:
        # tests/test_tracing.py)
        from .tracing import Observability

        self.obs = Observability.from_config(
            cfg, telemetry=self.telemetry, logger=self.logger
        )

        # event bus + offsets + subject cache: in-process by default;
        # a configured broker address switches all three to the
        # cross-process TCP backend (srv/broker.py — the reference's
        # separate Kafka + Redis processes, cfg events.kafka / redis)
        broker_address = cfg.get("events:broker:address")
        if broker_address:
            from .broker import (
                SocketEventBus,
                SocketOffsetStore,
                SocketSubjectCache,
            )

            broker_secret = cfg.get("events:broker:secret")
            self.bus = SocketEventBus(broker_address, secret=broker_secret)
            self.offset_store = SocketOffsetStore(
                broker_address, secret=broker_secret
            )
            self.subject_cache = SocketSubjectCache(
                broker_address, secret=broker_secret
            )
        else:
            self.bus = EventBus()
            self.offset_store = OffsetStore()
            self.subject_cache = SubjectCache()
        auth_topic = self.bus.topic("io.restorecommerce.authentication")
        self.hr_provider = HRScopeProvider(
            self.subject_cache,
            auth_topic,
            timeout_ms=cfg.get("authorization:hrReqTimeout", 15_000),
            logger=self.logger,
        )
        # server-side decision cache (srv/decision_cache.py): TTL +
        # LRU-bounded cache of evaluation_cacheable decisions, invalidated
        # by CRUD epoch bumps, user events and flush_cache commands
        self.decision_cache = decision_cache_from_config(
            cfg, telemetry=self.telemetry
        )

        # admission control (srv/admission.py): deadline-aware bounded
        # queues + shedding at the batcher, dependency circuit breakers
        # on the adapter/identity clients, graceful drain on stop.
        # Disabled (the default) the controller admits unconditionally
        # and the serving path is byte-identical to pre-admission code.
        self.admission = AdmissionController.from_config(
            cfg, telemetry=self.telemetry
        )

        # identity client: a live gRPC channel when the config names an
        # identity-service address (reference: src/worker.ts:135-143),
        # otherwise the in-memory static map
        if identity_client is not None:
            self.identity_client = identity_client
        else:
            ids_address = cfg.get("client:user:address") or cfg.get(
                "client:identity:address"
            )
            if ids_address:
                from .identity import GrpcIdentityClient

                self.identity_client = GrpcIdentityClient(
                    ids_address,
                    timeout=float(cfg.get("client:identity:timeout", 5.0)),
                    logger=self.logger,
                    cache_size=int(cfg.get(
                        "client:identity:cache:max_entries", 1024
                    )),
                    ttl_s=float(cfg.get(
                        "client:identity:cache:ttl_s", 600.0
                    )),
                    negative_ttl_s=float(cfg.get(
                        "client:identity:cache:negative_ttl_s", 30.0
                    )),
                    counter=self.telemetry.identity,
                    breaker=self.admission.breaker("identity"),
                )
            else:
                self.identity_client = StaticIdentityClient()

        # the engine + evaluator
        urns = Urns(cfg.get("policies:options:urns") or {})
        combining = cfg.get("policies:options:combiningAlgorithms") or None
        self.engine = AccessController(
            urns=urns,
            combining_algorithms=combining,
            logger=self.logger,
            identity_client=self.identity_client,
            hr_scope_provider=self.hr_provider,
        )
        adapter_cfg = cfg.get("adapter") or {}
        if adapter_cfg.get("graphql"):
            self.engine.create_resource_adapter(
                adapter_cfg, breaker=self.admission.breaker("adapter")
            )
        # multi-device serving: `parallel:data_devices` (int, or "all")
        # shards request batches over a data-parallel mesh;
        # `parallel:model_devices` (int > 1) also shards the RULE axis
        # of the compiled tables over a second mesh axis
        # (parallel/rule_shard.py), `parallel:pod_shards` the SET axis
        # (parallel/pod_shard.py, patched shard-locally).  The devices
        # are the ranks of the process group; every other rank follows
        # this one's kernel calls (srv/follower.py).  Unset keeps
        # single-device dispatch.
        mesh = None
        model_axis = pod_shards = None
        if layout is not None:
            mesh = build_mesh(layout, device)
            self.device = mesh.device
            model_axis = layout["model_axis"] if layout["n_model"] else None
            pod_shards = layout["pod_shards"]
            self.logger.info(
                _LAYOUT_ACTIVE[layout["kind"]],
                extra={"shape": dict(mesh.shape),
                       "available": layout["available"]},
            )
        self.mesh = mesh
        if dist.is_initialized() and dist.get_world_size() > 1:
            # the other ranks' follower loops: built before the evaluator,
            # whose first compile they follow
            from .follower import Leader

            self.followers = Leader(mesh, logger=self.logger)
        self.evaluator = HybridEvaluator(
            self.engine,
            backend=cfg.get("evaluator:backend", "hybrid"),
            logger=self.logger,
            async_compile=bool(cfg.get("evaluator:async_compile", False)),
            telemetry=self.telemetry,
            mesh=mesh,
            mesh_axis=layout["data_axis"] if layout else "data",
            model_axis=model_axis,
            pod_shards=pod_shards,
            followers=self.followers,
            decision_cache=self.decision_cache,
            # incremental policy updates (ops/delta.py): in-capacity CRUD
            # deltas patch the bucketed tables; false = full recompiles
            delta_enabled=bool(cfg.get("evaluator:delta_enabled", True)),
            observability=self.obs,
            # explain mode (srv/explain.py): kernel rows carry deciding-
            # node provenance
            explain=bool(cfg.get("explain:enabled", False)),
            device=self.device,
        )

        # deterministic fault injection (srv/faults.py): arm the process
        # registry from config — OFF by default, and configure_from leaves
        # the registry disarmed when the block is absent/disabled, so the
        # serving path stays byte-identical (tests/test_admission.py
        # differential)
        from .faults import REGISTRY as _faults_registry
        from .faults import configure_from as _faults_configure

        self._faults_armed = _faults_configure(cfg.get("faults"))
        if self.telemetry is not None:
            _faults_registry.on_hit = self.telemetry.failpoints.inc

        # device-hang watchdog (srv/watchdog.py): bounded materialize +
        # kernel-path quarantine + probe-driven restore.  OFF by default;
        # enabled it attaches to the evaluator so every kernel
        # materialize runs under the deadline.
        wd_cfg = cfg.get("evaluator:watchdog") or {}
        if wd_cfg.get("enabled"):
            from .watchdog import DeviceWatchdog

            self.watchdog = DeviceWatchdog(
                self.evaluator,
                materialize_timeout_s=float(
                    wd_cfg.get("materialize_timeout_s", 5.0)
                ),
                probe_interval_s=float(wd_cfg.get("probe_interval_s", 0.5)),
                breaker_cfg=wd_cfg.get("breaker"),
                telemetry=self.telemetry,
                logger=self.logger,
            )
            if self.telemetry is not None:
                self.telemetry.set_watchdog(self.watchdog)

        # policy store with self-authorization hook; the hook consults the
        # live config so authorization:enabled can be toggled at runtime via
        # config_update (reference: tests drive cfg.set + updateConfig,
        # test/microservice_acs_enabled.spec.ts:379-382)
        self.store = PolicyStore(
            self.engine,
            evaluator=self.evaluator,
            bus=self.bus,
            snapshot_dir=cfg.get("database:snapshot_dir"),
            access_check=self._access_check,
            logger=self.logger,
        )

        # multi-tenant registry: tenancy:enabled is refused above, so
        # every path is the single-tenant one
        self.tenancy = None

        # service facade + command interface + micro-batcher
        self.service = AccessControlService(
            cfg, self.engine, self.evaluator, self.store, self.logger,
            telemetry=self.telemetry, observability=self.obs,
        )
        self.command_interface = CommandInterface(
            cfg,
            self.service,
            store=self.store,
            bus=self.bus,
            cache=self.subject_cache,
            decision_cache=self.decision_cache,
            admission=self.admission,
            observability=self.obs,
            logger=self.logger,
            worker=self,
        )
        self.batcher = MicroBatcher(
            self.evaluator,
            window_ms=cfg.get("evaluator:micro_batch_window_ms", 2),
            max_batch=cfg.get("evaluator:micro_batch_max", 4096),
            admission=self.admission,
            observability=self.obs,
            # single source of truth for in-flight depth — admission's
            # feasibility estimate reads the same config value
            pipeline_depth=cfg.get("evaluator:pipeline_depth", 2),
        )
        self.batcher.tenancy = self.tenancy
        self.batcher.start()
        self.service.batcher = self.batcher

        # streaming wire pipeline (srv/pipeline.py): one depth-bounded
        # device queue shared by every IsAllowedStream client stream;
        # same depth value as the batcher and admission
        from .pipeline import DevicePipeline

        self.wire_pipeline = DevicePipeline(
            self, depth=cfg.get("evaluator:pipeline_depth", 2)
        )

        # event listeners (reference: src/worker.ts:249-361)
        auth_topic.on(self._auth_listener)
        self.bus.topic("io.restorecommerce.users.resource").on(
            self._user_listener
        )
        # always subscribed (not only with a decision cache): the listener
        # also maintains the live CRUD-offset watermark behind
        # policy_epoch() for workers running without a replicator
        on_topics(self.bus, CRUD_TOPICS, self._crud_cache_listener)

        # seed data (reference: src/worker.ts:200-242)
        seed_cfg = cfg.get("seed_data")
        if seed_cfg:
            entities = seed_cfg.get("entities", seed_cfg) if isinstance(
                seed_cfg, dict
            ) else seed_cfg
            self.store.seed(
                _yaml_list(entities["policy_sets"]),
                _yaml_list(entities["policies"]),
                _yaml_list(entities["rules"]),
            )

        # policy load (reference: src/worker.ts:245)
        self.service.load_policies()

        # multi-worker shared policy state: over a broker bus, the
        # journaled CRUD topic logs ARE the shared durable policy store
        # (the reference's shared-Arango role) — replay them at boot and
        # apply live frames from other workers (srv/store.PolicyReplicator)
        self.replicator = None
        if broker_address and cfg.get("replication:enabled", True):
            from .store import PolicyReplicator

            self.replicator = PolicyReplicator(
                self.store, self.bus, logger=self.logger
            )
            # tenant-tagged journal frames route to the registry; tenancy
            # is refused above, so they are dropped
            self.replicator.tenancy = self.tenancy
            self.replicator.start()
            # boot-time catch-up gate: don't return (and so don't let the
            # CLI open the serving port) until the journal tail observed
            # at boot is reflected in the tree — a half-replayed replica
            # would answer INDETERMINATE and the cluster router would
            # happily route to it
            self.replicator.wait_caught_up(
                timeout_s=float(
                    cfg.get("replication:catchup_timeout_s", 60.0)
                )
            )

        # Zanzibar-style relation tuples (srv/relations.py): host-side
        # tuple store behind the stage-B bit-reader's relation planes.
        # Off by default (relations:enabled) — the engine then treats
        # relation-bearing targets fail-closed.  Over a broker bus the
        # journaled tuple topic IS the shared durable tuple store (same
        # role the CRUD topics play for policies): replay at boot, then
        # follow live frames from other workers via origin-skip.
        self.relation_store = None
        if cfg.get("relations:enabled"):
            from .relations import RelationTupleStore

            self.relation_store = RelationTupleStore(
                bus=self.bus,
                topic=cfg.get(
                    "relations:topic",
                    "io.restorecommerce.relation-tuples.resource",
                ),
                logger=self.logger,
                telemetry=self.telemetry,
            )
            self.relation_store.replay()
            self.relation_store.start_replication()
            self.evaluator.attach_relation_store(self.relation_store)

        # shadow evaluation is refused above
        self.shadow = None
        self.service.shadow = None

        # permission-lattice audit sweeps (srv/audit_sweep.py): None
        # unless audit:enabled (the default) — no manager, no threads, no
        # command surface, byte-identical serving path
        from . import audit_sweep as audit_mod

        self.audit = audit_mod.from_config(
            cfg, worker=self,
            telemetry=self.telemetry, logger=self.logger,
        )
        if self.followers is not None:
            # every rank has built the published tables before the caller
            # opens the serving port
            self.followers.sync()
        return self

    def stop(self) -> None:
        if getattr(self, "audit", None) is not None:
            # cancel sweeps before the batcher drains: in-flight bulk
            # futures resolve with the shutdown status and land in the
            # snapshot as honest sheds, never as fabricated verdicts
            self.audit.stop()
            self.audit = None
        if getattr(self, "shadow", None) is not None:
            # stop mirroring before the serving teardown below: the
            # facade tap checks for None, and the shadow owns its own
            # evaluator (joined here, never by the production shutdown)
            self.service.shadow = None
            self.shadow.stop()
            self.shadow = None
        if getattr(self, "watchdog", None) is not None:
            self.watchdog.close()
        if getattr(self, "_faults_armed", False):
            # release any hung threads and disarm — only when THIS worker
            # armed the registry (in-process tests arm via REGISTRY.arm)
            from .faults import REGISTRY as _faults_registry

            _faults_registry.clear()
            self._faults_armed = False
        if getattr(self, "wire_pipeline", None) is not None:
            self.wire_pipeline.stop()
        if self.batcher is not None:
            # graceful drain: stop admitting, flush already-admitted
            # batches bounded by the drain deadline, fail the rest with
            # the shutdown status (srv/batcher.MicroBatcher.stop)
            self.batcher.stop()
        if self.evaluator is not None:
            # join the debounced async-compile worker instead of leaking a
            # thread mid-compile (srv/evaluator.shutdown)
            self.evaluator.shutdown()
        if getattr(self, "followers", None) is not None:
            # nothing reaches the kernel any more: every follower stops
            self.followers.stop()
        if getattr(self, "tenancy", None) is not None:
            self.tenancy.shutdown()
        if getattr(self, "replicator", None) is not None:
            self.replicator.stop()
        if getattr(self, "relation_store", None) is not None:
            self.relation_store.stop()
        if getattr(self, "store", None) is not None:
            for collection in self.store.collections.values():
                collection.close()
        for handler in getattr(self, "_log_handlers", []):
            handler.close()
            if self.logger is not None:
                self.logger.removeHandler(handler)
        for attr in ("bus", "offset_store", "subject_cache"):
            backend = getattr(self, attr, None)
            if backend is not None and hasattr(backend, "close"):
                backend.close()
        if getattr(self, "obs", None) is not None:
            # stop the /metrics endpoint and close the audit sink
            self.obs.close()
        if hasattr(self.identity_client, "close"):
            self.identity_client.close()

    # -------------------------------------------------------- event handlers

    def _auth_listener(self, event_name: str, message, ctx: dict) -> None:
        """hierarchicalScopesResponse -> cache write + waiter release
        (reference: src/worker.ts:252-299)."""
        if event_name == "hierarchicalScopesResponse":
            self.hr_provider.handle_hr_scopes_response(
                message, subject_resolver=self.identity_client.find_by_token
            )

    def _crud_cache_listener(self, event_name: str, message, ctx: dict) -> None:
        """Rule/Policy/PolicySet Created/Modified/Deleted from REMOTE
        workers -> decision-cache epoch flush (their tree mutations make
        cached decisions suspect before the replicator's debounced sync
        lands).  This worker's OWN frames are skipped: the local CRUD path
        already bumped through store hot-sync — with a delta-scoped
        footprint, which an unconditional global bump here would defeat.

        All frames (own included) advance the live CRUD-offset watermark
        behind policy_epoch() — the fallback epoch source when no
        replicator is running."""
        offset = ctx.get("offset")
        topic = ctx.get("topic")
        if isinstance(offset, int) and topic:
            with self._epoch_lock:
                self._crud_offsets[topic] = max(
                    self._crud_offsets.get(topic, -1), offset
                )
        if not event_name.endswith(("Created", "Modified", "Deleted")):
            return
        if (
            isinstance(message, dict)
            and self.store is not None
            and message.get("origin") == self.store.origin
        ):
            return
        if isinstance(message, dict) and message.get("tenant") is not None:
            # tenant-scoped frame: the replicator routes it to the tenant
            # registry, which bumps ONLY that tenant's cache namespace —
            # a global bump here would flush every other tenant's entries
            # on one tenant's CRUD (isolation + perf)
            return
        if self.decision_cache is not None:
            self.decision_cache.bump_epoch()

    def policy_epoch(self) -> int:
        """The replica's policy epoch: number of CRUD log frames reflected
        in the serving tree.  Replicated workers read the replicator's
        applied watermark (replay-inclusive, so replicas that booted at
        different times agree once converged); standalone workers count the
        frames the live listener has seen.  Responses are stamped with this
        value (transport_grpc) so the cluster router and the stale-decision
        oracle can reason about replica state without reading the trees."""
        replicator = getattr(self, "replicator", None)
        if replicator is not None:
            return replicator.epoch
        with self._epoch_lock:
            return sum(off + 1 for off in self._crud_offsets.values())

    def _user_listener(self, event_name: str, message, ctx: dict) -> None:
        """userModified / userDeleted -> subject-cache + decision-cache
        eviction (reference: src/worker.ts:300-345).  A ``tenant`` key on
        the event scopes the decision-cache eviction to the originating
        tenant's namespace: one tenant's user churn must not evict
        another tenant's cached decisions (isolation + perf)."""
        tenant = (message or {}).get("tenant") if isinstance(
            message, dict
        ) else None
        if event_name == "userDeleted":
            user_id = (message or {}).get("id")
            if user_id:
                self.hr_provider.evict_hr_scopes(user_id)
                if self.decision_cache is not None:
                    self.decision_cache.evict_subject(
                        user_id, tenant=tenant
                    )
                # the event carries no token list; the resolution cache
                # indexes entries by payload subject id for exactly this
                if hasattr(self.identity_client, "evict_subject"):
                    self.identity_client.evict_subject(user_id)
        elif event_name == "userModified":
            user_id = (message or {}).get("id")
            if not user_id:
                return
            # cached decisions fingerprint the subject's resolved role
            # associations, so changed-assoc requests miss anyway — the
            # prefix eviction also clears entries for the OLD associations
            # (reference analog: utils.ts flushACSCache on user mutation)
            if self.decision_cache is not None:
                self.decision_cache.evict_subject(user_id, tenant=tenant)
            # token resolutions for a mutated user are stale regardless of
            # role-association diffing
            if hasattr(self.identity_client, "evict"):
                for token in (message or {}).get("tokens") or []:
                    tok = token.get("token") if isinstance(token, dict) else token
                    if tok:
                        self.identity_client.evict(tok)
            # ...and tokens the event does NOT list (rotated/expired ones
            # the cache may still hold) drop via the subject-id index
            if hasattr(self.identity_client, "evict_subject"):
                self.identity_client.evict_subject(user_id)
            cached = self.subject_cache.get(f"cache:{user_id}:subject")
            if cached is None:
                return
            changed = compare_role_associations(
                (message or {}).get("role_associations") or [],
                cached.get("role_associations") or [],
                self.logger,
            )
            if changed:
                self.hr_provider.evict_hr_scopes(user_id)
                data = {"db_index": 5, "pattern": user_id}
                if tenant is not None:
                    # scope the fleet-wide flush to the originating
                    # tenant's cache namespace
                    data["tenant"] = tenant
                self.bus.topic("io.restorecommerce.command").emit(
                    "flushCacheCommand",
                    {"name": "flush_cache", "payload": {"data": data}},
                )

    # ------------------------------------------------- CRUD self-authorization

    def _access_check(self, kind, items, action, subject, ctx):
        """The service authorizes its own policy CRUD by asking itself
        (reference: checkAccessRequest -> gRPC back into this service's
        isAllowed, src/core/utils.ts:212-261, cfg client.acs-srv = self).
        A disabled authorization config short-circuits to PERMIT
        (reference: utils.ts:216-219)."""
        from ..models.model import Attribute, Request, Target

        if not self.cfg.get("authorization:enabled"):
            return Decision.PERMIT
        # api-key bypass: a subject bearing the operator key set via the
        # set_api_key command (or authentication:apiKey config) skips
        # self-authorization (chassis behavior the reference's suite
        # exercises, microservice_acs_enabled.spec.ts set_api_key flow)
        api_key = None
        if getattr(self, "command_interface", None) is not None:
            api_key = self.command_interface.api_key
        api_key = api_key or self.cfg.get("authentication:apiKey")
        if api_key and subject and subject.get("token") == api_key:
            return Decision.PERMIT

        urns = self.engine.urns
        action_urn = {
            "CREATE": urns.get("create"),
            "MODIFY": urns.get("modify"),
            "DELETE": urns.get("delete"),
            "DROP": urns.get("delete"),
            "READ": urns.get("read"),
        }.get(action, urns.get("read"))
        entity = f"urn:restorecommerce:acs:model:{kind}.{kind.title().replace('_', '')}"
        resources = []
        ctx_resources = []
        for item in items or [{}]:
            resources.append(Attribute(id=urns.get("entity"), value=entity))
            if item.get("id"):
                resources.append(
                    Attribute(id=urns.get("resourceID"), value=item["id"])
                )
                ctx_resources.append(
                    {"id": item["id"], "meta": item.get("meta") or {}}
                )
        subjects = []
        if subject:
            token = subject.get("token")
            if token:
                subjects.append(Attribute(id="token", value=token))
        request = Request(
            target=Target(
                subjects=subjects,
                resources=resources,
                actions=[Attribute(id=urns.get("actionID"), value=action_urn)],
            ),
            context={
                "subject": dict(subject or {}),
                "resources": ctx_resources,
            },
        )
        response = self.service.is_allowed(request)
        return response.decision
