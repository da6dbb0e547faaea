"""Hybrid evaluator: the device kernels fused with the scalar oracle.

The port's counterpart of the JAX package's ``srv/evaluator.py``, in its
uncached form: batched ``isAllowed`` requests are encoded (numpy), carried
to the device and decided by the ``PrefilteredKernel`` (the signature
path's kernels on trees of ``MIN_RULES`` rules or more, the dense
``DecisionKernel`` below); requests outside
the kernel's representable subset, whole trees the compiler rejects, and
condition-abort rows whose error message is ambiguous go to the oracle, so
decisions are bit-identical either way.  On trees of 256 rules or more the
oracle walk is candidate-filtered (``core/candidate_index.py``).

Batched ``whatIsAllowed`` runs the ``ReverseQueryKernel``
(``ops/reverse.py``) on trees of ``REVERSE_MIN_RULES`` rules or more,
built lazily on the first reverse batch and rebuilt after a version
change; smaller trees take the scalar walk.

Relation-path (ReBAC) trees are served through the kernels' relation
variants: ``attach_relation_store`` wires a ``RelationTupleStore``
(``srv/relations.py``), whose flat verdict tables every batch encode packs
into relation-closure bitplanes.  Tuple churn changes decisions without
a recompile or a new kernel build.  Without a store, relation checks fail
closed on the kernel and the oracle alike.

With a ``mesh`` (``parallel/mesh.py``) the kernel choice is the JAX
evaluator's: ``pod_shards`` set -> ``PodShardedKernel`` (the set axis over
``model_axis``, default "model"); else ``model_axis`` set ->
``RuleShardedKernel``; else ``PrefilteredKernel`` with requests sharded
over ``mesh_axis``.  Every rank of the mesh serves the same requests and
gets the whole batch's responses.  On rank 0 of a Worker's world,
``followers`` (``srv/follower.Leader``) carries every full compile's tree
snapshot, every patch's tables, every publish and every kernel batch to
the other ranks, in the order this evaluator makes them (the batch under
the dispatch lock), so all ranks call their kernels in step; a lost
follower fails the batch, which answers the degraded envelope.

Explain mode (``explain=True``) is the JAX evaluator's: every kernel
the evaluator builds emits the provenance code as a fourth output, an
``ExplainDecoder`` (``srv/explain.py``) built at each refresh from the
same tree snapshot as the compiled tables decodes it, and each response
carries ``_rule_id`` (the oracle's source: the deciding rule, or the
no-rules policy) and ``_explain`` (the full dict; on relation-gated rows
with the tuple-path witnesses under ``"relation"``).  Condition-abort
rows carry ``_explain`` naming the aborting rule and no ``_rule_id``, as
the oracle's abort response carries none; oracle rows get the same
``_explain`` shape from the engine's source stamp.

The serving front half is the JAX evaluator's: ``prepare_batch``
resolves every distinct subject token through the engine's identity client
and runs one HR-scope rendezvous per distinct cache key, so resolved token
rows stay on the kernel; a ``decision_cache`` (``srv/decision_cache.py``)
is consulted batch-wide before encode (one epoch snapshot per batch) and
written through from kernel and oracle rows alike, and every refresh and
every relation-tuple write bumps its epoch.  Oracle rows of a tree with a
resource adapter (``srv/adapters.py``) fan out over the adapter's
concurrency bound.

The native wire path (``is_allowed_batch_wire`` / ``_async``) takes
serialized ``acstpu.Request`` bytes: the C++ encoder (``native/``) fills
the row arrays, the kernel decides them, and rows past the floor caps are
re-encoded natively at ``_CAPS_CEIL``.  It returns None, as in JAX, in
explain mode, on trees with host-assisted conditions, with no kernel and
with ``backend="oracle"``; a native build or load failure raises.

Hot policy mutation is the JAX evaluator's (``delta_enabled``, the
default off the rule-sharded path and the oracle backend): compiled
tables are capacity-bucketed (``ops/delta.full_bucketed_compile``, or
``fixed_caps_compile`` into a pinned size class) and a refresh carrying
the store's CRUD ``events`` first tries the delta patcher
(``ops/delta.apply_events``).  A certified-empty diff keeps the tables,
the kernel and the decision cache; an in-capacity delta patches the
host tables, builds a new kernel over them (``PrefilteredKernel`` with
``dynamic_policies``, reusing the runners of ``shared_jits``: no build,
no library load; on the pod path ``PodShardedKernel.patched``, which
re-slices only the shards owning the patched set slots) and publishes it
with a post-swap decision-cache bump scoped to the footprint.  Anything
the patcher cannot certify falls back, its reason counted
(``delta_stats``), to the full recompile: the cache's epoch bumped whole,
the tree deep-copied and compiled again; with ``async_compile`` a
``refresh(wait=False)`` runs it on one debounced background thread (at
most one compile running and one pending).  On both paths the new
tables are published only after their upload to the device has
completed.  ``table_fingerprint`` digests the published tables (the
cluster tier's convergence check).

The serving hooks are the JAX evaluator's: ``telemetry`` path counters
(``_count_path``), the deadline shed of ``is_allowed_batch_async``
(``srv/admission.py``), stage spans for an ``observability`` hub
(``srv/tracing.py``), and the device watchdog (``srv/watchdog.py``:
``_guard_materialize`` bounds each device wait).  Where the port parts
from the JAX evaluator is what a failing device path answers: a batch
whose dispatch or readback raised or timed out, and every batch while
the watchdog holds the kernel path quarantined, gets the never-cacheable
``degraded`` envelope (``srv/admission.degraded_response``, code 503)
on each row, counted under ``device-error-degraded``,
``hang-fallback-degraded`` or ``quarantine-degraded``; the JAX
evaluator answers those rows with the oracle walk.  The tables live on
the card, so a failure there is reported to the caller, never served
from the host in its place.  The oracle still answers the rows the
kernel cannot encode (``batch.eligible`` False), the single-request
path and the ``backend="oracle"`` / no-kernel evaluators, as in JAX.
Kernel dispatches of one evaluator are serialized by a lock: the
prefilter's signature caches, the plane caches and the launch counts
are shared between the serving threads.  Not ported yet: tenancy.
"""

from __future__ import annotations

import copy
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..core.candidate_index import CandidateIndex
from ..core.common import get_field
from ..core.engine import AccessController, apply_resolved_subject
from ..core.relation_path import (
    collect_target_instances,
    relation_paths,
    request_subject_id,
)
from ..models.model import Decision, OperationStatus, Response, ReverseQuery
from ..ops import delta as delta_mod
from ..ops import reverse
from ..ops.compile import DECISION_NAMES, compile_policies
from ..ops.encode import (
    _CAPS_CEIL,
    _CAPS_FLOOR,
    encode_requests,
    fits_floor,
    request_needs,
)
from ..ops.kernel import resolve_device
from ..ops.prefilter import PrefilteredKernel
from ..ops.relation import relation_bits_needed
from .admission import (
    DEADLINE_CODE,
    degraded_response,
    overload_response,
)
from .decision_cache import request_features
from .explain import ExplainDecoder, explain_capacity_ok
from .faults import REGISTRY as _faults
from .telemetry import SampledLogger
from .tracing import (
    STAGE_CACHE,
    STAGE_DECODE,
    STAGE_DEVICE,
    STAGE_ENCODE,
    STAGE_ORACLE,
    STAGE_PREPARE,
    STAGE_WIRE_ENCODE,
)
from .watchdog import DeviceTimeoutError

# trees with fewer rules skip the candidate index (its build and lookups
# cost more than the walk it saves)
CANDIDATE_MIN_RULES = 256


class HybridEvaluator:
    def __init__(self, engine: AccessController,
                 backend: str = "hybrid",  # oracle | kernel | hybrid
                 logger=None, async_compile: bool = False, telemetry=None,
                 mesh=None, mesh_axis: str = "data",
                 model_axis: Optional[str] = None,
                 pod_shards: Optional[int] = None, decision_cache=None,
                 delta_enabled: bool = True, observability=None,
                 shared_jits: Optional[dict] = None, fixed_caps=None,
                 explain: bool = False, device=None, followers=None):
        self.engine = engine
        self.backend = backend
        self.logger = logger
        self.telemetry = telemetry
        self.async_compile = async_compile
        # observability hub (srv/tracing.Observability): stage spans and
        # audit attribution; None keeps every instrumentation site off
        self.obs = observability
        # rate-limited hot-path logging: the per-row warning sites
        # (token-unresolved, oracle fallback) must not turn the logger
        # into the bottleneck when an upstream is down under load
        self._slog = SampledLogger(logger)
        # server-side decision cache (srv/decision_cache.py): consulted
        # batch-wide BEFORE encode so hit rows skip both the device
        # round-trip and the oracle walk; written through from every miss
        # row the engine marks evaluation_cacheable.  Every refresh and
        # every relation-tuple write bumps its epoch.
        self.decision_cache = decision_cache
        # explain mode (srv/explain.py): the kernels' fourth output,
        # decoded onto each response
        self.explain = bool(explain) and backend != "oracle"
        self._explain_decoder: Optional[ExplainDecoder] = None
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.model_axis = model_axis
        self.pod_shards = pod_shards
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self._version = 0
        self._compiled = None
        self._kernel = None  # see _make_kernel
        self._rq_kernel: Optional[reverse.ReverseQueryKernel] = None
        self._tree_snapshot = None
        self._native_encoder = None  # see _make_native_encoder
        # candidate index over the LIVE engine tree: oracle rows skip rules
        # that provably cannot target-match.  Published as ONE (tree,
        # index) tuple so readers see a consistent pair; a hot
        # replace_policy_sets swap fails the identity check at once and
        # the refresh that follows rebuilds it.
        self._cand: Optional[tuple] = None
        # tuple writes seen by an attached relation store
        self.relation_churn = 0
        self._lock = threading.Lock()
        # one kernel dispatch at a time per evaluator: the serving threads
        # (transport handlers, batcher pools, the stream pipeline) share
        # the prefilter's signature caches, the reverse kernel's plane
        # cache and the launch counts
        self._dispatch_lock = threading.Lock()
        # srv/follower.Leader on rank 0 of a mesh: every build, swap and
        # kernel batch goes to the other ranks in this process's order
        self._followers = followers
        self._compile_thread: Optional[threading.Thread] = None
        # incremental updates (ops/delta.py): capacity-bucketed tables
        # and CRUD-event patching.  Off on the rule-sharded path
        # (RuleShardedKernel repartitions per compile) and for the oracle
        # backend (nothing compiled to patch); on the pod-sharded path
        # PodShardedKernel.patched re-slices only the owning shards
        self.delta_enabled = bool(
            delta_enabled
            and (model_axis is None or pod_shards is not None)
            and backend != "oracle"
        )
        self._caps = None                   # delta_mod.Capacities
        self._delta_state = None            # delta_mod.DeltaState
        # the kernels' runners (ops/kernel.Runner), kept across swaps
        # under the JAX package's shared-jit keys.  An injected dict is
        # shared by every evaluator of one size class (tenancy)
        self._shared_jits: dict = (
            shared_jits if shared_jits is not None else {}
        )
        # a pinned capacity class (delta_mod.Capacities): full compiles go
        # through fixed_caps_compile so the published shapes never drift
        # from the class; a tree that overflows it gets its own buckets
        self.fixed_caps = fixed_caps
        self._delta_counts = {
            "patches": 0, "full_compiles": 0, "noops": 0,
            "recompiles_avoided": 0, "fallbacks": 0,
        }
        self._delta_fallback_reasons: dict[str, int] = {}
        self._last_visibility_ms: Optional[float] = None
        # the last published patch's host-side split (ms): apply_events,
        # the kernel's construction and upload, the native encoder, the
        # candidate index
        self.last_patch_split: Optional[dict] = None
        # async full-compile debounce: at most one compile running and at
        # most one pending, however fast CRUD events arrive
        self._compile_state_lock = threading.Lock()
        self._compile_pending = False
        self._shutdown = False
        # device-health state (srv/watchdog.py): a quarantined evaluator
        # answers every kernel-path row with the degraded envelope until
        # the watchdog's probe restores the kernel
        self._watchdog = None
        self._quarantined = False
        self.refresh(wait=True)  # the oracle backend builds only the index

    # ------------------------------------------------------------- lifecycle

    def refresh(self, wait: bool = False, events=None,
                footprint=None) -> None:
        """Recompile the policy tensors after a tree mutation; the previous
        kernel serves until the swap.

        ``events`` (``ops/delta.CrudEvent`` list, captured by the store)
        enables the incremental path: certified-empty diffs skip the cache
        flush and the compile; in-capacity deltas patch the bucketed
        tables and reuse every runner; anything else falls back to the
        full recompile.  ``footprint`` (``ops/delta.Footprint``) scopes
        the post-swap decision-cache bump on the patch path; the pre-swap
        bump is the store's.  Before a full recompile the cache's epoch is
        bumped whole (a stale hit must never outlive the swap); the oracle
        backend, which compiles nothing, bumps only the footprint's scope.
        With ``async_compile`` and ``wait=False`` the full compile runs on
        the debounced background thread."""
        t0 = time.perf_counter()
        if self.backend == "oracle":
            if self.decision_cache is not None:
                if footprint is not None and footprint.empty:
                    pass  # certified no-op: nothing to flush
                elif footprint is not None:
                    self.decision_cache.bump_scoped(footprint)
                else:
                    self.decision_cache.bump_epoch()
            # no compile; every request takes the candidate-filtered walk
            self._cand = self._build_candidate_index()
            return
        if events is not None and self._delta_ready():
            if self._try_patch(events, footprint, t0):
                return
        if self.decision_cache is not None:
            self.decision_cache.bump_epoch()
        with self._lock:
            self._version += 1
        if self.async_compile and not wait:
            # debounce: one running compile + at most one pending; the
            # loop compiles from the LATEST version at each round, so a
            # burst of N CRUD events costs at most two compiles
            with self._compile_state_lock:
                if self._shutdown:
                    return
                self._compile_pending = True
                thread = self._compile_thread
                if thread is None or not thread.is_alive():
                    thread = threading.Thread(
                        target=self._compile_worker, daemon=True,
                        name="acs-compile",
                    )
                    self._compile_thread = thread
                    thread.start()
        else:
            with self._lock:
                version = self._version
            self._compile_and_swap(version, t0)

    # --------------------------------------------------- incremental path

    def _delta_ready(self) -> bool:
        """The patch path engages only when the PUBLISHED compile is the
        latest version (no async full compile in flight: patching stale
        tables would drop the in-flight mutation) and a supported kernel
        and its ownership state exist."""
        if not self.delta_enabled:
            return False
        with self._lock:
            return (
                self._compiled is not None
                and self._compiled.supported
                and self._kernel is not None
                and self._delta_state is not None
                and self._compiled.version == self._version
            )

    def _try_patch(self, events, footprint, t0) -> bool:
        """Apply a CRUD delta to the bucketed tables; True when the
        refresh is handled (patch published or certified no-op), False
        to fall back to the full recompile (a patch the prover refuses,
        counted with its reason, or one that raised)."""
        with self._lock:
            compiled = self._compiled
            state = self._delta_state
            claimed = self._version
            kernel_prev = self._kernel
        tree = self.engine.policy_sets
        t_apply = time.perf_counter()
        try:
            result, patched, new_state, stats = delta_mod.apply_events(
                state, compiled, tree, events, self.engine.urns
            )
        except delta_mod.DeltaIneligible as err:
            self._delta_counts["fallbacks"] += 1
            self._delta_fallback_reasons[err.reason] = (
                self._delta_fallback_reasons.get(err.reason, 0) + 1
            )
            self._count_delta("delta-fallback")
            if self.logger:
                self.logger.info("delta ineligible; full recompile",
                                 extra={"reason": err.reason})
            return False
        except Exception:  # noqa: BLE001 — patching must never kill CRUD
            if self.logger:
                self.logger.exception("delta patch failed; full recompile")
            return False
        split = {"apply_events_ms": (time.perf_counter() - t_apply) * 1e3}

        if result == "noop":
            # nothing evaluation-relevant changed: keep the tables, the
            # kernel AND the decision cache; only the candidate index
            # must track the new tree identity
            cand = self._build_candidate_index()
            with self._lock:
                if self._version == claimed:
                    self._cand = cand
                    self._tree_snapshot = tree
                    self._explain_decoder = self._make_explain_decoder(
                        self._compiled, self._kernel, tree)
                    if new_state is not None:
                        self._delta_state = new_state
            self._delta_counts["noops"] += 1
            self._count_delta("delta-noop")
            return True

        t_kernel = time.perf_counter()
        patched_slots = stats.get("patched_slots", [])
        followers = self._followers
        gen = None
        if followers is not None:
            # the followers build the same kernel meanwhile, from these
            # very tables: this process's interner holds the strings its
            # encodes met, so a patch lowered elsewhere could number a
            # new string otherwise
            gen = followers.build("patch", kernel_prev._follower_gen,
                                  patched, [int(x) for x in patched_slots])
            split["followers_ms"] = (time.perf_counter() - t_kernel) * 1e3
        try:
            kernel, shards_patched = self._patch_kernel(
                kernel_prev, patched, patched_slots)
            self._sync_upload()
        except BaseException:
            if followers is not None:
                followers.drop(gen)
            raise
        split["kernel_ms"] = (time.perf_counter() - t_kernel) * 1e3
        t_native = time.perf_counter()
        native_encoder = self._make_native_encoder(patched, kernel)
        split["native_encoder_ms"] = (time.perf_counter() - t_native) * 1e3
        t_cand = time.perf_counter()
        cand = self._build_candidate_index()
        split["candidate_index_ms"] = (time.perf_counter() - t_cand) * 1e3
        decoder = self._make_explain_decoder(patched, kernel, tree)
        if followers is not None:
            # publish only what every rank has built: a follower's loop
            # never waits on a build (srv/follower.py)
            followers.await_built(gen)
        with self._lock:
            if self._version != claimed:
                if followers is not None:
                    followers.drop(gen)
                return False  # a newer refresh superseded this patch
            if followers is not None:
                followers.publish(gen, kernel)
            self._version += 1
            patched.version = self._version
            self._compiled = patched
            self._kernel = kernel
            self._rq_kernel = None
            self._tree_snapshot = tree
            self._native_encoder = native_encoder
            self._cand = cand
            self._explain_decoder = decoder
            self._delta_state = new_state
        if self.decision_cache is not None:
            # post-swap bump, scoped to the delta's footprint: entries
            # whose signatures are disjoint survive the mutation (the
            # pre-swap bump in store._load_locked used the same footprint)
            if footprint is not None:
                self.decision_cache.bump_scoped(footprint)
            else:
                self.decision_cache.bump_epoch()
        visibility_ms = (time.perf_counter() - t0) * 1e3
        self._last_visibility_ms = visibility_ms
        self.last_patch_split = split
        self._delta_counts["patches"] += 1
        self._delta_counts["recompiles_avoided"] += 1
        self._count_delta("delta-patch")
        if self.telemetry is not None:
            self.telemetry.policy_update_latency.observe(visibility_ms / 1e3)
            self.telemetry.delta.inc(
                "sets_patched", int(stats.get("sets_patched", 0)))
            if shards_patched:
                self.telemetry.delta.inc("shards_patched", shards_patched)
        return True

    def _patch_kernel(self, kernel_prev, patched, patched_slots) -> tuple:
        """(kernel over the patched tables, shards re-sliced): on the
        pod-sharded path only the shards owning the patched set slots are
        re-sliced, every other shard's host tables (and this rank's
        device tables, when its shard is not an owner) reused; else a
        new ``PrefilteredKernel`` on the runners of ``shared_jits``."""
        if getattr(kernel_prev, "supports_shard_patch", False):
            kernel = kernel_prev.patched(patched, patched_slots)
            return kernel, len({
                min(int(s) // kernel_prev.s_local, kernel_prev.n_shards - 1)
                for s in patched_slots
            })
        return PrefilteredKernel(
            patched, device=self.device, mesh=self.mesh,
            axis=self.mesh_axis, telemetry=self.telemetry,
            dynamic_policies=True, shared_jits=self._shared_jits,
            explain=self.explain,
        ), 0

    def _sync_upload(self) -> None:
        """Wait for the tables' upload: it must be complete before any
        serving thread can reach them through a swap."""
        if self.device.type == "cuda":
            import torch

            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------ full compile

    def _compile_worker(self) -> None:
        """Debounced async compile loop: drains pending requests one
        compile at a time, always from the latest version."""
        while True:
            with self._compile_state_lock:
                if not self._compile_pending or self._shutdown:
                    self._compile_thread = None
                    return
                self._compile_pending = False
            with self._lock:
                version = self._version
            try:
                self._compile_and_swap(version, time.perf_counter())
            except Exception:  # noqa: BLE001 — keep draining
                if self.logger:
                    self.logger.exception("async policy compile failed")

    def _compile_tables(self, tree, version: int, prev_caps):
        """(compiled, capacities, delta state) of a tree: bucketed on the
        delta path (into ``fixed_caps`` where pinned, else buckets that
        grow from ``prev_caps``), unpadded without it."""
        if self.delta_enabled and self.fixed_caps is not None:
            try:
                return delta_mod.fixed_caps_compile(
                    tree, self.engine.urns, self.fixed_caps,
                    version=version,
                )
            except delta_mod.DeltaIneligible as err:
                # class overflow: serve from the tree's own buckets
                # rather than fail
                if self.logger:
                    self.logger.info(
                        "tree overflows the pinned size class; falling "
                        "back to its own capacity buckets",
                        extra={"reason": err.reason},
                    )
                return delta_mod.full_bucketed_compile(
                    tree, self.engine.urns, version=version,
                    prev_caps=None,
                )
        if self.delta_enabled:
            return delta_mod.full_bucketed_compile(
                tree, self.engine.urns, version=version,
                prev_caps=prev_caps,
            )
        return compile_policies(tree, self.engine.urns,
                                version=version), None, None

    def _compile_and_swap(self, version: int, t0: float) -> None:
        # snapshot first, compile from the snapshot: the published
        # (tree, arrays) pair is consistent by construction.  The
        # snapshot is a pickle round trip, which copies the model's plain
        # dataclasses as ``copy.deepcopy`` does, several times faster on
        # large trees; its bytes are what the followers compile from
        data = pickle.dumps(self.engine.policy_sets, pickle.HIGHEST_PROTOCOL)
        tree_snapshot = pickle.loads(data)
        prev_caps = self._caps
        prev_t_cap = getattr(self._kernel, "t_cap", 0)
        followers = self._followers
        gen = None
        if followers is not None:
            # the followers compile the same tree meanwhile
            gen = followers.build("tree", data, version, prev_caps,
                                  prev_t_cap)
        try:
            compiled, caps, state = self._compile_tables(
                tree_snapshot, version, prev_caps)
            kernel = None
            if compiled.supported and compiled.n_rules > 0:
                kernel = self._make_kernel(compiled, prev_t_cap)
                self._sync_upload()
            native_encoder = self._make_native_encoder(compiled, kernel)
            decoder = self._make_explain_decoder(compiled, kernel,
                                                 tree_snapshot)
            cand = self._build_candidate_index()
        except BaseException:
            if followers is not None:
                followers.drop(gen)
            raise
        if followers is not None:
            # the old kernel serves on every rank until each has built
            # this one (srv/follower.py)
            followers.await_built(gen)
        with self._lock:
            if version >= self._version:  # drop stale compiles
                if followers is not None:
                    followers.publish(gen, kernel)
                self._compiled = compiled
                self._kernel = kernel
                self._rq_kernel = None  # lazy: built on first wia batch
                self._tree_snapshot = tree_snapshot
                self._native_encoder = native_encoder
                self._explain_decoder = decoder
                self._cand = cand
                self._caps = caps
                self._delta_state = state
            elif followers is not None:
                followers.drop(gen)
        self._delta_counts["full_compiles"] += 1
        self._count_delta("full-compile")
        self._last_visibility_ms = (time.perf_counter() - t0) * 1e3
        if self.telemetry is not None:
            self.telemetry.policy_update_latency.observe(
                time.perf_counter() - t0
            )
        if self.logger and not compiled.supported:
            self.logger.warning(
                "policy tree not kernel-supported; serving from oracle",
                extra={"reason": compiled.unsupported_reason},
            )

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the async compile loop and join its thread (a worker's
        stop must not leak a compile thread mid-upload)."""
        with self._compile_state_lock:
            self._shutdown = True
            self._compile_pending = False
            thread = self._compile_thread
        if thread is not None and thread.is_alive():
            thread.join(timeout)

    def _count_delta(self, key: str) -> None:
        if self.telemetry is not None:
            self.telemetry.delta.inc(key)

    def delta_stats(self) -> dict:
        """health_check surface: patch vs full-compile counts, the
        fallback taxonomy, the last time to visibility and the active
        capacities."""
        out = {
            "enabled": self.delta_enabled,
            **self._delta_counts,
            "fallback_reasons": dict(self._delta_fallback_reasons),
            "last_visibility_ms": (
                round(self._last_visibility_ms, 3)
                if self._last_visibility_ms is not None else None
            ),
        }
        caps = self._caps
        if caps is not None:
            out["capacities"] = caps.as_dict()
        sharding = self.shard_identity()
        if sharding is not None:
            out["sharding"] = {
                "n_shards": sharding["n_shards"],
                "applied_patches": [
                    sh["applied_patches"] for sh in sharding["shards"]
                ],
            }
        return out

    def table_fingerprint(self) -> Optional[str]:
        """Digest of the compiled policy tables: every array's bytes,
        shape and dtype, the condition sources, the entity vocab and the
        active capacities (and the pod fingerprint and the relation
        store's, where they exist).  Two replicas that applied the same
        CRUD sequence hold byte-identical tables, so their fingerprints
        match: the cluster tier's convergence check.  Equal to the JAX
        evaluator's on the same tree and CRUD sequence."""
        return self._tables_digest(relations=True)

    def rank_fingerprints(self) -> list:
        """Each mesh rank's digest of the tables it serves, in rank order
        (this rank's without the relation-tuple state, which only rank 0
        holds and encodes): every rank that applied the same builds and
        swaps gives the same.  One entry on one process."""
        own = [self._tables_digest(relations=False)]
        if self._followers is None:
            return own
        return own + self._followers.query("fingerprint")

    def _tables_digest(self, relations: bool) -> Optional[str]:
        from hashlib import blake2b

        compiled = self._compiled
        if compiled is None:
            return None
        h = blake2b(digest_size=16)
        for name in sorted(compiled.arrays):
            arr = np.ascontiguousarray(compiled.arrays[name])
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(repr(arr.shape).encode())
            h.update(arr.tobytes())
        h.update(repr(compiled.entity_vocab).encode())
        h.update(repr([
            (c.rule_flat_index, c.condition, repr(c.context_query), c.owner)
            for c in compiled.conditions
        ]).encode())
        caps = self._caps
        if caps is not None:
            h.update(repr(sorted(caps.as_dict().items())).encode())
        sharding = self.shard_identity()
        if sharding is not None:
            # replicas must agree on the sliced tables too
            h.update(sharding["pod_fingerprint"].encode())
        store = getattr(self.engine, "relation_store", None)
        if store is not None and relations:
            # the relation-tuple state decides relation-bearing rows
            h.update(store.fingerprint().encode())
        return h.hexdigest()

    def _make_kernel(self, compiled, prev_t_cap: int = 0):
        """The kernel for a supported compile: pod-sharded, rule-sharded
        or the signature prefilter (which delegates to the dense kernel
        below MIN_RULES), by the mesh configuration.  ``prev_t_cap`` is
        the serving pod kernel's sticky target-row bucket."""
        if self.pod_shards is not None and self.mesh is not None:
            # the SET axis partitions over the model axis with per-shard
            # compacted target subtables
            from ..parallel.pod_shard import PodShardedKernel

            return PodShardedKernel(
                compiled, self.mesh, data_axis=self.mesh_axis,
                model_axis=self.model_axis or "model",
                shared_jits=self._shared_jits,
                prev_t_cap=prev_t_cap,
                explain=self.explain,
            )
        if self.model_axis is not None and self.mesh is not None:
            # the rule axis partitions over the model axis
            from ..parallel.rule_shard import RuleShardedKernel

            return RuleShardedKernel(compiled, self.mesh,
                                     data_axis=self.mesh_axis,
                                     model_axis=self.model_axis,
                                     explain=self.explain)
        # keeps per-request work O(matching rules) on large trees and
        # delegates to the dense kernel below MIN_RULES
        return PrefilteredKernel(compiled, device=self.device,
                                 mesh=self.mesh, axis=self.mesh_axis,
                                 telemetry=self.telemetry,
                                 dynamic_policies=self.delta_enabled,
                                 shared_jits=self._shared_jits,
                                 explain=self.explain)

    def _make_explain_decoder(self, compiled, kernel, tree):
        """The ExplainDecoder paired with one published kernel, built from
        the tree snapshot its tables were compiled from; None when explain
        is off or no kernel serves."""
        if not self.explain or kernel is None:
            return None
        if not explain_capacity_ok(compiled.S, compiled.KP, compiled.KR):
            raise ValueError("policy tree exceeds the explain code's 30-bit "
                             "position bound")
        return ExplainDecoder(tree, kernel.explain_strides)

    def _make_native_encoder(self, compiled, kernel):
        """The C++ wire-batch encoder for ``is_allowed_batch_wire``; None,
        as in JAX, with no kernel, on trees with host-assisted conditions
        (the native encoder cannot run the condition sandbox) and in
        explain mode (wire batches carry no Response objects to stamp
        provenance on).  A build or load failure raises."""
        if kernel is None or compiled.conditions or self.explain:
            return None
        from .. import native

        return native.NativeBatchEncoder(compiled)

    def shard_identity(self) -> Optional[dict]:
        """Pod-sharding surface: shard count, per-shard fingerprints and
        capacities, applied-patch watermarks; None when the active kernel
        is not pod-sharded."""
        kernel = self._kernel
        if kernel is None or not getattr(kernel, "supports_shard_patch",
                                         False):
            return None
        return kernel.shard_identity()

    def _build_candidate_index(self) -> Optional[tuple]:
        """(live tree, CandidateIndex) for trees worth indexing, else
        None; the pair is published atomically (see __init__)."""
        live_tree = self.engine.policy_sets
        n_rules = sum(
            len(p.combinables)
            for ps in live_tree.values() if ps is not None
            for p in ps.combinables.values() if p is not None
        )
        if n_rules < CANDIDATE_MIN_RULES:
            return None
        return (live_tree, CandidateIndex(live_tree, self.engine.urns))

    @property
    def kernel_active(self) -> bool:
        return self._kernel is not None

    @property
    def native_active(self) -> bool:
        return self._native_encoder is not None

    # ------------------------------------------------ device-health plumbing

    @property
    def quarantined(self) -> bool:
        return self._quarantined

    def set_quarantined(self, flag: bool) -> None:
        """Flipped by the device watchdog (srv/watchdog.py): True refuses
        every kernel-path row (the degraded envelope; the native wire
        path reports itself inactive) while the kernel path heals; False
        restores kernel routing.  The single-request path and the rows
        the kernel cannot encode stay on the oracle either way."""
        self._quarantined = bool(flag)

    def attach_watchdog(self, watchdog) -> None:
        self._watchdog = watchdog

    @property
    def watchdog(self):
        return self._watchdog

    def _guard_materialize(self, materialize):
        """Bound a kernel materialize under the watchdog deadline when one
        is attached (the device readback then runs on the watchdog's
        thread); identity otherwise."""
        watchdog = self._watchdog
        if watchdog is None:
            return materialize
        return lambda: watchdog.run(materialize)

    def _dispatch(self, kernel, batch):
        """``kernel.evaluate_async(batch)`` under the dispatch lock, with
        the ``device.dispatch`` / ``device.materialize`` failpoints
        (srv/faults.py) at the host side of the device boundary, where
        the JAX package fires them."""
        _faults.fire("device.dispatch")
        with self._dispatch_lock:
            if self._followers is not None:
                # in the order the kernel sees it, on every rank
                self._followers.batch(kernel, batch)
            materialize = kernel.evaluate_async(batch)
        if not _faults.enabled:
            return materialize

        def faulted():
            _faults.fire("device.materialize")
            return materialize()

        return faulted

    def kernel_probe(self) -> bool:
        """One canary batch through the live kernel's dispatch and
        materialize; the watchdog's restore probe (bounded there).  False
        when no kernel is active.  Bypasses the watchdog wrap: the probe
        applies its own deadline."""
        with self._lock:
            kernel = self._kernel
            compiled = self._compiled
        if kernel is None or compiled is None:
            return False
        from ..models.model import Request, Target

        canary = Request(target=Target(), context={})
        batch = encode_requests(
            [canary], compiled, self.engine.resource_adapter
        )
        outputs = self._dispatch(kernel, batch)()
        return len(outputs) >= 3  # explain-enabled kernels append a 4th

    def _degraded_rows(self, requests: list, path: str, message: str,
                       err: Optional[BaseException] = None) -> list:
        """Per-row answers for a batch the device path could not answer:
        rows with an expired deadline shed with the deadline status, the
        rest get the never-cacheable ``degraded`` envelope, counted under
        ``path`` and logged (sampled).  Never the oracle in the kernel's
        place, never a fabricated PERMIT/DENY."""
        expired = self._expired_rows(requests)
        shed = overload_response(
            DEADLINE_CODE, "deadline expired before evaluation"
        )
        refused = degraded_response(message)
        out = [shed if b in expired else refused
               for b in range(len(requests))]
        self._count_path(path, len(requests) - len(expired))
        self._count_path("deadline-expired", len(expired))
        self._slog.warning(
            path, "%s: %d rows degraded, %d shed: %r", message,
            len(requests) - len(expired), len(expired), err,
        )
        return out

    def _hang_fallback(self, requests: list) -> list:
        """Per-row answers for a batch whose device materialize timed
        out: the degraded envelope (``hang-fallback-degraded``)."""
        return self._degraded_rows(requests, "hang-fallback-degraded",
                                   "device materialize timed out")

    def _device_failed(self, requests: list, err: BaseException) -> list:
        """Per-row answers for a batch whose kernel dispatch or readback
        raised (a launch or build failure, an injected fault): the
        degraded envelope (``device-error-degraded``)."""
        return self._degraded_rows(requests, "device-error-degraded",
                                   "device kernel failed", err)

    def _count_path(self, path: str, rows: int) -> None:
        if self.telemetry is not None and rows:
            self.telemetry.paths.inc(path, rows)

    def count_error(self, path: str, rows: int, err: BaseException) -> None:
        """A serving-shell site (transport, stream pipeline, batcher)
        caught ``err`` and answers its ``rows`` another way, as the JAX
        shell does: the rows are counted under ``path`` and the error is
        logged (sampled), so a failing kernel path never hides behind its
        fallback."""
        self._count_path(path, rows)
        self._slog.warning(path, "%s: %d rows answered another way: %r",
                           path, rows, err)

    @staticmethod
    def _expired_rows(requests: list) -> set[int]:
        """Indices of rows whose propagated ``_deadline`` already passed
        (empty for deadline-less traffic)."""
        expired: set[int] = set()
        now = None
        for b, request in enumerate(requests):
            deadline = getattr(request, "_deadline", None)
            if deadline is None:
                continue
            if now is None:
                now = time.monotonic()
            if deadline <= now:
                expired.add(b)
        return expired

    # ------------------------------------------------------ relation plumbing

    def attach_relation_store(self, store) -> None:
        """Wire a ``RelationTupleStore``: the oracle reads it through
        ``engine.relation_store`` and every batch encode packs its flat
        verdict tables.  Tuple churn changes decisions but swaps nothing:
        the compiled tables, the kernels and their built libraries stay
        as they are; each tuple write bumps the decision cache."""
        self.engine.relation_store = store

        def _on_change(_gen: int) -> None:
            if self.decision_cache is not None:
                self.decision_cache.bump_epoch()
            with self._lock:
                self.relation_churn += 1
            self._count_path("relation-churn", 1)

        store.on_change(_on_change)

    def _relation_tables(self, compiled):
        """The store's flat verdict tables for this compile, or None
        (encode then packs fail-closed planes, or dummies for a tree
        without relation paths)."""
        store = getattr(self.engine, "relation_store", None)
        if store is None or not relation_bits_needed(compiled):
            return None
        return store.tables_for(compiled)

    def _relation_tables_native(self, encoder):
        """Verdict tables in the NATIVE encoder's id space for the wire
        path: the C++ interner diverges from the Python one after the
        preload snapshot, so the host-space tables cannot be reused."""
        store = getattr(self.engine, "relation_store", None)
        if store is None or not encoder.needs_relation_bits:
            return None
        return encoder.native_relation_tables(store)

    # ------------------------------------------------- host-side pipeline

    def prepare_batch(self, requests: list) -> bool:
        """``_prepare_batch`` with the ``prepare`` stage recorded when an
        observability hub is wired and the batch had unprepared token
        rows.  True when it had."""
        tracer = self.obs.tracer if self.obs is not None else None
        if tracer is None:
            return self._prepare_batch(requests)
        t0 = time.perf_counter()
        did_work = self._prepare_batch(requests)
        if did_work:
            tracer.fan_out(requests, STAGE_PREPARE, time.perf_counter() - t0)
        return did_work

    def _prepare_batch(self, requests: list) -> bool:
        """Host-side eligibility pipeline: batch-resolve every distinct
        ``subject.token`` through the engine's identity client (one call
        per distinct token; a TTL'd resolution cache makes repeats across
        batches nearly free) and the HR-scope rendezvous (one per
        distinct cache key), then mark each request prepared so the
        encoder keeps resolved token rows on the kernel path.  True when
        the batch had unprepared token rows.

        Idempotent and semantics-preserving: afterwards
        ``engine.prepare_context`` is a no-op for these requests, so the
        kernel and the oracle evaluate the same resolved context.  A
        failed resolution leaves ``request._token_resolved`` False and
        the row goes to the oracle, as unprepared token traffic does."""
        engine = self.engine
        pending: list[tuple] = []
        for request in requests:
            if getattr(request, "_context_prepared", False):
                continue
            context = request.context
            subject = get_field(context, "subject") if context else None
            token = get_field(subject, "token") if subject is not None \
                else None
            if token:
                pending.append((request, token))
        if not pending:
            return False

        client = engine.identity_client

        def resolve(token):
            try:
                return client.find_by_token(token)
            except Exception as err:  # noqa: BLE001 — fail the row closed
                # sampled: a down identity service under overload fires
                # this once per distinct token per batch
                self._slog.warning(
                    "token-resolution",
                    "batch token resolution failed: %s", err,
                )
                return None

        by_token: dict[str, list] = {}
        for request, token in pending:
            by_token.setdefault(token, []).append(request)
        resolutions: dict[str, object] = {}
        if client is not None:
            tokens = list(by_token)
            if len(tokens) == 1:
                resolutions[tokens[0]] = resolve(tokens[0])
            else:
                with ThreadPoolExecutor(
                    max_workers=min(8, len(tokens))
                ) as pool:
                    for token, resolved in zip(
                        tokens, pool.map(resolve, tokens)
                    ):
                        resolutions[token] = resolved

        n_ok = n_fail = 0
        for token, rows in by_token.items():
            resolved = resolutions.get(token)
            payload = get_field(resolved, "payload") if resolved else None
            for request in rows:
                request._context_prepared = True
                if payload is not None:
                    # per-request copy: rows sharing a token must not
                    # share mutable payload objects
                    apply_resolved_subject(
                        get_field(request.context, "subject"),
                        copy.deepcopy(payload),
                    )
                    request._token_resolved = True
                    n_ok += 1
                else:
                    request._token_resolved = False
                    n_fail += 1
        self._count_path("token-resolved", n_ok)
        self._count_path("token-unresolved", n_fail)

        # HR scopes: one rendezvous per distinct cache key; the other rows
        # of each group read the freshly written cache.  A timed-out key
        # leaves its whole group scope-less, the per-row outcome the
        # reference's individual waits produce.
        provider = engine.hr_scope_provider
        if provider is None:
            return True
        groups: dict[str, list] = {}
        for request, _ in pending:
            if not getattr(request, "_token_resolved", False):
                continue
            subject = get_field(request.context, "subject")
            if get_field(subject, "hierarchical_scopes"):
                continue
            key = provider.hr_scopes_key(request.context)
            if key is not None:
                groups.setdefault(key, []).append(request)
        if not groups:
            return True
        firsts = [rows[0] for rows in groups.values()]
        if len(firsts) > 1:
            with ThreadPoolExecutor(max_workers=min(8, len(firsts))) as pool:
                list(pool.map(
                    lambda r: engine.create_hr_scope(r.context), firsts
                ))
        else:
            engine.create_hr_scope(firsts[0].context)
        for key, rows in groups.items():
            for request in rows[1:]:
                try:
                    cached = provider.cache.exists(key)
                except Exception:  # noqa: BLE001 — cache backend hiccup
                    cached = True  # fall through to the normal path
                if cached:
                    engine.create_hr_scope(request.context)
        return True

    # ------------------------------------------------------------ evaluation

    def is_allowed(self, request) -> Response:
        """Single-request path: the oracle, behind the decision cache when
        one is set (a warm cacheable request never pays the walk)."""
        tracer = self.obs.tracer if self.obs is not None else None
        cache = self.decision_cache
        if cache is None or not cache.enabled:
            return self._traced_oracle(request, tracer)
        # epoch snapshot BEFORE the walk reads the tree: if a bump lands
        # while this decision is in flight, the write-through below stores
        # a born-stale entry (logical miss) instead of serving an old-tree
        # decision as fresh
        epoch = cache.epoch
        self.engine.prepare_context(request)
        t0 = time.perf_counter() if tracer is not None else 0.0
        key = cache.fingerprint(
            request, self.engine.urns.get("subjectID") or ""
        )
        hit = cache.get(key)
        if hit is not None:
            self._count_path("cache-hit", 1)
            if tracer is not None:
                tracer.record(getattr(request, "_span", None),
                              STAGE_CACHE, time.perf_counter() - t0)
                hit._path = "cache-hit"
            return hit
        response = self._traced_oracle(request, tracer)
        cache.put(key, response, epoch=epoch,
                  features=self._request_features(request))
        return response

    def _traced_oracle(self, request, tracer) -> Response:
        """Oracle walk with the ``oracle`` stage recorded (and the serving
        path stamped for the audit log) when a hub is wired."""
        if tracer is None:
            return self._oracle_is_allowed(request)
        t0 = time.perf_counter()
        response = self._oracle_is_allowed(request)
        tracer.record(getattr(request, "_span", None), STAGE_ORACLE,
                      time.perf_counter() - t0)
        response._path = "oracle"
        return response

    def _request_features(self, request):
        """Candidate-signature features for scoped cache invalidation
        (srv/decision_cache.request_features)."""
        urns = self.engine.urns
        return request_features(
            request, urns.get("entity"), urns.get("operation")
        )

    def _oracle_is_allowed(self, request) -> Response:
        """Oracle walk, candidate-filtered on large trees (skipped rules
        provably cannot target-match; decisions bit-identical).  One read
        of the (tree, index) pair keeps the identity guard and the index
        consistent under concurrent swaps.  In explain mode the response
        carries the same ``_explain`` shape as kernel rows, looked up from
        the engine's source stamp."""
        cand = self._cand
        if cand is not None and cand[0] is self.engine.policy_sets:
            response = self.engine.is_allowed(
                request,
                candidate_rules=cand[1].candidates(request, self.engine.urns),
            )
        else:
            response = self.engine.is_allowed(request)
        decoder = self._explain_decoder
        if decoder is not None and getattr(response, "_explain", None) is None:
            info = decoder.describe_source(getattr(response, "_rule_id", None))
            if info is not None:
                response._explain = info
                self._stamp_relation(info, request)
        return response

    def _stamp_relation(self, info: dict, request) -> None:
        """Add the tuple-path witnesses of a relation-gated row to its
        explain dict (nothing on other rows)."""
        rel = self._relation_provenance(
            request, info.get("rule") or info.get("policy"))
        if rel is not None:
            info["relation"] = rel

    def _relation_provenance(self, request, source_id):
        """Tuple-path witnesses for an explain row: when the deciding
        node's target carries relation-path attributes, the hop list of
        the live tuple graph that satisfied each (path, instance) pair;
        None when the row was not relation-gated (no store, no relation
        attributes, nothing collected)."""
        store = getattr(self.engine, "relation_store", None)
        if store is None or source_id is None:
            return None
        target = self._node_target(source_id)
        if target is None:
            return None
        urns = self.engine.urns
        paths = relation_paths(target.subjects, urns)
        if not paths:
            return None
        instances = collect_target_instances(target, request, urns)
        subject_id = request_subject_id(request)
        if not instances or subject_id is None:
            return None
        witnesses = []
        for expr in paths:
            for ns, oid in instances:
                hops = store.witness(expr, ns, oid, subject_id)
                if hops is not None:
                    witnesses.append({"path": expr, "object": f"{ns}:{oid}",
                                      "tuples": hops})
        return witnesses or None

    def _node_target(self, source_id):
        """The target of the tree node ``source_id`` names: the deciding
        rule first, then the no-rules policy (the precedence of
        ``ExplainDecoder.describe_source``); None when the id left the
        tree."""
        live = [ps for ps in self.engine.policy_sets.values()
                if ps is not None]
        pols = [pol for ps in live for pol in ps.combinables.values()
                if pol is not None]
        for pol in pols:
            for rule in pol.combinables.values():
                if rule is not None and rule.id == source_id:
                    return rule.target
        for pol in pols:
            if pol.id == source_id:
                return pol.target
        return None

    def what_is_allowed(self, request):
        return self.engine.what_is_allowed(request)

    def what_is_allowed_batch(self, requests: list):
        """Batched reverse query: per-signature planes on the device
        (``ReverseQueryKernel``, built lazily on first use and rebuilt on
        a version change), tree and obligation assembly on the host.
        Dispatch is adaptive like the decision path's ``MIN_RULES``: below
        ``REVERSE_MIN_RULES`` rules, and when no kernel is active, the
        scalar walk serves every request."""
        self.prepare_batch(requests)
        with self._lock:
            # one consistent snapshot: kernel, compiled and tree are always
            # published together, so kernel != None implies supported
            compiled = self._compiled
            kernel = self._kernel
            rq_kernel = self._rq_kernel
            tree_snapshot = self._tree_snapshot
        if (
            self.backend == "oracle"
            or compiled is None
            or kernel is None
            or compiled.n_rules < reverse.REVERSE_MIN_RULES
        ):
            self._count_path("oracle-wia", len(requests))
            return [self.engine.what_is_allowed(r) for r in requests]
        if self._quarantined:
            return self._degraded_queries(
                requests, "quarantine-degraded",
                "the device path is quarantined")
        if rq_kernel is None or rq_kernel.compiled.version != compiled.version:
            # tree_snapshot was published with `compiled` and is the exact
            # tree the arrays were compiled from
            rq_kernel = reverse.ReverseQueryKernel(
                compiled, tree_snapshot, copy_tree=False, device=self.device
            )
            with self._lock:
                if self._compiled is compiled:
                    self._rq_kernel = rq_kernel
        # reverse queries never reach stage B: skip the owner-bit packer,
        # the relation-plane packer (wia ignores relation requirements,
        # like the HR gate) and the condition pre-pass on this encode
        batch = encode_requests(
            requests, compiled, skip_conditions=True, skip_owner_bits=True,
            skip_relation_bits=True,
        )
        try:
            with self._dispatch_lock:
                out = reverse.what_is_allowed_batch(
                    self.engine, compiled, rq_kernel, requests, batch
                )
        except Exception as err:  # noqa: BLE001 — reported, not rerouted
            return self._degraded_queries(
                requests, "device-error-degraded", "device kernel failed",
                err)
        n_oracle = int((~batch.eligible).sum())
        self._count_path("oracle-wia", n_oracle)
        self._count_path("kernel-wia", len(requests) - n_oracle)
        return out

    def _degraded_queries(self, requests: list, path: str, message: str,
                          err: Optional[BaseException] = None) -> list:
        """``_degraded_rows`` for reverse queries: each a ReverseQuery
        with no tree and the row's shed or degraded status."""
        return [
            ReverseQuery(policy_sets=[], obligations=[],
                         operation_status=resp.operation_status)
            for resp in self._degraded_rows(requests, path, message, err)
        ]

    def is_allowed_batch(self, requests: list) -> list[Response]:
        """Batched decision path: decision-cache lookup batch-wide BEFORE
        encode (hit rows skip the device round-trip and the oracle walk),
        then kernel rows and oracle rows together over the misses, then
        write-through of every miss row the engine marked
        ``evaluation_cacheable``.

        Rows carrying an already-expired ``_deadline`` (set by the
        transports and the service facade, srv/admission.py) are answered
        with the deadline status before any evaluation, and not cached."""
        return self.is_allowed_batch_async(requests)()

    def is_allowed_batch_async(self, requests: list):
        """Token / HR preparation, cache lookups, encode and launch now;
        the returned zero-arg ``finalize`` waits for the device result,
        decodes it, runs the oracle rows and writes the cache through.
        Calling it at once is the synchronous path."""
        expired = self._expired_rows(requests)
        if expired:
            live = [r for b, r in enumerate(requests) if b not in expired]
            fin_live = (
                self.is_allowed_batch_async(live) if live else (lambda: [])
            )
            self._count_path("deadline-expired", len(expired))
            shed = overload_response(
                DEADLINE_CODE, "deadline expired before evaluation"
            )

            def finalize_expired():
                computed = iter(fin_live())
                return [
                    shed if b in expired else next(computed)
                    for b in range(len(requests))
                ]

            return finalize_expired
        self.prepare_batch(requests)
        cache = self.decision_cache
        if cache is None or not cache.enabled:
            return self._uncached_async(requests)
        subject_urn = self.engine.urns.get("subjectID") or ""
        # one epoch snapshot for the whole batch, taken before any row
        # reads the tree: rows whose evaluation spans a concurrent epoch
        # bump are written through born-stale (see DecisionCache.put)
        epoch = cache.epoch
        tracer = self.obs.tracer if self.obs is not None else None
        t_cache = time.perf_counter() if tracer is not None else 0.0
        responses: list[Optional[Response]] = [None] * len(requests)
        keys: list = [None] * len(requests)
        misses: list[int] = []
        for b, request in enumerate(requests):
            # fingerprints are taken AFTER context resolution so the key
            # reflects the subject the evaluation will actually see
            self.engine.prepare_context(request)
            keys[b] = cache.fingerprint(request, subject_urn)
            hit = cache.get(keys[b])
            if hit is not None:
                responses[b] = hit
            else:
                misses.append(b)
        if tracer is not None and len(misses) < len(requests):
            tracer.fan_out(
                [r for b, r in enumerate(requests)
                 if responses[b] is not None],
                STAGE_CACHE, time.perf_counter() - t_cache,
            )
            for response in responses:
                if response is not None:
                    response._path = "cache-hit"
        self._count_path("cache-hit", len(requests) - len(misses))
        if not misses:
            return lambda: responses
        fin_misses = self._uncached_async([requests[b] for b in misses])

        def finalize_cached():
            computed = fin_misses()
            for j, b in enumerate(misses):
                responses[b] = computed[j]
                # write-through from BOTH serving paths: kernel rows and
                # oracle rows land here alike; put() keeps only
                # cacheable 200s
                cache.put(keys[b], computed[j], epoch=epoch,
                          features=self._request_features(requests[b]))
            return responses

        return finalize_cached

    def _uncached_async(self, requests: list):
        with self._lock:
            kernel = self._kernel
            compiled = self._compiled
            # paired with the kernel under the same lock: provenance
            # decodes against the tree the serving tables came from
            decoder = self._explain_decoder
        if self.backend == "oracle" or kernel is None:
            # host only: nothing to overlap, so the walk runs at finalize
            def run_oracle():
                self._count_path("oracle", len(requests))
                return [self._oracle_is_allowed(r) for r in requests]

            return run_oracle
        if self._quarantined:
            return lambda: self._degraded_rows(
                requests, "quarantine-degraded",
                "the device path is quarantined")

        # mixed-traffic split: a handful of deep/wide rows must not
        # inflate the adaptive padding caps (and device cost) of the whole
        # batch — encode floor-fitting rows at the steady-state shape and
        # only the rest at batch-max caps
        if len(requests) >= 8:
            ext = [
                b for b, r in enumerate(requests)
                if not fits_floor(request_needs(r, compiled.urns))
            ]
            if 0 < len(ext) < len(requests):
                ext_set = set(ext)
                floor_rows = [b for b in range(len(requests))
                              if b not in ext_set]
                # both sub-batches launch back to back on one stream, then
                # finalize in launch order
                fins = [
                    (rows, self._eval_encoded_async(
                        kernel, compiled, [requests[b] for b in rows], caps,
                        decoder,
                    ))
                    for rows, caps in ((floor_rows, dict(_CAPS_FLOOR)),
                                       (ext, None))
                ]

                def finalize_split():
                    out: list[Response] = [None] * len(requests)
                    for rows, fin in fins:
                        for b, resp in zip(rows, fin()):
                            out[b] = resp
                    return out

                return finalize_split
        return self._eval_encoded_async(kernel, compiled, requests, None,
                                        decoder)

    def _eval_encoded_async(self, kernel, compiled, requests: list, caps,
                            decoder: Optional[ExplainDecoder] = None):
        tracer = self.obs.tracer if self.obs is not None else None
        t_stage = time.perf_counter() if tracer is not None else 0.0
        batch = encode_requests(
            requests, compiled, self.engine.resource_adapter, caps=caps,
            relation_tables=self._relation_tables(compiled),
        )
        if tracer is not None:
            tracer.fan_out(requests, STAGE_ENCODE,
                           time.perf_counter() - t_stage)
        t_device = time.perf_counter()
        try:
            materialize = self._guard_materialize(
                self._dispatch(kernel, batch))
        except Exception as err:  # noqa: BLE001 — reported, not rerouted
            failed = err
            return lambda: self._device_failed(requests, failed)

        def finalize():
            try:
                outputs = materialize()
            except DeviceTimeoutError:
                return self._hang_fallback(requests)
            except Exception as err:  # noqa: BLE001 — as at dispatch
                return self._device_failed(requests, err)
            return self._decode_batch(requests, batch, outputs, decoder,
                                      tracer, t_device)

        return finalize

    def _decode_batch(self, requests, batch, outputs,
                      decoder: Optional[ExplainDecoder] = None,
                      tracer=None, t_device: float = 0.0
                      ) -> list[Response]:
        decision, cacheable, status = outputs[:3]
        # explain mode: the fourth output, decoded per kernel row
        expl = outputs[3] if decoder is not None and len(outputs) > 3 \
            else None
        t_stage = 0.0
        if tracer is not None:
            # dispatch -> materialize (host-to-device copy, launch, the
            # readback) is one ``device`` stage
            now = time.perf_counter()
            tracer.fan_out(requests, STAGE_DEVICE, now - t_device)
            t_stage = now
        n_oracle = sum(
            1 for b in range(len(requests))
            if not batch.eligible[b] or status[b] != 200
        )
        self._count_path("oracle", n_oracle)
        self._count_path("kernel", len(requests) - n_oracle)
        C = batch.cond_true.shape[0]
        responses: list[Optional[Response]] = []
        oracle_rows: list[int] = []
        for b, request in enumerate(requests):
            if batch.eligible[b] and status[b] != 200:
                # abort row: when exactly one aborting condition matches the
                # row's status code, its cached error text is the message
                # and the oracle re-run is skipped
                msgs = {
                    batch.cond_msg.get((ci, b))
                    for ci in range(C)
                    if batch.cond_abort[ci][b]
                    and batch.cond_code[ci][b] == status[b]
                }
                if len(msgs) == 1 and None not in msgs:
                    cach = None if cacheable[b] < 0 else bool(cacheable[b])
                    resp = Response(
                        decision=Decision.DENY,
                        obligations=[],
                        evaluation_cacheable=cach,
                        operation_status=OperationStatus(
                            code=int(status[b]), message=msgs.pop()
                        ),
                    )
                    if expl is not None:
                        # names the aborting rule; no ``_rule_id``, as the
                        # oracle's abort response carries none
                        info = decoder.decode(expl[b])
                        if info is not None:
                            resp._explain = info
                    responses.append(resp)
                    continue
            if not batch.eligible[b] or status[b] != 200:
                # ineligible rows and ambiguous abort rows: the oracle
                oracle_rows.append(len(responses))
                responses.append(None)
                continue
            cach = None if cacheable[b] < 0 else bool(cacheable[b])
            resp = Response(
                decision=DECISION_NAMES[int(decision[b])],
                obligations=[],
                evaluation_cacheable=cach,
                operation_status=OperationStatus(),
            )
            if expl is not None:
                info = decoder.decode(expl[b])
                if info is not None:
                    resp._explain = info
                    self._stamp_relation(info, request)
                source = decoder.source(expl[b])
                if source is not None:
                    # the oracle's EffectEvaluation.source stamp
                    resp._rule_id = source
            responses.append(resp)
        if tracer is not None:
            now = time.perf_counter()
            tracer.fan_out(requests, STAGE_DECODE, now - t_stage)
            t_stage = now
            for resp in responses:
                if resp is not None:
                    resp._path = "kernel"
        if not oracle_rows:
            return responses
        if len(requests) >= 8:
            # sampled: a down adapter under overload degrades whole
            # batches to the oracle; the signal matters, not the flood
            self._slog.warning(
                "oracle-fallback",
                "%d/%d batch rows fell back to the scalar oracle",
                len(oracle_rows), len(requests),
            )
        rows = [requests[slot] for slot in oracle_rows]
        adapter = self.engine.resource_adapter
        if adapter is not None and len(rows) > 1:
            # adapter-backed rows block on remote context queries: fan the
            # (candidate-filtered) walks out so the batch stalls for about
            # one endpoint timeout instead of N sequential ones
            workers = min(len(rows),
                          int(getattr(adapter, "max_concurrency", 8) or 8))
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(self._oracle_is_allowed, rows))
        else:
            results = [self._oracle_is_allowed(r) for r in rows]
        if tracer is not None:
            tracer.fan_out(rows, STAGE_ORACLE, time.perf_counter() - t_stage)
            for response in results:
                response._path = "oracle"
        for slot, response in zip(oracle_rows, results):
            responses[slot] = response
        return responses

    # ------------------------------------------------------ native wire path

    def is_allowed_batch_wire(self, messages: list[bytes], span=None):
        """Native path: serialized ``acstpu.Request`` messages -> the
        batch and per-row (decision, cacheable, status) arrays; rows with
        ``batch.eligible`` False or a status other than 200 are the
        caller's to serve another way.  None when the native encoder is
        not active (explain mode, host-assisted conditions, no kernel,
        ``backend="oracle"``, quarantine).  ``span`` is the RPC-level span
        of the transport (wire batches carry no per-row spans)."""
        finalize = self.is_allowed_batch_wire_async(messages, span=span)
        return None if finalize is None else finalize()

    def is_allowed_batch_wire_async(self, messages: list[bytes], span=None,
                                    reuse: bool = False):
        """Encode (C++) and launch without waiting; the returned zero-arg
        ``finalize`` waits for the device result and yields (batch,
        decision, cacheable, status).  Rows that overflowed the floor
        caps are re-encoded natively at ``_CAPS_CEIL`` and launched once
        more inside ``finalize``.  None when the native path is not
        active.

        ``reuse=True`` encodes into pooled staging buffers; the CALLER
        must fire ``batch.release_staging()`` once it has finished
        reading the batch, never before."""
        with self._lock:
            kernel = self._kernel
            encoder = self._native_encoder
        if (kernel is None or encoder is None or self.backend == "oracle"
                or self._quarantined):
            return None
        tracer = self.obs.tracer if self.obs is not None else None
        t_stage = time.perf_counter() if tracer is not None else 0.0
        rel_tables = self._relation_tables_native(encoder)
        batch = encoder.encode_wire(
            messages, reuse=reuse, relation_tables=rel_tables
        )
        if tracer is not None:
            tracer.record(span, STAGE_WIRE_ENCODE,
                          time.perf_counter() - t_stage)
        t_device = time.perf_counter()
        materialize = self._guard_materialize(self._dispatch(kernel, batch))

        def finalize():
            decision, cacheable, status = materialize()[:3]
            if tracer is not None:
                tracer.record(span, STAGE_DEVICE,
                              time.perf_counter() - t_device)
            if batch.overcap is not None and batch.overcap.any():
                # adaptive caps, native path: rows that overflowed the
                # floor shapes re-encode natively at the ceiling (one
                # more native call and one more launch for the rare deep
                # rows) instead of falling to the oracle
                idx = [
                    b for b in range(len(messages))
                    if batch.overcap[b] and not batch.eligible[b]
                ]
                retry = encoder.encode_wire(
                    [messages[b] for b in idx], caps=dict(_CAPS_CEIL),
                    relation_tables=rel_tables,
                )
                d2, c2, s2 = self._guard_materialize(
                    self._dispatch(kernel, retry))()[:3]
                decision = np.array(decision)
                cacheable = np.array(cacheable)
                status = np.array(status)
                n_retried = 0
                for j, b in enumerate(idx):
                    if retry.eligible[j]:
                        batch.eligible[b] = True
                        decision[b] = d2[j]
                        cacheable[b] = c2[j]
                        status[b] = s2[j]
                        n_retried += 1
                self._count_path("native-wire-ceil", n_retried)
            n_served = sum(
                1 for b in range(len(messages))
                if batch.eligible[b] and status[b] == 200
            )
            self._count_path("native-wire", n_served)
            return batch, decision, cacheable, status

        return finalize
