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
gets the whole batch's responses.

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

A refresh recompiles the whole tree (``compile_policies``), the JAX
evaluator's ``delta_enabled=False`` path; the JAX pod path compiles
through the delta subsystem's capacity-bucketed compile, which waits for
the delta slice (capacities differ, decisions do not).  Not ported yet:
delta patching and scoped cache bumps, async compiles (the delta slice);
the deadline shed, the watchdog, telemetry counters and tracing spans
(the serving shell, whose ``admission`` / ``tracing`` modules they
import); tenancy.
"""

from __future__ import annotations

import copy
import threading
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
from ..models.model import Decision, OperationStatus, Response
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
from .decision_cache import request_features
from .explain import ExplainDecoder, explain_capacity_ok
from .telemetry import SampledLogger

# trees with fewer rules skip the candidate index (its build and lookups
# cost more than the walk it saves)
CANDIDATE_MIN_RULES = 256


class HybridEvaluator:
    def __init__(self, engine: AccessController,
                 backend: str = "hybrid",  # oracle | kernel | hybrid
                 logger=None, mesh=None, mesh_axis: str = "data",
                 model_axis: Optional[str] = None,
                 pod_shards: Optional[int] = None, decision_cache=None,
                 explain: bool = False, device=None):
        self.engine = engine
        self.backend = backend
        self.logger = logger
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
        self.refresh(wait=True)  # the oracle backend builds only the index

    # ------------------------------------------------------------- lifecycle

    def refresh(self, wait: bool = True) -> None:
        """Recompile the policy tensors after a tree mutation; the previous
        kernel serves until the swap.  The decision cache's epoch is
        bumped first: a stale hit must never outlive the swap."""
        if not wait:
            raise NotImplementedError(
                "async compile: not ported yet (delta slice)"
            )
        if self.decision_cache is not None:
            self.decision_cache.bump_epoch()
        if self.backend == "oracle":
            # no compile; every request takes the candidate-filtered walk
            self._cand = self._build_candidate_index()
            return
        with self._lock:
            self._version += 1
            version = self._version
        # snapshot first, compile from the snapshot: the published
        # (tree, arrays) pair is consistent by construction
        tree_snapshot = copy.deepcopy(self.engine.policy_sets)
        compiled = compile_policies(
            tree_snapshot, self.engine.urns, version=version
        )
        kernel = None
        if compiled.supported and compiled.n_rules > 0:
            kernel = self._make_kernel(compiled)
        native_encoder = self._make_native_encoder(compiled, kernel)
        decoder = self._make_explain_decoder(compiled, kernel,
                                             tree_snapshot)
        cand = self._build_candidate_index()
        with self._lock:
            if version >= self._version:  # drop stale compiles
                self._compiled = compiled
                self._kernel = kernel
                self._rq_kernel = None  # lazy: built on first wia batch
                self._tree_snapshot = tree_snapshot
                self._native_encoder = native_encoder
                self._explain_decoder = decoder
                self._cand = cand
        if self.logger and not compiled.supported:
            self.logger.warning(
                "policy tree not kernel-supported; serving from oracle",
                extra={"reason": compiled.unsupported_reason},
            )

    def _make_kernel(self, compiled):
        """The kernel for a supported compile: pod-sharded, rule-sharded
        or the signature prefilter (which delegates to the dense kernel
        below MIN_RULES), by the mesh configuration."""
        if self.pod_shards is not None and self.mesh is not None:
            # the SET axis partitions over the model axis with per-shard
            # compacted target subtables
            from ..parallel.pod_shard import PodShardedKernel

            return PodShardedKernel(
                compiled, self.mesh, data_axis=self.mesh_axis,
                model_axis=self.model_axis or "model",
                prev_t_cap=getattr(self._kernel, "t_cap", 0),
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
                else:
                    request._token_resolved = False

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
        cache = self.decision_cache
        if cache is None or not cache.enabled:
            return self._oracle_is_allowed(request)
        # epoch snapshot BEFORE the walk reads the tree: if a bump lands
        # while this decision is in flight, the write-through below stores
        # a born-stale entry (logical miss) instead of serving an old-tree
        # decision as fresh
        epoch = cache.epoch
        self.engine.prepare_context(request)
        key = cache.fingerprint(
            request, self.engine.urns.get("subjectID") or ""
        )
        hit = cache.get(key)
        if hit is not None:
            return hit
        response = self._oracle_is_allowed(request)
        cache.put(key, response, epoch=epoch,
                  features=self._request_features(request))
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
            return [self.engine.what_is_allowed(r) for r in requests]
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
        return reverse.what_is_allowed_batch(
            self.engine, compiled, rq_kernel, requests, batch
        )

    def is_allowed_batch(self, requests: list) -> list[Response]:
        """Batched decision path: decision-cache lookup batch-wide BEFORE
        encode (hit rows skip the device round-trip and the oracle walk),
        then kernel rows and oracle rows together over the misses, then
        write-through of every miss row the engine marked
        ``evaluation_cacheable``."""
        return self.is_allowed_batch_async(requests)()

    def is_allowed_batch_async(self, requests: list):
        """Token / HR preparation, cache lookups, encode and launch now;
        the returned zero-arg ``finalize`` waits for the device result,
        decodes it, runs the oracle rows and writes the cache through.
        Calling it at once is the synchronous path."""
        self.prepare_batch(requests)
        cache = self.decision_cache
        if cache is None or not cache.enabled:
            return self._uncached_async(requests)
        subject_urn = self.engine.urns.get("subjectID") or ""
        # one epoch snapshot for the whole batch, taken before any row
        # reads the tree: rows whose evaluation spans a concurrent epoch
        # bump are written through born-stale (see DecisionCache.put)
        epoch = cache.epoch
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
        if self.backend == "oracle" or kernel is None:
            # host only: nothing to overlap, so the walk runs at finalize
            return lambda: [self._oracle_is_allowed(r) for r in requests]

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
        return self._eval_encoded_async(kernel, compiled, requests, None)

    def _eval_encoded_async(self, kernel, compiled, requests: list, caps):
        batch = encode_requests(
            requests, compiled, self.engine.resource_adapter, caps=caps,
            relation_tables=self._relation_tables(compiled),
        )
        decoder = self._explain_decoder
        materialize = kernel.evaluate_async(batch)

        def finalize():
            return self._decode_batch(requests, batch, materialize(),
                                      decoder)

        return finalize

    def _decode_batch(self, requests, batch, outputs,
                      decoder: Optional[ExplainDecoder] = None
                      ) -> list[Response]:
        decision, cacheable, status = outputs[:3]
        # explain mode: the fourth output, decoded per kernel row
        expl = outputs[3] if decoder is not None and len(outputs) > 3 \
            else None
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
        for slot, response in zip(oracle_rows, results):
            responses[slot] = response
        return responses

    # ------------------------------------------------------ native wire path

    def is_allowed_batch_wire(self, messages: list[bytes]):
        """Native path: serialized ``acstpu.Request`` messages -> the
        batch and per-row (decision, cacheable, status) arrays; rows with
        ``batch.eligible`` False or a status other than 200 are the
        caller's to serve another way.  None when the native encoder is
        not active (explain mode, host-assisted conditions, no kernel,
        ``backend="oracle"``)."""
        finalize = self.is_allowed_batch_wire_async(messages)
        return None if finalize is None else finalize()

    def is_allowed_batch_wire_async(self, messages: list[bytes],
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
        if kernel is None or encoder is None or self.backend == "oracle":
            return None
        rel_tables = self._relation_tables_native(encoder)
        batch = encoder.encode_wire(
            messages, reuse=reuse, relation_tables=rel_tables
        )
        materialize = kernel.evaluate_async(batch)

        def finalize():
            decision, cacheable, status = materialize()[:3]
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
                d2, c2, s2 = kernel.evaluate_async(retry)()[:3]
                decision = np.array(decision)
                cacheable = np.array(cacheable)
                status = np.array(status)
                for j, b in enumerate(idx):
                    if retry.eligible[j]:
                        batch.eligible[b] = True
                        decision[b] = d2[j]
                        cacheable[b] = c2[j]
                        status[b] = s2[j]
            return batch, decision, cacheable, status

        return finalize
