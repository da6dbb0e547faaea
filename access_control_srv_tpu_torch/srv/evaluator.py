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

A refresh recompiles the whole tree (``compile_policies``), the JAX
evaluator's ``delta_enabled=False`` path; the JAX pod path compiles
through the delta subsystem's capacity-bucketed compile, which waits for
the delta slice (capacities differ, decisions do not).  Not ported yet:
the decision cache (and with it the epoch bump on tuple churn), token /
HR-scope preparation (token rows are served by the oracle, which
resolves them itself), delta patching, async compiles, the watchdog,
telemetry and tracing, the native wire encoder's relation tables and
tenancy.
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

from ..core.candidate_index import CandidateIndex
from ..core.engine import AccessController
from ..core.relation_path import (
    collect_target_instances,
    relation_paths,
    request_subject_id,
)
from ..models.model import Decision, OperationStatus, Response
from ..ops import reverse
from ..ops.compile import DECISION_NAMES, compile_policies
from ..ops.encode import _CAPS_FLOOR, encode_requests, fits_floor, request_needs
from ..ops.kernel import resolve_device
from ..ops.prefilter import PrefilteredKernel
from ..ops.relation import relation_bits_needed
from .explain import ExplainDecoder, explain_capacity_ok

# trees with fewer rules skip the candidate index (its build and lookups
# cost more than the walk it saves)
CANDIDATE_MIN_RULES = 256


class HybridEvaluator:
    def __init__(self, engine: AccessController, device=None,
                 explain: bool = False, mesh=None, mesh_axis: str = "data",
                 model_axis: Optional[str] = None,
                 pod_shards: Optional[int] = None):
        self.engine = engine
        # explain mode (srv/explain.py): the kernels' fourth output,
        # decoded onto each response
        self.explain = bool(explain)
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
        # candidate index over the LIVE engine tree: oracle rows skip rules
        # that provably cannot target-match (bit-identical).  Published as
        # ONE (tree, index) tuple so readers see a consistent pair; a hot
        # replace_policy_sets swap fails the identity check at once and
        # the refresh that follows rebuilds it.
        self._cand: Optional[tuple] = None
        # tuple writes seen by an attached relation store (the JAX
        # evaluator bumps its decision-cache epoch here; the port has no
        # decision cache yet)
        self.relation_churn = 0
        self._lock = threading.Lock()
        self.refresh(wait=True)

    # ------------------------------------------------------------- lifecycle

    def refresh(self, wait: bool = True) -> None:
        """Recompile the policy tensors after a tree mutation; the previous
        kernel serves until the swap."""
        if not wait:
            raise NotImplementedError(
                "async compile: not ported yet (evaluator slice)"
            )
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
        decoder = self._make_explain_decoder(compiled, kernel,
                                             tree_snapshot)
        cand = self._build_candidate_index()
        with self._lock:
            if version >= self._version:  # drop stale compiles
                self._compiled = compiled
                self._kernel = kernel
                self._rq_kernel = None  # lazy: built on first wia batch
                self._tree_snapshot = tree_snapshot
                self._explain_decoder = decoder
                self._cand = cand

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

    # ------------------------------------------------------ relation plumbing

    def attach_relation_store(self, store) -> None:
        """Wire a ``RelationTupleStore``: the oracle reads it through
        ``engine.relation_store`` and every batch encode packs its flat
        verdict tables.  Tuple churn changes decisions but swaps nothing:
        the compiled tables, the kernels and their built libraries stay
        as they are."""
        self.engine.relation_store = store

        def _on_change(_gen: int) -> None:
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

    # ------------------------------------------------------------ evaluation

    def is_allowed(self, request) -> Response:
        """Single-request path: the oracle."""
        return self._oracle_is_allowed(request)

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
        with self._lock:
            # one consistent snapshot: kernel, compiled and tree are always
            # published together, so kernel != None implies supported
            compiled = self._compiled
            kernel = self._kernel
            rq_kernel = self._rq_kernel
            tree_snapshot = self._tree_snapshot
        if (
            compiled is None
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
        """Batched decision path: kernel rows and oracle rows together."""
        return self.is_allowed_batch_async(requests)()

    def is_allowed_batch_async(self, requests: list):
        """Encode and launch now; the returned zero-arg ``finalize`` waits
        for the device result, decodes it and runs the oracle rows.
        Calling it at once is the synchronous path."""
        with self._lock:
            kernel = self._kernel
            compiled = self._compiled
        if kernel is None:
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
        for slot in oracle_rows:
            # candidate-filtered on large trees
            responses[slot] = self._oracle_is_allowed(requests[slot])
        return responses
