"""Hybrid evaluator: the dense decision kernel fused with the scalar oracle.

The port's counterpart of the JAX package's ``srv/evaluator.py``, in its
uncached form: batched ``isAllowed`` requests are encoded (numpy), carried
to the device and decided by one ``DecisionKernel`` call; requests outside
the kernel's representable subset, whole trees the compiler rejects, and
condition-abort rows whose error message is ambiguous go to the oracle, so
decisions are bit-identical either way.

A refresh recompiles the whole tree (``compile_policies``), the JAX
evaluator's ``delta_enabled=False`` path.  Not ported yet: the decision
cache, token / HR-scope preparation (token rows are served by the oracle,
which resolves them itself), delta patching, async compiles, the watchdog,
telemetry and tracing, explain, relations and tenancy.  Trees of
``MIN_RULES`` rules or more, which the JAX evaluator serves through the
signature prefilter, are refused with ``NotImplementedError``.
"""

from __future__ import annotations

import copy
import threading
from typing import Optional

from ..core.engine import AccessController
from ..models.model import Decision, OperationStatus, Response
from ..ops.compile import DECISION_NAMES, compile_policies
from ..ops.encode import _CAPS_FLOOR, encode_requests, fits_floor, request_needs
from ..ops.kernel import DecisionKernel, resolve_device
from ..ops.prefilter import MIN_RULES


class HybridEvaluator:
    def __init__(self, engine: AccessController, device=None,
                 explain: bool = False):
        if explain:
            raise NotImplementedError(
                "explain output: not ported yet (serving-shell slice)"
            )
        self.engine = engine
        self.device = resolve_device(device)
        self._version = 0
        self._compiled = None
        self._kernel: Optional[DecisionKernel] = None
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
            if compiled.n_rules >= MIN_RULES:
                raise NotImplementedError(
                    f"trees of {MIN_RULES} rules or more take the signature "
                    f"prefilter path: not ported yet (signature slice); this "
                    f"tree has {compiled.n_rules}"
                )
            kernel = DecisionKernel(compiled, device=self.device)
        with self._lock:
            if version >= self._version:  # drop stale compiles
                self._compiled = compiled
                self._kernel = kernel

    @property
    def kernel_active(self) -> bool:
        return self._kernel is not None

    # ------------------------------------------------------------ evaluation

    def is_allowed(self, request) -> Response:
        """Single-request path: the oracle."""
        return self.engine.is_allowed(request)

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
            return lambda: [self.engine.is_allowed(r) for r in requests]

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
        )
        materialize = kernel.evaluate_async(batch)

        def finalize():
            return self._decode_batch(requests, batch, materialize())

        return finalize

    def _decode_batch(self, requests, batch, outputs) -> list[Response]:
        decision, cacheable, status = outputs
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
                    responses.append(Response(
                        decision=Decision.DENY,
                        obligations=[],
                        evaluation_cacheable=cach,
                        operation_status=OperationStatus(
                            code=int(status[b]), message=msgs.pop()
                        ),
                    ))
                    continue
            if not batch.eligible[b] or status[b] != 200:
                # ineligible rows and ambiguous abort rows: the oracle
                oracle_rows.append(len(responses))
                responses.append(None)
                continue
            cach = None if cacheable[b] < 0 else bool(cacheable[b])
            responses.append(Response(
                decision=DECISION_NAMES[int(decision[b])],
                obligations=[],
                evaluation_cacheable=cach,
                operation_status=OperationStatus(),
            ))
        for slot in oracle_rows:
            responses[slot] = self.engine.is_allowed(requests[slot])
        return responses
