"""Batched ``whatIsAllowed`` (reverse query): the port's
``ReverseQueryKernel``.

The reverse query's cost in a batch setting is the repeated target match
per (request x node): for every policy set, policy and rule the oracle
walks the whole request attribute list (reference:
accessController.ts:326-427 calling targetMatches :661-672).  As in the
JAX package's ``ops/reverse.py``, the split is:

- device: per resource signature (ordered entity runs and their validity,
  operations, action pairs, the request has-props bit) the seven
  whatIsAllowed resource planes over every target row, computed by the
  ``wia_planes`` kernel (K5, ``csrc/wia_planes.cu``) for one
  representative row of each signature missing from the plane cache;
- host: the subject fold per row (numpy), the per-rule match cubes, and
  the replay of the oracle's exact control flow per request with device
  booleans in place of match results, re-running the scalar matcher
  ONLY on rows whose ``maybe_mask`` bit is set (target properties and an
  entity hit: the precondition of any masking-obligation append).

Result: ReverseQuery trees and obligations bit-identical to the scalar
oracle.  Steady traffic hits the plane cache and touches the device not
at all.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..models.model import OperationStatus, PolicyRQ, PolicySetRQ
from ..models.model import ReverseQuery, RuleRQ
from .carry import _tensor, lead_padding, pad_cols, pow2_bucket, tables_from_numpy
from .compile import CompiledPolicies
from .encode import RequestBatch, encode_requests
from .kernel import resolve_device, wia_planes
from .reverse_ref import PLANE_KEYS, WIA_ROWS, WIA_TABLES
from .staging import default_pool

# below this rule count the scalar reverse-query walk beats the device
# round-trip (the JAX package's measurement); mirrors ops/prefilter.MIN_RULES
REVERSE_MIN_RULES = 512

# plane-cache entries kept per kernel (oldest evicted first)
PLANE_CACHE_SIZE = 4096


class ReverseQueryKernel:
    """The whatIsAllowed match vectors of a batch: per-signature planes
    from the ``wia_planes`` kernel on ``device`` (``None`` = the CUDA
    device), cached, and the subject fold on the host.

    ``policy_sets`` is deep-copied at construction: hot tree mutations
    (engine.update_rule & co. mutate combinables dicts in place) must not
    shift nodes under the compiled index arrays mid-serve, so the reverse
    query serves version-pinned from this snapshot."""

    def __init__(self, compiled: CompiledPolicies, policy_sets,
                 copy_tree: bool = True, device=None):
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported by kernel: {compiled.unsupported_reason}"
            )
        self.compiled = compiled
        self.device = resolve_device(device)
        if isinstance(policy_sets, dict):
            sets = [ps for ps in policy_sets.values() if ps is not None]
        else:
            sets = [ps for ps in policy_sets if ps is not None]
        # copy_tree=False: the caller passes a tree that is already a
        # version-pinned snapshot (the evaluator publishes one alongside
        # the compiled arrays)
        self.sets = copy.deepcopy(sets) if copy_tree else sets
        # the tree's own (set, policy, rule) extents: on capacity-bucketed
        # tables (ops/delta.py) the slots past them are pads, which the
        # rule-match cubes need not cover
        self.live = (
            len(self.sets),
            max((len(ps.combinables) for ps in self.sets), default=0),
            max((len(pol.combinables) for ps in self.sets
                 for pol in ps.combinables.values() if pol is not None),
                default=0),
        )
        # RuleRQ carriers are request-independent (pure rule data), so one
        # shared instance per rule serves every request this kernel
        # answers.  ALIASING INVARIANT: one RuleRQ instance appears in MANY
        # responses -- consumers must treat it as immutable, and the id()
        # keys are valid only because self.sets pins the rule objects
        # alive for this kernel's lifetime.
        self._rule_rq_cache: dict[int, RuleRQ] = {}
        self._c = tables_from_numpy(compiled.arrays, self.device,
                                    keys=WIA_TABLES)
        self._plane_cache: dict[tuple, np.ndarray] = {}
        # the packed rows and the planes' readback (pinned on the card)
        self.staging = default_pool(pinned=self.device.type == "cuda")

    @staticmethod
    def signatures(batch: RequestBatch):
        """The batch's distinct resource signatures -> (sig [G, width]
        int32, first row of each [G], each row's signature [B]).

        A signature is the ordered entity runs (sticky regex state is
        order-sensitive) with their validity bits (a VALID slot whose
        value interned to ABSENT=-1 still drives regex/prefix state and
        must not collide with an absent slot), the sorted operations, the
        sorted action pairs and the request has-props bit (it flips the
        wia PERMIT property-fail, reference :592-615)."""
        a_ = batch.arrays
        ents = np.asarray(a_["r_ent_vals"])
        valid = np.asarray(a_["r_ent_valid"])
        ops = np.asarray(a_["r_op_vals"])
        act_ids = np.asarray(a_["r_act_ids"])
        acts = np.asarray(a_["r_act_vals"])
        hasp = np.asarray(a_["r_has_props"])
        B = ents.shape[0]
        ents_m = np.where(valid, ents, -1)
        pair_key = (act_ids.astype(np.int64) << 32) | (
            acts.astype(np.int64) & 0xFFFFFFFF
        )
        order = np.argsort(pair_key, axis=1, kind="stable")
        sig = np.concatenate(
            [ents_m, valid.astype(np.int32), np.sort(ops, 1),
             np.take_along_axis(act_ids, order, 1),
             np.take_along_axis(acts, order, 1),
             hasp.astype(np.int32).reshape(B, 1)],
            axis=1,
        )
        uniq, first_idx, inv = np.unique(
            sig, axis=0, return_index=True, return_inverse=True
        )
        return uniq, first_idx, inv.reshape(B)

    def pack_rows(self, batch: RequestBatch, rows: np.ndarray, n_pad: int):
        """The representative ``rows`` of ``batch`` packed into one leased
        int32 [n_pad, WROW] staging buffer (pad rows zero) -> (buffer,
        schedule of (name, width, tail))."""
        schedule = []
        for k in WIA_ROWS:
            tail = np.asarray(batch.arrays[k]).shape[1:]
            schedule.append((k, int(np.prod(tail)) if tail else 1,
                             tuple(tail)))
        W = sum(w for _, w, _ in schedule)
        mega = self.staging.acquire((n_pad, W), np.int32)
        off = 0
        for k, w, _ in schedule:
            a = np.asarray(batch.arrays[k])[rows]
            np.copyto(mega[:len(rows), off:off + w],
                      a.reshape(len(rows), w), casting="unsafe")
            off += w
        mega[len(rows):].fill(0)
        return mega, tuple(schedule)

    def _signature_planes(self, batch: RequestBatch, sig, first_idx):
        """[G, NK, T] resource planes for the batch's distinct signatures,
        via the plane cache; misses are computed in one ``wia_planes``
        launch over the first batch row of each missing signature (the
        planes depend only on signature fields, so any representative row
        works), padded to a power-of-two row count, and copied back once.
        The cache key carries the compiled version."""
        G = sig.shape[0]
        T = self.compiled.arrays["t_role"].shape[0]
        NK = len(PLANE_KEYS)
        planes = np.empty((G, NK, T), bool)
        missing = []
        gkeys = []
        for g in range(G):
            gk = (sig[g].tobytes(), self.compiled.version)
            gkeys.append(gk)
            got = self._plane_cache.get(gk)
            if got is None:
                missing.append(g)
            else:
                planes[g] = got
        if missing:
            out = self._launch_missing(batch, first_idx[missing])
            for j, g in enumerate(missing):
                planes[g] = out[j]
                if len(self._plane_cache) >= PLANE_CACHE_SIZE:
                    self._plane_cache.pop(next(iter(self._plane_cache)))
                # own copy: caching a view would pin the whole per-batch
                # buffer for the cache's lifetime
                self._plane_cache[gkeys[g]] = planes[g].copy()
        return planes

    def _launch_missing(self, batch: RequestBatch, rows: np.ndarray
                        ) -> np.ndarray:
        """One ``wia_planes`` launch over ``rows`` -> bool [n_pad, NK, T]
        on the host.  The packed rows and the planes travel through
        pooled (pinned, on the card) staging buffers, held until the
        event after the readback."""
        _, _, e_bucket, _ = lead_padding(batch)
        n_pad = pow2_bucket(len(rows), floor=8)
        pool = self.staging
        dev = self.device
        leases = []
        try:
            mega, schedule = self.pack_rows(batch, rows, n_pad)
            leases.append(mega)
            rows_d = pool.tensor(mega).to(dev, non_blocking=True)
            out = wia_planes(
                self._c, rows_d, schedule,
                _tensor(pad_cols(batch.rgx_set, e_bucket), dev),
                _tensor(pad_cols(batch.pfx_neq, e_bucket), dev),
            )
            host = pool.acquire(tuple(out.shape), np.bool_)
            leases.append(host)
            pool.tensor(host).copy_(out, non_blocking=True)
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
                done.synchronize()
            return host.copy()
        finally:
            pool.release_all(leases)

    def fold(self, batch: RequestBatch, row_planes: np.ndarray
             ) -> dict[str, np.ndarray]:
        """The subject fold (reference: checkSubjectMatches :793-823) over
        each row's planes [B, NK, T] -> {key: [B, T] bool}, the six wia
        vectors."""
        a_ = batch.arrays
        pk = {k: i for i, k in enumerate(PLANE_KEYS)}
        c = self.compiled.arrays
        t_role = c["t_role"]
        roles = np.asarray(a_["r_roles"])
        role_ok = (
            (t_role[None, :, None] == roles[:, None, :]).any(-1)
            & (t_role >= 0)[None, :]
        )  # [B, T]
        # the pair-subset fold is the widest intermediate
        # ([B, T, KS, KSr]); it only decides USER-targeted rows
        # (subjects without a role attribute), so it runs compacted to
        # that row subset -- zero-width for the common role-only tree
        pair_rows = np.nonzero(
            ~c["t_has_role"] & (c["t_n_subjects"] > 0)
        )[0]
        sub_ok = (c["t_n_subjects"] == 0)[None] | (
            c["t_has_role"][None] & role_ok
        )
        if pair_rows.size:
            ts_ids = c["t_sub_ids"][pair_rows]
            ts_vals = c["t_sub_vals"][pair_rows]
            sub_ids = np.asarray(a_["r_sub_ids"])
            sub_vals = np.asarray(a_["r_sub_vals"])
            eq = (
                (ts_ids[None, :, :, None] == sub_ids[:, None, None, :])
                & (ts_vals[None, :, :, None] == sub_vals[:, None, None, :])
                & (sub_ids[:, None, None, :] >= 0)
            )  # [B, Tp, KS, KSr]
            pairs_ok = ((ts_ids[None] < 0) | eq.any(-1)).all(-1)
            sub_ok[:, pair_rows] |= pairs_ok
        base = sub_ok & row_planes[:, pk["sig_act_ok"]]
        return {
            "tm_wia_ex_p": base & row_planes[:, pk["sig_wia_ex_p"]],
            "tm_wia_ex_d": base & row_planes[:, pk["sig_wia_ex_d"]],
            "tm_wia_rg_p": base & row_planes[:, pk["sig_wia_rg_p"]],
            "tm_wia_rg_d": base & row_planes[:, pk["sig_wia_rg_d"]],
            "maybe_mask_ex": row_planes[:, pk["sig_maybe_ex"]],
            "maybe_mask_rg": row_planes[:, pk["sig_maybe_rg"]],
        }

    def evaluate(self, batch: RequestBatch) -> dict[str, np.ndarray]:
        """Returns {key: [B, T] bool} for the six wia vectors:
        per-signature planes (cached; misses from the kernel), folded
        with each row's subjects."""
        uniq, first_idx, inv = self.signatures(batch)
        planes = self._signature_planes(batch, uniq, first_idx)
        return self.fold(batch, planes[inv])


def _rule_match_cubes(compiled: CompiledPolicies, masks: dict,
                      live: Optional[tuple] = None):
    """Vectorized per-rule wia verdicts for the whole batch, over the
    tree's ``live`` (set, policy, rule) extents when given (the kernel's
    ``live``; the whole padded tables otherwise).

    ``rule_match[b, s, kp, kr]``: the oracle's final rule-target verdict
    (no-target rules match; otherwise exact OR regex -- the regex call is
    a fallback, so the disjunction equals the sequential result).
    ``rule_maskful[b, s, kp, kr]``: some mode of the rule's target row
    could append obligations for row b -- those rules must go through the
    scalar matcher in oracle order, the rest can be collected wholesale."""
    a = compiled.arrays
    cut = (slice(None),) * 3 if live is None else tuple(
        slice(0, n) for n in live)
    a = {k: a[k][cut] for k in ("rule_target", "rule_effect",
                                "rule_has_target", "rule_valid")}
    rt = a["rule_target"]  # [S, KP, KR]
    deny = (a["rule_effect"] == 2)[None]
    ex = np.where(deny, masks["tm_wia_ex_d"][:, rt],
                  masks["tm_wia_ex_p"][:, rt])
    rg = np.where(deny, masks["tm_wia_rg_d"][:, rt],
                  masks["tm_wia_rg_p"][:, rt])
    has_t = a["rule_has_target"][None]
    rule_match = a["rule_valid"][None] & (~has_t | ex | rg)
    rule_maskful = has_t & (
        masks["maybe_mask_ex"][:, rt] | masks["maybe_mask_rg"][:, rt]
    )
    return rule_match, rule_maskful


def _assemble(
    engine, compiled: CompiledPolicies, sets, request, m,
    match_lists=None, maskful_any=None, rule_rq_cache=None,
) -> ReverseQuery:
    """Replay of AccessController.what_is_allowed (engine.py:425-553,
    reference accessController.ts:326-427) with device match vectors.

    ``sets``: the kernel's version-pinned tree snapshot -- MUST be the
    tree the compiled index arrays were built from.
    ``m``: {key: [T] bool} for this request.  Obligations are produced by
    the scalar matcher re-run on maybe_mask rows -- identical side-effect
    order to the oracle because the control flow is identical."""
    a = compiled.arrays
    obligations = []
    engine.prepare_context(request)
    entity_urn = engine.urns.get("entity")

    def tm(row: int, target_obj, effect, regex: bool) -> bool:
        mode = "rg" if regex else "ex"
        if m[f"maybe_mask_{mode}"][row]:
            return engine._target_matches(
                target_obj, request, "whatIsAllowed", obligations,
                effect, regex,
            )
        deny = effect == "DENY"
        return bool(m[f"tm_wia_{mode}_{'d' if deny else 'p'}"][row])

    policy_sets_rq: list[PolicySetRQ] = []
    for s, policy_set in enumerate(sets):
        if policy_set.target is None or tm(
            int(a["set_target"][s]), policy_set.target, None, False
        ):
            pset = PolicySetRQ(
                id=policy_set.id,
                target=policy_set.target,
                combining_algorithm=policy_set.combining_algorithm,
            )

            exact_match = False
            policy_effect = None
            for kp, policy in enumerate(policy_set.combinables.values()):
                if policy is None:
                    continue
                if policy.effect:
                    policy_effect = policy.effect
                if policy.target and tm(
                    int(a["pol_target"][s, kp]), policy.target,
                    policy_effect, False,
                ):
                    exact_match = True
                    break

            req_entity_count = len([
                at for at in (request.target.resources or [])
                if at and at.id == entity_urn
            ])
            if exact_match and req_entity_count > 1:
                exact_match = engine._check_multiple_entities_match(
                    policy_set, request, obligations
                )

            for kp, policy in enumerate(policy_set.combinables.values()):
                if policy is None:
                    continue
                row = int(a["pol_target"][s, kp])
                if (
                    policy.target is None
                    or (exact_match
                        and tm(row, policy.target, policy_effect, False))
                    or (not exact_match
                        and tm(row, policy.target, policy_effect, True))
                ):
                    policy_rq = PolicyRQ(
                        id=policy.id,
                        target=policy.target,
                        effect=policy.effect,
                        evaluation_cacheable=policy.evaluation_cacheable,
                        combining_algorithm=policy.combining_algorithm,
                        has_rules=bool(policy.combinables),
                    )
                    rules_list = list(policy.combinables.values())
                    fast = (
                        match_lists is not None
                        and not maskful_any[s, kp]
                    )
                    if fast:
                        # no rule of this policy can append obligations for
                        # this request: collect matches wholesale from the
                        # pre-grouped (s, kp) -> [kr] lists
                        matching = match_lists.get((s, kp), ())
                        rule_iter = ((kr, rules_list[kr]) for kr in matching)
                    else:
                        rule_iter = enumerate(rules_list)
                    for kr, rule in rule_iter:
                        if rule is None:
                            continue
                        if fast:
                            matches = True
                        else:
                            rrow = int(a["rule_target"][s, kp, kr])
                            matches = rule.target is None or tm(
                                rrow, rule.target, rule.effect, False
                            )
                            if not matches:
                                matches = tm(rrow, rule.target,
                                             rule.effect, True)
                        if rule.target is None or matches:
                            rq = None
                            if rule_rq_cache is not None:
                                rq = rule_rq_cache.get(id(rule))
                            if rq is None:
                                rq = RuleRQ(
                                    id=rule.id,
                                    target=rule.target,
                                    effect=rule.effect,
                                    condition=rule.condition,
                                    context_query=rule.context_query,
                                    evaluation_cacheable=(
                                        rule.evaluation_cacheable
                                    ),
                                )
                                if rule_rq_cache is not None:
                                    rule_rq_cache[id(rule)] = rq
                            policy_rq.rules.append(rq)
                    if policy_rq.effect or (
                        not policy_rq.effect and policy_rq.rules
                    ):
                        pset.policies.append(policy_rq)

            if pset.policies:
                policy_sets_rq.append(pset)

    return ReverseQuery(
        policy_sets=policy_sets_rq,
        obligations=obligations,
        operation_status=OperationStatus(),
    )


def assemble_batch(engine, compiled: CompiledPolicies,
                   kernel: ReverseQueryKernel, requests: list,
                   batch: RequestBatch, masks: dict, cubes: tuple
                   ) -> list[ReverseQuery]:
    """The oracle's control flow per request over the match vectors
    ``masks`` and the rule-match ``cubes`` (``_rule_match_cubes``);
    ineligible rows go to the scalar oracle wholesale."""
    rule_match, rule_maskful = cubes
    # one vectorized pass over the whole batch replaces per-request
    # nonzero/any calls in the assembly loop: matching (b, s, kp, kr)
    # tuples grouped per request, and the per-policy "any maskful rule"
    # bit reduced once
    maskful_any = rule_maskful.any(axis=3)  # [B, S, KP]
    mb, ms, mp, mk = np.nonzero(rule_match)
    bounds = np.searchsorted(mb, np.arange(len(requests) + 1))
    out = []
    for b, request in enumerate(requests):
        if not batch.eligible[b]:
            out.append(engine.what_is_allowed(request))
            continue
        m = {k: v[b] for k, v in masks.items()}
        match_lists: dict[tuple[int, int], list[int]] = {}
        for j in range(bounds[b], bounds[b + 1]):
            match_lists.setdefault(
                (int(ms[j]), int(mp[j])), []
            ).append(int(mk[j]))
        out.append(_assemble(
            engine, compiled, kernel.sets, request, m,
            match_lists, maskful_any[b],
            rule_rq_cache=kernel._rule_rq_cache,
        ))
    return out


def what_is_allowed_batch(
    engine,
    compiled: CompiledPolicies,
    kernel: ReverseQueryKernel,
    requests: list,
    batch: Optional[RequestBatch] = None,
) -> list[ReverseQuery]:
    """Batched reverse query: device match vectors + host assembly over
    the kernel's version-pinned tree snapshot; ineligible rows fall back
    to the scalar oracle wholesale."""
    if batch is None:
        # the reverse matcher never runs stage B, so the owner-bit packer
        # is skipped alongside conditions
        batch = encode_requests(
            requests, compiled, skip_conditions=True, skip_owner_bits=True
        )
    masks = kernel.evaluate(batch)
    return assemble_batch(engine, compiled, kernel, requests, batch, masks,
                          _rule_match_cubes(compiled, masks, kernel.live))
