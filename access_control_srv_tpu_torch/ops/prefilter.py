"""Signature prefilter for large rule trees: the port's ``PrefilteredKernel``.

The dense kernel's per-request work is O(total target rows): every rule's
target row is matched against every request, although a rule whose target
names entity X can never match a request that names only entity Y.  With
100k rules that dense sweep is the whole cost.

This module restores O(matching rules), as the JAX package's
``ops/prefilter.py`` does: batch rows are grouped by their resource
signature (entity value ids, operation ids, action pairs); for each
signature the rule axis is compacted to the candidate subset, left-packed
along KR in the original order (``compact_rules``).  Combining algorithms
are order-sensitive only relatively, so dropping rules that provably
cannot match while keeping the relative order leaves every decision
bit-identical.  Policy and set target rows are always kept.

The compacted subtrees of a batch are padded to one shape and stacked on
a leading group axis ``[G, ...]`` on the device.  Then, per batch:

- batches without ACL pairs or request properties take the signature
  path: stage A's resource/action planes depend only on the signature, so
  they are computed once per signature set by the ``sig_planes`` kernel
  (K2) and cached; the rows, sorted by signature into ``[NSLOT, R]`` slots
  of one group each and packed into one int32 row buffer, are decided by
  the ``sig_decide`` kernel (K3), which folds the subject side, the owner
  bitplanes, the relation-closure bitplanes, the ACL short path and the
  conditions per row;
- any other batch is decided by the ``decide_grouped`` kernel (K4), the
  dense program per row against its own group's subtree.

Trees under ``MIN_RULES`` rules skip the machinery and delegate to the
dense ``DecisionKernel``.  Compacted subtrees, stacks, planes and parsed
signature groups are cached, so steady traffic pays neither compaction
nor the upload of policy data again.

Relation-path (ReBAC) trees take the kernels' ``with_rel`` variants: the
signature planes carry each rule's and policy's relation-vocab index and
``!direct`` flag, and the packed rows carry the batch's closure bitplanes.

With a ``mesh`` (``parallel/mesh.py``) requests shard over its ``axis``
while the stacks and planes replicate, as in the JAX package: below
``MIN_RULES`` the delegate is ``ShardedDecisionKernel`` (K6); above it
K4's rows and K3's slots split over the ranks of the axis, each rank
launches its share, and the outputs merge over the axis group (K4's
``[3, rows]`` all-gathered; K3's request-order outputs, zero on the rows
another rank decides, summed).

``explain=True`` adds the provenance code as a fourth output (the JAX
kernel's explain mode): the compacted subtrees then record each slot's
original flat position (``rule_orig_flat``), which K3 and K4 map the
winning rule through, so the codes decode with the uncompacted strides
``explain_strides = (KP, KR)``.

``dynamic_policies=True`` (the hot-update mode, ops/delta.py) registers
the kernel's runners (``kernel.Runner``: ``sig_planes`` under the JAX
package's ``("bits", needs_hr, needs_rel)``, ``sig_decide`` under
``("sig", schedule, needs_pairs, with_hr, with_rel)``, ``decide_grouped``
under ``("pref", (with_acl, with_hr, with_rel))``, ``"explain"``
appended in explain mode, and the dense delegate's) in ``shared_jits``,
so a kernel swapped in over patched tables reuses them: no build and no
library load.
"""

from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple, Optional

import numpy as np
import torch

from .carry import (
    batch_from_numpy,
    half_pow2_bucket,
    lead_padding,
    pow2_bucket,
    stacked_from_numpy,
    tables_from_numpy,
)
from .compile import CompiledPolicies
from .kernel import (
    ORIG_TABLE,
    DecisionKernel,
    ROW_ARRAYS,
    Runner,
    TABLE_ARRAYS,
    carve,
    carve_plan,
    decide_grouped,
    readback,
    resolve_device,
    runner,
    sig_decide,
    sig_planes,
    slot_layout,
    tree_needs_hr,
    tree_needs_rel,
)
from .staging import HostBufferPool, default_pool

# rules below this count are cheaper to sweep densely than to group/compact
MIN_RULES = 512

# varying arrays the signature kernel reads per group (stage E-G inputs);
# everything stage-A/target-table-shaped is folded into the planes
_SIG_C_KEYS = [
    "rule_valid", "rule_effect", "rule_cacheable_raw", "rule_cacheable_eff",
    "rule_has_target", "rule_cond",
]
_SIG_R_KEYS = [
    "r_sub_ids", "r_sub_vals", "r_roles", "r_act_ids", "r_act_vals",
    "r_n_entity_attrs", "r_n_ra", "r_acl_short",
]
# additional per-row arrays when the tree carries HR-bearing targets: the
# owner side travels as host-packed bitplanes (r_ctx_present packed as an
# int32 column)
_SIG_R_KEYS_HR = _SIG_R_KEYS + ["r_ctx_present", "r_own_runs", "r_own_bits"]
# the relation-closure bitplanes ride the same packed row buffer
_SIG_R_KEYS_REL = ["r_rel_runs", "r_rel_bits"]

_RULE_FIELDS = [
    "rule_valid", "rule_effect", "rule_cacheable_raw", "rule_cacheable_eff",
    "rule_has_target", "rule_target", "rule_cond",
]


def _is_varying(name: str) -> bool:
    """Arrays that differ between signature subtrees (compacted rule axis,
    compacted target subtable, remapped target indices); everything else is
    group-invariant policy/set metadata shared across the stack."""
    return (
        name in _RULE_FIELDS
        or name in ("pol_target", "set_target", ORIG_TABLE)
        or name.startswith("t_")
    )


# the kernel tables, split into the stacked per-group part and the shared
VARYING_TABLES = tuple(k for k in TABLE_ARRAYS if _is_varying(k))
INVARIANT_TABLES = tuple(k for k in TABLE_ARRAYS if not _is_varying(k))


def candidate_rows(
    compiled: CompiledPolicies,
    ent_ids: np.ndarray,
    ent_cols: np.ndarray,
    op_ids: np.ndarray,
    act_vals: np.ndarray,
    rgx_set: np.ndarray,
) -> np.ndarray:
    """[T] bool: target rows that could produce a match for a request
    whose distinct entity value ids are ``ent_ids`` (batch entity columns
    ``ent_cols``), operation ids ``op_ids`` and action attribute values
    ``act_vals``.

    Resource side: no-resource targets, exact entity hits, regex entity
    hits, operation hits.  Action side: every target action attribute must
    find an id+value pair in the request (kernel ``act_ok``), so a target
    action VALUE absent from the request's action values disqualifies the
    row — value-only filtering is conservative (id mismatches are left for
    the kernel), which keeps signature aliasing safe."""
    a = compiled.arrays
    tv = a["t_ent_vals"]  # [T, K_ENT]
    cand = a["t_n_res"] == 0
    if ent_ids.size:
        cand = cand | (np.isin(tv, ent_ids) & (tv >= 0)).any(axis=1)
        # regex candidacy: any target vocab row regex-hits a batch entity col
        w = a["t_ent_w"]  # [T, K_ENT]
        hits = rgx_set[np.clip(w, 0, None)][:, :, ent_cols]  # [T, K, |cols|]
        cand = cand | (hits & (w >= 0)[:, :, None]).any(axis=(1, 2))
    if op_ids.size:
        ov = a["t_op_vals"]
        cand = cand | (np.isin(ov, op_ids) & (ov >= 0)).any(axis=1)
    av = a["t_act_vals"]  # [T, K_ACT]
    act_compat = ((av < 0) | np.isin(av, act_vals)).all(axis=1)
    return cand & act_compat


def compact_rules(compiled: CompiledPolicies, row_cand: np.ndarray,
                  explain: bool = False) -> CompiledPolicies:
    """Left-pack candidate rules along KR (order-preserving) and compact
    the target subtable to the rows the kept rules and all policy/set
    targets reference.  Accepts either package's ``CompiledPolicies`` and
    returns the same type.  ``explain=True`` also records
    ``rule_orig_flat`` [S, KP, KRp]: each compacted slot's original flat
    rule position ``(s * KP + kp) * KR + kr``."""
    a = compiled.arrays
    cand = a["rule_valid"] & (~a["rule_has_target"] | row_cand[a["rule_target"]])

    counts = cand.sum(axis=2)
    krp = pow2_bucket(int(counts.max()) if counts.size else 0, floor=4)
    krp = min(krp, compiled.KR) if compiled.KR else krp
    order = np.argsort(~cand, axis=2, kind="stable")  # candidates first
    new: dict[str, np.ndarray] = {}
    for name in _RULE_FIELDS:
        new[name] = np.take_along_axis(a[name], order, axis=2)[:, :, :krp]
    new["rule_valid"] = np.take_along_axis(cand, order, axis=2)[:, :, :krp]
    if explain:
        S, KP, KR = a["rule_valid"].shape
        base = (np.arange(S, dtype=np.int64)[:, None, None] * KP
                + np.arange(KP, dtype=np.int64)[None, :, None]) * KR
        new[ORIG_TABLE] = (base + order[:, :, :krp]).astype(np.int32)

    needed = set(
        np.unique(new["rule_target"][new["rule_valid"] & new["rule_has_target"]])
    )
    needed |= set(np.unique(a["pol_target"][a["pol_has_target"]]))
    needed |= set(np.unique(a["set_target"][a["set_has_target"]]))
    needed.add(0)  # row 0 backs the "no target" index
    rows = sorted(needed)
    remap = np.zeros(a["t_role"].shape[0], np.int64)
    for j, old in enumerate(rows):
        remap[old] = j
    for name, arr in a.items():
        if name.startswith("t_"):
            new[name] = arr[rows]
        elif name not in new:
            new[name] = arr
    new["rule_target"] = remap[new["rule_target"]].astype(np.int32)
    new["pol_target"] = remap[a["pol_target"]].astype(np.int32)
    new["set_target"] = remap[a["set_target"]].astype(np.int32)
    return replace(compiled, arrays=new, KR=krp, T=len(rows))


def _pad_sub(arr: np.ndarray, name: str, krp: int, tp: int) -> np.ndarray:
    """Pad one compacted-subtree array to the stack's common KR/T."""
    if name in _RULE_FIELDS or name == ORIG_TABLE:
        width = krp - arr.shape[2]
        if width > 0:
            fill = (
                False if arr.dtype == bool
                else (0 if name in ("rule_effect", "rule_target") else -1)
            )
            arr = np.concatenate(
                [arr, np.full(arr.shape[:2] + (width,), fill, arr.dtype)],
                axis=2,
            )
        return arr
    if name.startswith("t_") and arr.shape[0] < tp:
        reps = np.repeat(arr[:1], tp - arr.shape[0], axis=0)
        arr = np.concatenate([arr, reps], axis=0)
    return arr


class Stack(NamedTuple):
    """A signature set's stacked subtrees on the device, with the static
    facts the kernels are chosen by."""

    tables: dict  # name -> [G, ...] tensor of the varying kernel tables
    needs_pairs: bool  # some subject-bearing target matches by pairs
    with_hr: bool  # tree_needs_hr of the stacked tables
    with_rel: bool  # tree_needs_rel of the stacked tables


class PrefilteredKernel:
    """Drop-in ``DecisionKernel``: groups the batch by resource signature,
    compacts the rule axis per signature, and decides the whole batch in
    one launch over the stacked subtrees.  Decisions are bit-identical to
    the dense kernel; trees under ``MIN_RULES`` rules skip the machinery.
    The stacks and planes live on ``device`` (``None`` = the CUDA
    device)."""

    def __init__(self, compiled: CompiledPolicies, device=None,
                 cache_size: int = 1024, mesh=None, axis: str = "data",
                 max_groups: int = 512, telemetry=None,
                 dynamic_policies: bool = False,
                 shared_jits: Optional[dict] = None,
                 staging: Optional[HostBufferPool] = None,
                 explain: bool = False):
        """``max_groups``: cardinality guard, a batch whose rows span more
        than this many distinct signatures is split into group-bounded
        segments decided separately, so adversarial traffic degrades to
        more launches instead of unbounded stack memory.

        ``telemetry``: anything with ``.paths.inc(key, n)``; counts the
        compaction/stack cache hits and misses and guard splits.

        ``staging``: the host buffer pool of the packed row buffer and
        the slot maps (pinned when the device is CUDA).

        ``mesh``: a ``parallel.mesh.Mesh``; requests shard over its
        ``axis`` and the tables live on the mesh's device.

        ``dynamic_policies``: the hot-update mode (ops/delta.py): the
        kernel's runners live in ``shared_jits`` (see the module
        docstring), so a kernel swapped in over patched tables of the
        same shapes reuses them."""
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported by kernel: {compiled.unsupported_reason}"
            )
        self.compiled = compiled
        self.dynamic_policies = bool(dynamic_policies)
        self._shared = shared_jits if shared_jits is not None else {}
        self._runs: dict[tuple, Runner] = {}
        self.mesh = mesh
        self.axis = axis
        self.explain = bool(explain)
        # compacted slots map back through rule_orig_flat, so the codes
        # decode with the uncompacted strides
        self.explain_strides = (compiled.KP, compiled.KR)
        # explain-off launches pass no keyword: their calls are unchanged
        self._explain_kw = {"explain": True} if explain else {}
        self.device = mesh.device if mesh is not None else resolve_device(
            device)
        self.cache_size = cache_size
        self.max_groups = max_groups
        self.telemetry = telemetry
        self.staging = staging if staging is not None else default_pool(
            pinned=self.device.type == "cuda"
        )
        self._subs: dict[tuple, CompiledPolicies] = {}
        self._stacks: dict[tuple, Stack] = {}
        self._bits: dict[tuple, dict[str, torch.Tensor]] = {}
        self._ginfo: dict[tuple, tuple] = {}
        self._dense = None
        # the variant of the signature kernels, fixed for the tree: the
        # sub-tree, stack and plane caches live on this instance, so each
        # holds one variant's entries
        self.needs_hr = tree_needs_hr(compiled.arrays)
        self.needs_rel = tree_needs_rel(compiled.arrays)
        self.active = compiled.n_rules >= MIN_RULES
        if not self.active:
            if mesh is not None:
                # a configured mesh is honored on every tree size
                from ..parallel.mesh import ShardedDecisionKernel

                self._dense = ShardedDecisionKernel(compiled, mesh, axis,
                                                    explain=self.explain)
            else:
                self._dense = DecisionKernel(
                    compiled, device=self.device,
                    dynamic_policies=dynamic_policies,
                    shared_jits=self._shared, explain=self.explain)
        self._c_inv = tables_from_numpy(compiled.arrays, self.device,
                                        keys=INVARIANT_TABLES)

    # ---------------------------------------------------------------- caches
    def _count(self, key: str, n: int = 1) -> None:
        if self.telemetry is not None and n:
            self.telemetry.paths.inc(key, n)

    def _runner(self, key: tuple, name: str, *flags,
                explains: bool = True) -> Runner:
        """The runner of wrapper ``name`` in the variant ``flags`` under
        the JAX package's ``key`` (``"explain"`` appended in explain mode
        where the wrapper ``explains``): this kernel's own, else the
        shared registry's in ``dynamic_policies`` mode, else a new one."""
        kw = self._explain_kw if explains else {}
        key = key + (("explain",) if kw else ())
        run = self._runs.get(key)
        if run is None:
            run = self._runs[key] = runner(
                self._shared, self.dynamic_policies, key, globals(), name,
                *flags, **kw)
        return run

    def _sub(self, key, ent_ids, ent_cols, op_ids, act_vals,
             rgx_set) -> CompiledPolicies:
        sub = self._subs.pop(key, None)  # LRU: reinsert at the tail
        if sub is None:
            self._count("prefilter-sub-miss")
            rows = candidate_rows(
                self.compiled, ent_ids, ent_cols, op_ids, act_vals, rgx_set
            )
            sub = compact_rules(self.compiled, rows, explain=self.explain)
            if len(self._subs) >= self.cache_size:
                self._subs.pop(next(iter(self._subs)))
        else:
            self._count("prefilter-sub-hit")
        self._subs[key] = sub
        return sub

    def _stack(self, keys: tuple, subs: list[CompiledPolicies]) -> Stack:
        stack = self._stacks.pop(keys, None)
        if stack is None:
            self._count("prefilter-stack-miss")
            krp = pow2_bucket(max(s.KR for s in subs), floor=4)
            tp = pow2_bucket(max(s.T for s in subs), floor=8)
            keys_v = VARYING_TABLES + ((ORIG_TABLE,) if self.explain else ())
            padded = [
                {k: _pad_sub(s.arrays[k], k, krp, tp) for k in keys_v}
                for s in subs
            ]
            has_role = np.stack([p["t_has_role"] for p in padded])
            n_sub = np.stack([p["t_n_subjects"] for p in padded])
            stack = Stack(
                tables=stacked_from_numpy(padded, self.device, keys_v),
                needs_pairs=bool((~has_role & (n_sub > 0)).any()),
                with_hr=any(tree_needs_hr(p) for p in padded),
                with_rel=any(tree_needs_rel(p) for p in padded),
            )
            if len(self._stacks) >= 16:
                self._stacks.pop(next(iter(self._stacks)))
        else:
            self._count("prefilter-stack-hit")
        self._stacks[keys] = stack
        return stack

    def _planes_for(self, keys: tuple, groups: list[dict], stack: Stack,
                    widths: tuple, rgx_np, pfx_np) -> dict:
        """Per-signature stage-A planes pre-gathered to rule/policy/set
        granularity ([G, S, KP, KR] / [G, S, KP] / [G, S]), cached per
        signature set.  One ``sig_planes`` call over per-group
        pseudo-requests (the signature's entities, operations and actions;
        no subjects or properties) against the stacked target tables:
        regex outcomes are deterministic per (vocab row, entity value), so
        the planes do not depend on the batch.  The pseudo-requests travel
        packed in one pooled host buffer (pinned on the card), one copy,
        held until an event after the launch."""
        bits = self._bits.pop(keys, None)
        if bits is None:
            NR, NOP, NACT = widths
            G = len(groups)
            W = rgx_np.shape[0]
            p_ent = np.full((G, NR), -1, np.int32)
            p_ent_e = np.zeros((G, NR), np.int32)
            p_ent_valid = np.zeros((G, NR), bool)
            p_ops = np.full((G, NOP), -1, np.int32)
            p_act_ids = np.full((G, NACT), -1, np.int32)
            p_act_vals = np.full((G, NACT), -1, np.int32)
            p_rgx = np.zeros((G, W, max(NR, 1)), bool)
            p_pfx = np.zeros((G, W, max(NR, 1)), bool)
            for g, info in enumerate(groups):
                ents = info["ordered_ents"]
                cols = info["ordered_cols"]
                for j, (e, col) in enumerate(zip(ents, cols)):
                    p_ent[g, j] = e
                    p_ent_e[g, j] = j
                    if e >= 0:
                        p_ent_valid[g, j] = True
                        p_rgx[g, :, j] = rgx_np[:, col]
                        p_pfx[g, :, j] = pfx_np[:, col]
                ops = info["op_ids"]
                p_ops[g, : len(ops)] = ops
                for j, (aid, aval) in enumerate(info["act_pairs"]):
                    p_act_ids[g, j] = aid
                    p_act_vals[g, j] = aval
            neg1 = np.full((G, 1), -1, np.int32)
            pseudo = {
                "r_act_ids": p_act_ids,
                "r_act_vals": p_act_vals,
                "r_ent_vals": p_ent,
                "r_ent_e": p_ent_e,
                "r_ent_valid": p_ent_valid,
                "r_prop_vals": neg1,
                "r_prop_sfx": neg1,
                "r_prop_run": neg1,
                "r_prop_tail": neg1,
                "r_op_vals": p_ops,
                "r_has_props": np.zeros((G,), bool),
                "rgx_set": p_rgx,
                "pfx_neq": p_pfx,
            }
            plan, nbytes = carve_plan(
                [(k, v.shape, v.dtype, None) for k, v in pseudo.items()])
            host = self.staging.acquire((pow2_bucket(nbytes, floor=4096),),
                                        np.uint8)
            try:
                for k, v in carve(host, plan).items():
                    v[...] = pseudo[k]
                packed = self.staging.tensor(host)[:nbytes].to(
                    self.device, non_blocking=True)
                run = self._runner(
                    ("bits", self.needs_hr, self.needs_rel), "sig_planes",
                    self.needs_hr, self.needs_rel, explains=False)
                bits = run(stack.tables, self._c_inv, carve(packed, plan))
                if self.device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                    done.synchronize()
            finally:
                self.staging.release(host)
            if len(self._bits) >= 16:
                self._bits.pop(next(iter(self._bits)))
        self._bits[keys] = bits
        return bits

    # -------------------------------------------------------------- evaluate
    def evaluate(self, batch):
        return self.evaluate_async(batch)()

    def evaluate_async(self, batch):
        """Host preparation and launch without waiting for the result;
        returns a zero-arg callable that materializes the (decision,
        cacheable, status) tuple of numpy int32 [B] arrays (and the
        provenance codes fourth in explain mode).  Callers that
        stream batches overlap batch i+1's host grouping and packing with
        batch i's device work."""
        if not self.active:
            # small trees: the dense kernel's own async launch
            return self._dense.evaluate_async(batch)

        ents = np.asarray(batch.arrays["r_ent_vals"])  # [B, NR]
        cols = np.asarray(batch.arrays["r_ent_e"])     # [B, NR]
        valid = np.asarray(batch.arrays["r_ent_valid"])
        ops = np.asarray(batch.arrays["r_op_vals"])    # [B, NOP]
        act_ids = np.asarray(batch.arrays["r_act_ids"])
        acts = np.asarray(batch.arrays["r_act_vals"])  # [B, NACT]
        B, NR = ents.shape
        NOP = ops.shape[1]
        NACT = acts.shape[1]

        # signature-plane eligibility: no ACL pairs / request properties
        # in this batch (those rows need the full per-row matcher)
        with_acl = bool((np.asarray(batch.arrays["r_acl_ent"]) >= 0).any())
        use_sig = (
            not with_acl
            and not bool(np.asarray(batch.arrays["r_has_props"]).any())
        )

        # signature path: group rows by ORDERED entity runs (the sticky /
        # prefix-reset state machines are order-sensitive) + sorted ops +
        # sorted action (id, val) pairs.  Fallback path: stage A runs per
        # row anyway, so the coarser order-insensitive signature maximizes
        # group sharing
        ents_m = np.where(valid, ents, -1)
        pair_key = (act_ids.astype(np.int64) << 32) | (
            acts.astype(np.int64) & 0xFFFFFFFF
        )
        order = np.argsort(pair_key, axis=1, kind="stable")
        act_ids_s = np.take_along_axis(act_ids, order, 1)
        act_vals_s = np.take_along_axis(acts, order, 1)
        if use_sig:
            sig = np.concatenate(
                [ents_m, np.sort(ops, 1), act_ids_s, act_vals_s], axis=1
            )
        else:
            sig = np.concatenate(
                [np.sort(ents_m, 1), np.sort(ops, 1), np.sort(acts, 1)],
                axis=1,
            )
        # exact mixed-radix packing of the signature columns into one
        # int64 key when the value ranges fit; order-preserving, so the
        # group order matches the lexicographic fallback
        shifted = sig.astype(np.int64) + 1  # -1 padding -> 0
        radix = shifted.max(axis=0) + 1
        if float(np.prod(radix.astype(np.float64))) < 2.0 ** 62:
            key = np.zeros(B, np.int64)
            for j in range(sig.shape[1]):
                key = key * radix[j] + shifted[:, j]
            _, first_idx, inv = np.unique(
                key, return_index=True, return_inverse=True
            )
            uniq = sig[first_idx]
        else:
            uniq, inv = np.unique(sig, axis=0, return_inverse=True)
        inv = inv.reshape(B)

        if uniq.shape[0] > self.max_groups:
            return self._guard_split(batch, inv)

        # entity value id -> batch entity column (positional in the runs)
        id_to_col = dict(zip(ents[valid].tolist(), cols[valid].tolist()))

        rgx_np = np.asarray(batch.rgx_set)
        pfx_np = np.asarray(batch.pfx_neq)
        keys = []
        groups = []
        subs = []  # held directly: cache eviction cannot orphan this batch
        for g in range(uniq.shape[0]):
            ginfo = self._group_info(uniq[g], NR, NOP, NACT, use_sig)
            sub_key, key_entry, group_entry, ent_ids, op_ids, act_vals = ginfo
            ent_cols = np.array(
                [id_to_col[int(e)] for e in ent_ids], np.int64
            )
            subs.append(
                self._sub(sub_key, ent_ids, ent_cols, op_ids, act_vals,
                          rgx_np)
            )
            keys.append(key_entry)
            if group_entry is not None:
                # ordered_cols is batch-positional (regex matrix columns),
                # so it is derived fresh per batch
                groups.append({
                    **group_entry,
                    "ordered_cols": [
                        id_to_col.get(int(e), 0)
                        for e in group_entry["ordered_ents"]
                    ],
                })
        stack = self._stack(tuple(keys), subs)

        if use_sig:
            bits = self._planes_for(tuple(keys), groups, stack,
                                    (NR, NOP, NACT), rgx_np, pfx_np)
            return self._launch_sig(batch, inv, uniq.shape[0], stack, bits)
        return self._launch_grouped(batch, inv, stack, with_acl)

    def _group_info(self, sig_row, NR, NOP, NACT, use_sig) -> tuple:
        """The parsed signature group (cache keys, unique ids, pair list),
        memoized by the raw signature bytes: steady traffic repeats
        signatures, so a recurring group costs one dict lookup."""
        gkey = (sig_row.tobytes(), NR, NOP, NACT, use_sig,
                self.compiled.version)
        ginfo = self._ginfo.get(gkey)
        if ginfo is not None:
            return ginfo
        ordered = sig_row[:NR]
        ent_ids = np.unique(ordered[ordered >= 0])
        op_row = sig_row[NR:NR + NOP]
        op_ids = np.unique(op_row[op_row >= 0])
        if use_sig:
            aid_row = sig_row[NR + NOP:NR + NOP + NACT]
            aval_row = sig_row[NR + NOP + NACT:]
        else:
            aid_row = np.full((0,), -1, sig_row.dtype)
            aval_row = sig_row[NR + NOP:]
        pair_valid = (aid_row >= 0) | (aval_row[: aid_row.shape[0]] >= 0)
        act_vals = np.unique(aval_row[aval_row >= 0])
        # the compaction key stays sorted (order-insensitive candidacy:
        # permuted signatures share one compacted subtree)
        sub_key = (tuple(ent_ids.tolist()), tuple(op_ids.tolist()),
                   tuple(act_vals.tolist()), self.compiled.version)
        if use_sig:
            key_entry = (tuple(ordered.tolist()), tuple(op_ids.tolist()),
                         tuple(aid_row[pair_valid].tolist()),
                         tuple(aval_row[pair_valid].tolist()),
                         self.compiled.version)
            group_entry = {
                "ordered_ents": ordered.tolist(),
                "op_ids": op_ids,
                "act_pairs": list(zip(aid_row[pair_valid].tolist(),
                                      aval_row[pair_valid].tolist())),
            }
        else:
            key_entry = sub_key
            group_entry = None
        ginfo = (sub_key, key_entry, group_entry, ent_ids, op_ids, act_vals)
        if len(self._ginfo) >= 8192:
            self._ginfo.pop(next(iter(self._ginfo)))
        self._ginfo[gkey] = ginfo
        return ginfo

    def _guard_split(self, batch, inv):
        """Cardinality guard: segment the batch so each launch spans at
        most ``max_groups`` signatures, each segment evaluated alone."""
        self._count("prefilter-guard-splits")
        B = inv.shape[0]
        row_order = np.argsort(inv, kind="stable")
        seg_slices = []
        start = 0
        seen = 0
        last_group = -1
        for pos, gidx in enumerate(inv[row_order].tolist()):
            if gidx != last_group:
                seen += 1
                last_group = gidx
                if seen > self.max_groups:
                    seg_slices.append(row_order[start:pos])
                    start = pos
                    seen = 1
        seg_slices.append(row_order[start:])
        outs = [np.zeros((B,), np.int32)
                for _ in range(4 if self.explain else 3)]
        for idx in seg_slices:
            sub_batch = type(batch)(
                B=len(idx),
                arrays={k: np.ascontiguousarray(np.asarray(v)[idx])
                        for k, v in batch.arrays.items()},
                rgx_set=batch.rgx_set,
                pfx_neq=batch.pfx_neq,
                cond_true=np.ascontiguousarray(batch.cond_true[:, idx]),
                cond_abort=np.ascontiguousarray(batch.cond_abort[:, idx]),
                cond_code=np.ascontiguousarray(batch.cond_code[:, idx]),
                eligible=np.asarray(batch.eligible)[idx],
            )
            for o, s in zip(outs, self.evaluate(sub_batch)):
                o[idx] = s
        res = tuple(outs)
        return lambda: res

    def _launch_sig(self, batch, inv, G: int, stack: Stack, bits: dict):
        """The signature path: pack the rows into one pooled int32 buffer,
        lay them out in group-dense ``[NSLOT, R]`` slots and launch K3."""
        B = inv.shape[0]
        r_keys = _SIG_R_KEYS_HR if self.needs_hr else _SIG_R_KEYS
        if self.needs_rel:
            r_keys = r_keys + _SIG_R_KEYS_REL
        schedule = []
        for k in r_keys:
            tail = np.asarray(batch.arrays[k]).shape[1:]
            schedule.append((k, int(np.prod(tail)) if tail else 1,
                             tuple(tail)))
        C = batch.cond_true.shape[0]
        for nm in ("cond_true", "cond_abort", "cond_code"):
            schedule.append((nm, C, (C,)))
        W = sum(w for _, w, _ in schedule)
        # pad the row buffer and the readback map to the half-pow2 bucket
        b_pad = half_pow2_bucket(B, floor=8)
        pool = self.staging
        leases: list = []

        def take(shape):
            buf = pool.acquire(shape, np.int32)
            leases.append(buf)
            return buf

        try:
            mega_rows = take((b_pad, W))
            off = 0
            for k, w, _ in schedule:
                src = (np.asarray(batch.arrays[k]).reshape(B, w)
                       if not k.startswith("cond_")
                       else np.asarray(getattr(batch, k)).T)
                np.copyto(mega_rows[:B, off:off + w], src, casting="unsafe")
                off += w
            if b_pad != B:
                mega_rows[B:].fill(0)

            # group-dense slot layout: rows sorted by signature, packed
            # into [NSLOT, R] slots that each share one group
            n_data = 1 if self.mesh is None else self.mesh.shape[self.axis]
            slot_g, grid2row_flat, gp_orig, R, _, ns_pad = slot_layout(
                inv, G, b_pad, n_data, take)

            ns_own = ns_pad
            if n_data > 1:
                # this rank's share of the slots; rows in other ranks'
                # slots map to -1 and stay 0 in this rank's output
                ns_own = ns_pad // n_data
                lo = self.mesh.coords[self.axis] * ns_own * R
                gp_own = take((b_pad,))
                np.copyto(gp_own, np.where(
                    (gp_orig >= lo) & (gp_orig < lo + ns_own * R),
                    gp_orig - lo, -1))
                gp_own[B:] = 0
                slot_own = take((ns_own,))
                np.copyto(slot_own, slot_g[lo // R:lo // R + ns_own])
                g2r_own = take((ns_own * R,))
                np.copyto(g2r_own, grid2row_flat[lo:lo + ns_own * R])
                slot_g, grid2row_flat, gp_orig = slot_own, g2r_own, gp_own

            c_keys = _SIG_C_KEYS + ([ORIG_TABLE] if self.explain else [])
            cs = {k: stack.tables[k] for k in c_keys}
            dev = self.device
            slot_g_d, mega_rows_d, grid2row_d, gp_orig_d = (
                pool.tensor(buf).to(dev, non_blocking=True)
                for buf in (slot_g, mega_rows, grid2row_flat, gp_orig)
            )
            schedule = tuple(schedule)
            run = self._runner(
                ("sig", schedule, stack.needs_pairs, self.needs_hr,
                 self.needs_rel), "sig_decide", stack.needs_pairs,
                self.needs_hr, self.needs_rel)
            out = run(self._c_inv, cs, bits, slot_g_d, mega_rows_d,
                      grid2row_d.reshape(ns_own, R), gp_orig_d, B, schedule)
            if n_data > 1:
                from ..parallel.mesh import all_reduce

                out = all_reduce(out, self.mesh, self.axis,
                                 torch.distributed.ReduceOp.SUM)
            host = take((out.shape[0], b_pad))
            pool.tensor(host).copy_(out, non_blocking=True)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
        except BaseException:
            # a failed launch must not leak its leases
            pool.release_all(leases)
            raise

        def materialize():
            # the leases recycle only after the event that follows the
            # output copy: the card has then read every input buffer
            if done is not None:
                done.synchronize()
            res = tuple(host[i, :B].copy() for i in range(host.shape[0]))
            if leases:
                pool.release_all(leases)
                leases.clear()
            return res

        return materialize

    def _launch_grouped(self, batch, inv, stack: Stack, with_acl: bool):
        """The per-row path (ACL pairs or request properties in the
        batch): K4 over the stacked subtrees, one group index per row, in
        the variant of the stack (a stack without relation rows runs the
        plain variant even on a relation tree)."""
        flags = (with_acl, stack.with_hr, stack.with_rel)
        run = self._runner(("pref", flags), "decide_grouped", *flags)
        if self.mesh is not None:
            # this rank's row slice; the outputs gather over the axis
            from ..parallel.mesh import all_gather_cols, row_slice, \
                shard_bucket

            n_data = self.mesh.shape[self.axis]
            index = self.mesh.coords[self.axis]
            b, r = row_slice(batch, self.device, ROW_ARRAYS, n_data, index)
            per = shard_bucket(b, n_data) // n_data
            g_all = np.zeros((per * n_data,), np.int32)
            g_all[:b] = inv
            out = run(self._c_inv, stack.tables,
                      g_all[index * per:(index + 1) * per], r)
            return readback(all_gather_cols(out, self.mesh, self.axis), b)
        b, r = batch_from_numpy(batch, self.device, keys=ROW_ARRAYS)
        _, _, _, pad_lead = lead_padding(batch)
        return readback(
            run(self._c_inv, stack.tables, pad_lead(inv.astype(np.int32)),
                r), b)
