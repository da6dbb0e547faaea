"""Rule-axis (model-parallel) sharded decision kernel (K7).

For policy trees too large to replicate per device, rules are partitioned
into contiguous chunks along the rule axis and distributed over the mesh's
``model`` axis; requests stay data-parallel over ``data``.  Each rank
evaluates target matching and rule collection for its own chunk against a
**compacted per-shard target subtable** (only the target rows its rules
reference, plus all policy/set targets), so both hot stages shard.

The reference's combining algorithms are order-sensitive, so cross-shard
combination uses **packed positional keys** ``global_rule_pos * 8 +
effect * 2 + cacheable`` per (set, policy): ordering by key is ordering by
rule position, and the winning rule's payload rides in the low bits.  The
JAX package reduces them with ``lax.pmin`` / ``lax.pmax`` inside one
jitted ``shard_map``; a CUDA kernel cannot call NCCL, so here the program
is three steps per batch:

1. ``rule_chunk`` (``ops/csrc/shard_chunk.cu``, the rows program in its
   rule-chunk mode): stages A-E on this rank's shard, writing each row's
   merge row (keys, the negated last key, the policy gates and this
   shard's abort slot; ``ops/shard_ref.py``);
2. one MIN ``all_reduce`` of the merge rows over the ``model`` group
   (positions are unique, so MIN and the negated MAX are exact in any
   order; the abort slots travel as an all-gather);
3. ``shard_tail`` (``ops/csrc/shard_tail.cu``, a warp per row): the
   combining-algorithm selection, the no-rules contributions, stages F-G
   and the abort preemption, on the tail's tables packed once
   (``TailTables``); then the ``[3, rows]`` outputs are all-gathered over
   ``data``.

``explain=True`` adds the provenance code as a fourth output with no
extra collective, as the JAX program recovers it: the merged keys' high
bits already name the winning GLOBAL rule, so only ``shard_tail`` reads
it out, in strides ``explain_strides = (KP, kr_total)`` (the padded
global rule extent).

``partition_rules`` is the JAX package's, byte for byte.  Like the JAX
kernel this one is not delta-patchable: a mutated tree re-partitions.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.carry import tables_from_numpy
from ..ops.compile import CompiledPolicies
from ..ops.encode import RequestBatch
from ..ops.kernel import (
    ROW_ARRAYS,
    TABLE_ARRAYS,
    TailTables,
    readback,
    rule_chunk,
    shard_tail,
    tree_needs_hr,
    tree_needs_rel,
)
from .mesh import Mesh, all_gather_cols, all_reduce, row_slice

# target-table fields partitioned per shard (see compile.py _TargetTable).
# t_rel_idx stays a GLOBAL relation-vocab index (the packed closure planes
# are vocab-wide), so no per-shard remap; t_rel_path is host-only and
# never ships.
_T_FIELDS = [
    "t_n_subjects", "t_role", "t_has_role", "t_scoping", "t_has_scoping",
    "t_hr_check", "t_skip_acl", "t_sub_ids", "t_sub_vals", "t_act_ids",
    "t_act_vals", "t_ent_vals", "t_ent_w", "t_ent_tails", "t_op_vals",
    "t_prop_vals", "t_prop_sfx", "t_has_props", "t_n_res", "t_rs_idx",
    "t_rel_idx", "t_rel_direct",
]


@dataclass
class _Partitioned:
    arrays: dict[str, np.ndarray]  # stacked [D, ...] per-shard arrays
    kr_local: int
    kr_offsets: np.ndarray  # [D]


def partition_rules(compiled: CompiledPolicies, n_shards: int) -> _Partitioned:
    """Slice the rule axis into contiguous chunks and compact each chunk's
    target subtable; policy/set metadata is replicated into every shard."""
    a = compiled.arrays
    S, KP, KR = compiled.S, compiled.KP, compiled.KR
    kr_local = -(-KR // n_shards)

    shard_arrays: list[dict[str, np.ndarray]] = []
    t_sizes = []
    for d in range(n_shards):
        # clamp: with more shards than rule columns the tail shards hold
        # only padding (all-invalid rules)
        lo = min(d * kr_local, KR)
        hi = min(lo + kr_local, KR)
        sl: dict[str, np.ndarray] = {}
        for name in ("rule_valid", "rule_effect", "rule_cacheable_raw",
                     "rule_cacheable_eff", "rule_has_target", "rule_target",
                     "rule_cond"):
            chunk = a[name][:, :, lo:hi]
            if hi - lo < kr_local:  # pad the tail shard
                pad_width = kr_local - (hi - lo)
                fill = (
                    False if chunk.dtype == bool
                    else (0 if name in ("rule_effect", "rule_target") else -1)
                )
                chunk = np.concatenate(
                    [chunk,
                     np.full((S, KP, pad_width), fill, chunk.dtype)], axis=2
                )
            sl[name] = chunk
        # compact target rows: local rule targets + all policy/set targets
        needed = set(np.unique(sl["rule_target"][sl["rule_has_target"]]))
        needed |= set(np.unique(a["pol_target"][a["pol_has_target"]]))
        needed |= set(np.unique(a["set_target"][a["set_has_target"]]))
        needed.add(0)  # row 0 backs the "no target" index
        order = sorted(needed)
        remap = np.zeros(a["t_role"].shape[0], np.int64)
        for new, old in enumerate(order):
            remap[old] = new
        for name in _T_FIELDS:
            sl[name] = a[name][order]
        sl["rule_target"] = remap[sl["rule_target"]].astype(np.int32)
        sl["pol_target"] = remap[a["pol_target"]].astype(np.int32)
        sl["set_target"] = remap[a["set_target"]].astype(np.int32)
        shard_arrays.append(sl)
        t_sizes.append(len(order))

    t_max = max(t_sizes)
    for sl in shard_arrays:
        t_have = sl["t_role"].shape[0]
        if t_have < t_max:  # pad subtables to a common T (repeat row 0)
            for name in _T_FIELDS:
                reps = np.repeat(sl[name][:1], t_max - t_have, axis=0)
                sl[name] = np.concatenate([sl[name], reps], axis=0)

    # replicate policy/set metadata into the stacked layout
    # hrv_role/hrv_scope stay host-side: stage B consumes the encoder's
    # packed owner bitplanes, so only t_rs_idx (a target-table column)
    # reaches the device
    replicated = [
        "set_valid", "set_ca", "set_has_target", "pol_valid", "pol_ca",
        "pol_effect", "pol_cacheable", "pol_has_target", "pol_has_subjects",
        "pol_n_rules", "pol_eff_ctx", "pol_has_props", "pol_ent_vals",
        "acl_consts",
    ]
    stacked: dict[str, np.ndarray] = {}
    for name in list(shard_arrays[0]):
        stacked[name] = np.stack([sl[name] for sl in shard_arrays])
    for name in replicated:
        stacked[name] = np.stack([a[name]] * n_shards)
    return _Partitioned(
        arrays=stacked,
        kr_local=kr_local,
        kr_offsets=np.arange(n_shards, dtype=np.int32) * kr_local,
    )


class RuleShardedKernel:
    """Two-axis sharded kernel: requests over ``data``, rules over
    ``model``; per-shard compacted target subtables; the collectives carry
    the per-(set, policy) packed keys only.  This rank holds its own
    shard's tables on its device."""

    def __init__(self, compiled: CompiledPolicies, mesh: Mesh,
                 data_axis: str = "data", model_axis: str = "model",
                 explain: bool = False):
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported: {compiled.unsupported_reason}"
            )
        self.compiled = compiled
        self.explain = bool(explain)
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.n_data = mesh.shape[data_axis]
        self.n_model = mesh.shape[model_axis]
        self.device = mesh.device

        part = partition_rules(compiled, self.n_model)
        # rule flat positions use the PADDED global kr extent, not
        # compiled.KR: the abort order spans every shard's padding
        self._kr_total = part.kr_local * self.n_model
        self.explain_strides = (compiled.KP, self._kr_total)
        # explain-off launches pass no keyword: their calls are unchanged
        self._explain_kw = {"explain": True,
                            "kr_stride": self._kr_total} if explain else {}
        rank = mesh.coords[model_axis]
        self._kr_offset = int(part.kr_offsets[rank])
        self._c = tables_from_numpy(
            {k: part.arrays[k][rank] for k in TABLE_ARRAYS}, self.device)
        # the tail's tables with their pointers packed once
        self._tail = TailTables(self._c)
        self.with_hr = tree_needs_hr(compiled.arrays)
        self.with_rel = tree_needs_rel(compiled.arrays)

    def evaluate(self, batch: RequestBatch):
        return self.evaluate_async(batch)()

    def evaluate_async(self, batch: RequestBatch):
        """This rank's rows against its rule chunk, the merge over
        ``model``, the tail, and the gather over ``data``; returns the
        thunk that materializes (decision, cacheable, status, and the
        provenance codes in explain mode) numpy [B].
        The batch pads to ``n_data * pow2_bucket(ceil(B / n_data))`` rows
        and the regex matrices to the entity bucket, as the JAX kernel
        pads them."""
        with_acl = bool((np.asarray(batch.arrays["r_acl_ent"]) >= 0).any())
        b, r = row_slice(batch, self.device, ROW_ARRAYS, self.n_data,
                         self.mesh.coords[self.data_axis])
        merge = rule_chunk(self._c, r, self._kr_offset, self._kr_total,
                           self.n_model, self.mesh.coords[self.model_axis],
                           with_acl, self.with_hr, self.with_rel)
        merge = all_reduce(merge, self.mesh, self.model_axis)
        out = shard_tail(merge, self.n_model, self._tail, **self._explain_kw)
        return readback(all_gather_cols(out, self.mesh, self.data_axis), b)
