"""Pod-sharded policy tree: set-axis model partitioning with shard-local
patching (K8).

``parallel/rule_shard.py`` shards the RULE axis; this module shards the
SET axis of one pod-level compile: shard ``d`` owns the padded set slots
``[d*S_loc, (d+1)*S_loc)`` with a compacted per-shard target subtable, so
a tree too large for one device splits into per-shard tables that fit,
while the encoder keeps operating on the one pod-level compiled tree (one
entity vocab, one condition list, one request encoding).

Set slots are stable under in-place patches, so a CRUD event touching one
set re-slices exactly one shard (``PodShardedKernel.patched``); the other
shards' host tables are reused by reference and their fingerprints
(``_shard_fingerprint``, byte-equal to the JAX package's) do not move.
The kernel's libraries are built once per process, so a patch costs no
new build.

Whole sets are shard-local, so every order-sensitive combining algorithm
runs inside one shard.  The JAX package merges across the ``model`` axis
with a ``pmax`` over packed last-set keys and a ``pmin`` / owner ``pmax``
for condition aborts inside one jitted ``shard_map``; here each batch is
``set_chunk`` (``ops/csrc/shard_chunk.cu``: stages A-F on this rank's set
slots and its shard's live target rows, the negated last-set key and this
shard's abort slot), one MIN
``all_reduce`` over ``model``, then ``shard_tail`` (``ops/csrc/
shard_tail.cu``: unpack the winner, apply the first abort), and the
``[3, rows]`` outputs all-gather over ``data``.  Only O(n_model) ints per
request cross ranks.

``explain=True`` adds the provenance code as a fourth output.  The JAX
program packs it on the shard owning the winning set and broadcasts it
with a second ``pmax``; here ``set_chunk`` writes each shard's code as a
key that orders like the global set position into one more merge column
(``ops/shard_ref.py``), so the one MIN ``all_reduce`` leaves the owner's
and ``shard_tail`` decodes it, in strides ``explain_strides = (KP,
KR)``.

The evaluator hands in a capacity-bucketed compile
(``ops/delta.full_bucketed_compile``) and, after a CRUD patch
(``ops/delta.apply_events``), calls ``patched`` with the patched set
slots.  ``shared_jits`` holds the ``set_chunk`` runner
(``ops/kernel.Runner``) under the JAX package's key ``("pod",
model_axis, n_shards, with_rel)`` (``"explain"`` appended in explain
mode): every kernel object of a patch chain reuses it.
"""

from __future__ import annotations

from dataclasses import dataclass
from hashlib import blake2b

import numpy as np

from ..ops.carry import tables_from_numpy
from ..ops.compile import CompiledPolicies
from ..ops.delta import _bucket, _POL_FILLS, _RULE_FILLS, _SET_FILLS
from ..ops.encode import RequestBatch
from ..ops.kernel import (
    ROW_ARRAYS,
    TABLE_ARRAYS,
    readback,
    runner,
    set_chunk,
    shard_tail,
    tree_needs_hr,
    tree_needs_rel,
)
from ..ops.shard_ref import live_rows
from .mesh import Mesh, all_gather_cols, all_reduce, row_slice
from .rule_shard import _T_FIELDS

# fields sliced along the leading set axis; target-table fields
# (_T_FIELDS) are compacted per shard; acl_consts is replicated;
# hrv_role/hrv_scope are host-only (the encoder's owner bitplanes carry
# the HR verdicts, see rule_shard) and never reach the device
_SET_AXIS_FIELDS = tuple(_SET_FILLS) + tuple(_POL_FILLS) + tuple(_RULE_FILLS)
_FILL_BY_NAME = {**_SET_FILLS, **_POL_FILLS, **_RULE_FILLS}


@dataclass
class ShardTables:
    """One shard's host-side tables: set-axis slices at ``s_local`` slots
    plus the compacted target subtable at ``t_live`` rows (padded to the
    kernel's sticky t-bucket only at stack time, so the fingerprint is
    invariant under pod-wide bucket growth)."""

    index: int
    s_lo: int                      # first owned global set slot
    arrays: dict                   # name -> np.ndarray
    t_live: int                    # compacted target rows (pre-padding)
    fingerprint: str               # blake2b-16 over the live tables


def _shard_fingerprint(arrays: dict, s_lo: int, t_live: int) -> str:
    h = blake2b(digest_size=16)
    h.update(f"s_lo={s_lo};t_live={t_live};".encode())
    for name in sorted(arrays):
        v = np.ascontiguousarray(arrays[name])
        h.update(name.encode())
        h.update(str(v.dtype).encode())
        h.update(str(v.shape).encode())
        h.update(v.tobytes())
    return h.hexdigest()


def slice_shard(compiled: CompiledPolicies, index: int, s_local: int
                ) -> ShardTables:
    """Slice shard ``index``'s set slots out of the pod tables and compact
    its target subtable: a synthetic all-zeros row at local index 0 backs
    every "no target" reference, followed by only the rows this shard's
    sets/policies/rules actually reference.  The blank anchor matters for
    byte-identity: pod target rows are ordinary allocatable slots that
    in-place patches rewrite, so anchoring padding on pod row 0 would
    leak another shard's churn into this shard's bytes.  Pure per-shard:
    re-slicing one shard after a patch cannot observe any other shard's
    content."""
    a = compiled.arrays
    S = a["set_valid"].shape[0]
    lo = min(index * s_local, S)
    hi = min(lo + s_local, S)
    sl: dict[str, np.ndarray] = {}
    for name in _SET_AXIS_FIELDS:
        chunk = a[name][lo:hi]
        if hi - lo < s_local:  # pad the tail shard with inert slots
            pad_shape = (s_local - (hi - lo),) + chunk.shape[1:]
            fill = _FILL_BY_NAME[name]
            chunk = np.concatenate(
                [chunk, np.full(pad_shape, fill, chunk.dtype)], axis=0
            )
        sl[name] = np.ascontiguousarray(chunk)

    needed: set[int] = set()
    needed |= set(np.unique(sl["rule_target"][sl["rule_has_target"]]).tolist())
    needed |= set(np.unique(sl["pol_target"][sl["pol_has_target"]]).tolist())
    needed |= set(np.unique(sl["set_target"][sl["set_has_target"]]).tolist())
    order = sorted(needed)
    # remap defaults to 0 = the blank anchor, so dangling target indexes
    # on has_target=False entries can never alias a live local row
    remap = np.zeros(a["t_role"].shape[0], np.int64)
    for new, old in enumerate(order):
        remap[old] = new + 1
    for name in _T_FIELDS:
        rows = a[name][order]
        blank = np.zeros((1,) + rows.shape[1:], rows.dtype)
        sl[name] = np.ascontiguousarray(
            np.concatenate([blank, rows], axis=0)
        )
    for kind in ("rule", "pol", "set"):
        sl[f"{kind}_target"] = np.where(
            sl[f"{kind}_has_target"],
            remap[sl[f"{kind}_target"]],
            0,
        ).astype(np.int32)
    sl["acl_consts"] = np.asarray(a["acl_consts"])

    t_live = len(order) + 1
    return ShardTables(
        index=index, s_lo=lo, arrays=sl, t_live=t_live,
        fingerprint=_shard_fingerprint(sl, lo, t_live),
    )


def partition_sets(compiled: CompiledPolicies, n_shards: int
                   ) -> tuple[list[ShardTables], int]:
    """Split the (capacity-padded) set axis into ``n_shards`` contiguous
    chunks of ``s_local`` slots each; returns (shards, s_local)."""
    S = compiled.arrays["set_valid"].shape[0]
    s_local = -(-S // n_shards)
    return (
        [slice_shard(compiled, d, s_local) for d in range(n_shards)],
        s_local,
    )


class PodShardedKernel:
    """Set-axis sharded kernel over a two-axis mesh: requests shard over
    ``data``, the pod-level compiled set slots over ``model``; per-shard
    compacted target subtables; the collectives carry O(n_model) ints per
    request.  Every rank keeps every shard's host tables (the identity
    surface), and only its own shard's on its device.

    ``patched`` re-slices only the shards owning the patched slots, so
    the evaluator may keep an incremental path with pod sharding on."""

    supports_shard_patch = True

    def __init__(self, compiled: CompiledPolicies, mesh: Mesh,
                 data_axis: str = "data", model_axis: str = "model",
                 shared_jits: dict | None = None, prev_t_cap: int = 0,
                 explain: bool = False,
                 _shards: list[ShardTables] | None = None,
                 _applied: list[int] | None = None,
                 _placed: tuple | None = None):
        if not compiled.supported:
            raise ValueError(
                f"policy tree unsupported: {compiled.unsupported_reason}"
            )
        self.compiled = compiled
        self.explain = bool(explain)
        self.explain_strides = (compiled.KP, compiled.KR)
        # explain-off launches pass no keyword: their calls are unchanged
        self._explain_kw = {"explain": True} if explain else {}
        self._tail_kw = {"explain": True,
                         "kr_stride": compiled.KR} if explain else {}
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.n_data = mesh.shape[data_axis]
        self.n_shards = mesh.shape[model_axis]
        self.device = mesh.device

        if _shards is None:
            self.shards, self.s_local = partition_sets(
                compiled, self.n_shards
            )
        else:
            self.shards = _shards
            self.s_local = _shards[0].arrays["set_valid"].shape[0]
        # sticky per-pod target-row bucket (pow2, 1.25x headroom): patches
        # that stay inside it keep every shape of the shard tables stable
        self.t_cap = max(
            prev_t_cap,
            _bucket(max(sh.t_live for sh in self.shards), 1.25, 8),
        )
        # per-shard applied-patch watermark since the last full partition
        self.applied = list(_applied) if _applied is not None else (
            [0] * self.n_shards
        )
        self.with_hr = tree_needs_hr(compiled.arrays)
        self.with_rel = tree_needs_rel(compiled.arrays)
        self._shared = shared_jits if shared_jits is not None else {}
        key = ("pod", model_axis, self.n_shards, self.with_rel) + (
            ("explain",) if explain else ())
        # the variant flags follow the call's own arguments; the with_acl
        # flag varies per batch, so the runner is called with it
        self._run = runner(self._shared, True, key, globals(), "set_chunk")
        self._place(_placed)

    # ------------------------------------------------------------ placement
    def _place(self, placed: tuple | None) -> None:
        """This rank's shard on its device, its target subtable padded to
        the sticky bucket by repeating row 0 (inert: no live index reaches
        the pads, and ``set_chunk`` scans only the first ``t_live`` rows).
        ``placed`` (shard tables, t_cap, device tensors) is reused when
        this rank's shard and the bucket did not change."""
        own = self.shards[self.mesh.coords[self.model_axis]]
        if placed is not None and placed[0] is own and placed[1] == self.t_cap:
            self._c = placed[2]
        else:
            arrays = {}
            for name in TABLE_ARRAYS:
                v = own.arrays[name]
                if name in _T_FIELDS and v.shape[0] < self.t_cap:
                    reps = np.repeat(v[:1], self.t_cap - v.shape[0], axis=0)
                    v = np.concatenate([v, reps], axis=0)
                arrays[name] = v
            self._c = tables_from_numpy(arrays, self.device)
        self._own = own
        # the live rows' prefix views, cut once per placement
        self._live = live_rows(self._c, own.t_live)

    # ------------------------------------------------------- shard-local patch
    def patched(self, new_compiled: CompiledPolicies,
                patched_slots: list[int]) -> "PodShardedKernel":
        """Shard-local relower: re-slice ONLY the shards owning
        ``patched_slots`` (the delta patcher's stats), reusing every other
        shard's host tables by reference (set slots never move under a
        patch, and the patcher rewrites only rows the affected sets own).
        This rank's device tables are reused when its shard is not among
        the owners and the bucket holds."""
        owners = sorted({
            min(int(s) // self.s_local, self.n_shards - 1)
            for s in patched_slots
        })
        shards = list(self.shards)
        for d in owners:
            shards[d] = slice_shard(new_compiled, d, self.s_local)
        applied = list(self.applied)
        for d in owners:
            applied[d] += 1
        return PodShardedKernel(
            new_compiled, self.mesh,
            data_axis=self.data_axis, model_axis=self.model_axis,
            shared_jits=self._shared, prev_t_cap=self.t_cap,
            explain=self.explain, _shards=shards,
            _applied=applied,
            _placed=(self._own, self.t_cap, self._c),
        )

    # ------------------------------------------------------------- identity
    def pod_fingerprint(self) -> str:
        """The combined pod fingerprint: a digest over the per-shard
        fingerprints in shard order."""
        h = blake2b(digest_size=16)
        for sh in self.shards:
            h.update(sh.fingerprint.encode())
        return h.hexdigest()

    def shard_identity(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "s_local": self.s_local,
            "t_bucket": self.t_cap,
            "pod_fingerprint": self.pod_fingerprint(),
            "shards": [
                {
                    "index": sh.index,
                    "fingerprint": sh.fingerprint,
                    "set_slots": [sh.s_lo, sh.s_lo + self.s_local],
                    "t_rows_live": sh.t_live,
                    "applied_patches": self.applied[sh.index],
                }
                for sh in self.shards
            ],
        }

    # ------------------------------------------------------------- evaluate
    def evaluate(self, batch: RequestBatch):
        return self.evaluate_async(batch)()

    def evaluate_async(self, batch: RequestBatch):
        """This rank's rows against its set slots, the merge over
        ``model``, the tail, and the gather over ``data``; returns the
        thunk that materializes (decision, cacheable, status, and the
        provenance codes in explain mode) numpy [B].
        Batch and regex-matrix axes pad as in ``RuleShardedKernel``."""
        with_acl = bool((np.asarray(batch.arrays["r_acl_ent"]) >= 0).any())
        b, r = row_slice(batch, self.device, ROW_ARRAYS, self.n_data,
                         self.mesh.coords[self.data_axis])
        merge = self._run(self._live, r, self._own.s_lo, self.n_shards,
                          self.mesh.coords[self.model_axis], with_acl,
                          self.with_hr, self.with_rel, t_live=self._own.t_live,
                          **self._explain_kw)
        merge = all_reduce(merge, self.mesh, self.model_axis)
        out = shard_tail(merge, self.n_shards, **self._tail_kw)
        return readback(all_gather_cols(out, self.mesh, self.data_axis), b)
