"""Relation-closure bitplanes: the ReBAC analog of the owner-bit packer.

``ops/encode.pack_owner_bitplanes`` folds the HR owner-tree membership
host-side into packed A/B fail bits the kernel reads back with
``_owner_bit_reader``.  This module generalizes that exact layout to
arbitrary relation closures: per (request row, relation-vocab entry) the
reachable-subject verdicts of the targeted resource instances are packed
into the same int32 bitplane format —

  r_rel_runs [B, NRU] — the distinct instance-bearing entity runs per row
      (ABSENT-padded), bit group g of every vocab entry refers to run
      r_rel_runs[g]; identical construction to r_own_runs.
  r_rel_bits [B, NWORDS] — packed fail bits per (row, vocab entry), laid
      out by ops/encode.owner_bit_layout(RELV, NRU, 0): ebits = 2*NRU,
      bit g = plane A (full closure: rewrites + userset expansion) fails,
      bit NRU+g = plane B (!direct: literal tuples only) fails.

The membership source is a precomputed flat verdict table (built by the
serving store, srv/relations.py): per (vocab entry v, plane p) segment
``obj_offs[v*2+p] : obj_offs[v*2+p+1]`` of sorted int64 object keys
``(ent_id << 32) | inst_id``, plus one globally sorted int64 ``pairs``
array of ``(object_row << 32) | subject_id`` — a verdict is two binary
searches, so packing a batch is O(B * NI * RELV * log) numpy work with
zero per-tuple cost at decision time.  The native (C++) wire encoder
implements the same two searches bit-identically
(native/host_encoder.cpp acs_pack_relation_bits).

Decisions are fail-closed: a missing table (no store attached) behaves
as an empty tuple set, matching the scalar oracle
(core/relation_path.check_relation_path with graph=None).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .compile import CompiledPolicies
from .encode import _pow2_at_least, owner_bit_layout
from .interner import ABSENT


def relation_bits_needed(compiled: CompiledPolicies) -> bool:
    """True when some target row carries a relation-path requirement
    (mirrors ops/kernel.tree_needs_rel without importing the kernel)."""
    t = compiled.arrays.get("t_rel_idx")
    return t is not None and bool((np.asarray(t) >= 0).any())


def empty_relation_tables(relv: int) -> dict[str, np.ndarray]:
    """The fail-closed table for ``relv`` vocab entries: zero objects, so
    every checked instance fails both planes."""
    return {
        "obj_offs": np.zeros((2 * relv + 1,), np.int64),
        "obj_keys": np.zeros((0,), np.int64),
        "pairs": np.zeros((0,), np.int64),
    }


def _plane_pass(tables: dict, idx: int, keys: np.ndarray, subj: np.ndarray
                ) -> np.ndarray:
    """Membership verdicts for one (vocab, plane) segment: ``keys`` are
    packed object keys, ``subj`` the (broadcastable) packed subject ids;
    returns bool shaped like keys."""
    obj_offs = tables["obj_offs"]
    obj_keys = tables["obj_keys"]
    pairs = tables["pairs"]
    lo = int(obj_offs[idx])
    hi = int(obj_offs[idx + 1])
    if hi <= lo:
        return np.zeros(keys.shape, bool)
    pos = np.searchsorted(obj_keys[lo:hi], keys)
    found = pos < (hi - lo)
    row = lo + np.minimum(pos, hi - lo - 1)
    found &= obj_keys[row] == keys
    pk = (row.astype(np.int64) << 32) | subj
    npair = pairs.shape[0]
    if npair == 0:
        return np.zeros(keys.shape, bool)
    pp = np.searchsorted(pairs, pk)
    ok = pp < npair
    ok &= pairs[np.minimum(pp, npair - 1)] == pk
    return found & ok


def pack_relation_bitplanes(
    arrays: dict[str, np.ndarray],
    compiled: CompiledPolicies,
    tables: Optional[dict] = None,
    skip: bool = False,
) -> dict[str, np.ndarray]:
    """Pack the per-batch relation verdicts.  Pure function of the raw
    encoder arrays + the store's flat tables, so the Python and native
    encode paths share it structurally (the C++ packer reproduces it bit
    for bit).  ``skip=True`` or a relation-free tree emits 1-wide dummies
    no compiled program ever reads."""
    B = arrays["r_ent_vals"].shape[0]
    if skip or not relation_bits_needed(compiled):
        return {
            "r_rel_runs": np.full((B, 1), ABSENT, np.int32),
            "r_rel_bits": np.zeros((B, 1), np.int32),
        }
    relv_path = np.asarray(compiled.arrays["relv_path"])
    RELV = int(relv_path.shape[0])
    if tables is None:
        tables = empty_relation_tables(RELV)

    inst_run = arrays["r_inst_run"]
    valid_i = arrays["r_inst_valid"] & (inst_run >= 0)  # [B, NI]
    # distinct instance-bearing runs per row (identical construction to
    # pack_owner_bitplanes so both planes share one run grouping scheme)
    big = np.int32(1 << 30)
    runs_sorted = np.sort(np.where(valid_i, inst_run, big), axis=1)
    fresh = np.ones(runs_sorted.shape, bool)
    fresh[:, 1:] = runs_sorted[:, 1:] != runs_sorted[:, :-1]
    fresh &= runs_sorted < big
    counts = fresh.sum(axis=1)
    nru = _pow2_at_least(int(counts.max()) if B else 1, 1)
    rel_runs = np.full((B, nru), ABSENT, np.int32)
    b_idx, j_idx = np.nonzero(fresh)
    pos = (np.cumsum(fresh, axis=1) - 1)[b_idx, j_idx]
    rel_runs[b_idx, pos] = runs_sorted[b_idx, j_idx]

    ebits, epw, wpe, nwords = owner_bit_layout(RELV, nru, 0)
    words = np.zeros((B, nwords), np.uint32)
    if B:
        NI = inst_run.shape[1]
        run_c = np.clip(inst_run, 0, None)
        ent = np.take_along_axis(arrays["r_ent_vals"], run_c, axis=1)  # [B,NI]
        inst = arrays["r_inst_id"]
        keys = (
            (np.clip(ent, 0, None).astype(np.int64) << 32)
            | np.clip(inst, 0, None).astype(np.int64)
        )  # [B, NI]
        key_ok = valid_i & (ent >= 0) & (inst >= 0)
        subj = arrays["r_subject_id"].astype(np.int64)  # [B]
        subj_ok = subj >= 0
        subj_pk = np.clip(subj, 0, None)[:, None]
        flat_keys = keys
        bad_full = np.empty((B, RELV, NI), bool)
        bad_dir = np.empty((B, RELV, NI), bool)
        for v in range(RELV):
            ok_f = _plane_pass(tables, v * 2, flat_keys, subj_pk)
            ok_d = _plane_pass(tables, v * 2 + 1, flat_keys, subj_pk)
            ok_f &= key_ok & subj_ok[:, None]
            ok_d &= key_ok & subj_ok[:, None]
            bad_full[:, v, :] = valid_i & ~ok_f
            bad_dir[:, v, :] = valid_i & ~ok_d
        g_one = (
            (inst_run[:, :, None] == rel_runs[:, None, :])
            & valid_i[:, :, None]
        ).astype(np.float32)  # [B, NI, NRU]
        a_run = np.matmul(bad_full.astype(np.float32), g_one) > 0
        b_run = np.matmul(bad_dir.astype(np.float32), g_one) > 0
        bits3 = np.concatenate([a_run, b_run], axis=2)  # [B, RELV, 2*nru]
        flat = np.arange(RELV * ebits)
        v_of, k_of = flat // ebits, flat % ebits
        if epw:
            w_of = v_of // epw
            off = ((v_of % epw) * ebits + k_of).astype(np.uint64)
        else:
            w_of = v_of * wpe + k_of // 32
            off = (k_of % 32).astype(np.uint64)
        starts = np.nonzero(np.diff(w_of, prepend=-1))[0]
        contrib = bits3.reshape(B, RELV * ebits).astype(np.uint64) << off
        words[:] = np.add.reduceat(contrib, starts, axis=1).astype(np.uint32)
    return {
        "r_rel_runs": rel_runs,
        "r_rel_bits": np.ascontiguousarray(words).view(np.int32),
    }
