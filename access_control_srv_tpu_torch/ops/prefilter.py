"""Host side of the signature prefilter that the port needs already.

Only the tree-size threshold and the candidacy test live here for now:
the encoder's context-query prefetch plan (``ops/encode.py``) calls
``candidate_rows``, and the evaluator refuses trees of ``MIN_RULES`` rules
and more, which take the signature path.  The signature kernels themselves
are still to be ported.
"""

from __future__ import annotations

import numpy as np

from .compile import CompiledPolicies

# rules below this count are cheaper to sweep densely than to group/compact
MIN_RULES = 512


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
