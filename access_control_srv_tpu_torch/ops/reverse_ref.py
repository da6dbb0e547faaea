"""Plain PyTorch version of the whatIsAllowed planes kernel (K5).

A mirror of the JAX package's ``ops/reverse.ReverseQueryKernel._runner``:
each representative row (one per new resource signature) is unpacked from
the packed int32 row buffer and run through ``_match_targets`` in
components mode with the whatIsAllowed planes (``with_hr=False``), and the
seven planes are stacked in ``PLANE_KEYS`` order.  ``ReverseQueryKernel``
runs it for tensors on the CPU; on the card it is only the yardstick
``csrc/wia_planes.cu`` is held against.
"""

from __future__ import annotations

import torch

from .kernel_ref import CHUNK_ELEMS, _match_targets
from .prefilter_ref import unpack_rows

# the planes, in the order the JAX runner stacks them (ops/reverse.py
# _PLANE_KEYS)
PLANE_KEYS = (
    "sig_wia_ex_p", "sig_wia_ex_d", "sig_wia_rg_p", "sig_wia_rg_d",
    "sig_maybe_ex", "sig_maybe_rg", "sig_act_ok",
)
# the target-table columns the planes read
WIA_TABLES = (
    "t_act_ids", "t_act_vals", "t_ent_vals", "t_ent_w", "t_ent_tails",
    "t_op_vals", "t_prop_vals", "t_prop_sfx", "t_has_props", "t_n_res",
)
# the request columns packed per representative row, in packing order
WIA_ROWS = (
    "r_act_ids", "r_act_vals", "r_ent_vals", "r_ent_e", "r_ent_valid",
    "r_prop_vals", "r_prop_sfx", "r_prop_run", "r_prop_tail", "r_op_vals",
    "r_has_props",
)
_BOOL_ROWS = ("r_ent_valid", "r_has_props")


def wia_planes_ref(tables: dict, rows: torch.Tensor, schedule,
                   rgx_set: torch.Tensor, pfx_neq: torch.Tensor
                   ) -> torch.Tensor:
    """K5's plain version: ``tables`` the ``WIA_TABLES`` tensors, ``rows``
    int32 [N, WROW] packed per ``schedule`` ((name, width, tail) in
    packing order), ``rgx_set`` / ``pfx_neq`` bool [W, E] -> bool
    [N, 7, T], the planes in ``PLANE_KEYS`` order."""
    N = rows.shape[0]
    T = tables["t_n_res"].shape[0]
    step = max(1, CHUNK_ELEMS // max(T, 1))
    parts = []
    for lo in range(0, N, step):
        r = unpack_rows(rows[lo:lo + step], schedule)
        for k in _BOOL_ROWS:
            r[k] = r[k] != 0
        r["rgx_set"] = rgx_set
        r["pfx_neq"] = pfx_neq
        m = _match_targets(tables, r, with_hr=False, components=True,
                           wia=True)
        parts.append(torch.stack([m[k] for k in PLANE_KEYS], dim=1))
    return torch.cat(parts)
