"""Plain PyTorch versions of the signature path's three kernels.

Stage-for-stage mirrors of the JAX package's ``ops/prefilter.py`` device
programs, written over the batched building blocks of ``kernel_ref``:

- ``sig_planes_ref``: ``_planes_for.bits_fn`` (stage A in components mode
  per signature pseudo-request, gathered to rule / policy / set planes);
- ``sig_decide_ref``: ``_sig_runner``'s ``body`` (the per-row subject
  fold, HR pass, relation-path fold, ACL short path, conditions, policy
  gates and the
  flat-order combination on the group's planes, un-permuted through
  ``gp_orig``);
- ``decide_grouped_ref``: ``_runner``'s ``body`` (the dense program per
  row against its own compacted subtree).

``vmap`` over groups / slots / rows becomes a Python loop over the
signature groups with the rows of a group batched.  K3 and K4 take
``explain`` as the JAX runners do: a fourth output row, the provenance
code, whose rule positions map through the stacked ``rule_orig_flat``
back to the uncompacted tree.  ``PrefilteredKernel``
runs these for tensors on the CPU; on the card they are only the
yardstick the CUDA kernels are held against.
"""

from __future__ import annotations

import torch

from .kernel_ref import (
    _action_kind,
    _combine_and_decide_flat,
    _hr_pass_from_bits,
    _match_targets,
    _multi_entity_ok,
    _policy_gates_core,
    _rel_pass_from_bits,
    _rule_conditions,
    decide_dense_ref,
)

# planes K2 writes, by (name, source table, gather index); the JAX
# package's ``bits`` dict key for key
RULE_PLANES = ("rl_ex", "rl_rg", "rl_role", "rl_has_role", "rl_n_sub",
               "rl_sub_ids", "rl_sub_vals", "rl_skip")
POL_PLANES = ("pp_ex_p", "pp_ex_d", "pp_rg_p", "pp_rg_d", "pl_role",
              "pl_has_role", "pl_n_sub", "pl_sub_ids", "pl_sub_vals")
SET_PLANES = ("ss_ex_p", "sl_role", "sl_has_role", "sl_n_sub", "sl_sub_ids",
              "sl_sub_vals", "multi_ok")
HR_PLANES = ("rl_collect", "rl_op_hit", "rl_triv", "rl_rs", "rl_hrchk",
             "pl_collect", "pl_op_hit", "pl_triv", "pl_rs", "pl_hrchk")
REL_PLANES = ("rl_rel_idx", "rl_rel_dir", "pl_rel_idx", "pl_rel_dir")


def plane_names(with_hr: bool, with_rel: bool) -> tuple:
    """The planes of a variant: the relation fold reads the collection
    planes, which otherwise come with the HR set."""
    names = RULE_PLANES + POL_PLANES + SET_PLANES
    if with_hr:
        names += HR_PLANES
    elif with_rel:
        names += ("rl_collect", "pl_collect")
    return names + (REL_PLANES if with_rel else ())


def _group_planes(c, r, with_hr: bool, with_rel: bool) -> dict:
    """One group's planes from its tables ``c`` and its pseudo-request
    ``r`` (a batch of one row)."""
    comp = {k: v[0] for k, v in _match_targets(
        c, r, with_hr, components=True, with_rel=with_rel).items()}
    act = comp["sig_act_ok"]
    rt = c["rule_target"].long()
    pt = c["pol_target"].long()
    st = c["set_target"].long()
    deny = c["rule_effect"] == 2
    out = {
        "rl_ex": torch.where(deny, comp["sig_res_ex_d"][rt],
                             comp["sig_res_ex_p"][rt]) & act[rt],
        "rl_rg": torch.where(deny, comp["sig_res_rg_d"][rt],
                             comp["sig_res_rg_p"][rt]) & act[rt],
        "ss_ex_p": comp["sig_res_ex_p"][st] & act[st],
        "multi_ok": _multi_entity_ok(c, r["r_ent_vals"],
                                     r["r_ent_valid"])[0],
    }
    for kind in ("ex_p", "ex_d", "rg_p", "rg_d"):
        out["pp_" + kind] = comp["sig_res_" + kind][pt] & act[pt]
    for prefix, idx in (("rl", rt), ("pl", pt), ("sl", st)):
        out[prefix + "_role"] = c["t_role"][idx]
        out[prefix + "_has_role"] = c["t_has_role"][idx]
        out[prefix + "_n_sub"] = c["t_n_subjects"][idx]
        out[prefix + "_sub_ids"] = c["t_sub_ids"][idx]
        out[prefix + "_sub_vals"] = c["t_sub_vals"][idx]
    out["rl_skip"] = c["t_skip_acl"][rt]
    if with_hr:
        triv = (c["t_n_subjects"] == 0) | ~c["t_has_scoping"]
        for prefix, idx in (("rl", rt), ("pl", pt)):
            out[prefix + "_collect"] = comp["sig_collect"][idx]
            out[prefix + "_op_hit"] = comp["sig_op_hit"][idx]
            out[prefix + "_triv"] = triv[idx]
            out[prefix + "_rs"] = c["t_rs_idx"][idx]
            out[prefix + "_hrchk"] = c["t_hr_check"][idx]
    if with_rel:
        for prefix, idx in (("rl", rt), ("pl", pt)):
            out[prefix + "_collect"] = comp["sig_collect"][idx]
            out[prefix + "_rel_idx"] = c["t_rel_idx"][idx]
            out[prefix + "_rel_dir"] = c["t_rel_direct"][idx]
    return out


def sig_planes_ref(tabs: dict, inv: dict, pseudo: dict, with_hr: bool,
                   with_rel: bool) -> dict:
    """K2's plain version: ``tabs`` the stacked varying tables ``[G, ...]``,
    ``inv`` the group-invariant policy arrays, ``pseudo`` the per-group
    pseudo-requests ``[G, ...]`` (``rgx_set`` / ``pfx_neq`` ``[G, W, E]``).
    Returns the planes ``[G, ...]`` under ``plane_names(with_hr,
    with_rel)``."""
    G = pseudo["r_ent_vals"].shape[0]
    per_group = []
    for g in range(G):
        c = {**inv, **{k: v[g] for k, v in tabs.items()}}
        r = {k: v[g:g + 1] for k, v in pseudo.items()
             if k not in ("rgx_set", "pfx_neq")}
        r["rgx_set"] = pseudo["rgx_set"][g]
        r["pfx_neq"] = pseudo["pfx_neq"][g]
        per_group.append(_group_planes(c, r, with_hr, with_rel))
    return {k: torch.stack([p[k] for p in per_group])
            for k in plane_names(with_hr, with_rel)}


def _sub_fold(r, n_sub, has_role, role, sub_ids, sub_vals,
              needs_pairs: bool):
    """checkSubjectMatches at plane granularity: plane arrays of any
    shape P (``sub_ids`` / ``sub_vals`` with a trailing KS axis) against
    the rows' subjects -> [R, *P]."""
    roles = r["r_roles"]  # [R, NROLE]
    R = roles.shape[0]
    lead = (R,) + (1,) * role.dim()
    role_ok = torch.zeros((R,) + tuple(role.shape), dtype=torch.bool,
                          device=role.device)
    for j in range(roles.shape[1]):
        rj = roles[:, j].reshape(lead)
        role_ok = role_ok | ((role[None] == rj) & (rj >= 0))
    if not needs_pairs:
        return (n_sub == 0)[None] | role_ok
    rids, rvals = r["r_sub_ids"], r["r_sub_vals"]
    pairs_ok = torch.ones_like(role_ok)
    for i in range(sub_ids.shape[-1]):
        sid = sub_ids[..., i][None]
        sval = sub_vals[..., i][None]
        hit = torch.zeros_like(role_ok)
        for j in range(rids.shape[1]):
            qid = rids[:, j].reshape(lead)
            qval = rvals[:, j].reshape(lead)
            hit = hit | ((sid == qid) & (sval == qval) & (qid >= 0))
        pairs_ok = pairs_ok & ((sid < 0) | hit)
    return (n_sub == 0)[None] | torch.where(has_role[None], role_ok,
                                            pairs_ok)


def _hr_planes_pass(r, v, collect, op_hit, hr_check, trivial):
    """``_hr_pass_from_bits`` on a group's planes (any leading shape P,
    shared by the rows) -> [R, *P]."""
    shape = tuple(v.shape)
    out = _hr_pass_from_bits(
        r, v.reshape(-1).long(),
        collect.reshape((1, -1, collect.shape[-1])),
        op_hit.reshape((1, -1, op_hit.shape[-1])),
        hr_check.reshape(-1), trivial.reshape(-1),
    )
    return out.reshape((-1,) + shape)


def _rel_planes_pass(r, idx, collect, direct):
    """``_rel_pass_from_bits`` on a group's planes (any leading shape P)
    -> [R, *P]."""
    shape = tuple(idx.shape)
    v = idx.reshape(-1)
    out = _rel_pass_from_bits(
        r, v.long(), collect.reshape((1, -1, collect.shape[-1])),
        direct.reshape(-1), v < 0,
    )
    return out.reshape((-1,) + shape)


def _sig_rows(c, sg, r, needs_pairs: bool, with_hr: bool, with_rel: bool,
              explain: bool = False):
    """Decisions of rows ``r`` (batched [R, ...]) of one group against its
    tables ``c`` and planes ``sg`` -> three int32 [R] (four with
    ``explain``)."""
    S, KP, KR = c["rule_effect"].shape
    M = KP * KR

    def flat(x):
        return x.reshape(S, M)

    rl_sub = _sub_fold(
        r, flat(sg["rl_n_sub"]), flat(sg["rl_has_role"]), flat(sg["rl_role"]),
        sg["rl_sub_ids"].reshape(S, M, -1), sg["rl_sub_vals"].reshape(S, M, -1),
        needs_pairs,
    )  # [R, S, M]
    pl_sub = _sub_fold(r, sg["pl_n_sub"], sg["pl_has_role"], sg["pl_role"],
                       sg["pl_sub_ids"], sg["pl_sub_vals"], needs_pairs)
    sl_sub = _sub_fold(r, sg["sl_n_sub"], sg["sl_has_role"], sg["sl_role"],
                       sg["sl_sub_ids"], sg["sl_sub_vals"], needs_pairs)

    rht_f = flat(c["rule_has_target"])[None]
    tm_rule = ~rht_f | (rl_sub & (flat(sg["rl_ex"]) | flat(sg["rl_rg"]))[None])
    reached = flat(c["rule_valid"])[None] & tm_rule
    pol_subject = None
    if with_hr:
        hr_rule = _hr_planes_pass(
            r, flat(sg["rl_rs"]), sg["rl_collect"].reshape(S, M, -1),
            sg["rl_op_hit"].reshape(S, M, -1), flat(sg["rl_hrchk"]),
            flat(sg["rl_triv"]),
        )  # [R, S, M]
        hr_pol = _hr_planes_pass(r, sg["pl_rs"], sg["pl_collect"],
                                 sg["pl_op_hit"], sg["pl_hrchk"],
                                 sg["pl_triv"])  # [R, S, KP]
        reached = reached & (~rht_f | hr_rule)
        pol_subject = ~c["pol_has_subjects"][None] | hr_pol
    if with_rel:
        rel_rule = _rel_planes_pass(r, flat(sg["rl_rel_idx"]),
                                    sg["rl_collect"].reshape(S, M, -1),
                                    flat(sg["rl_rel_dir"]))  # [R, S, M]
        rel_pol = _rel_planes_pass(r, sg["pl_rel_idx"], sg["pl_collect"],
                                   sg["pl_rel_dir"])  # [R, S, KP]
        reached = reached & (~rht_f | rel_rule)
        pol_rel = ~c["pol_has_subjects"][None] | rel_pol
        pol_subject = pol_rel if pol_subject is None else pol_subject & pol_rel
    kind = _action_kind(c, r)
    short = r["r_acl_short"]
    row_ok = (short == 1) | ((short == 0) & (r["r_n_ra"] > 0) & (kind > 0))
    acl_row = flat(sg["rl_skip"])[None] | row_ok[:, None, None]
    acl_rule = ~rht_f | acl_row
    has_cond, cond_t, cond_a, cond_c = _rule_conditions(
        {"rule_cond": flat(c["rule_cond"])}, r
    )
    multi_gate = torch.where(
        (r["r_n_entity_attrs"] > 1)[:, None], sg["multi_ok"][None], True
    )
    pol_gate = _policy_gates_core(
        c, sg["pp_ex_p"][None] & pl_sub, sg["pp_ex_d"][None] & pl_sub,
        sg["pp_rg_p"][None] & pl_sub, sg["pp_rg_d"][None] & pl_sub,
        multi_gate,
    )
    set_gate = (~c["set_has_target"][None]
                | (sg["ss_ex_p"][None] & sl_sub)) & c["set_valid"][None]
    return _combine_and_decide_flat(
        c, reached, acl_rule, has_cond, cond_t, cond_a, cond_c, pol_gate,
        set_gate, pol_subject=pol_subject, explain=explain,
    )


def unpack_rows(rows: torch.Tensor, schedule) -> dict:
    """Packed int32 rows [R, W] -> the request arrays named in
    ``schedule`` ((name, width, tail) in packing order; the three
    condition blocks come back as [C, R] columns, as ``kernel_ref``
    reads them)."""
    out = {}
    off = 0
    R = rows.shape[0]
    for name, w, tail in schedule:
        v = rows[:, off:off + w]
        off += w
        if name.startswith("cond_"):
            v = v.T.contiguous()
            out[name] = v if name == "cond_code" else v != 0
        elif name == "r_ctx_present":
            out[name] = v[:, 0] != 0
        else:
            out[name] = v.reshape((R,) + tuple(tail)) if tail else v[:, 0]
    return out


def sig_decide_ref(inv: dict, cs: dict, planes: dict, slot_g, mega_rows,
                   grid2row, gp_orig, n_rows: int, schedule,
                   needs_pairs: bool, with_hr: bool, with_rel: bool, *,
                   explain: bool = False) -> torch.Tensor:
    """K3's plain version -> int32 [3, b_pad] ([4, b_pad] with
    ``explain``): every grid position of the
    ``[NSLOT, R]`` slot layout decided against its slot's group, then
    gathered back to request order through ``gp_orig`` for the ``n_rows``
    real rows (padding rows, and rows whose ``gp_orig`` is negative because
    another rank decides their slots, stay 0)."""
    NS, R = grid2row.shape
    grid_rows = mega_rows[grid2row.reshape(-1).long()]  # [NS * R, W]
    n_out = 4 if explain else 3
    out_flat = torch.zeros((n_out, NS * R), dtype=torch.int32,
                           device=mega_rows.device)
    slot_of = torch.arange(NS * R, device=mega_rows.device) // R
    pos_g = slot_g.long()[slot_of]
    for g in torch.unique(slot_g).tolist():
        pos = (pos_g == g).nonzero().flatten()
        c = {**inv, **{k: v[g] for k, v in cs.items()}}
        sg = {k: v[g] for k, v in planes.items()}
        r = unpack_rows(grid_rows[pos], schedule)
        out_flat[:, pos] = torch.stack(_sig_rows(c, sg, r, needs_pairs,
                                                 with_hr, with_rel, explain))
    out = torch.zeros((n_out, gp_orig.shape[0]), dtype=torch.int32,
                      device=mega_rows.device)
    gp = gp_orig[:n_rows].long()
    rows = (gp >= 0).nonzero().flatten()
    out[:, rows] = out_flat[:, gp[rows]]
    return out


def decide_grouped_ref(inv: dict, cs: dict, g_idx, r: dict, with_acl: bool,
                       with_hr: bool, with_rel: bool, *,
                       explain: bool = False) -> torch.Tensor:
    """K4's plain version -> int32 [3, B] ([4, B] with ``explain``): the
    dense program per row against ``inv`` joined with its group's subtree
    ``cs[g_idx[row]]``, rows of one group batched."""
    B = r["r_n_ra"].shape[0]
    out = torch.zeros((4 if explain else 3, B), dtype=torch.int32,
                      device=g_idx.device)
    for g in torch.unique(g_idx).tolist():
        rows = (g_idx == g).nonzero().flatten()
        c = {**inv, **{k: v[g] for k, v in cs.items()}}
        rr = {}
        for k, v in r.items():
            if k in ("rgx_set", "pfx_neq"):
                rr[k] = v
            elif k.startswith("cond_"):
                rr[k] = v[:, rows]
            else:
                rr[k] = v[rows]
        out[:, rows] = torch.stack(decide_dense_ref(
            c, rr, with_acl, with_hr, with_rel, explain=explain))
    return out
