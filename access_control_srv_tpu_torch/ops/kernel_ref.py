"""Plain PyTorch version of the dense decision kernel.

A stage-for-stage mirror of the JAX package's ``ops/kernel._evaluate_one``
(``_match_targets``, ``_hr_pass_from_bits``, ``_rel_pass_from_bits``,
``_acl_pass``,
``_rule_predicates``, ``_policy_gates`` and ``_combine_and_decide``), with
the batch axis written out in front of every intermediate instead of
``vmap`` and Python loops over the static scan lengths instead of
``lax.scan``.  ``DecisionKernel`` runs it for tensors on the CPU; on the
card it exists only as the yardstick the CUDA kernel is held against.

``c``: compiled policy tensors (``ops/carry.tables_from_numpy``).
``r``: batch tensors (``ops/carry.batch_from_numpy``): per-row arrays
``[B, ...]``, the regex matrices ``[W, E]`` and the condition columns
``[C, B]``.  Outputs are three int32 ``[B]`` tensors: decision (0
INDETERMINATE, 1 PERMIT, 2 DENY), cacheable (-1 none, 0/1) and status.
``explain=True`` appends a fourth, the packed provenance code
``(flat_pos << 2) | kind`` of ``srv/explain.py``, recovered from the same
positional selections the decision used (the JAX package's
``_combine_and_decide`` / ``_combine_and_decide_flat`` recovery).
"""

from __future__ import annotations

import torch

# positional-reduction sentinel (JAX package: ops/kernel.BIG)
BIG = 1 << 30

# rows per chunk: bounds the [B, T, ...] intermediates of large trees
CHUNK_ELEMS = 1 << 22


def _pairs_subset(rule_ids, rule_vals, req_ids, req_vals):
    """Every valid rule (id, value) pair appears among the request pairs:
    rule arrays [T, K], request arrays [B, J] -> [B, T]."""
    eq = (
        (rule_ids[None, :, :, None] == req_ids[:, None, None, :])
        & (rule_vals[None, :, :, None] == req_vals[:, None, None, :])
        & (req_ids[:, None, None, :] >= 0)
    ).any(dim=3)  # [B, T, K]
    return (~(rule_ids >= 0)[None] | eq).all(dim=2)


def _subject_ok(c, r):
    """Subject matching per target row -> [B, T]."""
    sub_pairs_ok = _pairs_subset(
        c["t_sub_ids"], c["t_sub_vals"], r["r_sub_ids"], r["r_sub_vals"]
    )
    roles = r["r_roles"]
    role_ok = (
        (c["t_role"][None, :, None] == roles[:, None, :])
        & (roles[:, None, :] >= 0)
    ).any(dim=2)
    return (c["t_n_subjects"] == 0)[None] | torch.where(
        c["t_has_role"][None], role_ok, sub_pairs_ok
    )


def _sticky(set_bits, reset_bits):
    """Sticky scan along the last axis: set wins, reset clears, else the
    state carries (JAX package: the ``lax.scan`` in ``_match_targets``)."""
    state = torch.zeros(set_bits.shape[:-1], dtype=torch.bool,
                        device=set_bits.device)
    out = []
    for j in range(set_bits.shape[-1]):
        state = torch.where(
            set_bits[..., j], True,
            torch.where(reset_bits[..., j], False, state),
        )
        out.append(state)
    return torch.stack(out, dim=-1)


def _take_runs(state, idx):
    """state [B, T, NR] at run index idx [B, NP] -> [B, T, NP]."""
    B, T, _ = state.shape
    return torch.gather(state, 2, idx[:, None, :].expand(B, T, idx.shape[1]))


def _owner_bit_reader(bits, v, ebits: int):
    """Unpack accessor over the host-packed owner bitplanes: ``bits`` is
    [B, NWORDS] int32, ``v`` [T] vocab indices; ``bit(k)`` -> [B, T].
    Word indices are clamped to the planes: the 1-wide dummy planes of a
    batch encoded without relation bits are never read where it matters
    (their runs are all absent), but the gather must stay in bounds."""
    B, nwords = bits.shape
    if ebits <= 32:
        epw = 32 // ebits
        words = torch.gather(
            bits, 1, (v // epw).clamp(max=nwords - 1)[None].expand(B, -1))
        codes = words >> ((v % epw) * ebits)[None]

        def bit(k: int):
            return ((codes >> k) & 1) == 1

        return bit
    wpe = -(-ebits // 32)
    base = v * wpe

    def bit(k: int):
        w = torch.gather(
            bits, 1, (base + k // 32).clamp(max=nwords - 1)[None].expand(B, -1))
        return ((w >> (k % 32)) & 1) == 1

    return bit


def _hr_pass_from_bits(r, v, collect, op_hit, hr_check, trivial):
    """Stage B from the owner bitplanes -> [B, T]."""
    runs = r["r_own_runs"]  # [B, NRU]
    nru = runs.shape[1]
    nop = op_hit.shape[-1]
    bit = _owner_bit_reader(r["r_own_bits"], v, 2 * (nru + nop))
    bad = torch.zeros(collect.shape[:2], dtype=torch.bool,
                      device=collect.device)
    n_runs = collect.shape[-1]
    for g in range(nru):
        coll_g = torch.zeros_like(bad)
        for nr in range(n_runs):
            coll_g = coll_g | ((runs[:, g] == nr)[:, None] & collect[..., nr])
        bad = bad | (coll_g & torch.where(hr_check[None], bit(g),
                                          bit(nru + g)))
    for j in range(nop):
        bad = bad | (op_hit[..., j] & torch.where(
            hr_check[None], bit(2 * nru + j), bit(2 * nru + nop + j)
        ))
    ctx_ok = r["r_ctx_present"] & (r["r_n_ra"] > 0)
    return trivial[None] | (ctx_ok[:, None] & ~bad)


def _rel_pass_from_bits(r, v, collect, direct, trivial):
    """The relation-path gate from the host-packed closure bitplanes
    (``ops/relation.pack_relation_bitplanes``) -> [B, T]: the owner
    layout with no operation slots (``ebits = 2 * NRU``), bit ``g``
    (full closure) or bit ``NRU + g`` (literal tuples only, where
    ``direct``) per collected run; no context term.  ``trivial`` marks
    target rows without a relation requirement (``t_rel_idx < 0``)."""
    runs = r["r_rel_runs"]  # [B, NRU]
    nru = runs.shape[1]
    bit = _owner_bit_reader(r["r_rel_bits"], v.clamp(min=0), 2 * nru)
    bad = torch.zeros(collect.shape[:2], dtype=torch.bool,
                      device=collect.device)
    n_runs = collect.shape[-1]
    for g in range(nru):
        coll_g = torch.zeros_like(bad)
        for nr in range(n_runs):
            coll_g = coll_g | ((runs[:, g] == nr)[:, None] & collect[..., nr])
        bad = bad | (coll_g & torch.where(direct[None], bit(nru + g), bit(g)))
    return trivial[None] | ~bad


def _hr_collect_state(c, r, rgx_hit, pfx_neq, ent_valid):
    """Stage B's signature-determined pieces, shared by the dense matcher
    and the components mode: the per-(target row, entity run) sticky
    collection state (exact OR regex sets, prefix-mismatch resets, any
    over the entity slots) and the per-(target row, op slot) operation
    hit -> ([B, T, NR], [B, T, NOP])."""
    tev = c["t_ent_vals"]  # [T, K]
    em_ex_k = (
        (tev[None, :, :, None] == r["r_ent_vals"][:, None, None, :])
        & (tev >= 0)[None, :, :, None]
        & ent_valid[:, None, None, :]
    )  # [B, T, K, NR]
    set_k = em_ex_k | rgx_hit  # regex set wins over reset
    reset_k = pfx_neq & ~set_k
    collect = _sticky(set_k, reset_k).any(dim=2)
    top = c["t_op_vals"]
    rop = r["r_op_vals"]
    op_hit = (
        (top[None, :, :, None] == rop[:, None, None, :])
        & (top >= 0)[None, :, :, None]
        & (rop >= 0)[:, None, None, :]
    ).any(dim=2)
    return collect, op_hit


def _match_targets(c, r, with_hr: bool, components: bool = False,
                   wia: bool = False, with_rel: bool = False):
    """Stages A (target matching) and B (HR scopes, then the relation-path
    fold ANDed into ``hr_pass`` when ``with_rel``): per-target-row match
    planes [B, T].

    ``components=True`` returns the resource/action stage-A planes
    (``sig_res_ex_p/d``, ``sig_res_rg_p/d``, ``sig_act_ok``) without the
    subject fold, plus stage B's ``sig_collect`` / ``sig_op_hit`` when
    ``with_hr`` or ``with_rel``: what the signature path precomputes per
    resource signature from a property-free pseudo-request.

    ``wia=True`` (components mode only, the one the reverse query uses)
    adds the whatIsAllowed-mode planes: PERMIT fails only when the target
    has properties, the request has none and the entity matched; DENY
    never property-fails; ``sig_maybe_*`` mark rows that could append
    masking obligations (target properties and an entity hit)."""
    act_ok = _pairs_subset(
        c["t_act_ids"], c["t_act_vals"], r["r_act_ids"], r["r_act_vals"]
    )

    ent_valid = r["r_ent_valid"]  # [B, NR]
    tev = c["t_ent_vals"]  # [T, K]
    em_ex = (
        (tev[None, :, :, None] == r["r_ent_vals"][:, None, None, :])
        & (tev >= 0)[None, :, :, None]
        & ent_valid[:, None, None, :]
    ).any(dim=2)  # [B, T, NR]
    tw = c["t_ent_w"]
    w_idx = tw.clamp(min=0)
    e_idx = r["r_ent_e"].clamp(min=0)
    w_ok = (tw >= 0)[None, :, :, None] & ent_valid[:, None, None, :]
    rgx_hit = r["rgx_set"][w_idx[None, :, :, None],
                           e_idx[:, None, None, :]] & w_ok
    pfx_neq = r["pfx_neq"][w_idx[None, :, :, None],
                           e_idx[:, None, None, :]] & w_ok
    em_rg = rgx_hit.any(dim=2)

    ent_any_ex = em_ex.any(dim=2)  # [B, T]
    top = c["t_op_vals"]
    rop = r["r_op_vals"]
    opm = (
        (top[None, :, :, None] == rop[:, None, None, :])
        & (top >= 0)[None, :, :, None]
        & (rop >= 0)[:, None, None, :]
    ).any(dim=3).any(dim=2)

    state_ex = torch.cumsum(em_ex.to(torch.int32), dim=2) > 0
    reset_rg = pfx_neq.any(dim=2) & ~em_rg
    state_rg = _sticky(em_rg, reset_rg)  # [B, T, NR]

    prop_vals = r["r_prop_vals"]
    prop_valid = (prop_vals >= 0)[:, None, :]  # [B, 1, NP]
    prop_run = r["r_prop_run"].clamp(min=0).long()
    prop_has_run = (r["r_prop_run"] >= 0)[:, None, :]
    state_at_prop_ex = _take_runs(state_ex, prop_run) & prop_has_run
    tails = c["t_ent_tails"]
    tail_eq = (
        (tails[None, :, :, None] == r["r_prop_tail"][:, None, None, :])
        & (tails >= 0)[None, :, :, None]
    ).any(dim=2)  # [B, T, NP]
    relevant_ex = prop_valid & state_at_prop_ex & tail_eq
    tpv = c["t_prop_vals"]
    in_rule = (
        (tpv[None, :, :, None] == prop_vals[:, None, None, :])
        & (tpv >= 0)[None, :, :, None]
    ).any(dim=2)
    tps = c["t_prop_sfx"]
    sfx_in_rule = (
        (tps[None, :, :, None] == r["r_prop_sfx"][:, None, None, :])
        & (tps >= 0)[None, :, :, None]
    ).any(dim=2)
    state_at_prop_rg = _take_runs(state_rg, prop_run) & prop_has_run
    relevant_rg = prop_valid & state_at_prop_rg

    has_props = c["t_has_props"][None]
    r_has_props = r["r_has_props"][:, None]
    state_any_rg = state_rg.any(dim=2)
    state_final_rg = state_rg[:, :, -1]
    permit_fail_ex = has_props & (
        (~r_has_props & ent_any_ex) | (relevant_ex & ~in_rule).any(dim=2)
    )
    deny_skip_ex = has_props & r_has_props & ~(
        relevant_ex & in_rule).any(dim=2)
    permit_fail_rg = has_props & (
        (~r_has_props & state_any_rg)
        | (relevant_rg & ~sfx_in_rule).any(dim=2)
    )
    deny_skip_rg = has_props & r_has_props & ~(
        relevant_rg & sfx_in_rule).any(dim=2)

    no_res = (c["t_n_res"] == 0)[None]

    def _wia_planes(prefix: str, maybe: str, base):
        """whatIsAllowed-mode planes, ANDed with ``base`` when given."""
        wia_fail_ex = has_props & ~r_has_props & ent_any_ex
        wia_fail_rg = has_props & ~r_has_props & state_any_rg
        planes = {
            prefix + "ex_p": no_res | ((ent_any_ex | opm) & ~wia_fail_ex),
            prefix + "ex_d": no_res | ent_any_ex | opm,
            prefix + "rg_p": no_res | (state_final_rg & ~wia_fail_rg),
            prefix + "rg_d": no_res | state_final_rg,
        }
        if base is not None:
            planes = {k: base & v for k, v in planes.items()}
        planes[maybe + "ex"] = has_props & ent_any_ex
        planes[maybe + "rg"] = has_props & state_any_rg
        return planes

    res_ex_p = no_res | ((ent_any_ex | opm) & ~permit_fail_ex)
    res_ex_d = no_res | ((ent_any_ex | opm) & ~deny_skip_ex)
    res_rg_p = no_res | (state_final_rg & ~permit_fail_rg)
    res_rg_d = no_res | (state_final_rg & ~deny_skip_rg)
    if components:
        out = {
            "sig_res_ex_p": res_ex_p,
            "sig_res_ex_d": res_ex_d,
            "sig_res_rg_p": res_rg_p,
            "sig_res_rg_d": res_rg_d,
            "sig_act_ok": act_ok,
        }
        if wia:
            out.update(_wia_planes("sig_wia_", "sig_maybe_", None))
        if with_hr or with_rel:
            out["sig_collect"], out["sig_op_hit"] = _hr_collect_state(
                c, r, rgx_hit, pfx_neq, ent_valid
            )
        return out

    base = _subject_ok(c, r) & act_ok
    out = {
        "tm_ex_p": base & res_ex_p,
        "tm_ex_d": base & res_ex_d,
        "tm_rg_p": base & res_rg_p,
        "tm_rg_d": base & res_rg_d,
    }
    if wia:
        out.update(_wia_planes("tm_wia_", "maybe_mask_", base))
    if not with_hr and not with_rel:
        out["hr_pass"] = torch.ones_like(base)
        return out
    collect, op_hit = _hr_collect_state(c, r, rgx_hit, pfx_neq, ent_valid)
    hr = torch.ones_like(base)
    if with_hr:
        hr_trivial = (c["t_n_subjects"] == 0) | ~c["t_has_scoping"]
        hr = _hr_pass_from_bits(r, c["t_rs_idx"].long(), collect, op_hit,
                                c["t_hr_check"], hr_trivial)
    if with_rel:
        # ANDed into hr_pass, so both gate sites (the rule's reach and the
        # policy-subject gate) read it, as the oracle pairs the HR-scope
        # and relation checks
        idx = c["t_rel_idx"]
        hr = hr & _rel_pass_from_bits(r, idx.long(), collect,
                                      c["t_rel_direct"], idx < 0)
    out["hr_pass"] = hr
    return out


def _action_kind(c, r):
    """0 other, 1 create, 2 read/modify/delete, judged on the first
    action attribute of each row -> [B]."""
    k = c["acl_consts"]
    id0 = r["r_act_ids"][:, 0]
    val0 = r["r_act_vals"][:, 0]
    is_action = id0 == k[2]
    create = is_action & (val0 == k[3])
    rmd = is_action & ((val0 == k[4]) | (val0 == k[5]) | (val0 == k[6]))
    return torch.where(create, 1, torch.where(rmd, 2, 0))


def _acl_pass(c, r, with_acl: bool):
    """Stage B2: verifyACL per target row -> [B, T]."""
    k = c["acl_consts"]
    skip = c["t_skip_acl"][None]  # [1, T]
    short = r["r_acl_short"][:, None]
    kind = _action_kind(c, r)[:, None]
    n_ra_ok = (r["r_n_ra"] > 0)[:, None]

    if not with_acl:
        return skip | (short == 1) | ((short == 0) & n_ra_ok & (kind > 0))

    ents = r["r_acl_ent"]    # [B, NACLE]
    insts = r["r_acl_inst"]  # [B, NACLE, NACLI]
    ev = ents >= 0
    iv = insts >= 0
    NACLE, NACLI = insts.shape[1], insts.shape[2]
    has_ents = ev.any(dim=1)[:, None]  # [B, 1]
    tsv = c["t_sub_vals"]  # [T, KS]
    scoped_mask = (c["t_sub_ids"] == k[0]) & (tsv >= 0)  # [T, KS]
    user_e = ev & (ents == k[1])  # [B, NACLE]

    def scoped(role_col):
        """role_col [B, N] -> [B, T, N]: the role is one of the target
        row's scoped roles."""
        return (
            (role_col[:, None, None, :] == tsv[None, :, :, None])
            & scoped_mask[None, :, :, None]
        ).any(dim=2)

    ra2 = r["r_ra2"]
    ra2v = ra2[:, :, 1] >= 0
    subj_exists = (
        scoped(ra2[:, :, 0])[:, :, None, :]
        & (ents[:, None, :, None] == ra2[:, None, None, :, 1])
        & ra2v[:, None, None, :]
    ).any(dim=3)  # [B, T, NACLE]

    ra3 = r["r_ra3"]
    ra3v = ra3[:, :, 1] >= 0
    inst_has = (
        (insts[:, :, :, None] == ra3[:, None, None, :, 2])
        & iv[:, :, :, None]
    ).any(dim=2)  # [B, NACLE, NRA]
    rmd_sub = (
        scoped(ra3[:, :, 0])[:, :, None, :]
        & (ents[:, None, :, None] == ra3[:, None, None, :, 1])
        & inst_has[:, None, :, :]
        & ra3v[:, None, None, :]
    ).any(dim=3)  # [B, T, NACLE]
    subj_in = ((insts == r["r_subject_id"][:, None, None]) & iv).any(dim=2)
    rmd_ok = (
        ev[:, None, :] & ((user_e & subj_in)[:, None, :] | rmd_sub)
    ).any(dim=2)  # [B, T]
    rmd_res = ~has_ents | rmd_ok

    hr_roles = r["r_hr_roles"]  # [B, NHRR]
    NHRR = hr_roles.shape[1]
    role_scoped = scoped(hr_roles) & (hr_roles >= 0)[:, None, :]  # [B,T,H]
    ahr = r["r_acl_hr"]  # [B, NHR, 2]
    ahrv = ahr[:, :, 1] >= 0
    elig = (
        (insts[:, :, :, None, None] == ahr[:, None, None, None, :, 1])
        & (hr_roles[:, None, None, :, None] == ahr[:, None, None, None, :, 0])
        & ahrv[:, None, None, None, :]
    ).any(dim=4) & iv[:, :, :, None]  # [B, NACLE, NACLI, NHRR]
    same_val = (
        (insts[:, :, :, None] == insts[:, :, None, :]) & iv[:, :, None, :]
    )  # [B, NACLE, NACLI(i), NACLI(j)]

    # the create-path scan over the (role, instance) grid, in order
    B, T = role_scoped.shape[:2]
    dev = insts.device
    validated = torch.zeros((B, T, NACLE, NACLI), dtype=torch.bool,
                            device=dev)
    broken = torch.zeros((B, T, NACLE), dtype=torch.bool, device=dev)
    last_ev = torch.zeros((B, T, NACLE), dtype=torch.int32, device=dev)
    for h in range(NHRR):
        rsc = role_scoped[:, :, h][:, :, None]  # [B, T, 1]
        for i in range(NACLI):
            if i == 0:
                broken = torch.zeros_like(broken)
            elig_cur = elig[:, :, i, h][:, None, :]  # [B, 1, NACLE]
            active = rsc & iv[:, :, i][:, None, :] & ~broken
            in_validated = (
                validated & same_val[:, None, :, i, :]
            ).any(dim=3)
            hit = active & elig_cur
            fail = active & ~elig_cur & ~in_validated
            validated[:, :, :, i] |= hit
            broken = broken | fail
            last_ev = torch.where(hit, 1, torch.where(fail, 2, last_ev))
    ev_any = last_ev > 0
    ev_true = last_ev == 1

    # compose the entities in order with the carried valid flag
    v = torch.zeros((B, T), dtype=torch.bool, device=dev)
    alive = torch.ones((B, T), dtype=torch.bool, device=dev)
    for e in range(NACLE):
        is_real = ev[:, e][:, None]
        is_user = user_e[:, e][:, None]
        v_out = torch.where(ev_any[:, :, e], ev_true[:, :, e], v)
        fail_e = ~is_user & (~subj_exists[:, :, e] | ~v_out)
        v = torch.where(is_real, is_user | v_out, v)
        alive = alive & (~is_real | ~fail_e)
    create_res = ~has_ents | alive

    pair_ok = n_ra_ok & torch.where(
        kind == 1, create_res, torch.where(kind == 2, rmd_res, False)
    )
    return skip | (short == 1) | ((short == 0) & pair_ok)


def _gather_t(plane, idx):
    """plane [B, T] at target indices idx (any shape) -> [B, *idx.shape]."""
    return plane[:, idx.long()]


def _rule_conditions(c, r):
    """Per-rule condition bits for every row -> [B, S, KP, KR] each."""
    has_cond = c["rule_cond"] >= 0
    cond_idx = c["rule_cond"].clamp(min=0).long()
    B = r["r_n_ra"].shape[0]
    if r["cond_true"].shape[0] > 0:
        cond_t = r["cond_true"].T[:, cond_idx]
        cond_a = r["cond_abort"].T[:, cond_idx]
        cond_c = r["cond_code"].T[:, cond_idx]
    else:
        shape = (B,) + tuple(cond_idx.shape)
        dev = cond_idx.device
        cond_t = torch.ones(shape, dtype=torch.bool, device=dev)
        cond_a = torch.zeros(shape, dtype=torch.bool, device=dev)
        cond_c = torch.full(shape, 200, dtype=torch.int32, device=dev)
    return has_cond[None], cond_t, cond_a, cond_c


def _rule_predicates(c, r, m, with_acl: bool):
    """Stage C: per-rule reachability, ACL gate and condition wiring."""
    rt = c["rule_target"]
    rule_deny = (c["rule_effect"] == 2)[None]
    tm_rule_ex = torch.where(rule_deny, _gather_t(m["tm_ex_d"], rt),
                             _gather_t(m["tm_ex_p"], rt))
    tm_rule_rg = torch.where(rule_deny, _gather_t(m["tm_rg_d"], rt),
                             _gather_t(m["tm_rg_p"], rt))
    no_target = ~c["rule_has_target"][None]
    tm_rule = no_target | tm_rule_ex | tm_rule_rg
    hr_rule = no_target | _gather_t(m["hr_pass"], rt)
    reached = c["rule_valid"][None] & tm_rule & hr_rule
    acl_rule = no_target | _gather_t(_acl_pass(c, r, with_acl), rt)
    has_cond, cond_t, cond_a, cond_c = _rule_conditions(c, r)
    return reached, acl_rule, has_cond, cond_t, cond_a, cond_c


def _multi_entity_ok(c, r_ent_vals, r_ent_valid):
    """Multi-entity recheck -> [B, S]: every requested entity must exactly
    match some policy's resources.  Shared by the dense matcher (request
    entities) and the signature planes (the signature is the entity
    list)."""
    pev = c["pol_ent_vals"]  # [S, KP, K]
    pol_ent_hit = (
        (pev[None, :, :, :, None] == r_ent_vals[:, None, None, None, :])
        & (pev >= 0)[None, :, :, :, None]
        & r_ent_valid[:, None, None, None, :]
    ).any(dim=3)  # [B, S, KP, NR]
    pol_multi_ok = pol_ent_hit & (
        ~((c["pol_effect"] == 1) & c["pol_has_props"]) & c["pol_valid"]
    )[None, :, :, None]
    return (
        ~r_ent_valid[:, None, :] | pol_multi_ok.any(dim=2)
    ).all(dim=2)


def _policy_gates_core(c, pp_ex_p, pp_ex_d, pp_rg_p, pp_rg_d, multi_gate):
    """First/second policy loop on policy-row match planes [B, S, KP]:
    carried policyEffect, exact-match break and the policy gate.  Shared
    by the dense matcher (planes gathered from the [B, T] match vectors)
    and the signature path (planes precomputed per signature, subject
    side folded by the caller)."""
    pol_valid = c["pol_valid"][None]
    ctx_deny = (c["pol_eff_ctx"] == 2)[None]
    pol_tm_first = torch.where(ctx_deny, pp_ex_d, pp_ex_p)
    pol_tm_first = pol_tm_first & pol_valid & c["pol_has_target"][None]
    KP = pol_tm_first.shape[2]
    kp_pos = torch.arange(KP, device=pol_valid.device)[None, None, :]
    first_kp = torch.where(pol_tm_first, kp_pos, BIG).amin(dim=2)  # [B, S]
    exact0 = pol_tm_first.any(dim=2)
    last_valid_kp = torch.where(pol_valid, kp_pos, -1).amax(dim=2)
    eff_src_kp = torch.where(exact0, first_kp.clamp(0, KP - 1),
                             last_valid_kp.clamp(0, KP - 1))
    B = eff_src_kp.shape[0]
    eval_eff = torch.gather(
        c["pol_eff_ctx"][None].expand(B, -1, -1), 2,
        eff_src_kp[:, :, None].long(),
    )[:, :, 0]
    exact = exact0 & multi_gate

    eval_deny = (eval_eff == 2)[:, :, None]
    pol_tm_ex = torch.where(eval_deny, pp_ex_d, pp_ex_p)
    pol_tm_rg = torch.where(eval_deny, pp_rg_d, pp_rg_p)
    pol_gate = ~c["pol_has_target"][None] | torch.where(
        exact[:, :, None], pol_tm_ex, pol_tm_rg
    )
    return pol_gate & pol_valid


def _policy_gates(c, r, m):
    """Stage D: carried policyEffect, exact-match break, multi-entity
    recheck, policy/set gates and the policy-subject HR gate."""
    pt = c["pol_target"]
    multi_gate = torch.where(
        (r["r_n_entity_attrs"] > 1)[:, None],
        _multi_entity_ok(c, r["r_ent_vals"], r["r_ent_valid"]), True
    )  # [B, S]
    pol_gate = _policy_gates_core(
        c, _gather_t(m["tm_ex_p"], pt), _gather_t(m["tm_ex_d"], pt),
        _gather_t(m["tm_rg_p"], pt), _gather_t(m["tm_rg_d"], pt), multi_gate,
    )
    set_gate = ~c["set_has_target"][None] | _gather_t(
        m["tm_ex_p"], c["set_target"]
    )
    set_gate = set_gate & c["set_valid"][None]  # [B, S]
    pol_subject = ~c["pol_has_subjects"][None] | _gather_t(m["hr_pass"], pt)
    return pol_gate, set_gate, pol_subject


def _select(ca, deny_first, permit_first, first, last):
    """Combining-algorithm selection over first/last positions: 0
    deny-overrides, 1 permit-overrides, 2 first-applicable, else 0."""
    sel_do = torch.where(deny_first < BIG, deny_first, last)
    sel_po = torch.where(permit_first < BIG, permit_first, last)
    return torch.where(
        ca == 0, sel_do,
        torch.where(ca == 1, sel_po,
                    torch.where(ca == 2, first, torch.zeros_like(first))),
    )


def _no_rules_contrib(c, pol_gate, set_gate):
    """Policies without rules contribute their own effect -> [B, S, KP]."""
    return (
        c["pol_valid"][None]
        & set_gate[:, :, None]
        & pol_gate
        & (c["pol_n_rules"] == 0)[None]
        & (c["pol_effect"] > 0)[None]
    )


def _per_set_effects(c, contrib_present, contrib_eff, contrib_cach,
                     explain: bool = False):
    """Stage F: each set's policy contributions [B, S, KP] combined under
    its combining algorithm -> per-set (effect, cacheable, any) [B, S];
    ``explain`` adds each set's selected policy slot [B, S]."""
    KP = contrib_present.shape[2]
    kp_pos = torch.arange(KP, device=contrib_present.device)[None, None, :]
    p_first_deny = torch.where(contrib_present & (contrib_eff == 2), kp_pos,
                               BIG).amin(dim=2)
    p_first_permit = torch.where(contrib_present & (contrib_eff == 1), kp_pos,
                                 BIG).amin(dim=2)
    p_first = torch.where(contrib_present, kp_pos, BIG).amin(dim=2)
    p_last = torch.where(contrib_present, kp_pos, -1).amax(dim=2)
    set_any = contrib_present.any(dim=2)  # [B, S]
    s_sel = _select(c["set_ca"][None], p_first_deny, p_first_permit, p_first,
                    p_last)
    s_sel_c = s_sel.clamp(0, KP - 1).long()[:, :, None]
    set_eff = torch.gather(contrib_eff, 2, s_sel_c)[:, :, 0]
    set_cach = torch.gather(contrib_cach, 2, s_sel_c)[:, :, 0]
    if explain:
        return set_eff, set_cach, set_any, s_sel_c[:, :, 0]
    return set_eff, set_cach, set_any


def _combine_sets(c, contrib_present, contrib_eff, contrib_cach,
                  explain: bool = False):
    """Stages F-G before aborts: per-set combination, then last-set-wins
    -> (decision, cacheable) [B]; ``explain`` adds the winning set slot
    (clamped), whether any set contributed and each set's selected policy
    slot, the coordinates the provenance is recovered from."""
    set_eff, set_cach, set_any, *s_sel_c = _per_set_effects(
        c, contrib_present, contrib_eff, contrib_cach, explain
    )
    S = set_eff.shape[1]
    s_pos = torch.arange(S, device=set_eff.device)[None, :]
    winner = torch.where(set_any, s_pos, -1).amax(dim=1)  # [B]
    have = winner >= 0
    winner_c = winner.clamp(0, S - 1).long()[:, None]
    decision = torch.where(
        have, torch.gather(set_eff, 1, winner_c)[:, 0].to(torch.int32), 0
    )
    cacheable = torch.where(
        have, torch.gather(set_cach, 1, winner_c)[:, 0].to(torch.int32), -1
    )
    if explain:
        return decision, cacheable, winner_c[:, 0], have, s_sel_c[0]
    return decision, cacheable


def _apply_aborts(decision, cacheable, abort_rule, cond_c, cach_raw,
                  explain: bool = False):
    """Condition aborts preempt everything, first in flat rule order:
    ``abort_rule`` / ``cond_c`` [B, ...] in flat order, ``cach_raw`` the
    rules' raw cacheable flags in the same order; ``explain`` adds the
    aborting rule's flat position (clamped) and whether one aborted."""
    B = abort_rule.shape[0]
    n = abort_rule[0].numel()
    flat_order = torch.arange(n, device=abort_rule.device)
    abort_pos = torch.where(abort_rule.reshape(B, -1), flat_order[None],
                            BIG).amin(dim=1)
    has_abort = abort_pos < BIG
    abort_flat = abort_pos.clamp(0, n - 1).long()[:, None]
    abort_code = torch.gather(cond_c.reshape(B, -1), 1, abort_flat)[:, 0]
    abort_cach = cach_raw.reshape(-1)[abort_flat[:, 0]]
    decision = torch.where(has_abort, 2, decision).to(torch.int32)
    cacheable = torch.where(has_abort, abort_cach.to(torch.int32),
                            cacheable).to(torch.int32)
    status = torch.where(has_abort, abort_code.to(torch.int32),
                         200).to(torch.int32)
    if explain:
        return decision, cacheable, status, abort_flat[:, 0], has_abort
    return decision, cacheable, status


def _wrap32(x):
    """int64 -> int32 with two's-complement wrap, as JAX's int32 shifts
    wrap."""
    return (((x.long() + (1 << 31)) % (1 << 32)) - (1 << 31)).to(torch.int32)


def _explain_code(have, no_rules_win, win_flat, rule_pos, has_abort,
                  abort_orig):
    """The packed provenance code [B]: the aborting rule (kind 3) over the
    winning no-rules policy (kind 2) or rule (kind 1), else 0."""
    code = torch.where(
        have,
        torch.where(no_rules_win, (win_flat.long() << 2) | 2,
                    (rule_pos.long() << 2) | 1),
        0,
    )
    return _wrap32(torch.where(has_abort, (abort_orig.long() << 2) | 3,
                               code))


def _take_rows(x, idx):
    """Row b's element idx[b] of x [B, ...] (flattened per row) -> [B]."""
    return torch.gather(x.reshape(x.shape[0], -1), 1,
                        idx.long()[:, None])[:, 0]


def _policy_contributions(c, reached, acl_rule, has_cond, cond_t, cond_a,
                          pol_gate, set_gate, pol_subject,
                          explain: bool = False):
    """Stage E alone: each policy's winning-rule contribution [B, S, KP]
    (present, effect, cacheable) and the abort-rule mask [B, S, KP, KR];
    split out, as in the JAX package, so the pod-sharded program can run
    stages A-F per shard (``ops/shard_ref.set_chunk_ref``).  ``explain``
    adds each policy's selected rule slot (clamped) and the no-rules
    contribution mask [B, S, KP]."""
    scope = set_gate[:, :, None, None] & pol_gate[:, :, :, None]
    abort_rule = reached & has_cond & cond_a & scope
    matches = reached & (~has_cond | cond_t) & ~(has_cond & cond_a) & acl_rule
    coll = matches & pol_subject[:, :, :, None] & scope  # [B, S, KP, KR]

    B, S, KP, KR = coll.shape
    dev = coll.device
    rule_effect = c["rule_effect"][None]
    kr_pos = torch.arange(KR, device=dev)[None, None, None, :]
    first_deny = torch.where(coll & (rule_effect == 2), kr_pos, BIG).amin(3)
    first_permit = torch.where(coll & (rule_effect == 1), kr_pos, BIG).amin(3)
    first_coll = torch.where(coll, kr_pos, BIG).amin(dim=3)
    last_coll = torch.where(coll, kr_pos, -1).amax(dim=3)
    any_coll = coll.any(dim=3)
    sel = _select(c["pol_ca"][None], first_deny, first_permit, first_coll,
                  last_coll)
    sel_c = sel.clamp(0, KR - 1).long()[:, :, :, None]
    rule_eff_sel = torch.gather(
        c["rule_effect"][None].expand(B, -1, -1, -1), 3, sel_c)[..., 0]
    rule_cach_sel = torch.gather(
        c["rule_cacheable_eff"][None].expand(B, -1, -1, -1), 3, sel_c
    )[..., 0]

    no_rules = _no_rules_contrib(c, pol_gate, set_gate)
    contrib_present = no_rules | any_coll  # [B, S, KP]
    contrib_eff = torch.where(no_rules, c["pol_effect"][None], rule_eff_sel)
    contrib_cach = torch.where(no_rules, c["pol_cacheable"][None],
                               rule_cach_sel)
    if explain:
        return (contrib_present, contrib_eff, contrib_cach, abort_rule,
                sel_c[..., 0], no_rules)
    return contrib_present, contrib_eff, contrib_cach, abort_rule


def _combine_and_decide(c, reached, acl_rule, has_cond, cond_t, cond_a,
                        cond_c, pol_gate, set_gate, pol_subject,
                        explain: bool = False):
    """Stages E-G: rule combination per policy, policy combination per
    set, last-set-wins and condition aborts in flat rule order.
    ``explain`` appends the provenance code; positions map through
    ``c["rule_orig_flat"]`` when the rule axis was compacted."""
    contrib_present, contrib_eff, contrib_cach, abort_rule, *sel = (
        _policy_contributions(c, reached, acl_rule, has_cond, cond_t,
                              cond_a, pol_gate, set_gate, pol_subject,
                              explain))
    decision, cacheable, *win = _combine_sets(
        c, contrib_present, contrib_eff, contrib_cach, explain)
    out = _apply_aborts(decision, cacheable, abort_rule, cond_c,
                        c["rule_cacheable_raw"], explain)
    if not explain:
        return out
    decision, cacheable, status, abort_flat, has_abort = out
    sel_c, no_rules = sel
    win_s, have, s_sel_c = win
    KP, KR = sel_c.shape[2], c["rule_effect"].shape[2]
    win_flat = win_s * KP + _take_rows(s_sel_c, win_s)
    win_kr = _take_rows(sel_c, win_flat)
    no_rules_win = _take_rows(no_rules, win_flat)
    rule_pos = win_flat * KR + win_kr
    abort_orig = abort_flat
    orig = c.get("rule_orig_flat")
    if orig is not None:
        orig_f = orig.reshape(-1)
        rule_pos = orig_f[rule_pos.long()]
        abort_orig = orig_f[abort_flat.long()]
    return decision, cacheable, status, _explain_code(
        have, no_rules_win, win_flat, rule_pos, has_abort, abort_orig)


def _combine_and_decide_flat(c, reached, acl_rule, has_cond, cond_t, cond_a,
                             cond_c, pol_gate, set_gate, pol_subject=None,
                             explain: bool = False):
    """The flat-rule-axis variant for the signature path: rule inputs
    arrive as [B, S, M] planes (M = KP * KR, flat positions in the
    original (set, policy, rule) order) and each policy's KR window is
    reduced over packed rule keys (``pack_rule_key``), so the winner's
    effect and cacheable bits travel with its position.  Differs from the
    3-D variant only where the JAX package's does: a policy whose
    combining algorithm is unknown selects key 0, i.e. effect 0; and the
    explain recovery reads the winner's position as ``key >> 3`` (a -1
    "last" stays -1), clamping only the ``rule_orig_flat`` lookup."""
    S, KP, KR = c["rule_effect"].shape
    M = KP * KR
    B = reached.shape[0]
    re_f = c["rule_effect"].reshape(S, M)
    cach_eff_f = c["rule_cacheable_eff"].reshape(S, M)

    scope = set_gate[:, :, None] & pol_gate  # [B, S, KP]
    scope_f = scope.repeat_interleave(KR, dim=2)  # [B, S, M]
    abort_rule = reached & has_cond & cond_a & scope_f
    matches = reached & (~has_cond | cond_t) & ~(has_cond & cond_a) & acl_rule
    coll = matches & scope_f
    if pol_subject is not None:
        coll = coll & pol_subject.repeat_interleave(KR, dim=2)

    m_pos = torch.arange(M, dtype=torch.int32, device=coll.device)
    code_f = ((m_pos[None, :] << 3) | (re_f << 1)
              | cach_eff_f.to(torch.int32))[None]  # [1, S, M]

    def win_min(x):
        return x.reshape(B, S, KP, KR).amin(dim=3)

    def win_max(x):
        return x.reshape(B, S, KP, KR).amax(dim=3)

    first_deny = win_min(torch.where(coll & (re_f == 2)[None], code_f, BIG))
    first_permit = win_min(torch.where(coll & (re_f == 1)[None], code_f, BIG))
    first_coll = win_min(torch.where(coll, code_f, BIG))
    last_coll = win_max(torch.where(coll, code_f, -1))
    any_coll = coll.reshape(B, S, KP, KR).any(dim=3)
    sel = _select(c["pol_ca"][None], first_deny, first_permit, first_coll,
                  last_coll)
    rule_eff_sel = (sel >> 1) & 3
    rule_cach_sel = sel & 1

    no_rules = _no_rules_contrib(c, pol_gate, set_gate)
    contrib_present = no_rules | any_coll
    contrib_eff = torch.where(no_rules, c["pol_effect"][None], rule_eff_sel)
    contrib_cach = torch.where(no_rules, c["pol_cacheable"][None].to(
        torch.int32), rule_cach_sel)
    decision, cacheable, *win = _combine_sets(
        c, contrib_present, contrib_eff, contrib_cach, explain)
    out = _apply_aborts(decision, cacheable, abort_rule, cond_c,
                        c["rule_cacheable_raw"], explain)
    if not explain:
        return out
    decision, cacheable, status, abort_flat, has_abort = out
    win_s, have, s_sel_c = win
    win_flat = win_s * KP + _take_rows(s_sel_c, win_s)
    win_m = _take_rows(sel, win_flat) >> 3
    no_rules_win = _take_rows(no_rules, win_flat)
    rule_pos = win_s * M + win_m
    abort_orig = abort_flat
    orig = c.get("rule_orig_flat")
    if orig is not None:
        orig_f = orig.reshape(-1)
        rule_pos = orig_f[rule_pos.clamp(0, S * M - 1).long()]
        abort_orig = orig_f[abort_flat.long()]
    return decision, cacheable, status, _explain_code(
        have, no_rules_win, win_flat, rule_pos, has_abort, abort_orig)


def _evaluate(c, r, with_acl: bool, with_hr: bool, with_rel: bool,
              explain: bool = False):
    m = _match_targets(c, r, with_hr, with_rel=with_rel)
    reached, acl_rule, has_cond, cond_t, cond_a, cond_c = _rule_predicates(
        c, r, m, with_acl
    )
    pol_gate, set_gate, pol_subject = _policy_gates(c, r, m)
    return _combine_and_decide(
        c, reached, acl_rule, has_cond, cond_t, cond_a, cond_c,
        pol_gate, set_gate, pol_subject, explain,
    )


def chunk_rows(c: dict) -> int:
    """Rows per chunk for a tree: keeps the widest [B, S*KP*KR] /
    [B, T, ...] intermediates near CHUNK_ELEMS elements, between 64 and
    8192 rows."""
    width = max(int(c["rule_valid"].numel()), int(c["t_role"].shape[0]), 1)
    return max(64, min(8192, CHUNK_ELEMS // width))


def row_chunks(c: dict, r: dict):
    """The batch ``r`` in row chunks of ``chunk_rows(c)`` rows each (the
    regex matrices whole, the condition columns cut along their row
    axis)."""
    B = r["r_n_ra"].shape[0]
    step = chunk_rows(c)
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        rc = {}
        for k, v in r.items():
            if k in ("rgx_set", "pfx_neq"):
                rc[k] = v
            elif k.startswith("cond_"):
                rc[k] = v[:, lo:hi]
            else:
                rc[k] = v[lo:hi]
        yield rc


def decide_dense_ref(c: dict, r: dict, with_acl: bool, with_hr: bool,
                     with_rel: bool, *, explain: bool = False):
    """The plain version of the dense decision kernel over a whole batch:
    (decision, cacheable, status) int32 [B], in row chunks, and with
    ``explain`` the provenance code [B]."""
    outs = [_evaluate(c, rc, with_acl, with_hr, with_rel, explain)
            for rc in row_chunks(c, r)]
    return tuple(torch.cat([o[i] for o in outs])
                 for i in range(len(outs[0])))
