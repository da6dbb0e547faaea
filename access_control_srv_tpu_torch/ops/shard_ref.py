"""Plain PyTorch versions of the sharded programs' kernels.

The JAX package runs each sharded program (``parallel/rule_shard.py``
``_evaluate_chunk``, ``parallel/pod_shard.py`` ``_evaluate_set_chunk``) as
one jitted ``shard_map`` with ``lax.pmin`` / ``lax.pmax`` inside.  The port
splits each into a shard kernel, one MIN ``all_reduce`` over the ``model``
group, and a tail kernel.  These are the stage-for-stage plain versions of
the three kernels (``rule_chunk`` and ``set_chunk``, the two modes of
``ops/csrc/shard_chunk.cu``, and ``shard_tail``, ``ops/csrc/shard_tail.cu``),
built from ``ops/kernel_ref.py``'s stage functions as
the JAX programs are built from ``ops/kernel.py``'s helpers.  The wrappers
in ``ops/kernel.py`` run them for tensors on the CPU; on the card they are
the yardstick the kernels are held against.

Both shard kernels write one int32 **merge row** per request:

- ``rule_chunk``: per (set, policy) ``KEY_COLS`` ints -- the first-DENY,
  first-PERMIT and first collected rule keys (``pack_rule_key`` of the
  GLOBAL rule position, ``BIGKEY`` when none), the NEGATED last key
  (``pack_rule_key(pos + 1, ...)``, 0 when none) and the policy's gate
  (valid, set gate and policy gate: equal on every shard);
- ``set_chunk``: the NEGATED key of the shard's last contributing set,
  ``pack_rule_key(global_set + 1, effect, cacheable)``, and in explain
  mode the NEGATED provenance key of that set (below);

then ``n_model`` abort slots of three ints: the shard's first aborting rule
in GLOBAL flat order (``BIG`` when none), its status code and its raw
cacheable + 1 (0 when none), in the shard's own slot, ``INT_MAX`` in every
other.  The MIN over the shards' rows is therefore exactly what JAX's
collectives compute: the MIN keys, the MAX last key (negated), and every
shard's abort slot (an all-gather), from which the tail takes the least
position.

Explain mode (``explain=True``) appends the fourth output, the provenance
code of ``srv/explain.py``, with no further collective.  The rule-sharded
tail recovers it from the merged keys, whose high bits already name the
winning GLOBAL rule (strides ``(KP, kr_total)``, as the JAX program's).
The pod-sharded program's JAX version packs the code on the shard that
owns the winning set and broadcasts it with a second ``pmax``; here each
shard writes the code of its own last contributing set as a key that
orders like the set position -- a kind-2 (no-rules policy) code carries
``flat_pos * KR`` in place of ``flat_pos`` -- so the MAX over shards,
negated through the same MIN, is the owner's, and the tail divides the
kind-2 position back by ``KR``.
"""

from __future__ import annotations

import torch

from .kernel_ref import (
    BIG,
    _combine_sets,
    _match_targets,
    _per_set_effects,
    _policy_contributions,
    _policy_gates,
    _rule_predicates,
    _take_rows,
    row_chunks,
)

# packed-key columns per (set, policy) of a rule-chunk merge row
KEY_COLS = 5
# "no collected rule" sentinel of the first keys (JAX: _evaluate_chunk)
BIGKEY = 2_000_000_000
INT_MAX = 2**31 - 1
# the tail's modes (csrc/decide_core.cuh RowMode)
MODE_RULE, MODE_SET = 1, 2


def merge_width(mode: int, S: int, KP: int, n_model: int,
                explain: bool = False) -> int:
    """Ints per merge row (csrc/decide_core.cuh ``chunk_width``)."""
    if mode == MODE_RULE:
        return S * KP * KEY_COLS + n_model * 3
    return 1 + int(explain) + n_model * 3


def _pack(pos, effect, cacheable):
    return (pos << 3) | (effect.long() << 1) | cacheable.long()


def _abort_slots(abort_rule, flat_order, cond_c, cach_raw, n_model: int,
                 rank: int):
    """The merge row's abort slots [B, n_model * 3]: the first aborting
    rule of this shard in global flat order, its code and cacheable + 1
    in slot ``rank``, INT_MAX elsewhere."""
    B = abort_rule.shape[0]
    masked = torch.where(abort_rule, flat_order[None], BIG).reshape(B, -1)
    pos = masked.amin(dim=1)
    idx = masked.argmin(dim=1)
    has = pos < BIG
    code = torch.gather(cond_c.reshape(B, -1), 1, idx[:, None])[:, 0]
    cach = cach_raw.reshape(-1)[idx].long() + 1
    triple = torch.stack([pos, torch.where(has, code.long(), 0),
                          torch.where(has, cach, 0)], dim=1)
    slots = torch.full((B, n_model, 3), INT_MAX, dtype=torch.long,
                       device=abort_rule.device)
    slots[:, rank] = triple
    return slots.reshape(B, -1)


def _rule_chunk(c, r, kr_offset, kr_total, n_model, rank, with_acl, with_hr,
                with_rel):
    m = _match_targets(c, r, with_hr, with_rel=with_rel)
    reached, acl_rule, has_cond, cond_t, cond_a, cond_c = _rule_predicates(
        c, r, m, with_acl)
    pol_gate, set_gate, pol_subject = _policy_gates(c, r, m)

    # ---- rule collection on the local chunk (stage E)
    scope = set_gate[:, :, None, None] & pol_gate[:, :, :, None]
    abort_rule = reached & has_cond & cond_a & scope
    matches = reached & (~has_cond | cond_t) & ~(has_cond & cond_a) & acl_rule
    coll = matches & pol_subject[:, :, :, None] & scope  # [B, S, KP, KRl]
    B, S, KP, KRl = coll.shape
    dev = coll.device
    pos = kr_offset + torch.arange(KRl, device=dev)[None, None, None, :]
    eff = c["rule_effect"][None]
    cach = c["rule_cacheable_eff"][None]
    key_lo = _pack(pos, eff, cach)
    key_hi = _pack(pos + 1, eff, cach)
    k_first_deny = torch.where(coll & (eff == 2), key_lo, BIGKEY).amin(3)
    k_first_permit = torch.where(coll & (eff == 1), key_lo, BIGKEY).amin(3)
    k_first = torch.where(coll, key_lo, BIGKEY).amin(3)
    k_last = torch.where(coll, key_hi, 0).amax(3)
    gate = c["pol_valid"][None] & set_gate[:, :, None] & pol_gate
    keys = torch.stack([k_first_deny, k_first_permit, k_first, -k_last,
                        gate.long()], dim=3).reshape(B, -1)

    # ---- condition aborts: first in GLOBAL flat rule order
    flat_order = (
        torch.arange(S, device=dev)[:, None, None] * (KP * kr_total)
        + torch.arange(KP, device=dev)[None, :, None] * kr_total
        + kr_offset + torch.arange(KRl, device=dev)[None, None, :]
    )
    slots = _abort_slots(abort_rule, flat_order, cond_c,
                         c["rule_cacheable_raw"], n_model, rank)
    return torch.cat([keys, slots], dim=1).to(torch.int32)


def rule_chunk_ref(c: dict, r: dict, kr_offset: int, kr_total: int,
                   n_model: int, rank: int, with_acl: bool, with_hr: bool,
                   with_rel: bool) -> torch.Tensor:
    """Stages A-E of the rule-sharded program on one shard's compacted
    tables (``parallel/rule_shard.partition_rules``), rule positions
    offset by ``kr_offset`` in a padded global extent ``kr_total`` ->
    int32 [B, merge_width(MODE_RULE, S, KP, n_model)]."""
    return torch.cat([
        _rule_chunk(c, rc, kr_offset, kr_total, n_model, rank, with_acl,
                    with_hr, with_rel)
        for rc in row_chunks(c, r)])


def _set_chunk(c, r, s_offset, n_model, rank, with_acl, with_hr, with_rel,
               explain=False):
    m = _match_targets(c, r, with_hr, with_rel=with_rel)
    reached, acl_rule, has_cond, cond_t, cond_a, cond_c = _rule_predicates(
        c, r, m, with_acl)
    pol_gate, set_gate, pol_subject = _policy_gates(c, r, m)
    contrib_present, contrib_eff, contrib_cach, abort_rule, *sel = (
        _policy_contributions(c, reached, acl_rule, has_cond, cond_t,
                              cond_a, pol_gate, set_gate, pol_subject,
                              explain))
    set_eff, set_cach, set_any, *s_sel_c = _per_set_effects(
        c, contrib_present, contrib_eff, contrib_cach, explain)

    # ---- last-set-wins across shards: the local max key, negated
    B, S_l = set_eff.shape
    KP, KR = abort_rule.shape[2], abort_rule.shape[3]
    dev = set_eff.device
    gpos = s_offset + torch.arange(S_l, device=dev)
    k_set = torch.where(set_any, _pack(gpos[None] + 1, set_eff,
                                       set_cach.long() & 1), 0)
    k_win = k_set.amax(dim=1)

    # ---- condition aborts: first in GLOBAL flat rule order
    flat_order = (
        gpos[:, None, None] * (KP * KR)
        + torch.arange(KP, device=dev)[None, :, None] * KR
        + torch.arange(KR, device=dev)[None, None, :]
    )
    slots = _abort_slots(abort_rule, flat_order, cond_c,
                         c["rule_cacheable_raw"], n_model, rank)
    cols = [-k_win[:, None]]
    if explain:
        cols.append(-_set_explain_key(k_set, k_win, s_offset, KP, KR,
                                      *sel, s_sel_c[0])[:, None])
    return torch.cat(cols + [slots], dim=1).to(torch.int32)


def _set_explain_key(k_set, k_win, s_offset, KP, KR, sel_c, no_rules,
                     s_sel_c):
    """The provenance of this shard's last contributing set as a key that
    orders like the global set position: ``(pos << 2) | kind`` with pos
    the global flat rule position (kind 1) or ``(s * KP + kp) * KR``
    (kind 2); 0 when no set of the shard contributed."""
    win_s = k_set.argmax(dim=1)
    win_l = win_s * KP + _take_rows(s_sel_c, win_s)
    win_flat = (s_offset + win_s) * KP + _take_rows(s_sel_c, win_s)
    no_rules_win = _take_rows(no_rules, win_l)
    pos = win_flat * KR + torch.where(no_rules_win, 0,
                                      _take_rows(sel_c, win_l))
    kind = torch.where(no_rules_win, 2, 1)
    return torch.where(k_win > 0, (pos << 2) | kind, 0)


def live_rows(c: dict, t_live: int | None) -> dict:
    """``c`` with every target-table field (``t_*``) cut to its first
    ``t_live`` rows: prefix views, no copies (``c`` itself for None or
    tables already cut, whose fields share one row count)."""
    if t_live is None or c["t_role"].shape[0] == t_live:
        return c
    return {k: v[:t_live] if k.startswith("t_") else v for k, v in c.items()}


def set_chunk_ref(c: dict, r: dict, s_offset: int, n_model: int, rank: int,
                  with_acl: bool, with_hr: bool, with_rel: bool, *,
                  explain: bool = False, t_live: int | None = None
                  ) -> torch.Tensor:
    """Stages A-F of the pod-sharded program on one shard's tables
    (``parallel/pod_shard.slice_shard``), set positions offset by
    ``s_offset`` -> int32 [B, merge_width(MODE_SET, ..., explain)].
    ``t_live`` cuts the target table to its live rows (``live_rows``)."""
    c = live_rows(c, t_live)
    return torch.cat([
        _set_chunk(c, rc, s_offset, n_model, rank, with_acl, with_hr,
                   with_rel, explain)
        for rc in row_chunks(c, r)])


def shard_tail_ref(merge: torch.Tensor, n_model: int,
                   tabs: dict | None = None, *, explain: bool = False,
                   kr_stride: int = 0) -> torch.Tensor:
    """The decisions from merged rows -> int32 [3, B] (decision,
    cacheable, status; with ``explain`` [4, B], the provenance code
    last, its rule positions in strides ``(KP, kr_stride)``: the padded
    ``kr_total`` of the rule-sharded tables, the pod tables' ``KR``).
    ``tabs`` (``pol_ca``, ``pol_effect``, ``pol_cacheable``,
    ``pol_n_rules``, ``set_ca``) selects the rule-sharded tail; None the
    pod-sharded one."""
    B = merge.shape[0]
    m = merge.long()
    if tabs is not None:
        S, KP = tabs["pol_ca"].shape
        keys = m[:, :S * KP * KEY_COLS].reshape(B, S, KP, KEY_COLS)
        k_first_deny, k_first_permit, k_first = keys.unbind(3)[:3]
        k_last = -keys[..., 3]
        any_coll = k_last > 0
        fallback = torch.where(any_coll, k_last - 8, 0)
        sel_do = torch.where(k_first_deny < BIGKEY, k_first_deny, fallback)
        sel_po = torch.where(k_first_permit < BIGKEY, k_first_permit,
                             fallback)
        sel_fa = torch.where(k_first < BIGKEY, k_first, 0)
        ca = tabs["pol_ca"][None]
        sel = torch.where(ca == 0, sel_do, torch.where(
            ca == 1, sel_po, torch.where(ca == 2, sel_fa, 0)))
        no_rules = ((keys[..., 4] != 0) & (tabs["pol_n_rules"] == 0)[None]
                    & (tabs["pol_effect"] > 0)[None])
        contrib_present = no_rules | any_coll
        contrib_eff = torch.where(no_rules, tabs["pol_effect"][None].long(),
                                  (sel >> 1) & 3)
        contrib_cach = torch.where(no_rules, tabs["pol_cacheable"][None],
                                   (sel & 1) == 1)
        decision, cacheable, *win = _combine_sets(
            tabs, contrib_present, contrib_eff, contrib_cach, explain)
        decision, cacheable = decision.long(), cacheable.long()
        slots = m[:, S * KP * KEY_COLS:]
        if explain:
            win_s, have, s_sel_c = win
            win_flat = win_s * KP + _take_rows(s_sel_c, win_s)
            win_kr = _take_rows(sel, win_flat) >> 3
            code = torch.where(
                have,
                torch.where(_take_rows(no_rules, win_flat),
                            (win_flat << 2) | 2,
                            ((win_flat * kr_stride + win_kr) << 2) | 1),
                0)
    else:
        k_win = -m[:, 0]
        have = k_win > 0
        decision = torch.where(have, (k_win >> 1) & 3, 0)
        cacheable = torch.where(have, k_win & 1, -1)
        slots = m[:, 1 + int(explain):]
        if explain:
            key = -m[:, 1]
            pos = key >> 2
            code = torch.where((key & 3) == 2,
                               ((pos // max(kr_stride, 1)) << 2) | 2, key)
    slots = slots.reshape(B, n_model, 3)
    owner = slots[:, :, 0].argmin(dim=1)
    best = torch.gather(slots, 1, owner[:, None, None].expand(B, 1, 3))[:, 0]
    has_abort = best[:, 0] < BIG
    decision = torch.where(has_abort, 2, decision)
    cacheable = torch.where(has_abort, best[:, 2] - 1, cacheable)
    status = torch.where(has_abort, best[:, 1], 200)
    outs = [decision, cacheable, status]
    if explain:
        outs.append(torch.where(has_abort, (best[:, 0] << 2) | 3, code))
    return torch.stack(outs).to(torch.int32)
