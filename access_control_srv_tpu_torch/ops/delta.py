"""The pieces of the JAX package's ``ops/delta.py`` that the pod-sharded
kernel (``parallel/pod_shard.py``) reads: the capacity bucket and the pad
fills of the set, policy and rule array families.

The rest of that module (capacity-bucketed compiles, the delta encoder
``apply_events``, the patch ledger) is the delta slice (ROADMAP A.5) and
is not ported yet.
"""

from __future__ import annotations

from .interner import ABSENT


def _bucket(n: int, headroom: float, floor: int) -> int:
    need = max(floor, int(-(-n * headroom // 1)))
    return 1 << max(0, (need - 1).bit_length())


# pad fills per array family (axis layout in ops/compile.py)
_SET_FILLS = {"set_valid": False, "set_ca": ABSENT,
              "set_has_target": False, "set_target": 0}
_POL_FILLS = {"pol_valid": False, "pol_ca": ABSENT, "pol_effect": 0,
              "pol_cacheable": False, "pol_has_target": False,
              "pol_target": 0, "pol_has_subjects": False, "pol_n_rules": 0,
              "pol_eff_ctx": 0, "pol_has_props": False,
              "pol_ent_vals": ABSENT}
_RULE_FILLS = {"rule_valid": False, "rule_effect": 0,
               "rule_cacheable_raw": False, "rule_cacheable_eff": False,
               "rule_has_target": False, "rule_target": 0,
               "rule_cond": ABSENT}
