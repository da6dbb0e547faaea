"""Host-side decode of the kernel's packed explain output.

The port's own copy of the JAX package's ``srv/explain.py`` (the module
is framework-neutral; the port imports nothing of that package).

Every kernel variant (dense ops/kernel.py, sig-path ops/prefilter.py,
rule-sharded parallel/rule_shard.py, pod-sharded parallel/pod_shard.py)
can emit one extra int32 per row encoding the deciding node:

    code = (flat_pos << 2) | kind

    kind 0  no contribution (INDETERMINATE with no winning set)
    kind 1  rule decided:           flat_pos = (s * KP + kp) * KR + kr
    kind 2  no-rules policy decided: flat_pos = s * KP + kp
    kind 3  condition abort:         flat_pos = rule flat pos as kind 1

``(KP, KR)`` are the kernel's ``explain_strides`` — the dense and
pod-sharded kernels use the compiled (possibly capacity-bucketed) table
shape, the rule-sharded kernel uses its padded global rule extent, and
the sig-path kernel maps compacted slots back to original coordinates on
device (``rule_orig_flat``), so the decode here is one divmod chain per
row either way.  Positions are always ORIGINAL slot coordinates, so the
decode table mirrors ops/compile.py's slot enumeration exactly: the
s-th non-None PolicySet in tree order, ``kp`` over
``ps.combinables.items()`` INCLUDING None placeholders, ``kr`` likewise
over ``pol.combinables.items()`` — the positional tree <-> slot
correspondence the delta patcher preserves (set membership/order changes
force a full recompile, ops/delta.py).

The decoded shape matches the host oracle's provenance
(core/engine.py ``EffectEvaluation.source``): a kind-1 row's source is
the deciding rule id, a kind-2 row's source is the no-rules policy id
(the engine stamps ``source=policy.id`` when a rule-less policy carries
an effect), kind 0 has no source, and kind 3 (condition abort) carries
NO ``_rule_id`` — the reference's abort path returns a bare DENY +
status without provenance — while the richer explain dict still names
the aborting rule.

Int32 bound: positions use 30 bits, so trees must satisfy
``S * KP * KR < 2**28`` (~268M rule slots) for explain mode — far above
any capacity bucket the compiler emits; the evaluator asserts it at
kernel publish.
"""

from __future__ import annotations

from typing import Optional

KIND_NONE = 0
KIND_RULE = 1
KIND_POLICY = 2
KIND_ABORT = 3

_KIND_NAMES = {
    KIND_RULE: "rule",
    KIND_POLICY: "policy",
    KIND_ABORT: "condition_abort",
}


class ExplainDecoder:
    """Positional decode table over one version-pinned tree snapshot.

    Built at kernel publish (srv/evaluator.py) from the same snapshot
    the compiled arrays were lowered from, so slot coordinates and node
    identities can never tear against hot mutations — exactly the
    ReverseQueryKernel's pinning discipline."""

    def __init__(self, policy_sets, strides: tuple):
        KP, KR = strides
        self.KP = int(KP)
        self.KR = int(KR)
        if isinstance(policy_sets, dict):
            sets = [ps for ps in policy_sets.values() if ps is not None]
        else:
            sets = [ps for ps in policy_sets if ps is not None]
        self._sets: list[tuple] = []      # s -> (set_id, set_ca)
        self._pols: list[list] = []       # s -> kp -> (id, ca, effect)|None
        self._rules: list[list] = []      # s -> kp -> kr -> rule_id|None
        for ps in sets:
            self._sets.append((ps.id, ps.combining_algorithm))
            pols: list = []
            rules: list = []
            for pol in ps.combinables.values():
                if pol is None:
                    pols.append(None)
                    rules.append([])
                    continue
                pols.append(
                    (pol.id, pol.combining_algorithm, pol.effect)
                )
                rules.append([
                    None if rule is None else rule.id
                    for rule in pol.combinables.values()
                ])
            self._pols.append(pols)
            self._rules.append(rules)

    # ------------------------------------------------------------- decode

    def decode(self, code: int) -> Optional[dict]:
        """Full provenance dict for one packed code; None for kind 0 or
        any out-of-range position (defensive: a corrupt code must never
        raise on the serving path)."""
        code = int(code)
        kind = code & 3
        pos = code >> 2
        if kind == KIND_NONE or pos < 0:
            return None
        if kind == KIND_POLICY:
            s, kp = divmod(pos, self.KP)
            pol = self._pol_at(s, kp)
            if pol is None:
                return None
            set_id, set_ca = self._sets[s]
            return {
                "kind": _KIND_NAMES[kind],
                "set": set_id,
                "set_algorithm": set_ca,
                "policy": pol[0],
                "policy_algorithm": pol[1],
                "policy_effect": pol[2],
                "rule": None,
            }
        pk, kr = divmod(pos, self.KR)
        s, kp = divmod(pk, self.KP)
        pol = self._pol_at(s, kp)
        if pol is None:
            return None
        rules = self._rules[s][kp]
        if kr >= len(rules) or rules[kr] is None:
            return None
        set_id, set_ca = self._sets[s]
        return {
            "kind": _KIND_NAMES[kind],
            "set": set_id,
            "set_algorithm": set_ca,
            "policy": pol[0],
            "policy_algorithm": pol[1],
            "rule": rules[kr],
        }

    def source(self, code: int) -> Optional[str]:
        """The host oracle's ``EffectEvaluation.source`` equivalent:
        deciding rule id (kind 1), no-rules policy id (kind 2), None for
        no-contribution and condition-abort rows (the engine's abort
        response carries no ``_rule_id``)."""
        kind = int(code) & 3
        if kind not in (KIND_RULE, KIND_POLICY):
            return None
        info = self.decode(code)
        if info is None:
            return None
        return info["rule"] if kind == KIND_RULE else info["policy"]

    def describe_source(self, source_id: Optional[str]) -> Optional[dict]:
        """Provenance dict for a host-oracle source id — the deciding
        rule (kind 1) or no-rules policy (kind 2) the engine stamped as
        ``EffectEvaluation.source``.  Lets the oracle-fallback serving
        path carry the same ``_explain`` shape as kernel rows, so the
        wire trailer and audit record never depend on which path decided
        a row.  Rules are searched before policies: a policy's own
        effect decides only when it has no rules."""
        if source_id is None:
            return None
        for s, (set_id, set_ca) in enumerate(self._sets):
            for kp, pol in enumerate(self._pols[s]):
                if pol is None:
                    continue
                for rule_id in self._rules[s][kp]:
                    if rule_id == source_id:
                        return {
                            "kind": _KIND_NAMES[KIND_RULE],
                            "set": set_id,
                            "set_algorithm": set_ca,
                            "policy": pol[0],
                            "policy_algorithm": pol[1],
                            "rule": rule_id,
                        }
        for s, (set_id, set_ca) in enumerate(self._sets):
            for kp, pol in enumerate(self._pols[s]):
                if pol is not None and pol[0] == source_id:
                    return {
                        "kind": _KIND_NAMES[KIND_POLICY],
                        "set": set_id,
                        "set_algorithm": set_ca,
                        "policy": pol[0],
                        "policy_algorithm": pol[1],
                        "policy_effect": pol[2],
                        "rule": None,
                    }
        return None

    # ------------------------------------------------------------ helpers

    def _pol_at(self, s: int, kp: int):
        if s >= len(self._pols) or kp >= len(self._pols[s]):
            return None
        return self._pols[s][kp]


def explain_capacity_ok(S: int, KP: int, KR: int) -> bool:
    """True when every flat rule position fits the 30-bit payload of the
    packed code (see module docstring)."""
    return S * KP * KR < (1 << 28)
