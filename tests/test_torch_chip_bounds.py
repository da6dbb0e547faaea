"""The chip script's kernel bounds count live work only.

The evaluator serves ``full_bucketed_compile``'s capacity-padded tables,
whose pad set / policy / rule slots, pad target rows and sentinel vocab
rows are inert: no call needs them.  So on padded tables, and on padded
tables after one ``apply_events`` patch, every bound ``chip_smoke.py``
reports (K1's ``bound_ms``, K2's ``bound_sig_planes``, K3's
``bound_sig_decide``, K4's stacked ``bound_ms``, K5's
``bound_wia_planes``) must equal the bound on the unpadded compile of
the same tree over the same requests.
"""

import copy
import random

import pytest

import chip_smoke as cs
from access_control_srv_tpu_torch.ops import compile_policies, encode_requests
from access_control_srv_tpu_torch.ops import delta as tdelta
from access_control_srv_tpu_torch.ops import prefilter as tprefilter
from access_control_srv_tpu_torch.ops import reverse as treverse

from .test_torch_delta import patched_compile


def padded_and_fresh(engine, patch: bool):
    """(the bucketed compile of ``engine``'s tree, patched once when
    ``patch``; the unpadded compile of the same tree)."""
    if patch:
        padded, _ = patched_compile(engine, tdelta, seed=3)
    else:
        padded, _, _ = tdelta.full_bucketed_compile(engine.policy_sets,
                                                    engine.urns)
    fresh = compile_policies(engine.policy_sets, engine.urns)
    assert padded.S * padded.KP * padded.KR > fresh.S * fresh.KP * fresh.KR
    assert padded.T > fresh.T
    return padded, fresh


# acl_policies.yml is not patched here: there the patch gives the edited
# rule a target row of its own (``_DeltaTargetTable`` appends it) where a
# fresh compile shares row 0, so the two tables differ in live rows, not
# in padding
@pytest.mark.parametrize("name,patch", [
    ("scoped_511", False), ("scoped_511", True),
    ("role_scopes.yml", False), ("role_scopes.yml", True),
    ("acl_policies.yml", False)])
def test_dense_bound_counts_live_work(name, patch):
    """K1 (and K6 / K8, which take the same bound): every pair and the
    passing pairs alike."""
    engine = cs.engine_for(name)
    padded, fresh = padded_and_fresh(engine, patch)
    reqs = cs.grid_requests(random.Random(5), 48, name == "scoped_511")
    bounds = []
    for compiled in (padded, fresh):
        batch = encode_requests(copy.deepcopy(reqs), compiled)
        c, _, r, flags = cs.device_inputs(compiled, batch, "cpu")
        bounds.append([cs.bound_ms(c, r, flags[2], every)
                       for every in (False, True)])
    assert bounds[0] == bounds[1]


def record(monkeypatch, module, names):
    """Every call of ``module``'s wrappers ``names``: (name, args, kw,
    output)."""
    calls = []
    for name in names:
        orig = getattr(module, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            out = _orig(*args, **kw)
            calls.append((_name, args, kw, out))
            return out

        monkeypatch.setattr(module, name, wrapped)
    return calls


def signature_bounds(call) -> tuple:
    name, args, kw, out = call
    if name == "sig_planes":
        return cs.bound_sig_planes(*args, out)
    if name == "sig_decide":
        return cs.bound_sig_decide(args)
    inv, cs_tabs, _, r, _, _, with_rel = args
    return cs.bound_ms({**inv, **cs_tabs}, r, with_rel, every_pair=True)


@pytest.mark.parametrize("patch", [False, True])
def test_signature_bounds_count_live_work(monkeypatch, patch):
    """K2, K3 and K4 on a 600-rule tree (the signature path; a second
    batch with four ACL rows for ``decide_grouped``): call by call, the
    padded tables' bounds equal the unpadded ones."""
    engine = cs.engine_from_doc(cs.stress_doc(600))
    padded, fresh = padded_and_fresh(engine, patch)
    batches = [cs.stress_traffic(64), cs.stress_traffic(64, n_acl=4)]
    runs = []
    for compiled in (padded, fresh):
        calls = record(monkeypatch, tprefilter,
                       ("sig_planes", "sig_decide", "decide_grouped"))
        kern = tprefilter.PrefilteredKernel(compiled, device="cpu")
        assert kern.active
        for reqs in batches:
            kern.evaluate(encode_requests(copy.deepcopy(reqs), compiled))
        runs.append([(c[0], signature_bounds(c)) for c in calls])
        monkeypatch.undo()
    assert {name for name, _ in runs[0]} == {"sig_planes", "sig_decide",
                                             "decide_grouped"}
    assert runs[0] == runs[1]


@pytest.mark.parametrize("patch", [False, True])
def test_wia_bound_counts_live_work(monkeypatch, patch):
    """K5 over the whole target table: the live rows and the regex
    matrices' referenced vocab rows only."""
    engine = cs.engine_for("basic_policies.yml")
    padded, fresh = padded_and_fresh(engine, patch)
    reqs = cs.grid_requests(random.Random(211), 40)
    runs = []
    for compiled in (padded, fresh):
        calls = record(monkeypatch, treverse, ("wia_planes",))
        kern = treverse.ReverseQueryKernel(compiled, engine.policy_sets,
                                           device="cpu")
        kern.evaluate(cs.wia_encode(copy.deepcopy(reqs), compiled))
        rows = cs.compiled_target_rows(compiled)
        runs.append([cs.bound_wia_planes(args, rows)
                     for _, args, _, _ in calls])
        monkeypatch.undo()
    assert runs[0] and runs[0] == runs[1]
