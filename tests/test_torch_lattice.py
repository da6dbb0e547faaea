"""The port's permission lattice and direct-mode audit sweep against the
JAX package's ``ops/lattice.py`` and ``srv/audit_sweep.py``.

Folds, lattice requests, snapshots (JSONL and bitmap), bitmap packing and
diffs must equal the JAX module's output for the same inputs; a
direct-mode sweep of the port (``HybridEvaluator(device="cpu")``, the
reverse-query kernel's plain version) must write a bitmap byte-equal to
the JAX manager's over the same tree.  The pause / cancel test is driven
by events, never by sleeps, and bounds every wait.
"""

import copy
import threading
import time

import numpy as np
import pytest

import access_control_srv_tpu.models.model as jmodel
import access_control_srv_tpu_torch.models as tmodels
import access_control_srv_tpu_torch.models.model as tmodel
import bench_all
from access_control_srv_tpu import models as jmodels
from access_control_srv_tpu.ops import lattice as jlat
from access_control_srv_tpu.srv.audit_sweep import AuditSweepManager as JaxManager
from access_control_srv_tpu.srv.evaluator import HybridEvaluator as JaxEvaluator
from access_control_srv_tpu_torch.ops import lattice as tlat
from access_control_srv_tpu_torch.ops import reverse as treverse
from access_control_srv_tpu_torch.srv import audit_sweep as taudit
from access_control_srv_tpu_torch.srv.audit_sweep import AuditSweepManager
from access_control_srv_tpu_torch.srv.evaluator import HybridEvaluator

from .test_torch_carryover import build_request, request_spec
from .test_torch_kernel import engines_from_doc

DO = bench_all.DO
PO = bench_all.PO
FA = "urn:oasis:names:tc:xacml:3.0:rule-combining-algorithm:first-applicable"
ALL_ACTIONS = ("read", "modify", "create", "delete")


def stress_engines(n_rules, flip_every=0):
    doc, _ = bench_all._stress_doc(n_rules, flip_every=flip_every)
    return engines_from_doc(doc)


def verdict_key(v):
    return (v.decision, v.rule_id, v.conditional, v.shed_code, v.code)


def cells(spec):
    return [(i, r) for chunk in spec.chunks(97) for i, r in chunk]


def test_fold_matches_jax_and_the_oracle():
    """fold(whatIsAllowed(cell)) of the port equals the JAX fold of the
    JAX tree on every cell, and the port's isAllowed decision and
    deciding rule."""
    jeng, teng = stress_engines(48)
    jspec = jlat.LatticeSpec.stress(8, 8, actions=ALL_ACTIONS)
    tspec = tlat.LatticeSpec.stress(8, 8, actions=ALL_ACTIONS)
    for (i, jreq), (k, treq) in zip(cells(jspec), cells(tspec)):
        assert i == k and request_spec(jreq) == request_spec(treq)
        want = jlat.fold_reverse_query(jeng.what_is_allowed(jreq))
        got = tlat.fold_reverse_query(teng.what_is_allowed(
            copy.deepcopy(treq)))
        assert verdict_key(got) == verdict_key(want), i
        resp = teng.is_allowed(copy.deepcopy(treq))
        assert got.decision == resp.decision
        if resp.decision in ("PERMIT", "DENY"):
            assert got.rule_id == resp._rule_id


def _rq(model, algorithm, rules, set_algorithm=DO, extra_sets=()):
    policy = model.PolicyRQ(
        id="p0", combining_algorithm=algorithm, has_rules=True,
        rules=[model.RuleRQ(id=rid, effect=eff, condition=cond)
               for rid, eff, cond in rules],
    )
    sets = [model.PolicySetRQ(id="s0", combining_algorithm=set_algorithm,
                              policies=[policy])]
    return model.ReverseQuery(policy_sets=sets + list(extra_sets))


FOLD_CASES = {
    "deny-overrides": (DO, [("r0", "PERMIT", ""), ("r1", "DENY", ""),
                            ("r2", "DENY", "")]),
    "deny-overrides-last": (DO, [("r0", "PERMIT", ""),
                                 ("r1", "PERMIT", "")]),
    "permit-overrides": (PO, [("r0", "DENY", ""), ("r1", "PERMIT", "")]),
    "first-applicable": (FA, [("r0", "DENY", ""), ("r1", "PERMIT", "")]),
    "alias": ("permitOverrides", [("r0", "DENY", "")]),
    "conditional": (DO, [("r0", "PERMIT", "context.subject.id == 'u1'")]),
    "unknown-algorithm": ("urn:custom:nope", [("r0", "PERMIT", "")]),
}


@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_cases_match_jax(case):
    algorithm, rules = FOLD_CASES[case]
    want = jlat.fold_reverse_query(_rq(jmodel, algorithm, rules))
    got = tlat.fold_reverse_query(_rq(tmodel, algorithm, rules))
    assert verdict_key(got) == verdict_key(want)


def test_fold_structure_cases_match_jax():
    """Last set with effects wins; a rule-less policy stands in with its
    own effect; has_rules with nothing matched is inert; a shed tree
    carries its status code."""
    out = []
    for m, lat in ((jmodel, jlat), (tmodel, tlat)):
        last = _rq(m, PO, [("r0", "DENY", "")], extra_sets=_rq(
            m, PO, [("r1", "PERMIT", "")]).policy_sets)
        ruleless = m.ReverseQuery(policy_sets=[m.PolicySetRQ(
            id="s0", combining_algorithm=DO,
            policies=[m.PolicyRQ(id="p0", effect="PERMIT",
                                 has_rules=False)])])
        inert = m.ReverseQuery(policy_sets=[m.PolicySetRQ(
            id="s0", combining_algorithm=DO,
            policies=[m.PolicyRQ(id="p0", effect="PERMIT",
                                 has_rules=True)])])
        shed = m.ReverseQuery(operation_status=m.OperationStatus(
            code=429, message="overload"))
        out.append([verdict_key(lat.fold_reverse_query(rq))
                    for rq in (last, ruleless, inert, shed)])
    assert out[1] == out[0]
    assert out[1][0][:2] == ("PERMIT", "r1")


def test_lattice_specs_match_jax():
    from access_control_srv_tpu.models import Urns as JUrns

    blocks = [
        {},
        {"subjects": 5, "resources": 3, "actions": ["read", "delete"]},
        {"subjects": [{"id": "alice", "role": "admin"}, "bob"],
         "resources": [{"id": "doc1", "entity": "urn:x:doc.Doc"},
                       "urn:x:file.File"],
         "actions": ["modify"],
         "subject_id_urn": "urn:custom:apiKey"},
    ]
    for block in blocks:
        jspec = jlat.LatticeSpec.from_config(block, urns=JUrns())
        tspec = tlat.LatticeSpec.from_config(block, urns=tmodels.Urns())
        assert jspec.shape == tspec.shape
        assert jspec.masked_axes() == tspec.masked_axes()
        for (i, jr), (k, tr) in zip(cells(jspec), cells(tspec)):
            assert i == k and tspec.unravel(i) == jspec.unravel(i)
            assert request_spec(jr) == request_spec(tr)
    j = jlat.LatticeSpec.stress(12, 70, actions=("read", "create"))
    t = tlat.LatticeSpec.stress(12, 70, actions=("read", "create"))
    assert (j.subjects, j.resources, j.actions) == \
        (t.subjects, t.resources, t.actions)
    assert [len(c) for c in t.chunks(300)] == [300, 300, 300, 300, 300, 180]


def _verdict_stream(n):
    """A seeded stream of verdicts covering every code, sheds and
    conditional cells."""
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        kind = int(rng.integers(6))
        if kind == 0:
            out.append(("INDETERMINATE", None, False, None))
        elif kind == 1:
            out.append(("INDETERMINATE", None, False, 503))
        else:
            out.append((["PERMIT", "DENY"][kind % 2], f"r{i % 7}",
                        kind == 4, None))
    return out


def _write(lat, path, spec, stream):
    writer = lat.SnapshotWriter(path, spec, source="production",
                                policy_epoch=3, meta={"job": 1})
    for index, (d, rule, cond, shed) in enumerate(stream):
        writer.write(index, lat.CellVerdict(d, rule, cond, shed))
    return writer.close()


def test_snapshot_and_bitmap_byte_equal_to_jax(tmp_path):
    spec_args = dict(actions=ALL_ACTIONS)
    jspec = jlat.LatticeSpec.stress(5, 7, **spec_args)
    tspec = tlat.LatticeSpec.stress(5, 7, **spec_args)
    stream = _verdict_stream(tspec.n_cells)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    jpath, tpath = str(tmp_path / "j" / "s.jsonl"), str(tmp_path / "t" / "s.jsonl")
    assert _write(tlat, tpath, tspec, stream) == _write(jlat, jpath, jspec,
                                                        stream)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    assert open(tpath + ".bits.npy", "rb").read() == \
        open(jpath + ".bits.npy", "rb").read()
    assert tlat.load_snapshot(tpath) == jlat.load_snapshot(jpath)
    codes = tlat.load_bitmap(tpath + ".bits.npy", tspec.n_cells)
    assert codes.tobytes() == jlat.load_bitmap(
        jpath + ".bits.npy", jspec.n_cells).tobytes()
    plain = tmp_path / "plain.jsonl"
    plain.write_text('{"c": [0, 0, 0], "d": "PERMIT"}\n')
    with pytest.raises(ValueError):
        tlat.load_snapshot(str(plain))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 17, 1000])
def test_pack_unpack_match_jax(n):
    codes = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    packed = tlat.pack_codes(codes)
    assert packed.tobytes() == jlat.pack_codes(codes).tobytes()
    assert tlat.unpack_codes(packed, n).tobytes() == codes.tobytes()
    assert jlat.unpack_codes(packed, n).tobytes() == codes.tobytes()


def test_diffs_match_jax(tmp_path):
    spec = tlat.LatticeSpec.stress(4, 9, actions=("read", "modify"))
    a = _verdict_stream(spec.n_cells)
    b = list(a)
    for i in range(0, len(b), 5):
        d, rule, cond, shed = b[i]
        b[i] = ("DENY" if d == "PERMIT" else "PERMIT", "flip", cond, None)
    pa, pb = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    _write(tlat, pa, spec, a)
    _write(tlat, pb, spec, b)
    for limit in (3, 4096):
        got = tlat.diff_snapshots(pa, pb, limit=limit)
        assert got == jlat.diff_snapshots(pa, pb, limit=limit)
        assert got["cells_changed"] > 0 and "flip" in got["rules"]
    _, ca, _ = tlat.load_snapshot(pa)
    _, cb, _ = tlat.load_snapshot(pb)
    assert tlat.diff_cells(ca, cb, limit=2) == jlat.diff_cells(ca, cb,
                                                               limit=2)
    other = str(tmp_path / "c.jsonl")
    _write(tlat, other, tlat.LatticeSpec.stress(2, 2), _verdict_stream(4))
    with pytest.raises(ValueError):
        tlat.diff_snapshots(pa, other)


def test_direct_sweep_bitmap_matches_jax(tmp_path):
    """A 600-rule stress tree (reverse-query kernel path in both
    packages) swept over an 8 x 8 x 2 lattice in 48-cell chunks: the
    port's bitmap and snapshot equal the JAX manager's."""
    jeng, teng = stress_engines(600)
    jev = JaxEvaluator(jeng, delta_enabled=False)
    tev = HybridEvaluator(teng, device="cpu")
    jspec = jlat.LatticeSpec.stress(8, 8, actions=("read", "modify"))
    tspec = tlat.LatticeSpec.stress(8, 8, actions=("read", "modify"))
    jm = JaxManager(jev, out_dir=str(tmp_path / "j"), chunk_size=48)
    tm = AuditSweepManager(tev, out_dir=str(tmp_path / "t"), chunk_size=48)
    try:
        jjob = jm.start_sweep(spec=jspec, wait=True, wait_timeout=300)
        tjob = tm.start_sweep(spec=tspec, wait=True, wait_timeout=300)
    finally:
        jm.stop()
        tm.stop()
    assert jjob.state == tjob.state == "done", (jjob.status(), tjob.status())
    assert tev._rq_kernel is not None and tev._rq_kernel._plane_cache
    assert open(tjob.bitmap_path, "rb").read() == \
        open(jjob.bitmap_path, "rb").read()
    _, jcells, jsum = jlat.load_snapshot(jjob.snapshot_path)
    _, tcells, tsum = tlat.load_snapshot(tjob.snapshot_path)
    assert tcells == jcells and tsum == jsum
    assert tsum["permit"] + tsum["deny"] > 0
    st = tjob.status()
    assert st["cells_done"] == tspec.n_cells and st["chunks_done"] == 3


class GatedEvaluator:
    """Wraps an evaluator: every ``what_is_allowed_batch`` call sets
    ``entered`` and then waits for one permit of ``gate``."""

    def __init__(self, inner, deadline):
        self.inner = inner
        self.engine = inner.engine
        self.entered = threading.Event()
        self.gate = threading.Semaphore(0)
        self.deadline = deadline
        self.calls = 0

    def what_is_allowed_batch(self, requests):
        self.calls += 1
        self.entered.set()
        if not self.gate.acquire(timeout=self.deadline.left()):
            raise TimeoutError("the test never released this chunk")
        return self.inner.what_is_allowed_batch(requests)


class Deadline:
    def __init__(self, seconds):
        self.end = time.monotonic() + seconds

    def left(self) -> float:
        return max(0.0, self.end - time.monotonic())


def test_pause_freezes_and_cancel_finishes_early(tmp_path):
    """Pause set while a chunk is in flight: that chunk completes and no
    further chunk is dispatched until resume; cancel during the next
    chunk ends the job after it, with a well-formed partial snapshot.
    Every wait is on an event or a semaphore, under one 60 s limit."""
    deadline = Deadline(60)
    _, teng = stress_engines(48)
    gated = GatedEvaluator(HybridEvaluator(teng, device="cpu"), deadline)
    manager = AuditSweepManager(gated, out_dir=str(tmp_path), chunk_size=4)
    try:
        job = manager.start_sweep(
            spec=tlat.LatticeSpec.stress(8, 8, actions=("read",)))
        assert gated.entered.wait(deadline.left()), "sweep never started"
        manager.pause(job.job_id)
        assert job.status()["paused"]
        gated.entered.clear()
        gated.gate.release()  # chunk 1 completes while paused
        # a paused sweep dispatches nothing more (a timed wait on an event
        # that only a dispatch could set)
        assert not gated.entered.wait(0.3), (
            "a paused sweep kept dispatching chunks")
        assert gated.calls == 1
        manager.resume(job.job_id)
        assert gated.entered.wait(deadline.left()), "resume never moved"
        assert gated.calls == 2
        manager.cancel(job.job_id)
        gated.gate.release()  # chunk 2 completes, then the cancel stops it
        assert job.wait(deadline.left())
        assert job.state == "cancelled"
        assert job.cells_done == 8 < job.spec.n_cells
        header, _, footer = tlat.load_snapshot(job.snapshot_path)
        assert footer is not None and footer["cells"] == 8
        assert header["shape"] == [8, 8, 1]
    finally:
        for _ in range(4):
            gated.gate.release()
        manager.stop(timeout=deadline.left())


def test_refusals(tmp_path):
    _, teng = stress_engines(48)
    tev = HybridEvaluator(teng, device="cpu")
    # the worker mode's arguments are taken as they are (the worker mode
    # itself: tests/test_torch_audit_worker.py)
    for kw in ({"batcher": object()}, {"worker": object()},
               {"telemetry": object()}):
        kept = AuditSweepManager(tev, out_dir=str(tmp_path), **kw)
        (key, value), = kw.items()
        assert getattr(kept, key) is value
    manager = AuditSweepManager(tev, out_dir=str(tmp_path))
    spec = tlat.LatticeSpec.stress(2, 2)
    with pytest.raises(NotImplementedError, match="shadow"):
        manager.start_sweep(spec=spec, target="shadow")
    with pytest.raises(NotImplementedError, match="shadow"):
        manager.sweep_twin(spec=spec)
    with pytest.raises(ValueError):
        manager.start_sweep(spec=spec, target="elsewhere")
    with pytest.raises(KeyError):
        manager.status(99)
    manager.stop()


def test_from_config_status_and_diff(tmp_path):
    """The manager from a config block (any object with ``.get``): off
    by default, the default lattice from the block, two sweeps of one
    tree diff empty."""
    _, teng = stress_engines(48)
    tev = HybridEvaluator(teng, device="cpu")
    assert taudit.from_config({}, evaluator=tev) is None
    assert taudit.from_config({"audit:enabled": True}) is None
    cfg = {"audit:enabled": True, "audit:out_dir": str(tmp_path),
           "audit:chunk_size": 7,
           "audit:lattice": {"subjects": 3, "resources": 4,
                             "actions": ["read", "modify"]}}
    manager = taudit.from_config(cfg, evaluator=tev)
    try:
        assert manager.chunk_size == 7
        a = manager.start_sweep(wait=True, wait_timeout=120)
        b = manager.start_sweep(wait=True, wait_timeout=120)
        assert a.status()["cells_total"] == 24 and a.state == "done"
        st = manager.status()
        assert st["running"] == 0 and len(st["jobs"]) == 2
        diff = manager.diff(a.job_id, b.job_id)
        assert diff["cells_changed"] == 0 and diff["shape"] == [3, 4, 2]
        assert a.status()["chunks_done"] == 4
    finally:
        manager.stop()
    batcher = object()
    assert taudit.from_config(cfg, evaluator=tev,
                              batcher=batcher).batcher is batcher


def test_sweep_rides_the_reverse_kernel(tmp_path, monkeypatch):
    """Direct mode answers each chunk through the evaluator's batched
    reverse query: with the kernel path forced on a small tree, the plane
    cache fills and the bitmap equals the scalar sweep's."""
    _, teng = stress_engines(48)
    spec = tlat.LatticeSpec.stress(6, 6, actions=("read", "create"))
    scalar = AuditSweepManager(HybridEvaluator(teng, device="cpu"),
                               out_dir=str(tmp_path / "s"), chunk_size=16)
    want = scalar.start_sweep(spec=spec, wait=True, wait_timeout=120)
    monkeypatch.setattr(treverse, "REVERSE_MIN_RULES", 0)
    tev = HybridEvaluator(teng, device="cpu")
    kern = AuditSweepManager(tev, out_dir=str(tmp_path / "k"), chunk_size=16)
    got = kern.start_sweep(spec=spec, wait=True, wait_timeout=120)
    scalar.stop()
    kern.stop()
    assert tev._rq_kernel is not None and tev._rq_kernel._plane_cache
    assert open(got.bitmap_path, "rb").read() == \
        open(want.bitmap_path, "rb").read()
