"""The port's device watchdog, its failure answers, and its concurrency
on the serving path.

- The hang path: a ``device.materialize`` failpoint (``srv/faults.py``,
  fired at the evaluator's dispatch) wedges the device readback past
  ``materialize_timeout_s``.  The native wire path's error sends the
  batch to the pb path, whose timed-out batch takes ``_hang_fallback``:
  every row gets the never-cacheable ``degraded`` envelope (503), where
  the JAX worker answers it with the oracle walk.  The counts say so
  (``native-wire-error``, ``hang-fallback-degraded``), the breaker
  quarantines the kernel path, a quarantined evaluator refuses its
  kernel-path rows the same way, and the probe restores the kernel path
  once the fault clears.
- A kernel call that raises (a ``device.dispatch`` error) answers
  degraded too, and the micro-batcher retries a batch that raised one
  row at a time through the batch path, never through the oracle.
- Concurrency: four gRPC callers at once (and a stress with a short
  switch interval) get the single-caller bytes, from the dense path and
  the signature path (a tree of 600 stress rules), while the dispatch
  lock keeps the prefilter's shared caches consistent.
"""

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest

from access_control_srv_tpu.srv.faults import REGISTRY as JAX_FAULTS
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu_torch.models.model import (
    Decision,
    OperationStatus,
    Response,
)
from access_control_srv_tpu_torch.ops import prefilter as pfmod
from access_control_srv_tpu_torch.srv.batcher import MicroBatcher
from access_control_srv_tpu_torch.srv.faults import REGISTRY as PORT_FAULTS

from .torch_serving import AC, Rig, batch_bytes, seed_cfg, traffic


def watchdog_cfg(min_volume):
    return {"enabled": True, "materialize_timeout_s": 0.3,
            "probe_interval_s": 0.05,
            "breaker": {"window_s": 30.0, "min_volume": min_volume,
                        "failure_ratio": 0.5, "open_s": 0.05,
                        "half_open_probes": 1}}


def hang(count):
    return [{"site": "device.materialize", "action": "hang",
             "hang_s": 10.0, "count": count}]


def assert_degraded(payload: bytes, rows: int, cause: str) -> None:
    """Every row of an ``IsAllowedBatch`` response is the degraded
    envelope: INDETERMINATE, not cacheable, 503 ``degraded: <cause>``."""
    responses = pb.BatchResponse.FromString(payload).responses
    assert len(responses) == rows
    for resp in responses:
        assert resp.decision == pb.INDETERMINATE
        assert not resp.evaluation_cacheable
        assert resp.operation_status.code == 503
        assert resp.operation_status.message == f"degraded: {cause}"


def test_hang_path_answers_honestly():
    """Two wedged readbacks (the wire path's, then the pb path's) with
    the breaker held closed: every row answers degraded (the JAX worker
    walks the oracle there and answers the clean bytes), and the counts
    name both steps."""
    rig = Rig(seed_cfg(evaluator={"watchdog": watchdog_cfg(1000),
                                  "delta_enabled": False}))
    payload = batch_bytes(traffic(48, seed=91))
    try:
        want_clean = rig.port.call(AC + "IsAllowedBatch", payload)
        JAX_FAULTS.configure(hang(2), seed=5)
        PORT_FAULTS.configure(hang(2), seed=5)
        try:
            got = rig.port.call(AC + "IsAllowedBatch", payload)
            jax_got = rig.jax.call(AC + "IsAllowedBatch", payload)
        finally:
            JAX_FAULTS.clear()
            PORT_FAULTS.clear()
        assert jax_got == want_clean
        assert_degraded(got, 48, "device materialize timed out")
        paths = rig.port.worker.telemetry.paths.snapshot()
        assert paths["native-wire-error"] == 48
        assert paths["hang-fallback-degraded"] == 48
        assert "hang-fallback-oracle" not in paths
        assert "oracle" not in paths
        st = rig.port.worker.watchdog.status()
        assert st["timeouts"] == 2 and not st["quarantined"]
        # the fault cleared: the same call serves the clean bytes again
        assert rig.port.call(AC + "IsAllowedBatch", payload) == want_clean
    finally:
        rig.close()


def test_timeout_quarantines_then_the_probe_restores():
    """One wedged readback opens the breaker: the kernel path is
    quarantined (the batch answers degraded), the probe finds the device
    healthy again and restores it, and the wire path serves."""
    rig = Rig(seed_cfg(evaluator={"watchdog": watchdog_cfg(1),
                                  "delta_enabled": False}))
    payload = batch_bytes(traffic(48, seed=91))
    try:
        want_clean = rig.port.call(AC + "IsAllowedBatch", payload)
        PORT_FAULTS.configure(hang(1), seed=5)
        try:
            assert_degraded(rig.port.call(AC + "IsAllowedBatch", payload),
                            48, "the device path is quarantined")
        finally:
            PORT_FAULTS.clear()
        wd = rig.port.worker.watchdog
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            st = wd.status()
            if st["restores"] >= 1 and not st["quarantined"]:
                break
            time.sleep(0.02)
        st = wd.status()
        assert st["timeouts"] == 1 and st["restores"] >= 1
        assert not st["quarantined"]
        paths = rig.port.worker.telemetry.paths.snapshot()
        assert paths["native-wire-error"] == 48
        assert paths["quarantine-degraded"] == 48
        before = rig.port.worker.telemetry.paths.get("native-wire")
        assert rig.port.call(AC + "IsAllowedBatch", payload) == want_clean
        assert rig.port.worker.telemetry.paths.get("native-wire") == \
            before + 48
    finally:
        rig.close()


def test_quarantine_routes_to_the_oracle():
    """A quarantined evaluator refuses its kernel-path rows: the batch
    answers degraded, the native wire path reports itself inactive, and
    no row reaches the oracle (the JAX evaluator walks the oracle there).
    The restored evaluator serves the clean bytes."""
    rig = Rig(seed_cfg(evaluator={"delta_enabled": False}))
    try:
        payload = batch_bytes(traffic(32, seed=92))
        want = rig.both(AC + "IsAllowedBatch", payload)
        ev = rig.port.worker.evaluator
        rig.port.worker.telemetry.paths.clear()
        ev.set_quarantined(True)
        try:
            got = rig.port.call(AC + "IsAllowedBatch", payload)
            assert not ev.native_active or ev.is_allowed_batch_wire(
                [b""]) is None
        finally:
            ev.set_quarantined(False)
        assert want[0] == want[1]
        assert_degraded(got, 32, "the device path is quarantined")
        paths = rig.port.worker.telemetry.paths.snapshot()
        assert paths.get("quarantine-degraded") == 32
        assert "oracle" not in paths and "native-wire" not in paths
        assert ev.kernel_probe()
        assert rig.port.call(AC + "IsAllowedBatch", payload) == want[1]
    finally:
        rig.close()


def test_device_error_answers_degraded():
    """A kernel dispatch that raises (``device.dispatch`` error on both
    the wire path's and the pb path's launch) answers every row degraded
    and counts them; the JAX worker walks the oracle there."""
    rig = Rig(seed_cfg(evaluator={"delta_enabled": False}))
    payload = batch_bytes(traffic(40, seed=94))
    try:
        want_clean = rig.port.call(AC + "IsAllowedBatch", payload)
        PORT_FAULTS.configure([{"site": "device.dispatch",
                                "action": "error", "count": 2}], seed=5)
        try:
            got = rig.port.call(AC + "IsAllowedBatch", payload)
        finally:
            PORT_FAULTS.clear()
        assert_degraded(got, 40, "device kernel failed")
        paths = rig.port.worker.telemetry.paths.snapshot()
        assert paths["native-wire-error"] == 40
        assert paths["device-error-degraded"] == 40
        assert "oracle" not in paths
        assert rig.port.call(AC + "IsAllowedBatch", payload) == want_clean
    finally:
        rig.close()


class PoisonedBatches:
    """An evaluator whose kernel-sized batches raise: the batcher's
    row-by-row retry must take the batch path again, one row at a time,
    and never the single-request (oracle) path."""

    def __init__(self, poisoned: str):
        self.poisoned = poisoned
        self.singles = []
        self.oracle_calls = 0
        self.errors = []

    def count_error(self, path, rows, err):
        self.errors.append((path, rows))

    def is_allowed_batch_async(self, requests):
        if len(requests) > 1:
            raise RuntimeError("poisoned batch")
        return lambda: self.is_allowed_batch(requests)

    def is_allowed_batch(self, requests):
        if len(requests) > 1:
            raise RuntimeError("poisoned batch")
        self.singles.append(requests[0])
        if requests[0] == self.poisoned:
            raise ValueError("poisoned row")
        return [Response(decision=Decision.PERMIT, obligations=[],
                         evaluation_cacheable=True,
                         operation_status=OperationStatus())]

    def is_allowed(self, request):
        self.oracle_calls += 1
        raise AssertionError("the oracle answered a kernel-sized batch")


@pytest.mark.parametrize("depth", [2, 4])
def test_batcher_retries_a_failed_batch_row_by_row(depth):
    """A kernel-sized batch that raised (``_eval_batch`` at depth 2, the
    dispatch half at depth 4) resolves row by row through the batch
    path: the poisoned row fails alone, the others get the kernel's
    answer, and the failure is counted."""
    ev = PoisonedBatches(poisoned="r3")
    batcher = MicroBatcher(ev, window_ms=50.0, min_kernel_batch=4,
                           pipeline_depth=depth)
    # queued before the collector starts: one window collects all eight
    futures = [batcher.submit(f"r{i}") for i in range(8)]
    batcher.start()
    try:
        results = []
        for f in futures:
            try:
                results.append(f.result(timeout=30).decision)
            except ValueError as err:
                results.append(str(err))
    finally:
        batcher.stop()
    assert results == ([Decision.PERMIT] * 3 + ["poisoned row"]
                       + [Decision.PERMIT] * 4)
    assert ev.oracle_calls == 0
    assert sorted(ev.singles) == [f"r{i}" for i in range(8)]
    assert sum(rows for _, rows in ev.errors) == 8
    assert {path for path, _ in ev.errors} <= {
        "batch-eval-error", "batch-dispatch-error", "batch-finalize-error"}


def _concurrent(rig, payloads, rounds=3):
    barrier = threading.Barrier(len(payloads))

    def caller(k):
        barrier.wait(timeout=60)
        return [rig.port.call(AC + "IsAllowedBatch", payloads[k])
                for _ in range(rounds)]

    with ThreadPoolExecutor(len(payloads)) as pool:
        return list(pool.map(caller, range(len(payloads))))


@pytest.mark.parametrize("tree", ["seed", "stress-600"])
def test_concurrent_rpcs_get_single_caller_bytes(tree):
    rig = Rig(seed_cfg(evaluator={"delta_enabled": False}))
    try:
        if tree == "stress-600":
            import chip_smoke

            docs = chip_smoke.store_docs(chip_smoke.stress_doc(600))
            for side in (rig.jax, rig.port):
                side.worker.store.seed(*docs)
                side.worker.evaluator.refresh(wait=True)
            assert rig.port.worker.evaluator._kernel.active
            traffic_of = [
                [chip_smoke.wire_bytes(r) for r in chip_smoke.stress_traffic(
                    40, seed=93 + k)] for k in range(4)]
        else:
            traffic_of = [traffic(40, seed=93 + k) for k in range(4)]
        payloads = [batch_bytes(m) for m in traffic_of]
        single = []
        for p in payloads:
            want, got = rig.both(AC + "IsAllowedBatch", p)
            assert got == want
            single.append(got)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            raced = _concurrent(rig, payloads)
        finally:
            sys.setswitchinterval(old)
        for k, answers in enumerate(raced):
            assert all(a == single[k] for a in answers), k
        paths = rig.port.worker.telemetry.paths.snapshot()
        assert not [k for k in paths if k.endswith("-error")]
    finally:
        rig.close()


def test_dispatch_lock_serializes_the_prefilter():
    """No two threads are ever inside ``PrefilteredKernel.evaluate_async``
    of one evaluator at once."""
    import chip_smoke

    rig = Rig(seed_cfg(evaluator={"delta_enabled": False}))
    inside = {"now": 0, "most": 0}
    lock = threading.Lock()
    orig = pfmod.PrefilteredKernel.evaluate_async

    def watched(self, batch):
        with lock:
            inside["now"] += 1
            inside["most"] = max(inside["most"], inside["now"])
        try:
            time.sleep(0.002)
            return orig(self, batch)
        finally:
            with lock:
                inside["now"] -= 1

    try:
        rig.port.worker.store.seed(*chip_smoke.store_docs(
            chip_smoke.stress_doc(600)))
        rig.port.worker.evaluator.refresh(wait=True)
        pfmod.PrefilteredKernel.evaluate_async = watched
        payloads = [batch_bytes([chip_smoke.wire_bytes(r) for r in
                                 chip_smoke.stress_traffic(16, seed=k)])
                    for k in range(6)]
        _concurrent(rig, payloads, rounds=2)
    finally:
        pfmod.PrefilteredKernel.evaluate_async = orig
        rig.close()
    assert inside["most"] == 1
