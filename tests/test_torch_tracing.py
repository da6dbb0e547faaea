"""The port's telemetry and stage tracing against the JAX package's.

For the same traffic (made from a numpy seed) a JAX worker and a port
worker (``device="cpu"``) count the same rows under the same ``paths``
keys (kernel, oracle, native-wire, cache-hit, ...), the same decisions,
and record the same stage names in their span trees and stage
histograms; a trace id sent as metadata echoes on the same trailers.
The telemetry primitives (histograms, percentile estimates, secret
masking, the Prometheus exposition's metric families) agree on the same
samples, and the ``profile`` command writes a ``torch.profiler`` trace.
"""

import json
import logging
import os

import numpy as np
import pytest

from access_control_srv_tpu.srv import telemetry as jtel
from access_control_srv_tpu.srv.gen import access_control_pb2 as pb
from access_control_srv_tpu.srv.tracing import TRACE_ID_METADATA_KEY
from access_control_srv_tpu_torch.srv import telemetry as ttel
from access_control_srv_tpu_torch.srv.worker import Worker

from .torch_serving import (
    AC,
    Rig,
    batch_bytes,
    seed_cfg,
    seed_request,
    traffic,
)


def obs_cfg(sample_rate=1.0, **overrides):
    cfg = seed_cfg(**overrides)
    cfg["observability"] = {
        "enabled": True,
        "tracing": {"enabled": True, "sample_rate": sample_rate},
        "audit_log": {"path": None, "sample_rate": 1.0},
        "metrics_http": {"enabled": False, "port": 0},
    }
    return cfg


def drive(rig, seed):
    """Unary calls (the cacheable super-administrator request three
    times, so the decision cache answers the repeats), two native
    batches, a stream and a reverse batch, on both sides."""
    messages = traffic(24, seed=seed)
    admin = seed_request().SerializeToString()
    for msg in messages + [admin] * 3:
        want, got = rig.both(AC + "IsAllowed", msg)
        assert got == want
    for n in (40, 64):
        want, got = rig.both(AC + "IsAllowedBatch",
                             batch_bytes(traffic(n, seed=seed + n)))
        assert got == want
    want, got = rig.stream_both(
        AC + "IsAllowedStream", [batch_bytes(traffic(16, seed=seed + 1))])
    assert got == want
    want, got = rig.both(AC + "WhatIsAllowedBatch", batch_bytes(messages))
    assert got == want


@pytest.mark.parametrize("mode", ["cache", "no-cache", "oracle-backend",
                                  "explain"])
def test_paths_and_decisions_counts(mode):
    """The same traffic counts the same rows per path: native-wire rows
    on the wire path, kernel rows on the pb path (explain on), oracle
    rows (the oracle backend), cache hits, reverse rows."""
    evaluator = {"delta_enabled": False}
    if mode == "oracle-backend":
        evaluator["backend"] = "oracle"
    cfg = seed_cfg(evaluator=evaluator,
                   decision_cache={"enabled": mode != "no-cache"},
                   explain={"enabled": mode == "explain"})
    rig = Rig(cfg)
    try:
        drive(rig, seed=70)
        jt, tt = rig.jax.worker.telemetry, rig.port.worker.telemetry
        assert tt.paths.snapshot() == jt.paths.snapshot()
        assert tt.decisions.snapshot() == jt.decisions.snapshot()
        assert tt.cache.snapshot() == jt.cache.snapshot()
        paths = tt.paths.snapshot()
        assert paths["oracle-wia"] > 0
        assert ("cache-hit" in paths) is (mode != "no-cache")
        assert ("native-wire" in paths) is (mode in ("cache", "no-cache"))
        assert ("kernel" in paths) is (mode == "explain")
        assert ("oracle" in paths) is (mode == "oracle-backend")
        assert not [k for k in paths if k.endswith("-error")
                    or k.startswith("hang-fallback")]
    finally:
        rig.close()


def test_stage_names_and_trace_echo():
    rig = Rig(obs_cfg(sample_rate=0.0, decision_cache={"enabled": False}))
    try:
        msg = traffic(1, seed=71)[0]
        md = ((TRACE_ID_METADATA_KEY, "trace-unary"),)
        want = rig.jax.call(AC + "IsAllowed", msg, metadata=md,
                            with_trailers=True)
        got = rig.port.call(AC + "IsAllowed", msg, metadata=md,
                            with_trailers=True)
        assert got == want
        assert got[1][TRACE_ID_METADATA_KEY] == "trace-unary"
        md = ((TRACE_ID_METADATA_KEY, "trace-batch"),)
        payload = batch_bytes(traffic(32, seed=72))
        want = rig.jax.call(AC + "IsAllowedBatch", payload, metadata=md,
                            with_trailers=True)
        got = rig.port.call(AC + "IsAllowedBatch", payload, metadata=md,
                            with_trailers=True)
        assert got == want

        def stage_names(worker, trace_id):
            traces = worker.command_interface.command("traces", {})["traces"]
            ours = [t for t in traces if t["trace_id"] == trace_id]
            assert ours, trace_id
            return [s["stage"] for s in ours[-1]["stages"]]

        for trace_id in ("trace-unary", "trace-batch"):
            names = stage_names(rig.port.worker, trace_id)
            assert names == stage_names(rig.jax.worker, trace_id)
        assert {"transport.parse", "wire.encode", "device", "decode",
                "serialize"} <= set(stage_names(rig.port.worker,
                                                "trace-batch"))
        assert set(rig.port.worker.telemetry.snapshot()["stages"]) == \
            set(rig.jax.worker.telemetry.snapshot()["stages"])
    finally:
        rig.close()


def test_batch_stages_fan_out_on_the_pb_path():
    """Service-level batches (the pb path) record the encode / device /
    decode stages, as in the JAX package."""
    rig = Rig(obs_cfg(decision_cache={"enabled": False}))
    try:
        from .test_torch_srv import requests_of

        messages = traffic(16, seed=73)
        for side in ("jax", "port"):
            worker = getattr(rig, side).worker
            worker.service.is_allowed_batch(requests_of(side, messages))
        stages = rig.port.worker.telemetry.snapshot()["stages"]
        want = rig.jax.worker.telemetry.snapshot()["stages"]
        assert set(stages) == set(want)
        for stage in ("encode", "device", "decode"):
            assert stages[stage]["count"] == want[stage]["count"] >= 1
    finally:
        rig.close()


def test_observability_changes_no_answer():
    """Tracing at 1.0 sampling watches the pipeline and changes no
    response byte (the port against itself and against JAX)."""
    messages = traffic(16, seed=74)
    payload = batch_bytes(messages)
    outs = []
    for cfg in (seed_cfg(), obs_cfg()):
        worker = Worker().start(cfg, device="cpu")
        try:
            from .test_torch_srv import requests_of, response_bytes

            svc = worker.service
            outs.append(
                response_bytes("port", [svc.is_allowed(r) for r in
                                        requests_of("port", messages)])
                + response_bytes("port", svc.is_allowed_batch(
                    requests_of("port", messages))))
        finally:
            worker.stop()
    assert outs[0] == outs[1]
    rig = Rig(obs_cfg())
    try:
        want, got = rig.both(AC + "IsAllowedBatch", payload)
        assert got == want
    finally:
        rig.close()


def test_metric_families_and_snapshot_shape():
    rig = Rig(seed_cfg())
    try:
        drive(rig, seed=75)
        fams = []
        for side in (rig.jax, rig.port):
            body = side.worker.command_interface.command(
                "metrics", {"format": "prometheus"})["body"]
            fams.append(sorted(line for line in body.splitlines()
                               if line.startswith("# TYPE")))
        assert fams[1] == fams[0]
        keys = [sorted(side.worker.telemetry.snapshot())
                for side in (rig.jax, rig.port)]
        assert keys[1] == keys[0]
    finally:
        rig.close()


def test_histograms_and_masking_agree():
    rng = np.random.default_rng(76)
    samples = rng.lognormal(-6.0, 1.5, size=500)
    hists = [jtel.Histogram(), ttel.Histogram()]
    for h in hists:
        for s in samples:
            h.observe(float(s))
    assert hists[1].snapshot() == hists[0].snapshot()
    values = rng.integers(0, 4096, size=200)
    vh = [jtel.ValueHistogram(), ttel.ValueHistogram()]
    for h in vh:
        for v in values:
            h.observe(int(v))
    assert vh[1].snapshot() == vh[0].snapshot()
    doc = {"user": {"password": "x", "token": "t", "nested": [
        {"apiKey": "k", "ok": 1}]}, "authorization": "a", "id": 3}
    assert ttel.mask_secrets(doc) == jtel.mask_secrets(doc)


def test_sampled_logger_caps_a_flood():
    records = []

    class Sink(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger("acs-port-sampled-test")
    logger.addHandler(Sink())
    logger.propagate = False
    slog = ttel.SampledLogger(logger, max_per_interval=3, interval_s=60.0)
    for i in range(1000):
        slog.warning("k", "row %d", i)
    assert len(records) == 3 and slog.suppressed("k") == 997


def test_profile_command_writes_a_torch_trace(tmp_path):
    worker = Worker().start(seed_cfg(), device="cpu")
    try:
        ci = worker.command_interface
        out = ci.command("profile", {"action": "start",
                                     "dir": str(tmp_path)})
        assert out == {"status": "tracing", "dir": str(tmp_path)}
        assert "error" in ci.command("profile", {"action": "start"})
        from .test_torch_srv import requests_of

        worker.service.is_allowed_batch(
            requests_of("port", traffic(16, seed=77)))
        out = ci.command("profile", {"action": "stop"})
        assert out["status"] == "stopped"
        with open(out["trace"]) as fh:
            trace = json.load(fh)
        assert trace["traceEvents"]
        assert os.path.dirname(out["trace"]) == str(tmp_path)
        assert "error" in ci.command("profile", {"action": "stop"})
    finally:
        worker.stop()


def test_profile_evaluator_writes_a_torch_trace(tmp_path):
    """``telemetry.profile_evaluator`` (``jax.profiler`` in the JAX
    package) captures with ``torch.profiler`` and leaves a Chrome trace
    in the directory."""
    import torch

    with ttel.profile_evaluator(str(tmp_path)) as prof:
        torch.ones(64).cumsum(0)
    assert prof is not None
    traces = list(tmp_path.glob("trace-*.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        assert json.load(fh)["traceEvents"]
