"""The port's minimal Engine against the JAX Engine on one request stream.

The same ``DecodedRequest`` stream (measurements, locations with and
without coordinates, alerts, state changes, command responses, alternate
ids, admin registrations, a tenant mismatch that dead-letters) goes
through ``sitewhere_tpu.engine.Engine(use_native=False)`` and
``sitewhere_tpu_torch.engine.Engine(device="cpu")`` with the clock pinned
on both sides, at the sizes of the JAX package's analytics test. The
``flush()`` summaries, ``get_device_state`` dicts and ``metrics()`` must be
equal; ``score_all()`` scores agree within float32 tolerance
(``rtol=1e-5, atol=1e-6``) when both models carry the same weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu.ingest.requests import DecodedRequest as JaxRequest
from sitewhere_tpu.ingest.requests import RequestType as JaxRequestType
from sitewhere_tpu.models.anomaly import AnomalyConfig as JaxAnomalyConfig
from sitewhere_tpu.models.service import AnalyticsService as JaxService
from sitewhere_tpu_torch import convert
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.models.anomaly import AnomalyConfig
from sitewhere_tpu_torch.models.service import AnalyticsService
from tests.torch_parity import assert_tree_equal

W = 8
BASE_S = 1_700_000_000.0
SIZES = dict(device_capacity=32, token_capacity=64, assignment_capacity=64,
             store_capacity=4096, batch_capacity=32, channels=4,
             analytics_devices=16, analytics_window=W)
MODEL = dict(sensors=4, window=W, hidden=64, lstm_hidden=64, latent=8)


def _pin(epoch_cls, now_ms):
    class Pinned(epoch_cls):
        def now_ms(self):
            return now_ms

    return Pinned(BASE_S)


def _requests():
    """(kind, kwargs) rows; each side builds its own DecodedRequest."""
    rows = []
    rng = np.random.default_rng(0)
    for t in range(W + 2):
        for d in range(8):
            val = float(np.sin(t / 3) + 0.01 * d) if d != 7 else 1e3 * (t + 1)
            rows.append(("DEVICE_MEASUREMENT", dict(
                device_token=f"an-{d}",
                measurements={"x": val, "y": float(rng.standard_normal())},
                event_ts_ms=int(BASE_S * 1000) + 1000 * t + d)))
    rows += [
        ("REGISTER_DEVICE", dict(device_token="admin-1", tenant="t2",
                                 extras={"deviceTypeToken": "gateway",
                                         "areaToken": "north"})),
        ("DEVICE_LOCATION", dict(device_token="an-1", latitude=51.5,
                                 longitude=-0.12, elevation=11.0)),
        ("DEVICE_LOCATION", dict(device_token="an-1")),       # no coordinates
        ("DEVICE_ALERT", dict(device_token="an-2", alert_type="overheat",
                              alert_level=3)),
        ("DEVICE_ALERT", dict(device_token="admin-1", tenant="t2")),
        ("DEVICE_STATE_CHANGE", dict(device_token="an-3", attribute="mode",
                                     state_type="eco")),
        ("ACKNOWLEDGE", dict(device_token="an-3", originating_event_id="e-9")),
        ("DEVICE_MEASUREMENT", dict(device_token="an-4", alternate_id="dup",
                                    measurements={"z": 1.0})),
        ("DEVICE_MEASUREMENT", dict(device_token="an-4", alternate_id="dup",
                                    measurements={"z": 2.0})),
        # tenant mismatch: an-5 lives in "default" -> dead letter
        ("DEVICE_MEASUREMENT", dict(device_token="an-5", tenant="t2",
                                    measurements={"x": 5.0})),
        ("DEVICE_MEASUREMENT", dict(device_token="late-1",
                                    measurements={"x": 0.5})),
    ]
    return rows


def _engines():
    jeng = JaxEngine(JaxEngineConfig(**SIZES, use_native=False))
    teng = Engine(EngineConfig(**SIZES, use_native=False), device="cpu")
    jeng.epoch = _pin(JaxEpoch, 5000)
    teng.epoch = _pin(EpochBase, 5000)
    return jeng, teng


def _drive(jeng, teng):
    summaries = []
    for i, (kind, kw) in enumerate(_requests()):
        jeng.process(JaxRequest(type=JaxRequestType[kind], **kw))
        teng.process(DecodedRequest(type=RequestType[kind], **kw))
        if i in (20, 47, 83):          # flush at uneven points, as a timer would
            summaries.append((jeng.flush(), teng.flush()))
    summaries.append((jeng.flush(), teng.flush()))
    return summaries


@pytest.fixture(scope="module")
def driven():
    jeng, teng = _engines()
    return jeng, teng, _drive(jeng, teng)


def test_flush_summaries_match(driven):
    _, _, summaries = driven
    for ref, got in summaries:
        assert got == ref
    assert sum(s["registered"] for s, _ in summaries) > 0
    assert sum(s["missed"] for s, _ in summaries) > 0


def test_device_state_and_metrics_match(driven):
    jeng, teng, _ = driven
    tokens = [f"an-{d}" for d in range(8)] + ["admin-1", "late-1", "nobody"]
    for tok in tokens:
        assert teng.get_device_state(tok) == jeng.get_device_state(tok), tok
    assert teng.metrics() == jeng.metrics()
    assert teng.dead_letters == jeng.dead_letters
    assert dataclasses.asdict(teng.get_device("admin-1")) == \
        dataclasses.asdict(jeng.get_device("admin-1"))
    assert {k: dataclasses.asdict(v) for k, v in teng.assignments.items()} == \
        {k: dataclasses.asdict(v) for k, v in jeng.assignments.items()}


def test_engine_state_matches_jax_byte_for_byte(driven):
    jeng, teng, _ = driven
    ref = jax.device_get(jeng.state)
    assert_tree_equal(ref, teng.state)


def test_score_all_matches_jax(driven):
    jeng, teng, _ = driven
    jsvc = JaxService(jeng, JaxAnomalyConfig(**MODEL, dtype=jnp.float32),
                      threshold=2.5, min_fill=W)
    tsvc = AnalyticsService(teng, AnomalyConfig(**MODEL, dtype=torch.float32),
                            threshold=2.5, min_fill=W)
    tsvc.model.load_state_dict(
        convert.anomaly_params_from_flax(jax.device_get(jsvc.params)))
    ref, got = jsvc.score_all(), tsvc.score_all()
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"][:8].all() and not got["valid"][10:].any()
    np.testing.assert_allclose(got["scores"], ref["scores"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["zscores"], ref["zscores"], rtol=1e-4, atol=1e-4)
    # no z-score sits at the threshold, so the crossing sets must agree
    assert np.min(np.abs(ref["zscores"] - 2.5)) > 1e-3
    assert got["anomalous_tokens"] == ref["anomalous_tokens"]


def test_emit_anomaly_alerts_lands_in_device_state():
    teng = Engine(EngineConfig(**SIZES, use_native=False), device="cpu")
    for t in range(W):
        for d in range(8):
            val = float(np.sin(t / 3) + 0.01 * d) if d != 7 else 1e3 * (t + 1)
            teng.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                                        device_token=f"an-{d}",
                                        measurements={"x": val}))
    teng.flush()
    svc = AnalyticsService(teng, AnomalyConfig(**MODEL, dtype=torch.float32),
                           threshold=-1e9, min_fill=W)   # everything crosses
    result = svc.score_all()
    assert len(result["anomalous_tokens"]) == 8
    assert svc.emit_anomaly_alerts(result) == 8
    st = teng.get_device_state("an-0")
    assert st["recent_alerts"][0]["type"] == "analytics.anomaly"
    assert st["recent_alerts"][0]["level"] == 1


def test_entry_points_need_an_explicit_cpu_device():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(EngineConfig(**SIZES))
