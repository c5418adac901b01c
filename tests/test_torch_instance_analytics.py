"""Twins of the analytics and rules routes of the instance
(``tests/test_models.py:210``, ``tests/test_rules.py:365``) on the JAX
instance and the port's (``device="cpu"``), held equal as in
``tests/torch_servers.py``."""

import json

import jax
import numpy as np
import pytest
import torch

from tests.torch_servers import make_instance, pin_servers, run_twin


@pytest.fixture
def twin(monkeypatch):
    pin_servers(monkeypatch)
    return run_twin


# --------------------------------------------- tests/test_models.py:210
def test_analytics_rest_surface(twin):
    """Scores/train/detect over a live instance. Both services run float32
    from the JAX service's initial weights (``convert``); the background
    analytics loop is left off so the requests alone train. Scores and the
    loss agree to rtol 1e-4 (``score`` in the log: rounded to 3 digits)."""
    from sitewhere_tpu_torch import convert

    jax_state = {}

    def make(P):
        inst = make_instance(P, dict(device_capacity=32, token_capacity=64,
                                     assignment_capacity=64, store_capacity=1024,
                                     analytics_devices=8, analytics_window=16))
        rng = np.random.default_rng(0)
        for _ in range(16):
            for d in range(3):
                inst.engine.process(P.mod("ingest.requests").DecodedRequest(
                    type=P.mod("ingest.requests").RequestType.DEVICE_MEASUREMENT,
                    device_token=f"ar-{d}",
                    measurements={"v": float(rng.standard_normal())}))
            inst.engine.flush()
        service = P.mod("models.service").AnalyticsService
        anomaly = P.mod("models.anomaly")
        c, w = inst.analytics.cfg.sensors, inst.analytics.cfg.window
        if P.port:
            svc = service(inst.engine, anomaly.AnomalyConfig(
                sensors=c, window=w, dtype=torch.float32))
            svc.model.load_state_dict(convert.anomaly_params_from_flax(jax_state["params"]))
            convert.adamw_state_from_optax(jax_state["opt"], svc.model, svc.opt)
        else:
            import jax.numpy as jnp

            svc = service(inst.engine, anomaly.AnomalyConfig(
                sensors=c, window=w, dtype=jnp.float32))
            jax_state.update(params=jax.device_get(svc.params),
                             opt=jax.device_get(svc.opt_state))
        inst.analytics = None           # no background loop: start_server
        inst._svc = svc                 # sees no service
        return inst

    losses, scores = [], []

    def case(S):
        S.inst.analytics = S.inst._svc
        status, body = S.call("POST", "/api/analytics/train",
                              {"batchSize": 4, "steps": 1}, keep=sorted)
        assert status == 200 and body["loss"] is not None
        losses.append(body["loss"])
        status, body = S.call("GET", "/api/analytics/scores", keep=lambda b: {
            "numResults": b["numResults"], "anomalousTokens": b["anomalousTokens"],
            "devices": [r["device"] for r in b["results"]]})
        assert body["numResults"] == 3
        scores.append([(r["score"], r["zscore"]) for r in body["results"]])
        status, body = S.call("POST", "/api/analytics/detect")
        assert status == 200

    twin(case, make=make)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    np.testing.assert_allclose(scores[1], scores[0], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------- tests/test_rules.py
RULES_SIZES = dict(device_capacity=256, token_capacity=512,
                   assignment_capacity=512, store_capacity=4096,
                   batch_capacity=32, channels=4, rule_groups=64,
                   rollup_buckets=8)


def test_rules_rest_surface(twin):
    """REST CRUD + rollup reads + status over a live gateway."""
    from tests.test_rules import RULESET

    def case(S):
        call, eng = S.call, S.inst.engine
        st, body = call("POST", "/api/rules", RULESET, keep=lambda b: {
            k: v for k, v in b["summary"].items() if k != "precompiled"})
        assert st == 201 and body["summary"]["rules"] == 4
        # the JAX manager compiles the new set's step ahead of the swap;
        # eager torch has nothing to compile
        assert body["summary"]["precompiled"] is (not S.P.port)
        st, body = call("POST", "/api/rules", {"rules": [
            {"name": "bad", "kind": "window", "agg": "count",
             "channel": "t", "op": "<", "value": 1, "windowMs": 10}]})
        assert st == 400
        eng.ingest_json_batch([json.dumps({
            "deviceToken": "rest-0", "type": "DeviceMeasurement",
            "request": {"name": "temp", "value": 95.0,
                        "eventDate": int(eng.epoch.base_unix_s * 1000) + 100}}).encode()])
        eng.flush()
        st, body = call("POST", "/api/rules/poll", {"flush": False})
        assert st == 200 and {a["rule"] for a in body["alerts"]} == {"hot"}
        st, body = call("GET", "/api/rules")
        assert st == 200 and body["status"]["alertsEmitted"] == 1
        assert body["ruleSet"]["name"] == "t"
        st, body = call("GET", "/api/rules/rollups")
        assert st == 200 and body[0]["name"] == "temp-1s"
        st, body = call("GET", "/api/rules/rollups/temp-1s",
                        params={"group": "rest-0"})
        assert st == 200 and body["buckets"][0]["count"] == 1
        st, _ = call("GET", "/api/rules/rollups/nope")
        assert st == 404

    twin(case, make=lambda P: make_instance(P, RULES_SIZES))
