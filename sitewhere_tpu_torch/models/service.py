"""Analytics service, scoring half: anomaly scores over the engine's live
telemetry windows (port of ``sitewhere_tpu/models/service.py``; training,
the checkpoint and the background loop are not ported yet).

Data flow: the pipeline step keeps [M, W, C] windows on the device
(pipeline.py stage 5) -> window features (the CUDA kernel of
ops/window_features.py) + normalization -> AnomalyModel scores, all on the
device; only scores and threshold crossings reach the host. Crossings are
injected back into the pipeline as DeviceAlert events.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from sitewhere_tpu_torch.core.types import AlertLevel
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, AnomalyModel
from sitewhere_tpu_torch.models.windows import snapshot_windows
from sitewhere_tpu_torch.ops.window_features import normalize_windows, window_features


@torch.inference_mode()
def _score_windows(model: AnomalyModel, data: torch.Tensor,
                   filled: torch.Tensor, min_fill: int):
    """windows [M, W, C] -> (scores [M], valid [M], features [M, C, 6]);
    devices without enough samples score 0 / invalid."""
    feats = window_features(data)
    normed = normalize_windows(data, feats)
    scores = model(normed)
    valid = filled >= min_fill
    return torch.where(valid, scores, 0.0), valid, feats


class AnalyticsService:
    """Owns the anomaly model and scores the engine's windows."""

    def __init__(self, engine, cfg: AnomalyConfig | None = None,
                 threshold: float = 3.0, min_fill: int | None = None,
                 seed: int = 0):
        if engine.config.analytics_devices <= 0:
            raise ValueError("engine has no analytics windows "
                             "(set EngineConfig.analytics_devices > 0)")
        self.engine = engine
        w = engine.config.analytics_window
        c = engine.config.channels
        self.cfg = cfg or AnomalyConfig(sensors=c, window=w,
                                        hidden=256, lstm_hidden=256, latent=32)
        if self.cfg.sensors != c or self.cfg.window != w:
            raise ValueError("AnomalyConfig sensors/window must match the "
                             "engine's channels/analytics_window")
        self.model = AnomalyModel(self.cfg, device=engine.device,
                                  generator=torch.Generator().manual_seed(seed))
        self.model.eval()
        self.threshold = threshold
        self.min_fill = min_fill if min_fill is not None else w
        self._lock = threading.Lock()
        # running score statistics for the adaptive threshold (z-score)
        self._score_mean = 0.0
        self._score_m2 = 1.0
        self._score_n = 1e-3

    def _windows(self):
        wins = self.engine.state.windows
        if wins is None:
            raise RuntimeError("engine windows disappeared")
        return wins

    def score_all(self, update_stats: bool = True) -> dict:
        """Score every analytics device; returns scores + anomalous tokens.
        ``update_stats=False`` makes the call read-only."""
        with self._lock:
            return self._score_all(update_stats)

    def _score_all(self, update_stats: bool) -> dict:
        wins = self._windows()
        data = snapshot_windows(wins)
        scores, valid, _ = _score_windows(self.model, data, wins.filled,
                                          self.min_fill)
        scores_np = scores.cpu().numpy()
        valid_np = valid.cpu().numpy()
        vs = scores_np[valid_np]
        if update_stats and vs.size:
            self._score_n += vs.size
            delta = vs.mean() - self._score_mean
            self._score_mean += delta * vs.size / self._score_n
            self._score_m2 += vs.var() * vs.size
        std = max(np.sqrt(self._score_m2 / self._score_n), 1e-6)
        z = (scores_np - self._score_mean) / std
        anomalous = valid_np & (z > self.threshold)
        tokens = []
        for did in np.nonzero(anomalous)[0]:
            info = self.engine.devices.get(int(did))
            if info is not None:
                tokens.append(info.token)
        return {
            "scores": scores_np,
            "valid": valid_np,
            "zscores": z,
            "anomalous_tokens": tokens,
        }

    def emit_anomaly_alerts(self, result: dict | None = None) -> int:
        """Inject DeviceAlert events for anomalous devices back into the
        pipeline."""
        result = result if result is not None else self.score_all()
        for token in result["anomalous_tokens"]:
            self.engine.process(DecodedRequest(
                type=RequestType.DEVICE_ALERT,
                device_token=token,
                alert_type="analytics.anomaly",
                alert_level=AlertLevel.WARNING,
                alert_message="anomaly score exceeded threshold",
            ))
        if result["anomalous_tokens"]:
            self.engine.flush()
        return len(result["anomalous_tokens"])
