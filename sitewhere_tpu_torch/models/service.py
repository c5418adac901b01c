"""Analytics service: anomaly scoring and training over the engine's live
telemetry windows, the model checkpoint and the background loop (port of
``sitewhere_tpu/models/service.py``).

Data flow: the pipeline step keeps [M, W, C] windows on the device
(pipeline.py stage 5) -> window features (the CUDA kernel of
ops/window_features.py) + normalization -> AnomalyModel scores, all on the
device; only scores and threshold crossings reach the host. Crossings are
injected back into the pipeline as DeviceAlert events. Training reads the
same windows through the same kernel (one launch a ``train_on_live``
call) and steps a torch AdamW held to ``optax.adamw``.

The checkpoint is ``model/state.pt`` (``torch.save`` of the model's and
the optimizer's ``state_dict``) beside the JAX package's
``analytics.json``. The JAX checkpoint's ``model/`` directory is orbax,
which the port cannot read; a JAX-trained service comes across through
``convert.anomaly_params_from_flax`` and ``convert.adamw_state_from_optax``.
"""

from __future__ import annotations

import asyncio
import copy
import json
import logging
import pathlib
import threading

import numpy as np
import torch
from torch.profiler import record_function

from sitewhere_tpu_torch.core.types import AlertLevel
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.models.anomaly import (AnomalyConfig, AnomalyModel, adamw,
                                                make_train_step)
from sitewhere_tpu_torch.models.windows import snapshot_windows
from sitewhere_tpu_torch.ops.window_features import normalize_windows, window_features

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"


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
    """Owns the anomaly model, its optimizer, and training and scoring
    over the engine's windows."""

    def __init__(self, engine, cfg: AnomalyConfig | None = None,
                 threshold: float = 3.0, min_fill: int | None = None,
                 learning_rate: float = 1e-3, seed: int = 0):
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
        self.opt = adamw(self.model.parameters(), learning_rate)
        self._train = make_train_step(self.model, self.opt)
        self.threshold = threshold
        self.min_fill = min_fill if min_fill is not None else w
        # train and score run on worker threads (the background loop);
        # parameter, optimizer and statistics updates serialize here
        self._lock = threading.Lock()
        self._save_lock = threading.Lock()   # serializes checkpoint writes
        # running score statistics for the adaptive threshold (z-score)
        self._score_mean = 0.0
        self._score_m2 = 1.0
        self._score_n = 1e-3

    def _windows(self):
        wins = self.engine.state.windows
        if wins is None:
            raise RuntimeError("engine windows disappeared")
        return wins

    # ------------------------------------------------------------ training
    def train_on_live(self, batch_size: int = 256, steps: int = 1) -> float:
        """Self-supervised training on the current (sufficiently filled)
        windows — 'normal' is whatever the fleet is doing. Returns the
        last step's loss, or nan when no window is filled enough."""
        with self._lock:
            return self._train_on_live(batch_size, steps)

    def _train_on_live(self, batch_size: int, steps: int) -> float:
        # read outside the engine lock: the step is functional, so this
        # windows object is one version of the state and never written
        # again (a CUDA graph with static state buffers must copy here)
        wins = self._windows()
        data = snapshot_windows(wins)
        filled = wins.filled.cpu().numpy()       # the draw needs it on the host
        eligible = np.nonzero(filled >= self.min_fill)[0]
        if eligible.size == 0:
            return float("nan")
        rng = np.random.default_rng(int(filled.sum()) % (2**31))
        # features are not differentiated; one launch a call, every window
        with torch.no_grad(), record_function("analytics.features"):
            feats = window_features(data)
            normed = normalize_windows(data, feats)
        loss = None
        self.model.train()
        try:
            for _ in range(steps):
                pick = rng.choice(eligible, size=min(batch_size, eligible.size),
                                  replace=False)
                x = normed[torch.from_numpy(pick).to(normed.device)]
                loss = self._train(x)
        finally:
            self.model.eval()
        return float("nan") if loss is None else float(loss)

    # ------------------------------------------------------------- scoring
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
        from sitewhere_tpu_torch.engine import local_device_info

        tokens = []
        for did in np.nonzero(anomalous)[0]:
            # analytics windows hold this engine's local device ids
            info = local_device_info(self.engine, int(did))
            if info is not None:
                tokens.append(info.token)
        return {
            "scores": scores_np,
            "valid": valid_np,
            "zscores": z,
            "anomalous_tokens": tokens,
        }

    # --------------------------------------------------------- persistence
    def save_model(self, directory) -> dict:
        """Checkpoint parameters, optimizer state and score statistics:
        ``model/state.pt`` and ``analytics.json`` (the JAX package's four
        keys). One step's view is captured under the service lock; the
        disk write happens outside it."""
        directory = pathlib.Path(directory).absolute()
        with self._lock:
            state = copy.deepcopy({"model": self.model.state_dict(),
                                   "optimizer": self.opt.state_dict()})
            meta = {"score_mean": float(self._score_mean),
                    "score_m2": float(self._score_m2),
                    "score_n": float(self._score_n),
                    "threshold": float(self.threshold)}
        with self._save_lock:       # concurrent saves must not interleave
            model_dir = directory / "model"
            model_dir.mkdir(parents=True, exist_ok=True)
            tmp = model_dir / (CHECKPOINT_FILE + ".tmp")
            torch.save(state, tmp)
            tmp.replace(model_dir / CHECKPOINT_FILE)
            (directory / "analytics.json").write_text(json.dumps(meta))
        return meta

    def restore_model(self, directory) -> None:
        """Load a checkpoint written by :meth:`save_model`, onto this
        service's device whatever device wrote it."""
        directory = pathlib.Path(directory).absolute()
        path = directory / "model" / CHECKPOINT_FILE
        if not path.exists():
            if (directory / "model").is_dir():
                raise ValueError(
                    f"{directory / 'model'} holds no {CHECKPOINT_FILE}: an orbax "
                    "checkpoint of the JAX package cannot be read by the port; "
                    "carry it across with sitewhere_tpu_torch.convert "
                    "(anomaly_params_from_flax, adamw_state_from_optax)")
            raise FileNotFoundError(path)
        state = torch.load(path, map_location=self.engine.device,
                           weights_only=True)
        meta = json.loads((directory / "analytics.json").read_text())
        opt_state = state["optimizer"]
        for st in opt_state["state"].values():
            st["step"] = st["step"].cpu()   # a non-fused AdamW's step lives on the host
        with self._lock:
            self.model.load_state_dict(state["model"])
            self.opt.load_state_dict(opt_state)
            self._score_mean = meta["score_mean"]
            self._score_m2 = meta["score_m2"]
            self._score_n = meta["score_n"]
            self.threshold = meta["threshold"]

    # ----------------------------------------------------- background loop
    async def run(self, interval_s: float = 5.0, train_steps: int = 1,
                  stop_event=None) -> None:
        """Background analytics loop: train on live windows, score, inject
        anomaly alerts — the always-on analytics process. An iteration
        that raises is logged and the loop goes on."""
        while stop_event is None or not stop_event.is_set():
            try:
                # torch compute off the event loop (the locks serialize)
                await asyncio.to_thread(self.train_on_live, steps=train_steps)
                await asyncio.to_thread(self.emit_anomaly_alerts)
            except Exception:
                logger.exception("analytics loop error")
            await asyncio.sleep(interval_s)

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

