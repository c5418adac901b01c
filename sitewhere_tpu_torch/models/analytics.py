"""Historical analytics: archive -> device batched scoring jobs (port of
``sitewhere_tpu/models/analytics.py``; training and the background loop
are not ported).

A job scores each device's newest window of archived history:

  plan   one ``SegmentPlanner`` pass a streaming round prunes segments by
         zone maps and blooms (etype / tenant / time pushdown) and prices
         each survivor with the planner's decode-cost table;
  load   rounds pack segments up to a cost budget; only the columns the
         job reads decode (lazily, through the archive's segment cache);
  trim   a vectorized reservoir keeps each device's newest W matching rows
         on the host (no per-device Python loop);
  fill   each batch of M devices rebuilds its [M, W, C] windows on the
         engine's device (ops/window_fill.fill_windows);
  score  ``models/service._score_windows``: on a CUDA engine the
         window_features kernel, the normalization and the AnomalyModel.
         Batches are double-buffered: batch k is staged in page-locked
         host memory, copied and scored asynchronously, and its scores
         come back by an asynchronous copy into page-locked memory; the
         host waits on batch k-1's event only, while it prepares k+1;
  emit   threshold crossings re-enter the pipeline as DeviceAlert
         envelopes through ``ingest_json_batch``, deduplicated by
         ``swa:<job>:<device>:<windowEnd>`` alternate ids: the event-id
         interner is the durable key registry, ``resync_emitted()`` replays
         it, so a re-run after recovery, or a promoted standby, emits only
         the scores the previous owner never shipped.

Conservation: every window entering a scoring batch lands in one sink —
``windows_planned == windows_scored + windows_skipped_underfilled +
windows_cancelled`` — committed in one manager-lock block a batch (the
``analytics-windows`` equation of utils/conservation.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)

SCORE_KEY_PREFIX = "swa:"

_MEASUREMENT = 0        # core.types.EventType.MEASUREMENT
_JOB_COLUMNS = ("valid", "etype", "device", "tenant", "ts_ms",
                "values", "vmask")


@dataclasses.dataclass(frozen=True)
class AnalyticsJobSpec:
    """One scoring job over the archived history of a tenant (or the whole
    fleet). ``name`` defaults to a content hash of the spec, so a re-run
    after a crash derives the same dedup keys and suppresses against the
    replayed alerts."""

    tenant: str | None = "default"
    since_ms: int | None = None       # event-time range (engine epoch-
    until_ms: int | None = None       # relative ms, the archive's ts)
    batch_devices: int = 256          # M — devices a scoring batch
    window: int | None = None         # W; default analytics_window
    min_fill: int | None = None       # rows required to score; default W
    threshold: float = 3.0            # absolute score threshold
    emit: bool = True                 # emit threshold crossings
    round_cost_bytes: int = 8 << 20   # planner-cost budget a round
    max_rounds: int | None = None     # stream at most this many rounds
    max_batches: int | None = None    # score at most this many batches
    duty: float | None = None         # background duty cycle in (0, 1):
                                      # the job sleeps after each round and
                                      # batch so its busy share stays <=
                                      # duty (not hashed into the name:
                                      # pacing does not change the scores)
    name: str = ""

    def resolved_name(self) -> str:
        if self.name:
            return self.name
        h = hashlib.sha256(json.dumps(
            [self.tenant, self.since_ms, self.until_ms,
             self.batch_devices, self.window, self.min_fill,
             self.threshold, self.round_cost_bytes],
            sort_keys=True).encode()).hexdigest()[:12]
        return f"hist-{h}"


class AnalyticsManager:
    """Job lifecycle and score-alert emission for one engine's archive:
    dedup-keyed emission through ``ingest_json_batch``, incremental
    interner resync, leader-only emission (an ``active=False`` standby
    scores but ships nothing; ``promote`` resyncs first), and single-lock
    counter commits for the conservation ledger. ``service`` is an
    optional live AnalyticsService whose model the jobs use when its
    window shape matches."""

    def __init__(self, engine, service=None, active: bool = True):
        self.engine = engine
        self.service = service
        self.active = active
        self._mu = threading.Lock()        # counters + job table
        self._run_lock = threading.Lock()  # one executing job at a time
        self._emitted: set[str] = set()
        self._scan_pos = 0
        self._seq = 0
        self._default_bundle = None
        self.jobs: dict[str, dict] = {}
        # conservation counters (analytics-windows equation)
        self.windows_planned = 0
        self.windows_scored = 0
        self.windows_skipped_underfilled = 0
        self.windows_cancelled = 0
        self.jobs_started = 0
        self.jobs_completed = 0
        self.jobs_cancelled = 0
        self.jobs_failed = 0
        self.rounds_streamed = 0
        self.segments_streamed = 0
        self.bytes_streamed = 0           # planner decode-cost bytes
        self.rows_streamed = 0
        self.alerts_emitted = 0
        self.alerts_suppressed = 0
        # the conservation ledger finds the manager here
        engine.analytics_jobs = self

    # ---------------------------------------------------------- emission
    def resync_emitted(self) -> int:
        """Register every score-alert dedup key the engine has interned
        (append-only: survives snapshot restore and WAL replay),
        incrementally."""
        ids = self.engine.event_ids
        n = len(ids)
        added = 0
        with self._mu:
            for i in range(self._scan_pos, n):
                tok = ids.token(i)
                if tok.startswith(SCORE_KEY_PREFIX) and tok not in self._emitted:
                    self._emitted.add(tok)
                    added += 1
            self._scan_pos = n
        return added

    def promote(self) -> int:
        """Standby -> owner: enable emission; the next run emits exactly
        the score alerts the old owner never shipped."""
        self.active = True
        return self.resync_emitted()

    # --------------------------------------------------------- lifecycle
    def start_job(self, spec: "AnalyticsJobSpec | dict") -> dict:
        """Launch a job on a worker thread; returns its status row at once
        (poll :meth:`status`)."""
        job = self._register(spec)
        t = threading.Thread(target=self._execute, args=(job,),
                             name=f"swtpu-analytics-{job['id']}", daemon=True)
        job["_thread"] = t
        t.start()
        return self._public(job)

    def run_job(self, spec: "AnalyticsJobSpec | dict") -> dict:
        """Run a job to its end on this thread; returns its final status
        row."""
        job = self._register(spec)
        self._execute(job)
        return self._public(job)

    def _register(self, spec) -> dict:
        if isinstance(spec, dict):
            spec = AnalyticsJobSpec(**spec)
        with self._mu:
            self._seq += 1
            job = {
                "id": f"aj-{self._seq}", "spec": spec,
                "name": spec.resolved_name(), "state": "pending",
                "error": None, "cancel": threading.Event(),
                "rounds": 0, "segments": 0, "bytes": 0, "rows": 0,
                "planned": 0, "scored": 0, "skipped_underfilled": 0,
                "cancelled": 0, "emitted": 0, "suppressed": 0,
                "devices": 0, "batches": 0, "stream_s": 0.0, "score_s": 0.0,
                "devices_per_s": 0.0, "bytes_per_s": 0.0,
            }
            self.jobs[job["id"]] = job
            self.jobs_started += 1
        return job

    def cancel(self, job_id: str) -> bool:
        with self._mu:
            job = self.jobs.get(job_id)
        if job is None or job["state"] in ("done", "failed", "cancelled"):
            return False
        job["cancel"].set()
        return True

    def status(self, job_id: str | None = None) -> dict:
        with self._mu:
            if job_id is not None:
                job = self.jobs.get(job_id)
                if job is None:
                    raise KeyError(f"analytics job {job_id!r} not found")
                return self._public(job)
            return {"active": self.active,
                    "jobs": [self._public(j) for j in self.jobs.values()],
                    **self.ledger_stage(locked=True)}

    def _public(self, job: dict) -> dict:
        out = {k: v for k, v in job.items()
               if not k.startswith("_") and k != "cancel"}
        out["spec"] = dataclasses.asdict(job["spec"])
        return out

    def ledger_stage(self, locked: bool = False) -> dict:
        """The counter snapshot of the conservation ledger. ``locked=True``
        when the caller holds ``_mu``."""
        if not locked:
            with self._mu:
                return self.ledger_stage(locked=True)
        return {
            "planned": self.windows_planned,
            "scored": self.windows_scored,
            "skipped_underfilled": self.windows_skipped_underfilled,
            "cancelled": self.windows_cancelled,
            "jobs_started": self.jobs_started,
            "jobs_completed": self.jobs_completed,
            "jobs_cancelled": self.jobs_cancelled,
            "jobs_failed": self.jobs_failed,
            "rounds": self.rounds_streamed,
            "segments": self.segments_streamed,
            "bytes": self.bytes_streamed,
            "rows": self.rows_streamed,
            "alerts_emitted": self.alerts_emitted,
            "alerts_suppressed": self.alerts_suppressed,
        }

    # --------------------------------------------------------- execution
    def _execute(self, job: dict) -> None:
        with self._run_lock:
            job["state"] = "running"
            try:
                self._run(job)
            except Exception as e:          # noqa: BLE001 — job boundary
                job["state"] = "failed"
                job["error"] = f"{type(e).__name__}: {e}"
                with self._mu:
                    self.jobs_failed += 1
                logger.exception("analytics job %s failed", job["id"])
                return
            if job["state"] == "running":
                job["state"] = "done"
                with self._mu:
                    self.jobs_completed += 1

    def _model_bundle(self, w: int, c: int):
        """(model, scorer): the attached service's model when its window
        shape is (w, c), else a default model of the same width as the
        service's default (``AnomalyConfig(sensors=c, window=w,
        hidden=256, lstm_hidden=256, latent=32)``) made on the engine's
        device from a ``torch.Generator`` seeded 0, so every re-run (and a
        host oracle) sees the same model. Its weights are not those of
        the JAX package's ``jax.random.key(0)`` default and need not be:
        parity with the JAX package goes through a service that carries
        converted JAX parameters."""
        from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, AnomalyModel
        from sitewhere_tpu_torch.models.service import _score_windows

        svc = self.service
        if svc is not None and svc.cfg.window == w and svc.cfg.sensors == c:
            with svc._lock:
                return svc.model, _score_windows
        cached = self._default_bundle
        if cached is not None and cached[0] == (w, c):
            return cached[1], _score_windows
        cfg = AnomalyConfig(sensors=c, window=w, hidden=256, lstm_hidden=256,
                            latent=32)
        model = AnomalyModel(cfg, device=self.engine.device,
                             generator=torch.Generator().manual_seed(0))
        model.eval()
        self._default_bundle = ((w, c), model)
        return model, _score_windows

    @staticmethod
    def _pace(job, busy_s: float) -> None:
        """Duty-cycle throttle (``spec.duty``): after ``busy_s`` of work
        the job waits so that its busy share stays at the duty. The wait
        rides the cancel event, so pacing never delays a cancel."""
        duty = job["spec"].duty
        if not duty or duty >= 1.0 or busy_s <= 0:
            return
        job["cancel"].wait(busy_s * (1.0 - duty) / duty)

    def _run(self, job: dict) -> None:
        from sitewhere_tpu_torch.ops.query import host_filter_mask

        eng = self.engine
        spec: AnalyticsJobSpec = job["spec"]
        arch = getattr(eng, "archive", None)
        if arch is None:
            raise RuntimeError("engine has no archive "
                               "(set EngineConfig.archive_dir)")
        w = int(spec.window or eng.config.analytics_window)
        c = int(eng.config.channels)
        m = int(spec.batch_devices)
        min_fill = int(spec.min_fill if spec.min_fill is not None else w)
        tid = None
        if spec.tenant is not None:
            tid = eng.tenants.lookup(spec.tenant)
            if tid < 0:
                job["devices"] = 0
                return                  # unknown tenant: empty job
        tracer = eng.tracer

        def span(name, **tags):
            return tracer.begin(name, job=job["name"], **tags)

        self.resync_emitted()
        # stream planner-batched rounds, newest first, keeping each
        # device's newest <= w matching rows (int64 positions keep the
        # (ts, archive position) tie order exact)
        r_dev = np.empty(0, np.int64)
        r_ts = np.empty(0, np.int64)
        r_pos = np.empty(0, np.int64)
        r_vals = np.empty((0, c), np.float32)
        r_mask = np.empty((0, c), bool)
        seen: set[str] = set()
        t0 = time.monotonic()
        while True:
            t_round = time.monotonic()
            if job["cancel"].is_set():
                job["state"] = "cancelled"
                with self._mu:
                    self.jobs_cancelled += 1
                return
            with span("analytics.plan", round=job["rounds"]):
                plan_rows, _ = arch.planner.plan(
                    etype=_MEASUREMENT, tenant=tid,
                    since_ms=spec.since_ms, until_ms=spec.until_ms)
                fresh = [(i, seg) for i, seg, _f, _hi, _cap in plan_rows
                         if seg.path not in seen]
            if not fresh:
                break
            # pack one round by planner decode cost (always >= 1 segment)
            round_segs: list = []
            cost = 0
            for i, seg in fresh:
                seg_cost = arch.planner.cost_of(i)
                if round_segs and cost + seg_cost > spec.round_cost_bytes:
                    break
                round_segs.append(seg)
                cost += seg_cost
            with span("analytics.load", round=job["rounds"],
                      segments=len(round_segs)):
                parts = []
                for seg in round_segs:
                    seen.add(seg.path)
                    cols = arch._cols_or_drop(seg, _JOB_COLUMNS)
                    if cols is None:
                        continue        # quarantined mid-job
                    msk = cols["valid"].astype(bool) & host_filter_mask(
                        cols, etype=_MEASUREMENT, tenant=tid,
                        since_ms=spec.since_ms, until_ms=spec.until_ms)
                    idx = np.nonzero(msk)[0]
                    if not idx.size:
                        continue
                    parts.append((
                        cols["device"][idx].astype(np.int64),
                        cols["ts_ms"][idx].astype(np.int64),
                        seg.start + idx.astype(np.int64),
                        cols["values"][idx].astype(np.float32),
                        cols["vmask"][idx].astype(bool)))
            rows = 0
            if parts:
                r_dev = np.concatenate([r_dev] + [p[0] for p in parts])
                r_ts = np.concatenate([r_ts] + [p[1] for p in parts])
                r_pos = np.concatenate([r_pos] + [p[2] for p in parts])
                r_vals = np.concatenate([r_vals] + [p[3] for p in parts])
                r_mask = np.concatenate([r_mask] + [p[4] for p in parts])
                rows = int(sum(p[0].size for p in parts))
                # trim to the newest w a device (vectorized)
                order = np.lexsort((r_pos, r_ts, r_dev))
                r_dev, r_ts, r_pos = r_dev[order], r_ts[order], r_pos[order]
                r_vals, r_mask = r_vals[order], r_mask[order]
                _, starts, counts = np.unique(r_dev, return_index=True,
                                              return_counts=True)
                rank = np.arange(r_dev.size) - np.repeat(starts, counts)
                keep = rank >= np.repeat(counts, counts) - w
                r_dev, r_ts, r_pos = r_dev[keep], r_ts[keep], r_pos[keep]
                r_vals, r_mask = r_vals[keep], r_mask[keep]
            job["rounds"] += 1
            job["segments"] += len(round_segs)
            job["bytes"] += cost
            job["rows"] += rows
            with self._mu:
                self.rounds_streamed += 1
                self.segments_streamed += len(round_segs)
                self.bytes_streamed += cost
                self.rows_streamed += rows
            if spec.max_rounds is not None and job["rounds"] >= spec.max_rounds:
                break
            self._pace(job, time.monotonic() - t_round)
        job["stream_s"] = time.monotonic() - t0
        devs, starts, counts = np.unique(r_dev, return_index=True,
                                         return_counts=True)
        job["devices"] = int(devs.size)
        if not devs.size:
            return
        # each device's window end (the reservoir is (dev, ts, pos)-sorted:
        # a run's last row has its newest ts), the dedup key's identity
        dev_end_ts = r_ts[starts + counts - 1]
        dev_idx = np.searchsorted(devs, r_dev)   # row -> dense device index
        t1 = time.monotonic()
        self._score_pass(job, devs, dev_end_ts, dev_idx,
                         (r_ts, r_vals, r_mask), m=m, w=w, c=c,
                         min_fill=min_fill, span=span)
        job["score_s"] = time.monotonic() - t1
        if job["stream_s"] > 0:
            job["bytes_per_s"] = job["bytes"] / job["stream_s"]
        if job["score_s"] > 0:
            job["devices_per_s"] = job["planned"] / job["score_s"]

    def _score_pass(self, job, devs, dev_end_ts, dev_idx, rows, *, m, w, c,
                    min_fill, span) -> None:
        """Pipelined batch scoring: prepare batch k in host staging, submit
        its copy, fill and scoring, then harvest batch k-1 (waiting on
        k-1's event only) while k runs. Fixed shapes a batch ([m*w]
        rows, [m] windows). On a CUDA engine the staging and the score
        buffers are page-locked and both copies asynchronous; two staging
        sets alternate, and set k%2 is refilled only after batch k-2 was
        harvested, whose event covers its copy."""
        from sitewhere_tpu_torch.ops.window_fill import fill_windows

        eng = self.engine
        spec: AnalyticsJobSpec = job["spec"]
        model, score_fn = self._model_bundle(w, c)
        r_ts, r_vals, r_mask = rows
        dev = eng.device
        cuda = dev.type == "cuda"
        n_fixed = m * w
        n_batches = (devs.size + m - 1) // m
        if spec.max_batches is not None:
            n_batches = min(n_batches, int(spec.max_batches))
        batch_of_row = dev_idx // m

        def staging():
            def buf(shape, dtype):
                return torch.empty(shape, dtype=dtype, pin_memory=cuda)
            return (buf((n_fixed,), torch.int32), buf((n_fixed,), torch.int32),
                    torch.arange(n_fixed, dtype=torch.int32).pin_memory()
                    if cuda else torch.arange(n_fixed, dtype=torch.int32),
                    buf((n_fixed, c), torch.float32), buf((n_fixed, c), torch.bool))

        stage = [staging(), staging()] if cuda else None

        def prepare(k):
            host = stage[k % 2] if cuda else staging()
            slot, ts, _seq, vals, mask = (t.numpy() for t in host)
            sel = np.nonzero(batch_of_row == k)[0]   # (dev, ts, pos)-ordered
            n = sel.size                              # <= m*w after the trim
            slot[:n] = (dev_idx[sel] - k * m).astype(np.int32)
            slot[n:] = -1
            ts[:n] = r_ts[sel].astype(np.int32)
            ts[n:] = 0
            vals[:n] = r_vals[sel]
            vals[n:] = 0.0
            mask[:n] = r_mask[sel]
            mask[n:] = False
            lo = k * m
            return host, devs[lo:lo + m], dev_end_ts[lo:lo + m]

        def submit(host):
            with span("analytics.transfer"):
                slot, ts, seq, vals, mask = (t.to(dev, non_blocking=True)
                                             for t in host)
                data, filled = fill_windows(slot, ts, seq, vals, mask,
                                            m=m, w=w)
            with span("analytics.score"):
                scores, valid, _ = score_fn(model, data, filled, min_fill)
            out_s = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=cuda)
            out_v = torch.empty(valid.shape, dtype=valid.dtype, pin_memory=cuda)
            out_s.copy_(scores, non_blocking=True)
            out_v.copy_(valid, non_blocking=True)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            return out_s, out_v, done

        def harvest(pend):
            (out_s, out_v, done), batch_devs, ends = pend
            if done is not None:
                done.synchronize()
            scores = out_s.numpy()[:batch_devs.size]
            valid = out_v.numpy()[:batch_devs.size]
            scored = int(valid.sum())
            self._emit_batch(job, batch_devs, ends, scores, valid,
                             spec.threshold, span)
            with self._mu:      # one commit: planned lands with its sinks
                self.windows_planned += batch_devs.size
                self.windows_scored += scored
                self.windows_skipped_underfilled += batch_devs.size - scored
            job["planned"] += batch_devs.size
            job["scored"] += scored
            job["skipped_underfilled"] += batch_devs.size - scored
            job["batches"] += 1

        pending = None
        done = 0
        t_batch = time.monotonic()
        for k in range(n_batches):
            if job["cancel"].is_set():
                break
            host, batch_devs, ends = prepare(k)
            out = submit(host)                   # asynchronous on the card
            if pending is not None:
                harvest(pending)
                done += 1
            pending = (out, batch_devs, ends)
            self._pace(job, time.monotonic() - t_batch)
            t_batch = time.monotonic()
        if pending is not None:
            harvest(pending)
            done += 1
        if done < n_batches or job["cancel"].is_set():
            # cancelled mid-pass: the planned but unscored windows of the
            # batches in scope land in the cancelled sink, planned with them
            in_scope = min(n_batches * m, int(devs.size))
            rest = max(in_scope - done * m, 0)
            with self._mu:
                self.windows_planned += rest
                self.windows_cancelled += rest
                self.jobs_cancelled += 1
            job["planned"] += rest
            job["cancelled"] += rest
            job["state"] = "cancelled"

    def _emit_batch(self, job, batch_devs, ends, scores, valid,
                    threshold, span) -> None:
        """Threshold crossings -> DeviceAlert envelopes through the normal
        ingest path, dedup-keyed a (job, device, window end). A standby
        (``active=False``) emits nothing."""
        eng = self.engine
        spec: AnalyticsJobSpec = job["spec"]
        if not spec.emit or not self.active:
            return
        hits = np.nonzero(valid & (scores > threshold))[0]
        if not hits.size:
            return
        base_ms = int(eng.epoch.base_unix_s * 1000)
        by_tenant: dict[str, list[bytes]] = {}
        emitted = suppressed = 0
        with span("analytics.emit", hits=int(hits.size)):
            for i in hits:
                info = eng.devices.get(int(batch_devs[i]))
                if info is None:
                    continue
                end_ms = int(ends[i])
                dedup = f"{SCORE_KEY_PREFIX}{job['name']}:{info.token}:{end_ms}"
                with self._mu:
                    if dedup in self._emitted:
                        suppressed += 1
                        continue
                    self._emitted.add(dedup)
                envelope = {
                    "deviceToken": info.token, "type": "DeviceAlert",
                    "tenant": info.tenant,
                    "request": {
                        "type": "analytics.history",
                        "level": "Warning",
                        "message": (f"historical anomaly score "
                                    f"{float(scores[i]):.3f} > "
                                    f"{threshold:g} (job {job['name']})"),
                        "eventDate": base_ms + end_ms,
                        "alternateId": dedup,
                    },
                }
                by_tenant.setdefault(info.tenant, []).append(
                    json.dumps(envelope, sort_keys=True).encode())
                emitted += 1
        for tenant, payloads in by_tenant.items():
            eng.ingest_json_batch(payloads, tenant)
        with self._mu:
            self.alerts_emitted += emitted
            self.alerts_suppressed += suppressed
        job["emitted"] += emitted
        job["suppressed"] += suppressed
        if emitted:
            eng.host_counters["analytics_alerts"] = \
                eng.host_counters.get("analytics_alerts", 0) + emitted
