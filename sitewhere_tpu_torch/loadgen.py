"""Load generator: the closed-loop load of the engine's wire-ingest path
(port of ``generate_measurements_message``, ``LoadStats`` and
``run_engine_load`` of ``sitewhere_tpu/loadgen.py``; its open-loop
generator is not ported).

It generates the canonical DeviceRequest measurement JSON and drives the
engine's native host path — payload bytes -> native decode -> staging
arena -> fused step -> device state — reporting throughput and per-batch
latency percentiles.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np


def generate_measurements_message(token: str, seq: int,
                                  name: str = "engine.temperature",
                                  value: float | None = None) -> bytes:
    """Canonical JSON measurement DeviceRequest."""
    payload = {
        "deviceToken": token,
        "type": "DeviceMeasurement",
        "request": {
            "name": name,
            "value": value if value is not None else round(20.0 + (seq % 80) * 0.5, 2),
            "eventDate": None,
            "updateState": True,
            "metadata": {"seq": str(seq)},
        },
    }
    return json.dumps(payload).encode()


@dataclasses.dataclass
class LoadStats:
    events_sent: int
    events_decoded: int
    events_failed: int
    wall_s: float
    events_per_s: float
    latency_p50_ms: float
    latency_p99_ms: float
    latency_max_ms: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _percentiles(lat_ms: list[float]) -> tuple[float, float, float]:
    arr = np.asarray(lat_ms)
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 99)),
            float(arr.max()))


def batch_maker(n_devices: int, batch_size: int, seed: int = 0):
    """``make(b)``: batch ``b`` of :func:`run_engine_load`'s stream, its
    devices drawn from one seeded generator. Called in the order the load
    calls it (the warm-up batches ``0..W-1``, then ``0..N-1``), it gives
    the load's payloads."""
    rng = np.random.default_rng(seed)
    toks = [f"lg-{i}" for i in range(n_devices)]

    def make_batch(b: int) -> list[bytes]:
        picks = rng.integers(0, n_devices, batch_size)
        return [generate_measurements_message(toks[d], b * batch_size + i)
                for i, d in enumerate(picks)]

    return make_batch


def run_engine_load(engine, n_batches: int = 50, batch_size: int = 4096,
                    n_devices: int = 10_000, seed: int = 0,
                    warmup_batches: int = 3,
                    pipelined: bool = False) -> LoadStats:
    """Drive the full host path: JSON bytes -> native decode -> staged ->
    fused step -> device state.

    pipelined=False — per-batch latency = submit -> flush return (state
    merged and visible on the host).
    pipelined=True — steady-state throughput: batches dispatch without a
    readback (the engine bounds outstanding dispatches by its
    ``dispatch_depth``); a batch's latency runs from its submit to the
    return of the call that dispatched its last row, and the timed window
    ends at a readback-free ``barrier()``.
    """
    make_batch = batch_maker(n_devices, batch_size, seed)
    for w in range(warmup_batches):          # interners and allocator warm
        engine.ingest_json_batch(make_batch(w))
        if not pipelined:
            engine.flush()
    if pipelined:
        engine.barrier()
    else:
        engine.flush()

    # payloads are built first, so the generator stays out of the timing
    prebuilt = [make_batch(b) for b in range(n_batches)]
    latencies: list[float] = []
    decoded = failed = 0
    submits: list[float] = []
    t0 = time.perf_counter()
    for payloads in prebuilt:
        s0 = time.perf_counter()
        res = engine.ingest_json_batch(payloads)
        if pipelined:
            submits.append(s0)
            if engine.staged_count:
                engine.flush_async()
            if engine.staged_count == 0:
                done = time.perf_counter()
                latencies.extend((done - s) * 1e3 for s in submits)
                submits.clear()
        else:
            engine.flush()                    # state merged on return
            latencies.append((time.perf_counter() - s0) * 1e3)
        decoded += res["decoded"]
        failed += res["failed"]
    if pipelined:
        engine.barrier()                      # the tail, no readback
        done = time.perf_counter()
        latencies.extend((done - s) * 1e3 for s in submits)
    wall = time.perf_counter() - t0
    p50, p99, mx = _percentiles(latencies)
    sent = n_batches * batch_size
    return LoadStats(sent, decoded, failed, wall, sent / wall, p50, p99, mx)
