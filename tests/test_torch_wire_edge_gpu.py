"""The wire edge's flusher thread on the card (``ingest/wire_edge.py``): a
card test, kept apart from the JAX parity tests of
``tests/test_torch_wire_edge.py`` (this file imports no JAX). It skips
without a CUDA device; on the GPU machine run ``python -m pytest
tests/test_torch_wire_edge_gpu.py -m gpu``."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest import wire_edge as twe

W_CFG = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
             store_capacity=2048, batch_capacity=32, channels=4)


class FixedEpoch(EpochBase):
    def __init__(self, now_ms: int = 500_000):
        super().__init__(0.0)
        self._now = now_ms

    def now_ms(self) -> int:
        return self._now


class GatedClock:
    """A clock that stands still: only the size threshold flushes."""

    def __call__(self) -> float:
        return 0.0


def _payload(i, dev=6):
    return json.dumps({"deviceToken": f"wd-{i % dev}", "type": "DeviceMeasurement",
                       "request": {"name": "temp", "value": 20.0 + i,
                                   "eventDate": 1_000 + 10 * i}}).encode()


def _leaves(state, prefix="state"):
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out += _leaves(v, f"{prefix}.{f.name}")
        elif isinstance(v, torch.Tensor):
            out.append((f"{prefix}.{f.name}", v))
    return out


@pytest.mark.gpu
def test_flusher_thread_drives_the_card_on_its_creators_stream():
    """The flusher thread runs the engine's batch call under the stream
    and device that were current where the batcher was built (here a side
    stream), and the card engine ends equal to a CPU engine fed the same
    windows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda", 0)
    card = Engine(EngineConfig(**W_CFG), device=dev)
    host = Engine(EngineConfig(**W_CFG), device="cpu")
    for e in (card, host):
        e.epoch = FixedEpoch()
    seen = []
    call = card.ingest_json_batch

    def spy(payloads, tenant="default", **kw):
        seen.append((threading.current_thread().name, torch.cuda.current_device(),
                     torch.cuda.current_stream(dev)))
        return call(payloads, tenant=tenant, **kw)

    card.ingest_json_batch = spy
    side = torch.cuda.Stream(dev)
    with torch.cuda.stream(side):
        b = twe.WireBatcher(card, flush_rows=16, flush_interval_s=30.0, auto=True,
                            clock=GatedClock())
    payloads = [_payload(i) for i in range(64)]
    for lo in range(0, 64, 16):
        done = threading.Event()
        for k, p in enumerate(payloads[lo:lo + 16]):
            b.add(p, on_durable=done.set if k == 15 else None)
        assert done.wait(60)
        host.ingest_json_batch(payloads[lo:lo + 16])
    b.close()
    assert b.counters()["frames_stalled"] == 0
    assert [s[0] for s in seen] == ["swtpu-wire-flush"] * 4
    assert all(d == 0 and s == side for _, d, s in seen)
    with torch.cuda.stream(side):
        card.flush()
    torch.cuda.synchronize()
    host.flush()
    # arena_pool_waits counts the host's waits for a free arena: timing
    untimed = lambda e: {k: v for k, v in e.metrics().items() if k != "arena_pool_waits"}
    assert untimed(card) == untimed(host)
    for (name, a), (_, h) in zip(_leaves(card.state), _leaves(host.state)):
        assert np.array_equal(a.cpu().numpy(), h.numpy()), name

