"""The multi-shard engine with every shard on the card, against every shard
on the CPU (card-only: it skips without a GPU). It imports the port alone,
so it collects on a machine with a card and no JAX stack; the parity with
the JAX package is held on the CPU (``tests/test_torch_spmd*.py``)."""

import json

import pytest
import torch

from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.engine import EngineConfig
from sitewhere_tpu_torch.parallel.sharded import SpmdEngine, _leaves

CFG = dict(device_capacity=64, token_capacity=128, assignment_capacity=128,
           store_capacity=2048, batch_capacity=32, channels=4,
           rule_groups=64, rollup_buckets=8)


class _Pinned(EpochBase):
    def __init__(self):
        super().__init__(0.0)

    def now_ms(self) -> int:
        return 500_000


def _engine(n_shards, scan_chunk, depth, device):
    eng = SpmdEngine(EngineConfig(**CFG, scan_chunk=scan_chunk, ingest_arenas=depth),
                     n_shards=n_shards, device=device)
    eng.epoch = _Pinned()
    return eng


def _wire(i0, n):
    return [json.dumps({"deviceToken": f"sp-{i % 8}", "type": "DeviceMeasurement",
                        "request": {"name": "temp", "value": 20.0 + (i % 40) * 0.5,
                                    "eventDate": 1_000 + 10 * i}}).encode()
            for i in range(i0, i0 + n)]


@pytest.mark.gpu
@pytest.mark.parametrize("n_shards,scan_chunk,depth", [(2, 1, 1), (4, 2, 2)])
def test_card_engine_equals_the_cpu_engine(n_shards, scan_chunk, depth):
    if not torch.cuda.is_available():
        pytest.skip("the card engine runs only on a GPU")
    card = _engine(n_shards, scan_chunk, depth, "cuda:0")
    cpu = _engine(n_shards, scan_chunk, depth, "cpu")
    for lo in range(0, 128, 32):
        for eng in (card, cpu):
            eng.ingest_json_batch(_wire(lo, 32))
            eng.flush()
    for a, b in zip(_leaves(card.state), _leaves(cpu.state)):
        assert torch.equal(a.cpu(), b)
    assert card.query_events(limit=200) == cpu.query_events(limit=200)
    assert card.metrics()["persisted"] == cpu.metrics()["persisted"] == 128
    assert card.host_counters == cpu.host_counters
