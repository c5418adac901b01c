"""The port's registry admin API against the JAX Engine's.

The same admin calls — ``register_device``, ``update_device`` (type, area,
customer, a parent remapped through metadata and unmapped again),
``map_device``, ``create_assignment`` with assets, ``get_assignment``,
``list_assignments``, ``update_assignment``, ``mark_assignment_missing``,
``release_assignment``, ``delete_assignment``, ``delete_device`` — and a
stream of events between them go through ``sitewhere_tpu.engine.Engine``
and ``sitewhere_tpu_torch.engine.Engine(device="cpu")`` with both clocks
pinned: with ``assignment_triggers`` on (STATE_CHANGE events), with
``auto_register=False`` (unknown tokens dead-letter), with
``tenant_arenas=4`` and a flood tenant, and with ``query_coalesce=4``.
Every state leaf, every host mirror (devices, assignments, slots, the
asset interner) and every answer must be identical: integers and bools
byte for byte (the calls copy their float inputs unchanged).
"""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest

from sitewhere_tpu.core.events import EpochBase as JaxEpoch
from sitewhere_tpu.engine import Engine as JaxEngine
from sitewhere_tpu.engine import EngineConfig as JaxEngineConfig
from sitewhere_tpu_torch.core.events import EpochBase
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from tests.test_torch_ingest_wire import BASE_MS, pinned
from tests.torch_parity import assert_tree_equal, strip_trace

SIZES = dict(device_capacity=32, token_capacity=128, assignment_capacity=64,
             store_capacity=256, batch_capacity=16, channels=4,
             use_native=False)

CASES = {
    "plain": {},
    "triggers": dict(assignment_triggers=True),
    "no_auto_register": dict(auto_register=False),
    "arenas": dict(tenant_arenas=4),
    "coalesce": dict(query_coalesce=4, assignment_triggers=True),
}


def _engines(**kw):
    jeng = JaxEngine(JaxEngineConfig(**SIZES, **kw))
    teng = Engine(EngineConfig(**SIZES, **kw), device="cpu")
    jeng.epoch, teng.epoch = pinned(JaxEpoch), pinned(EpochBase)
    return jeng, teng


def _meas(tok: str, k: int, v: float) -> bytes:
    return json.dumps({"deviceToken": tok, "type": "DeviceMeasurements",
                       "request": {"measurements": {"m0": v, "m1": -v},
                                   "eventDate": BASE_MS + k}}).encode()


def _info(x):
    return None if x is None else dataclasses.asdict(x)


def assert_same(jeng, teng):
    """State leaves, host mirrors, interners and metrics."""
    assert_tree_equal(jax.device_get(jeng.state), teng.state)
    for name in ("devices", "assignments"):
        assert ({k: _info(v) for k, v in getattr(teng, name).items()}
                == {k: _info(v) for k, v in getattr(jeng, name).items()}), name
    for name in ("assignment_tokens", "device_slots", "token_device",
                 "dead_letters", "_next_device", "_next_assignment"):
        assert getattr(teng, name) == getattr(jeng, name), name
    for name in ("tokens", "tenants", "device_types", "areas", "customers",
                 "assets", "event_ids"):
        a, b = getattr(jeng, name), getattr(teng, name)
        assert [b.token(i) for i in range(len(b))] == \
            [a.token(i) for i in range(len(a))], name
    assert teng.metrics() == jeng.metrics()


def _both(jeng, teng, method: str, *a, **kw):
    """Call ``method`` on both engines: equal results or the same error."""
    out = []
    for eng in (jeng, teng):
        try:
            res = getattr(eng, method)(*a, **kw)
        except (KeyError, ValueError, RuntimeError) as e:
            res = ("raised", type(e).__name__)
        if isinstance(res, list):
            res = [_info(x) for x in res]
        elif dataclasses.is_dataclass(res):
            res = _info(res)
        out.append(res)
    assert out[1] == out[0], (method, a, kw)
    return out[1]


def _ingest(jeng, teng, payloads, tenant="default"):
    ref = strip_trace(jeng.ingest_json_batch(payloads, tenant))
    assert strip_trace(teng.ingest_json_batch(payloads, tenant)) == ref


def _admin_script(jeng, teng):
    """Every admin method in a row, events in between."""
    for i in range(4):
        _both(jeng, teng, "register_device", f"a-{i}", device_type="meter",
              area="north" if i % 2 else None, customer="acme" if i == 2 else None)
    _ingest(jeng, teng, [_meas(f"a-{i % 4}", i, float(i)) for i in range(10)])
    _both(jeng, teng, "update_device", "a-0", device_type="gauge", area="south")
    _both(jeng, teng, "update_device", "a-1", customer="zeta",
          metadata={"parentToken": "a-0", "site": "x"})
    _both(jeng, teng, "update_device", "a-1", metadata={"site": "y"})
    _both(jeng, teng, "update_device", "a-1", metadata={"parentToken": None})
    _both(jeng, teng, "update_device", "a-2", metadata={"parentToken": "a-2"})
    _both(jeng, teng, "update_device", "nobody", area="x")
    _both(jeng, teng, "map_device", "a-3", "a-0")
    _both(jeng, teng, "create_assignment", "a-0", token="as-0", asset="pump-7",
          area="east", metadata={"k": 1})
    _both(jeng, teng, "create_assignment", "a-0", asset="valve-2",
          customer="acme")
    _both(jeng, teng, "create_assignment", "a-1", token="as-1", asset="pump-7")
    _both(jeng, teng, "create_assignment", "a-1", token="as-1")   # taken
    _both(jeng, teng, "create_assignment", "nobody")
    for _ in range(3):   # the fourth slot of a-2 fills, the fifth refuses
        _both(jeng, teng, "create_assignment", "a-2")
    _both(jeng, teng, "create_assignment", "a-2")
    _ingest(jeng, teng, [_meas(f"a-{i % 4}", 20 + i, float(i)) for i in range(12)])
    _both(jeng, teng, "get_assignment", "as-0")
    _both(jeng, teng, "get_assignment", "nope")
    _both(jeng, teng, "update_assignment", "as-0", asset="pump-8",
          customer="acme", metadata={"k": 2})
    _both(jeng, teng, "update_assignment", "nope", asset="x")
    _both(jeng, teng, "mark_assignment_missing", "as-0")
    _both(jeng, teng, "release_assignment", "as-1")
    _ingest(jeng, teng, [_meas(f"a-{i % 4}", 40 + i, float(i)) for i in range(12)])
    _both(jeng, teng, "delete_assignment", "as-0")
    _both(jeng, teng, "delete_assignment", "as-0")
    _both(jeng, teng, "delete_assignment", "as-1")     # released already
    _both(jeng, teng, "delete_device", "a-3")
    _both(jeng, teng, "delete_device", "nobody")
    _ingest(jeng, teng, [_meas(f"a-{i % 4}", 60 + i, float(i)) for i in range(8)]
            + [_meas("stranger", 70, 1.0)])
    for kw in ({}, dict(device_token="a-0"), dict(status="RELEASED"),
               dict(asset="pump-7"), dict(area="east"), dict(customer="acme")):
        _both(jeng, teng, "list_assignments", **kw)
    jeng.flush()
    teng.flush()


@pytest.mark.parametrize("name", list(CASES))
def test_admin_calls_match_jax(name):
    jeng, teng = _engines(**CASES[name])
    _admin_script(jeng, teng)
    assert_same(jeng, teng)
    for q in (dict(limit=200), dict(device_token="a-0", limit=50),
              dict(etype=EventType.STATE_CHANGE, limit=50),
              dict(assignment_id=4, limit=50)):
        ref = jeng.query_events(**q)
        assert teng.query_events(**q) == ref, q
    for i in range(0, 80, 7):
        assert teng.get_event(i) == jeng.get_event(i), i
    if CASES[name].get("assignment_triggers"):
        changes = teng.query_events(etype=EventType.STATE_CHANGE, limit=50)
        assert {e["stateChange"] for e in changes["events"]} >= {
            "assignment.created", "assignment.missing", "assignment.released"}
    if CASES[name].get("auto_register") is False:
        assert teng.dead_letters and teng.metrics()["registered"] == 0
        assert teng.get_device("stranger") is None


def test_assignment_expansion_follows_the_slots():
    """An event of a device with three active assignments persists three
    rows; a released assignment stops receiving rows, a MISSING one keeps
    them."""
    jeng, teng = _engines()
    for eng in (jeng, teng):
        eng.register_device("x-0")
        eng.create_assignment("x-0", token="x-a")
        eng.create_assignment("x-0", token="x-b")
    _ingest(jeng, teng, [_meas("x-0", 1, 1.0)])
    for eng in (jeng, teng):
        eng.release_assignment("x-a")
        eng.mark_assignment_missing("x-b")
    _ingest(jeng, teng, [_meas("x-0", 2, 2.0)])
    jeng.flush()
    teng.flush()
    assert_same(jeng, teng)
    assert teng.metrics()["persisted"] == 3 + 2


def test_flood_tenant_keeps_to_its_arena():
    """With ``tenant_arenas=4`` a tenant that writes ten times the store
    evicts only its own arena's rows; event ids carry the arena
    (``position * arenas + arena``)."""
    jeng, teng = _engines(tenant_arenas=4)
    _ingest(jeng, teng, [_meas(f"t-{i}", i, float(i)) for i in range(8)], "tiny")
    for r in range(20):
        _ingest(jeng, teng, [_meas(f"b-{i % 6}", 1000 + 16 * r + i, 1.0)
                             for i in range(128)], "bulk")
    jeng.flush()
    teng.flush()
    assert_same(jeng, teng)
    tiny = teng.query_events(tenant="tiny", limit=50)
    assert tiny == jeng.query_events(tenant="tiny", limit=50)
    assert tiny["total"] == 8
    bulk = teng.query_events(tenant="bulk", limit=100)
    assert bulk == jeng.query_events(tenant="bulk", limit=100)
    assert bulk["total"] == 256 // 4
    ids = [i for i in range(0, 40 * 4)]
    assert [teng.get_event(i) for i in ids] == [jeng.get_event(i) for i in ids]
    assert [teng.get_event(i, tenant="tiny") for i in ids] == \
        [jeng.get_event(i, tenant="tiny") for i in ids]


def test_coalesced_rounds_hold_query_coalesce():
    """``query_coalesce=4``: concurrent queries ride rounds of at most
    four, and each caller gets the page a lone query gets."""
    _, teng = _engines(query_coalesce=4)
    for i in range(6):
        teng.register_device(f"q-{i}")
    teng.ingest_json_batch([_meas(f"q-{i % 6}", i, float(i)) for i in range(40)])
    serial = {i: teng.query_events(device_token=f"q-{i}") for i in range(6)}
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, teng.query_events(device_token=f"q-{i}"))) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert results == serial
    assert teng._query_batcher.max_batch == 4
    assert 1 <= teng._query_batcher.max_coalesced <= 4


def test_admin_helpers_write_only_their_rows():
    """Each admin helper changes exactly the rows it names: every other
    element of every state leaf keeps its value."""
    from sitewhere_tpu_torch import engine as eng_mod

    _, teng = _engines()
    teng.register_device("h-0")
    teng.register_device("h-1")
    s0 = teng.state
    calls = [
        (eng_mod._admin_set_device_active, (1, False), {".registry.device_active": [1]}),
        (eng_mod._admin_update_device, (1, 3, 2, 5),
         {".registry.device_type": [1], ".registry.device_area": [1],
          ".registry.device_customer": [1]}),
        (eng_mod._admin_add_assignment, (1, 9, 2, 4, 5, 6),
         {".registry.device_assignments": [1 * 4 + 2],
          ".registry.assignment_active": [9], ".registry.assignment_status": [9],
          ".registry.assignment_device": [9], ".registry.assignment_asset": [9],
          ".registry.assignment_area": [9], ".registry.assignment_customer": [9],
          ".next_assignment": [0]}),
        (eng_mod._admin_update_assignment, (1, 7, 8, 9),
         {".registry.assignment_asset": [1], ".registry.assignment_area": [1],
          ".registry.assignment_customer": [1]}),
        (eng_mod._admin_set_assignment_status, (1, 2, False),
         {".registry.assignment_status": [1], ".registry.assignment_active": [1],
          ".registry.device_assignments": [1 * 4 + 0]}),
    ]
    from sitewhere_tpu_torch.utils.checkpoint import _leaves

    before = {p: leaf.numpy().reshape(-1).copy() for p, leaf in _leaves(s0)}
    for fn, args, allowed in calls:
        after = {p: leaf.numpy().reshape(-1) for p, leaf in _leaves(fn(s0, *args))}
        for path, a in after.items():
            changed = set(np.nonzero(a != before[path])[0].tolist())
            assert changed <= set(allowed.get(path, [])), (fn.__name__, path, changed)
            if path in allowed:
                assert changed, (fn.__name__, path)
