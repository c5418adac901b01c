"""The port's zone monitor (``outbound/zones.py``) held to the JAX package's.

The two ``ZoneMonitor`` cases of ``tests/test_geofence.py`` run the JAX
side through the JAX instance and the port's monitor wired by hand over
``Engine(device="cpu")`` and ``DeviceManagement`` (as
``instance/instance.py`` wires it); then a seeded stream of 256 devices x 8
rounds of one location each over 64 random zones of up to 16 vertices,
pumped until the feed drains. Alerts raised a pump, memberships and the
engines leaf for leaf must be equal: ``points_in_zones`` is exact, so there
is no tolerance. The monitor keeps its zone arrays on the engine's device
and makes one device-to-host copy a pump that has points; the port's
``local_device_info`` resolves the devices JAX's does.
"""

import asyncio

import numpy as np
import pytest

from sitewhere_tpu.instance.instance import InstanceConfig, SiteWhereTpuInstance
from tests.torch_parity import plain, wire_services
from tests.torch_services import BOTH, T, engine, pin_services, twin_engines

FENCE = [(0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0)]


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    pin_services(monkeypatch)


def _instance(P, eng):
    """The JAX instance over ``eng``; the port's services wired by hand."""
    if P.port:
        return wire_services(P, eng)
    return SiteWhereTpuInstance(InstanceConfig(engine=eng.config), engine=eng)


def _plant(s):
    dm = s.device_management
    dm.create_area_type("site", "Site")
    dm.create_area("plant", "site", "Plant")
    return dm


def _locator(P, s, loop):
    def locate(lat, lon):
        s.engine.process(P.DecodedRequest(type=P.RequestType.DEVICE_LOCATION,
                                          device_token="rover", latitude=lat,
                                          longitude=lon))
        s.engine.flush()
        return loop.run_until_complete(s.zone_monitor.pump())

    return locate


def test_zone_monitor_entry_exit_alerts():
    def run(P):
        eng = engine(P)
        s = _instance(P, eng)
        _plant(s).create_zone("fence", "plant", "Fence", bounds=FENCE)
        eng.register_device("rover")
        locate = _locator(P, s, asyncio.new_event_loop())
        raised = [locate(5.0, 5.0), locate(6.0, 6.0), locate(50.0, 50.0)]
        assert raised == [1, 0, 1]
        eng.flush()
        st = eng.get_device_state("rover")
        kinds = [a["type"] for a in st["recent_alerts"]]
        assert "zone.entered:fence" in kinds and "zone.exited:fence" in kinds
        return {"raised": raised, "state": st,
                "membership": s.zone_monitor.membership}, eng

    twin_engines(run)


def test_zone_monitor_resilience():
    def run(P):
        eng = engine(P)
        s = _instance(P, eng)
        dm = _plant(s)
        dm.create_zone("fence", "plant", "Fence", bounds=FENCE)
        eng.register_device("rover")
        locate = _locator(P, s, asyncio.new_event_loop())
        raised = [locate(5.0, 5.0)]
        dm.zones.delete("fence")
        dm.create_zone("fence", "plant", "Fence",
                       bounds=[(100.0, 100.0), (100.0, 110.0), (110.0, 110.0),
                               (110.0, 100.0)])
        raised += [locate(5.0, 5.0), locate(105.0, 105.0)]
        dm.zones.delete("fence")
        raised.append(locate(105.0, 105.0))
        with pytest.raises(ValueError, match="exceed 16"):
            dm.create_zone("big", "plant", "Big",
                           bounds=[(float(i), float(i)) for i in range(20)])
        dm.zones.create("sneaky", lambda m: P.Zone(
            meta=m, area_token="plant", name="Sneaky",
            bounds=[(float(i), 0.0) for i in range(20)]))
        raised.append(locate(1.0, 1.0))
        assert raised == [1, 1, 1, 1, 0]
        eng.flush()
        return {"raised": raised, "state": eng.get_device_state("rover")}, eng

    twin_engines(run)


def random_zones(seed: int, n: int = 64, v: int = 16) -> list:
    """``n`` star-shaped polygons of 3..``v`` vertices in [0, 10]^2."""
    rng = np.random.default_rng(seed)
    zones = []
    for _ in range(n):
        k = int(rng.integers(3, v + 1))
        cy, cx = rng.uniform(1, 9, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        rad = rng.uniform(0.3, 2.5, k)
        zones.append([(float(cy + r * np.sin(a)), float(cx + r * np.cos(a)))
                      for a, r in zip(ang, rad)])
    return zones


def drain(s, loop) -> list[int]:
    """Pump the monitor until its feed is empty: alerts raised a pump."""
    raised = []
    while True:
        raised.append(loop.run_until_complete(s.zone_monitor.pump()))
        s.engine.flush()
        if not s.zone_monitor.consumer.poll():
            return raised


def test_seeded_stream_over_64_zones_matches_jax():
    """256 devices x 8 rounds of one location each (seeded, some outside
    every zone, a null-coordinate event a round) over 64 random zones."""
    def run(P):
        rng = np.random.default_rng(3)
        eng = engine(P, device_capacity=512, token_capacity=1024,
                     assignment_capacity=1024, store_capacity=16384, batch_capacity=256)
        s = wire_services(P, eng, index_events=False)
        dm = _plant(s)
        for i, bounds in enumerate(random_zones(17)):
            dm.create_zone(f"z-{i:02d}", "plant", f"Z{i}", bounds=bounds)
        for d in range(256):
            eng.register_device(f"v-{d}")
        loop = asyncio.new_event_loop()
        pumps = []
        for _ in range(8):
            pts = rng.uniform(-1, 11, (256, 2))
            for d in range(256):
                eng.process(P.DecodedRequest(type=P.RequestType.DEVICE_LOCATION,
                                             device_token=f"v-{d}",
                                             latitude=float(pts[d, 0]),
                                             longitude=float(pts[d, 1])))
            eng.process(P.DecodedRequest(type=P.RequestType.DEVICE_LOCATION,
                                         device_token="v-0"))
            eng.flush()
            pumps.append(drain(s, loop))
        alerts = eng.query_events(etype=P.EventType.ALERT, limit=100_000)["events"]
        assert sum(map(sum, pumps)) == len(alerts) > 1000
        return {"pumps": pumps, "membership": s.zone_monitor.membership,
                "alerts": [(a["deviceToken"], a["alertType"]) for a in alerts]}, eng

    twin_engines(run)


def test_zone_arrays_on_the_engine_device_and_one_copy_a_pump():
    """The packed zones lie on ``engine.device``; a pump with points makes
    one device-to-host copy, one without points none."""
    eng = engine(T)
    s = wire_services(T, eng, index_events=False)
    _plant(s).create_zone("fence", "plant", "Fence", bounds=FENCE)
    eng.register_device("rover")
    loop = asyncio.new_event_loop()
    locate = _locator(T, s, loop)
    assert [locate(5.0, 5.0), locate(50.0, 50.0)] == [1, 1]
    zm = s.zone_monitor
    assert zm._verts.device == eng.device and zm._valid.device == eng.device
    assert zm.stats["syncs"] == 2 and zm.stats["points"] == 2
    loop.run_until_complete(zm.pump())      # the alerts only: no location
    assert zm.stats == {"pumps": 3, "points": 2, "point_zones": 2, "syncs": 2}


def test_local_device_info_resolves_like_jax(monkeypatch):
    """Both packages' ``local_device_info`` resolve every device id of an
    engine, and of a facade holding it as ``local``, to the same record;
    the port's analytics service names its anomalous devices through it."""
    import types

    from sitewhere_tpu_torch import engine as engine_mod
    from sitewhere_tpu_torch.models.anomaly import AnomalyConfig
    from sitewhere_tpu_torch.models.service import AnalyticsService

    out = {}
    for P in BOTH:
        eng = engine(P)
        for i in range(5):
            eng.register_device(f"l-{i}", device_type=f"t{i % 2}")
        facade = types.SimpleNamespace(local=eng)
        out[P.root] = [plain(P.local_device_info(e, i, "none"))
                       for e in (eng, facade) for i in range(-1, 7)]
    assert out["sitewhere_tpu_torch"] == out["sitewhere_tpu"]

    eng = engine(T, analytics_devices=8, analytics_window=4, use_native=False)
    for t in range(6):
        for d in range(4):
            eng.process(T.DecodedRequest(type=T.RequestType.DEVICE_MEASUREMENT,
                                         device_token=f"a{d}",
                                         measurements={"x": float(t * d), "y": float(t)}))
    eng.flush()
    svc = AnalyticsService(eng, AnomalyConfig(sensors=4, window=4, hidden=8,
                                              lstm_hidden=8, latent=2),
                           threshold=-1e9)
    seen = []
    real = engine_mod.local_device_info

    def spy(e, did, default=None):
        seen.append(did)
        return real(e, did, default)

    monkeypatch.setattr(engine_mod, "local_device_info", spy)
    tokens = svc.score_all()["anomalous_tokens"]
    assert seen and tokens == [eng.devices[d].token for d in seen]
