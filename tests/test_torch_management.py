"""The port's management services (``management/``, ``labels/``) held to the
JAX package's.

Each case of ``tests/test_management.py`` but the two engine-only ones
(``tests/test_torch_admin.py`` twins those) runs here on both packages:
the JAX services over a JAX engine and the port's over
``Engine(device="cpu")``, both engine clocks, the entity and batch clocks
and the invocation counters pinned. The answers (entities, trees, pages,
batch elements, deliveries byte for byte) must be equal in plain form, the
engines leaf for leaf, besides the JAX test's own assertions. The stream
round trip runs the JAX side through the JAX instance and the port's
services wired by hand (``torch_parity.wire_services``), as the instance
routes requests. Then the entity store's id stride and wire forms.
"""

import asyncio
import base64
import datetime
import json

import pytest

from sitewhere_tpu.instance.instance import InstanceConfig, SiteWhereTpuInstance
from tests.torch_parity import wire_services
from tests.torch_services import (SIZES, T, engine, frozen_wall_clock, measure,
                                  pin_services, twin, twin_engines)


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    pin_services(monkeypatch)


def test_device_type_and_device_crud():
    def run(P):
        eng = engine(P)
        dm = P.DeviceManagement(eng)
        dm.create_device_type("thermostat", "Thermostat")
        summary = dm.create_device("d-1", "thermostat")
        assert summary.device_type == "thermostat"
        with pytest.raises(P.EntityNotFound):
            dm.create_device("d-2", "no-such-type")
        with pytest.raises(P.DuplicateToken):
            dm.create_device_type("thermostat", "Again")
        res = dm.list_devices(device_type="thermostat")
        assert res.total == 1 and res.results[0].token == "d-1"
        deleted = dm.delete_device("d-1")
        assert deleted
        return {"summary": summary, "list": res, "deleted": deleted,
                "types": dm.device_types.all(),
                "after": dm.list_devices()}, eng

    twin_engines(run)


def test_area_customer_zone_hierarchy():
    def run(P):
        dm = P.DeviceManagement(engine(P))
        dm.create_area_type("region", "Region", contained_area_types=["site"])
        dm.create_area_type("site", "Site")
        dm.create_area("southeast", "region", "Southeast")
        dm.create_area("atlanta", "site", "Atlanta", parent_token="southeast")
        with pytest.raises(ValueError, match="cannot contain"):
            dm.create_area("nested-region", "region", "Bad", parent_token="southeast")
        tree = dm.area_tree()
        assert len(tree) == 1 and tree[0].entity.meta.token == "southeast"
        assert tree[0].children[0].entity.meta.token == "atlanta"
        dm.create_zone("z-1", "atlanta", "Loading dock",
                       bounds=[(33.7, -84.4), (33.8, -84.4), (33.8, -84.3)])
        with pytest.raises(ValueError, match="3 vertices"):
            dm.create_zone("z-2", "atlanta", "Bad", bounds=[(0, 0), (1, 1)])
        with pytest.raises(ValueError, match="exceed 16"):
            dm.create_zone("z-3", "atlanta", "Big",
                           bounds=[(float(i), float(i)) for i in range(17)])
        assert len(dm.zones_for_area("atlanta")) == 1
        dm.create_customer_type("org", "Organization")
        dm.create_customer("acme", "org", "ACME")
        dm.create_customer("acme-south", "org", "ACME South", parent_token="acme")
        ctree = dm.customer_tree()
        assert ctree[0].entity.name == "ACME"
        assert ctree[0].children[0].entity.name == "ACME South"
        return {"areas": tree, "customers": ctree,
                "zones": dm.zones_for_area("atlanta")}

    twin(run)


def test_statuses_and_alarms(monkeypatch):
    frozen_wall_clock(monkeypatch)

    def run(P):
        eng = engine(P)
        dm = P.DeviceManagement(eng)
        dm.create_device_type("pump", "Pump")
        dm.create_device("p-1", "pump")
        dm.create_device_status("s-ok", "pump", "ok", "OK")
        dm.create_device_status("s-fault", "pump", "fault", "Fault",
                                background_color="#ff0000")
        assert {s.code for s in dm.statuses_for_type("pump")} == {"ok", "fault"}
        alarm = dm.create_alarm("a-1", "p-1", "Pressure exceeded")
        assert alarm.state is P.AlarmState.TRIGGERED
        acked = dm.acknowledge_alarm("a-1")
        assert acked.state is P.AlarmState.ACKNOWLEDGED
        resolved = dm.resolve_alarm("a-1")
        assert resolved.state is P.AlarmState.RESOLVED
        assert len(dm.alarms_for_device("p-1")) == 1
        with pytest.raises(P.EntityNotFound):
            dm.create_alarm("a-2", "ghost", "no device")
        return {"statuses": dm.statuses_for_type("pump"),
                "alarms": dm.alarms_for_device("p-1"),
                "summary": dm.get_device_summary("p-1")}, eng

    twin_engines(run)


def test_device_groups_and_expansion():
    def run(P):
        eng = engine(P)
        dm = P.DeviceManagement(eng)
        for tok in ("d-1", "d-2", "d-3"):
            dm.create_device(tok, "default")
        dm.create_group("all", "All devices", roles=["monitor"])
        dm.create_group("subset", "Subset")
        dm.add_group_elements("subset", [{"device": "d-3", "roles": ["leaf"]}])
        dm.add_group_elements("all", [{"device": "d-1", "roles": ["primary"]},
                                      {"device": "d-2"}, {"group": "subset"}])
        expanded = dm.expand_group_devices("all")
        assert expanded == ["d-1", "d-2", "d-3"]
        primary = dm.expand_group_devices("all", roles=["primary"])
        assert primary == ["d-1"]
        with pytest.raises(ValueError, match="exactly one"):
            dm.add_group_elements("all", [{"device": "d-1", "group": "subset"}])
        with pytest.raises(P.EntityNotFound):
            dm.add_group_elements("all", [{"device": "ghost"}])
        els = dm.group_elements("all")
        assert dm.remove_group_element("all", els[0].element_id)
        assert len(dm.group_elements("all")) == 2
        return {"expanded": expanded, "primary": primary,
                "all": dm.group_elements("all"), "subset": dm.group_elements("subset"),
                "groups": dm.groups.all()}, eng

    twin_engines(run)


def test_asset_management():
    def run(P):
        am = P.AssetManagement()
        am.create_asset_type("truck", "Delivery truck")
        am.create_asset("truck-17", "truck", "Truck 17")
        with pytest.raises(P.EntityNotFound):
            am.create_asset("x", "no-type", "X")
        res = am.list_assets(asset_type="truck")
        assert res.total == 1 and res.results[0].name == "Truck 17"
        return res

    twin(run)


def _command_stack(P, eng):
    svc = P.CommandDeliveryService(eng, P.SingleChoiceCommandRouter("local"))
    svc.registry.create(P.DeviceCommand(token="ping", device_type="default", name="ping"))
    provider = P.LocalDeliveryProvider()
    svc.add_destination(P.CommandDestination(
        "local", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(), provider))
    return svc, provider


def test_batch_command_invocation():
    def run(P):
        eng = engine(P)
        for i in range(5):
            eng.register_device(f"b-{i}")
        svc, provider = _command_stack(P, eng)
        mgr = P.BatchOperationManager(concurrency=3)
        mgr.register_handler(P.BatchCommandInvocationHandler(svc))
        mgr.create_operation("op-1", "InvokeCommand", [f"b-{i}" for i in range(5)],
                             {"commandToken": "ping"})
        op = asyncio.run(mgr.process_operation("op-1"))
        assert op.status == "Finished"
        assert op.counts()["SUCCEEDED"] == 5
        assert len(provider.delivered) == 5
        assert all(el.response_metadata["invocationId"] for el in op.elements)
        eng.flush()
        pumped = asyncio.run(svc.pump())
        return {"op": op, "counts": op.counts(), "delivered": provider.delivered,
                "pumped": pumped, "history": svc.history}, eng

    twin_engines(run)


def test_batch_failure_tracking():
    def run(P):
        eng = engine(P)
        eng.register_device("ok-1")
        svc, _ = _command_stack(P, eng)
        mgr = P.BatchOperationManager()
        mgr.register_handler(P.BatchCommandInvocationHandler(svc))
        mgr.create_operation("op-2", "InvokeCommand", ["ok-1", "ghost"],
                             {"commandToken": "nope"})
        op = asyncio.run(mgr.process_operation("op-2"))
        assert op.counts()["FAILED"] == 2
        assert len(mgr.failed_elements) == 2
        with pytest.raises(ValueError, match="no handler"):
            mgr.create_operation("op-3", "Unknown", ["ok-1"])
        return {"op": op, "failed": mgr.failed_elements}, eng

    twin_engines(run)


def test_cron_expression():
    def run(P):
        c = P.CronExpression.parse("*/15 3 * * *")
        assert c.matches(datetime.datetime(2026, 7, 29, 3, 45))
        assert not c.matches(datetime.datetime(2026, 7, 29, 4, 0))
        nxt = c.next_fire(datetime.datetime(2026, 7, 29, 3, 46))
        assert nxt == datetime.datetime(2026, 7, 30, 3, 0)
        c2 = P.CronExpression.parse("0 9 * * 1-5")
        assert c2.matches(datetime.datetime(2026, 7, 29, 9, 0))
        assert not c2.matches(datetime.datetime(2026, 8, 1, 9, 0))
        for bad in ("61 * * * *", "* * *"):
            with pytest.raises(ValueError):
                P.CronExpression.parse(bad)
        # a week of minutes: every match and the next fire after each hour
        start = datetime.datetime(2026, 7, 27, 0, 0)
        minutes = [start + datetime.timedelta(minutes=m) for m in range(0, 7 * 1440, 7)]
        return {"c": c, "c2": c2,
                "matches": [[x.matches(t) for t in minutes] for x in (c, c2)],
                "next": [[x.next_fire(t).isoformat() for t in minutes[::60]]
                         for x in (c, c2)]}

    twin(run)


def test_schedule_manager_fires_jobs():
    def run(P):
        eng = engine(P)
        eng.register_device("sched-1")
        svc, provider = _command_stack(P, eng)
        sm = P.ScheduleManager()
        sm.register_executor("CommandInvocation", P.command_invocation_executor(svc))
        sm.create_schedule("every-sec", "Every second", "Simple", interval_s=0.01,
                           repeat_count=1)
        sm.create_job("job-1", "every-sec", "CommandInvocation",
                      {"deviceToken": "sched-1", "commandToken": "ping"})

        async def go():
            now = 1_000_000.0
            return [await sm.fire_due(now + dt) for dt in (0, 5, 20, 40)]

        fired = asyncio.run(go())
        assert fired == [1, 0, 1, 0]
        assert len(provider.delivered) == 2
        job = sm.jobs.get("job-1")
        assert job.fired_count == 2 and job.last_error is None
        with pytest.raises(ValueError, match="cron"):
            sm.create_schedule("bad", "Bad", "Cron")
        with pytest.raises(ValueError, match="no executor"):
            sm.create_job("job-2", "every-sec", "Unknown", {})
        eng.flush()
        return {"fired": fired, "job": job, "delivered": provider.delivered,
                "schedules": sm.schedules.all()}, eng

    twin_engines(run)


def test_cron_schedule_fires_on_an_injected_clock():
    """A cron job and a batch-by-criteria job fired by ``fire_due`` at
    pinned times (local-time minutes): the same fires, deliveries and
    batch operations on both packages."""
    def run(P):
        eng = engine(P)
        s = wire_services(P, eng)
        dm = s.device_management
        dm.create_device_type("meter", "Meter")
        for i in range(4):
            dm.create_device(f"m-{i}", "meter" if i % 2 else "default")
        s.commands.registry.create(P.DeviceCommand(token="ping", device_type="default",
                                                   name="ping"))
        s.commands.registry.create(P.DeviceCommand(token="ping-m", device_type="meter",
                                                   name="ping"))
        provider = P.LocalDeliveryProvider()
        s.commands.add_destination(P.CommandDestination(
            "default", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(),
            provider))
        s.scheduler.create_schedule("quarter", "Quarter hour", "Cron", cron="*/15 * * * *")
        s.scheduler.create_job("j-1", "quarter", "CommandInvocation",
                               {"deviceToken": "m-0", "commandToken": "ping"})
        s.scheduler.create_job("j-2", "quarter", "BatchCommandByCriteria",
                               {"deviceTypeToken": "meter", "commandToken": "ping-m"})
        base = datetime.datetime(2026, 7, 29, 3, 0).timestamp() * 1000

        async def go():
            out = []
            for minute in (0, 1, 14, 15, 15.5, 30):
                out.append(await s.scheduler.fire_due(base + minute * 60_000))
                await asyncio.sleep(0)
            return out

        fired = asyncio.run(go())
        eng.flush()
        return {"fired": fired, "jobs": s.scheduler.jobs.all(),
                "delivered": provider.delivered,
                "ops": s.batch.operations.all()}, eng

    a, _ = twin_engines(run)
    assert a["fired"] == [2, 0, 0, 2, 0, 2]


def test_qr_code_structure():
    def run(P):
        M = P.qr_matrix("sitewhere://tpu/device/dev-123")
        size = len(M)
        assert size in (21 + 4 * v for v in range(10))
        for r0, c0 in ((0, 0), (0, size - 7), (size - 7, 0)):
            assert M[r0][c0] == 1 and M[r0 + 3][c0 + 3] == 1
            assert M[r0 + 1][c0 + 1] == 0
        assert [M[6][i] for i in range(8, 12)] == [1, 0, 1, 0]
        assert M[size - 8][8] == 1
        assert all(v in (0, 1) for row in M for v in row)
        png = P.qr_png("short", scale=2, border=1)
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        M2 = P.qr_matrix("x" * 100)
        assert len(M2) > size
        return {"m": M, "m2": M2, "png": png,
                "sizes": [len(P.qr_matrix("y" * n)) for n in range(0, 200, 13)]}

    twin(run)


def test_label_manager():
    def run(P):
        mgr = P.LabelGeneratorManager()
        gen = mgr.get("qrcode")
        png = gen.device_label("dev-1")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert mgr.list_generators() == [{"id": "qrcode", "name": "QR Code Generator"}]
        with pytest.raises(KeyError):
            mgr.get("missing")
        return {"png": png, "generators": mgr.list_generators()}

    twin(run)


def test_device_streams():
    def run(P):
        sm = P.DeviceStreamManager()
        sm.create_stream("video-1", "cam-1", "video/h264")
        sm.append_chunk("video-1", 2, b"BBB")
        sm.append_chunk("video-1", 1, b"AAA")
        sm.append_chunk("video-1", 3, b"CCC")
        assert sm.get_chunk("video-1", 2) == b"BBB"
        assert sm.get_chunk("video-1", 9) is None
        assert sm.read_all("video-1") == b"AAABBBCCC"
        stream = sm.streams.get("video-1")
        assert stream.chunk_count == 3 and stream.total_bytes == 9
        with pytest.raises(P.EntityNotFound):
            sm.append_chunk("ghost", 1, b"x")
        return {"stream": stream, "all": sm.read_all("video-1")}

    twin(run)


def test_stream_commands_roundtrip_via_downlink():
    """Stream requests from a device go through the stream service and the
    ack and the requested chunk come back over command delivery: the JAX
    instance's routing against the port's services wired by hand."""
    def run(P):
        eng = engine(P)
        if P.port:
            s = wire_services(P, eng)
            route = s.route
        else:
            s = SiteWhereTpuInstance(InstanceConfig(engine=eng.config), engine=eng)
            route = s._route_device_request
        provider = P.LocalDeliveryProvider()
        s.commands.add_destination(P.CommandDestination(
            "default", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(),
            provider))
        eng.register_device("cam-1")
        dec = P.JsonDeviceRequestDecoder()

        def send(envelope):
            for req in dec.decode(json.dumps(envelope).encode(), {}):
                route(req)

        async def go():
            send({"deviceToken": "cam-1", "type": "DeviceStream",
                  "request": {"streamId": "vid-1", "contentType": "video/mjpeg"}})
            for seq in (0, 1):
                send({"deviceToken": "cam-1", "type": "DeviceStreamData",
                      "request": {"streamId": "vid-1", "sequenceNumber": seq,
                                  "data": base64.b64encode(b"frame-%d" % seq).decode()}})
            send({"deviceToken": "cam-1", "type": "SendDeviceStreamData",
                  "request": {"streamId": "vid-1", "sequenceNumber": 1}})
            send({"deviceToken": "cam-1", "type": "DeviceMeasurements",
                  "request": {"measurements": {"t": 2.5}}})
            await asyncio.sleep(0.1)   # let the downlink tasks run

        asyncio.new_event_loop().run_until_complete(go())
        eng.flush()
        assert s.streams.read_all("vid-1") == b"frame-0frame-1"
        payloads = [json.loads(p.decode()) for _, p, system in provider.delivered
                    if system]
        kinds = [p["systemCommand"] for p in payloads]
        assert "DeviceStreamAck" in kinds and "DeviceStreamData" in kinds
        chunk = next(p for p in payloads if p["systemCommand"] == "DeviceStreamData")
        assert base64.b64decode(chunk["payload"]["data"]) == b"frame-1"
        assert chunk["payload"]["found"] is True
        return {"delivered": sorted(provider.delivered),
                "stream": s.streams.streams.get("vid-1")}, eng

    twin_engines(run)


def test_stream_spill_to_disk_bounds_memory(tmp_path):
    def run(P):
        spill = tmp_path / P.root
        spill.mkdir()
        mgr = P.DeviceStreamManager(memory_budget_bytes=256, spill_dir=str(spill))
        mgr.create_stream("big", "cam-9")
        blobs = [bytes([i]) * 64 for i in range(10)]
        for i, b in enumerate(blobs):
            mgr.append_chunk("big", i, b)
        assert mgr.memory_resident_bytes("big") <= 256
        assert mgr.spilled_chunks("big") > 0
        assert mgr.read_all("big") == b"".join(blobs)
        assert mgr.get_chunk("big", 0) == blobs[0]
        assert mgr.get_chunk("big", 9) == blobs[9]
        assert mgr.get_chunk("big", 42) is None
        return {"resident": mgr.memory_resident_bytes("big"),
                "spilled": mgr.spilled_chunks("big"),
                "chunks": [mgr.get_chunk("big", i) for i in range(12)]}

    twin(run)


# --------------------------------------------------------- port-side extras

def test_entity_store_id_stride_and_wire_forms():
    """``configure_id_space`` mints ids ``offset (mod stride)`` after the
    ones made before it; a replicated upsert jumps the counter past its id;
    ``entity_json`` / ``paged_json`` / ``build_tree`` give the JAX forms."""
    def run(P):
        dm = P.DeviceManagement(engine(P))
        store = dm.area_types
        store.create("a", lambda m: P.mod("management.device_management").AreaType(
            meta=m, name="A"))
        store.configure_id_space(2, 3)
        for tok in ("b", "c", "d"):
            dm.create_area_type(tok, tok.upper())
        replicated = P.mod("management.device_management").AreaType(
            meta=P.mod("management.entities").EntityMeta(
                id=40, token="r", created_ms=1.0, updated_ms=2.0), name="R")
        store.apply_replicated("r", replicated)
        dm.create_area_type("e", "E")
        store.remove_replicated("b")
        page = store.list(page=1, page_size=3)
        return {"ids": [(e.meta.token, e.meta.id) for e in store.all()],
                "json": [P.entity_json(e, extra=1) for e in store.all()],
                "paged": P.paged_json(page),
                "page2": P.paged_json(store.list(page=2, page_size=3))}

    a, _ = twin(run)
    assert [i for _, i in a["ids"]] == [1, 5, 8, 40, 41]


def test_seeded_registry_stream_matches_jax():
    """A seeded stream of registry writes through ``DeviceManagement`` (areas
    and customers in trees, two device types, devices created, updated and
    deleted, groups, alarms) interleaved with events: every summary and
    listing equal and the engines leaf for leaf."""
    import numpy as np

    def run(P):
        rng = np.random.default_rng(11)
        eng = engine(P)
        dm = P.DeviceManagement(eng)
        dm.create_area_type("region", "Region", contained_area_types=["site"])
        dm.create_area_type("site", "Site")
        dm.create_customer_type("org", "Org")
        for r in range(2):
            dm.create_area(f"r-{r}", "region", f"R{r}")
            dm.create_customer(f"c-{r}", "org", f"C{r}")
            for k in range(2):
                dm.create_area(f"s-{r}-{k}", "site", f"S{r}{k}", parent_token=f"r-{r}")
        dm.create_device_type("meter", "Meter")
        out = []
        for i in range(40):
            area = f"s-{rng.integers(2)}-{rng.integers(2)}"
            tok = f"dev-{i}"
            out.append(dm.create_device(tok, "meter" if i % 3 else "default",
                                        area=area, customer=f"c-{i % 2}",
                                        metadata={"k": int(rng.integers(100))}))
            measure(P, eng, tok, "temp", float(rng.normal()))
            if i % 7 == 6:
                out.append(dm.update_device(f"dev-{i - 3}", device_type="meter",
                                            area="s-0-0"))
            if i % 11 == 10:
                out.append(dm.delete_device(f"dev-{i - 5}"))
        eng.flush()
        dm.create_group("g", "G")
        dm.add_group_elements("g", [{"device": f"dev-{i}"} for i in range(0, 40, 9)])
        out.append(dm.list_devices(page=2, page_size=7))
        out.append(dm.list_devices(device_type="meter", page_size=100))
        out.append([dm.get_device_summary(f"dev-{i}") for i in range(0, 40, 4)
                    if eng.get_device(f"dev-{i}") is not None])
        out.append(dm.expand_group_devices("g"))
        out.append((dm.area_tree(), dm.customer_tree()))
        return out, eng

    twin_engines(run)


def test_device_management_on_a_card_engine_reads_the_card():
    """``DeviceManagement`` over a port engine delegates every write to the
    engine and reads its device state: nothing is kept beside it."""
    eng = engine(T)
    dm = T.DeviceManagement(eng)
    dm.create_device("x-1", "default")
    measure(T, eng, "x-1", "t", 3.0)
    eng.flush()
    s = dm.get_device_summary("x-1")
    assert s.presence == eng.get_device_state("x-1")["presence"]
    assert s.last_interaction_ms == eng.get_device_state("x-1")["last_interaction_ms"]
    assert eng.config.device_capacity == SIZES["device_capacity"]
