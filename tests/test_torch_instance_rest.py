"""Twins of the server cases outside the four server test files: the
versioned scripts over REST (``tests/test_scripting_rest.py``) and the REST,
RPC and tenant-config cases of earlier slices' files (archive, aux,
conservation, device watch, load generator, QoS, geofence, streams), each
run through the JAX instance and the port's (``device="cpu"``) and held
equal as in ``tests/torch_servers.py``; the analytics and rules routes are
in ``test_torch_instance_analytics.py``, the mesh engine's in
``test_torch_instance_mesh.py``. Then the instance's own rules: it builds
its engine on the card unless asked for the CPU, and the debug bundle has
the JAX package's key set on the single engine and on the mesh engine."""

import asyncio
import base64
import json
import os

import pytest
import torch

from tests.torch_parity import plain
from tests.torch_servers import (BOTH, J, T, compare_engines, make_instance, mask,
                                 mesh_engine, pin_servers, rpc_names, run_rpc_twin,
                                 run_twin)


@pytest.fixture
def twin(monkeypatch):
    pin_servers(monkeypatch)
    return run_twin


@pytest.fixture
def pinned_servers(monkeypatch):
    pin_servers(monkeypatch)


def notes_twin(case) -> list:
    """``case(P, note) -> instance`` on each package; the notes equal and
    the engines leaf for leaf."""
    out, insts = [], []
    for P in BOTH:
        notes: list = []
        insts.append(case(P, lambda *v: notes.append(mask(plain(list(v))))))
        out.append(notes)
    assert out[1] == out[0]
    compare_engines(insts[0].engine, insts[1].engine)
    return out


# ------------------------------------------------- tests/test_scripting_rest.py
V1 = """
from sitewhere_tpu.ingest.requests import DecodedRequest, RequestType

def decode(payload, metadata):
    return [DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                           device_token=payload.decode(),
                           measurements={"script": 1.0})]
"""

V2 = V1.replace('"script": 1.0', '"script": 2.0')
SCRIPTING = "/api/microservices/event-sources/tenants/default/scripting"
SCRIPT_SIZES = dict(store_capacity=1024)


def generic(text: bytes) -> str:
    """A script's text with either package's name as ``<pkg>``."""
    return text.decode().replace("sitewhere_tpu_torch.", "<pkg>.").replace(
        "sitewhere_tpu.", "<pkg>.")


def test_script_lifecycle_over_rest(twin, tmp_path):
    def case(S):
        call, base, v1, v2 = S.call, SCRIPTING, S.src(V1), S.src(V2)
        # create (v1 auto-activates)
        status, meta = call("POST", f"{base}/scripts", {
            "id": "my-decoder", "name": "My decoder",
            "category": "decoders", "content": v1})
        assert status == 201
        assert meta["activeVersion"] == "v1"
        # duplicate id -> 409
        status, _ = call("POST", f"{base}/scripts", {"id": "my-decoder"})
        assert status == 409
        # listing + categories
        status, body = call("GET", f"{base}/scripts")
        assert [s["id"] for s in body] == ["my-decoder"]
        status, cats = call("GET", f"{base}/categories")
        assert cats[0]["id"] == "decoders" and len(cats[0]["scripts"]) == 1
        status, body = call("GET", f"{base}/categories/decoders")
        assert len(body) == 1
        status, body = call("GET", f"{base}/categories/ghost")
        assert body == []
        # content
        status, text = call("GET", f"{base}/scripts/my-decoder/versions/v1/content",
                            raw=True, keep=generic)
        assert "script\": 1.0" in text.decode()
        # clone v1 -> v2, update v2's content
        status, body = call("POST", f"{base}/scripts/my-decoder/versions/v1/clone",
                            {"comment": "tweak"})
        assert status == 201
        assert [v["versionId"] for v in body["versions"]] == ["v1", "v2"]
        status, _ = call("POST", f"{base}/scripts/my-decoder/versions/v2",
                         {"content": v2})
        assert status == 200
        # v2 exists but v1 is still active
        status, body = call("GET", f"{base}/scripts/my-decoder")
        assert body["activeVersion"] == "v1"
        # activate v2
        status, body = call("POST", f"{base}/scripts/my-decoder/versions/v2/activate", {})
        assert body["activeVersion"] == "v2"
        # unknown version -> 404
        status, _ = call("POST", f"{base}/scripts/my-decoder/versions/v9/activate", {})
        assert status == 404
        # delete
        status, _ = call("DELETE", f"{base}/scripts/my-decoder")
        assert status == 200
        status, _ = call("GET", f"{base}/scripts/my-decoder")
        assert status == 404

    twin(case, make=lambda P: make_instance(
        P, SCRIPT_SIZES, script_root=str(tmp_path / P.root / "scripts")))


def test_activate_then_decode_with_new_script(twin, tmp_path):
    """A scripted decoder bound to the store's active.py decodes with v1;
    activating v2 changes the very next decode."""
    def case(S):
        call, base, inst = S.call, SCRIPTING, S.inst
        ScriptedDecoder = S.mod("ingest.decoders").ScriptedDecoder
        call("POST", f"{base}/scripts", {"id": "hot-decoder", "content": S.src(V1)})
        # bind a scripted decoder to the ACTIVE script path
        handle = inst.scripts.manager.handle(
            inst.scripts.active_path("event-sources", "default",
                                     "hot-decoder"), "decode")
        decoder = ScriptedDecoder(handle)
        reqs = decoder.decode(b"dev-hot", {})
        assert reqs[0].measurements == {"script": 1.0}
        # publish + activate v2; next decode must use it
        call("POST", f"{base}/scripts/hot-decoder/versions/v1/clone", {})
        call("POST", f"{base}/scripts/hot-decoder/versions/v2", {"content": S.src(V2)})
        call("POST", f"{base}/scripts/hot-decoder/versions/v2/activate", {})
        reqs = decoder.decode(b"dev-hot", {})
        assert reqs[0].measurements == {"script": 2.0}
        # and the decoded request flows into the engine
        inst.engine.process(reqs[0])
        out = inst.engine.flush()
        assert out["persisted"] == 1
        S.note(out)

    twin(case, make=lambda P: make_instance(
        P, SCRIPT_SIZES, script_root=str(tmp_path / P.root / "scripts")))


def test_script_templates_endpoints(twin, tmp_path):
    def case(S):
        status, cats = S.call("GET", "/api/microservices/event-sources/scripting/categories")
        assert status == 200 and cats[0]["id"] == "templates"
        assert "event-decoder" in cats[0]["templates"]
        status, text = S.call(
            "GET", "/api/microservices/event-sources/scripting/templates"
            "/event-decoder", raw=True, keep=generic)
        assert status == 200 and "decode" in text.decode()
        status, _ = S.call(
            "GET", "/api/microservices/event-sources/scripting/templates/../etc",
            raw=True, keep=generic)
        assert status == 404

    twin(case, make=lambda P: make_instance(
        P, SCRIPT_SIZES, script_root=str(tmp_path / P.root / "scripts")))


# --------------------------------------------- tests/test_archive.py:700
ARCHIVE_SIZES = dict(device_capacity=64, token_capacity=128,
                     assignment_capacity=128, store_capacity=64, channels=4,
                     batch_capacity=16, archive_segment_rows=16)


def meas(eng, token: str, value: float, ts_rel: int) -> bytes:
    base = int(eng.epoch.base_unix_s * 1000)
    return json.dumps({
        "deviceToken": token, "type": "DeviceMeasurements",
        "request": {"measurements": {"temp": value}, "eventDate": base + ts_rel},
    }).encode()


def test_archived_history_serves_over_rest(twin, tmp_path):
    """The REST event listings include archived history, and the archive
    maintenance endpoints answer alike."""
    def make(P):
        inst = make_instance(P, dict(ARCHIVE_SIZES,
                                     archive_dir=str(tmp_path / P.root / "ra")))
        eng = inst.engine
        for i in range(256):
            eng.ingest_json_batch([meas(eng, f"rr-{i % 4}", float(i), 1000 + i)])
        eng.flush()
        return inst

    def case(S):
        call, eng = S.call, S.inst.engine
        status, body = call("GET", "/api/events")
        assert body["total"] == 256
        status, body = call("GET", "/api/devices/rr-1/events",
                            params={"sinceMs": "1000", "untilMs": "1063",
                                    "pageSize": "64"})
        assert body["total"] == 16
        assert all(e["deviceToken"] == "rr-1" for e in body["events"])
        feed = eng.make_feed_consumer("rest-arch")
        first = feed.poll()[0]
        status, body = call("GET", f"/api/events/id/{first.event_id}")
        assert status == 200 and body["eventDateMs"] == 1000
        status, m = call("GET", "/api/instance/metrics",
                         keep=lambda m: {k: v for k, v in m.items()
                                         if k != "archive"})
        assert m["archive"]["rows"] > 0 and m["archive"]["live_bytes"] > 0
        files_before = m["archive"]["live_segments"]
        S.note(m["archive"]["rows"], files_before)
        status, stats = call("POST", "/api/instance/archive/compact",
                             {"targetRows": 64}, keep=sorted)
        assert status == 200
        assert stats["files_now"] < files_before
        S.note(stats["files_now"])
        status, body = call("GET", "/api/devices/rr-1/events",
                            params={"sinceMs": "1000", "untilMs": "1063",
                                    "pageSize": "64"})
        assert body["total"] == 16
        status, body = call("POST", "/api/instance/archive/purge-retired")
        assert status == 200 and body["freedBytes"] == 0
        res = eng.query_events(device_token="rr-1", since_ms=1000,
                               until_ms=1063, limit=64)
        assert res["total"] == 16

    twin(case, make=make)


# ------------------------------------------------- tests/test_aux.py
def test_config_driven_components(pinned_servers):
    def case(P, note):
        cfg = P.mod("config")
        inst = make_instance(P)
        summary = cfg.apply_tenant_config(inst, {
            "eventSources": [
                {"id": "mem-src", "type": "inmemory", "decoder": {"type": "json"},
                 "deduplicator": {"type": "alternate-id"}},
            ],
            "outboundConnectors": [{"id": "audit", "type": "inmemory"}],
            "commandRouting": {
                "router": {"type": "single-choice", "destination": "local-dest"},
                "destinations": [
                    {"id": "local-dest", "type": "local", "encoder": {"type": "json"}},
                ],
            },
        })
        assert summary == {"eventSources": ["mem-src"], "connectors": ["audit"],
                           "destinations": ["local-dest"]}
        recv = inst.event_sources.sources["mem-src"].receivers[0]
        recv.submit(json.dumps({"deviceToken": "cfg-1", "type": "DeviceMeasurement",
                                "request": {"name": "t", "value": 9}}).encode())
        inst.engine.flush()
        st = inst.engine.get_device_state("cfg-1")
        assert st is not None
        asyncio.run(inst.pump_outbound())
        audit = inst.connector_hosts[-1].connector
        assert len(audit.events) == 1
        with pytest.raises(cfg.ConfigError, match="unknown event source type") as e1:
            cfg.apply_tenant_config(inst, {"eventSources": [{"id": "x", "type": "bogus"}]})
        with pytest.raises(cfg.ConfigError, match="unknown connector type") as e2:
            cfg.apply_tenant_config(inst, {"outboundConnectors": [{"id": "x", "type": "bogus"}]})
        note(summary, st, audit.events, str(e1.value), str(e2.value))
        return inst

    notes_twin(case)


def test_scripting_component_end_to_end(pinned_servers, tmp_path):
    """File-loaded script hooks across the decoder, filter and connector
    slots of a tenant config."""
    def case(P, note):
        d = tmp_path / P.root
        d.mkdir()
        scripting = P.mod("utils.scripting")
        mgr = scripting.ScriptManager("script-templates")
        assert "event-decoder.py" in mgr.list_scripts()
        reqs = mgr.handle("event-decoder.py", "decode")(b"dev-9,temp,21.5", {})
        assert reqs[0].device_token == "dev-9"
        with pytest.raises(scripting.ScriptError, match="does not define"):
            mgr.handle("event-decoder.py", "nope")
        script = d / "dec.py"
        script.write_text("def decode(p, m):\n    return []\n")
        h = scripting.ScriptManager().handle(script, "decode")
        assert h(b"", {}) == []
        script.write_text(
            f"from {P.root}.ingest.requests import DecodedRequest, RequestType\n"
            "def decode(p, m):\n"
            "    return [DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,\n"
            "            device_token=p.decode(), measurements={'x': 1.0})]\n")
        st = os.stat(script)
        os.utime(script, ns=(st.st_atime_ns, st.st_mtime_ns + 10_000_000))
        assert h(b"sc-1", {})[0].device_token == "sc-1"
        conn = d / "conn.py"
        conn.write_text("SEEN = []\n"
                        "def process_event(event):\n"
                        "    SEEN.append(event.device_token)\n")
        filt = d / "filt.py"
        filt.write_text("def is_excluded(event):\n"
                        "    return event.etype.name != 'MEASUREMENT'\n")
        inst = make_instance(P)
        summary = P.mod("config").apply_tenant_config(inst, {
            "eventSources": [{"id": "script-src", "type": "inmemory",
                              "decoder": {"type": "scripted", "script": str(script)}}],
            "outboundConnectors": [
                {"id": "script-conn", "type": "scripted",
                 "configuration": {"script": str(conn)},
                 "filters": [{"type": "scripted", "script": str(filt)}]}],
        })
        assert summary["eventSources"] == ["script-src"]
        inst.event_sources.sources["script-src"].receivers[0].submit(b"sdev-1")
        inst.engine.flush()
        asyncio.run(inst.pump_outbound())
        seen = scripting.DEFAULT_MANAGER._load(conn)["SEEN"]
        assert seen == ["sdev-1"]
        note(summary, seen)
        return inst

    notes_twin(case)


def test_http_connector_scripted_builders(pinned_servers, tmp_path):
    """The uri- and payload-builder scripts bind through the tenant config's
    connector builder alike."""
    out = []
    for P in BOTH:
        d = tmp_path / P.root
        d.mkdir()
        mgr = P.mod("utils.scripting").ScriptManager("script-templates")
        assert {"payload-builder.py", "uri-builder.py"} <= set(mgr.list_scripts())
        (d / "u.py").write_text("def uri(event):\n"
                                "    return f'http://x.invalid/{event.device_token}'\n")
        (d / "p.py").write_text("def payload(event):\n"
                                "    return event.device_token.upper().encode()\n")
        eng = make_instance(P).engine
        conn = P.mod("config").build_connector({
            "id": "h", "type": "http",
            "configuration": {"uri": {"script": str(d / "u.py")},
                              "payloadBuilder": {"script": str(d / "p.py")}},
        }, eng)
        ev = P.OutboundEvent(event_id=1, etype=P.EventType.MEASUREMENT,
                             device_token="dv-1", device_id=0, assignment_id=0,
                             tenant="default", area_id=-1, asset_id=-1, ts_ms=1,
                             received_ms=1, measurements={}, values=[], aux0=-1,
                             aux1=-1)
        out.append((type(conn).__name__, conn.uri(ev), conn.payload_builder(ev)))
    assert out[1] == out[0] == ("HttpConnector", "http://x.invalid/dv-1", b"DV-1")


# ------------------------------------------- tests/test_conservation.py:393
def test_rest_conservation_endpoint(twin):
    """The conservation document over REST, with the auditor thread the
    server starts (and stops again on cleanup)."""
    def make(P):
        inst = make_instance(P, dict(store_capacity=1024),
                             conservation_audit_s=0.05)
        inst.engine.ingest_json_batch([json.dumps({
            "deviceToken": f"cv-{i % 3}", "type": "DeviceMeasurement",
            "request": {"name": "t", "value": 1.0,
                        "metadata": {"seq": str(1_000_000 + i)}}}).encode()
            for i in range(12)])
        inst.engine.flush()
        return inst

    def case(S):
        assert S.inst.conservation_auditor._thread is not None
        status, doc = S.call("GET", "/api/instance/conservation",
                             keep=lambda d: [d["balanced"], d["ledger"]["stages"]])
        assert status == 200 and doc["balanced"] is True
        assert doc["ledger"]["stages"]["ingest"]["staged_rows"] == 12
        assert "auditor" in doc

    j, t = twin(case, make=make)
    assert t.inst.conservation_auditor._thread is None
    assert j.inst.conservation_auditor._thread is None


# --------------------------------------------- tests/test_devicewatch.py
def _devicewatch_instance(P):
    inst = make_instance(P)
    gen = P.mod("loadgen").generate_measurements_message
    inst.engine.ingest_json_batch([gen(f"rest-{i % 8}", i) for i in range(16)])
    inst.engine.flush()
    return inst


def test_rest_device_memory_endpoint(twin):
    """The memory ledger over REST: the same component breakdown. The JAX
    package also counts its XLA compiles per family; eager torch compiles
    nothing, so the port's ``compileFamilies`` is empty (pinned)."""
    def case(S):
        status, body = S.call("GET", "/api/instance/device/memory",
                              keep=lambda b: b["components"])
        assert status == 200 and body["components"]["ring_store"] > 0
        assert "highWatermarks" in body and "totalBytes" in body
        fams = body["compileFamilies"]
        if S.P.port:
            assert fams == {}
        else:
            assert fams["ingest.step"]["compiles"] >= 1

    twin(case, make=_devicewatch_instance)


def test_rest_device_profile_endpoint(twin):
    """GET /api/instance/profile/device?ms=N captures a profiler trace into
    a named directory on both packages (the port's is torch.profiler's)."""
    def case(S):
        status, body = S.call("GET", "/api/instance/profile/device",
                              params={"ms": "60"}, keep=sorted)
        assert status == 200
        assert os.path.isdir(body["dir"])
        assert body["files"] and body["bytes"] > 0

    twin(case, make=_devicewatch_instance, engines=None)


# ------------------------------------------------ tests/test_loadgen.py:45
def test_rest_load_five_by_hundred(twin):
    """The 5 workers x 20 posts load over live HTTP: each package's
    ``run_rest_load`` (the port's over its own client) against its own
    gateway, the same counts and device states."""
    def case(S):
        stats = S.run(S.mod("loadgen").run_rest_load(
            S.base, S.token, n_workers=5, msgs_per_worker=20))
        S.inst.engine.flush()
        assert stats.events_sent == 100 and stats.events_failed == 0
        states = [S.inst.engine.get_device_state(f"rest-lg-{w}") for w in range(5)]
        assert all(st is not None for st in states)
        S.note(stats.events_sent, stats.events_decoded, stats.events_failed,
               [{k: v for k, v in st.items() if k != "last_interaction_ms"}
                for st in states])

    twin(case, engines=None)


# ------------------------------------------------------ tests/test_qos.py
def _qos(P, inst, rates, burst_s, **kw):
    q = P.mod("utils.qos")
    clock = q.ManualClock()
    inst.engine.qos = q.AdmissionController(tenant_rates=rates, burst_s=burst_s,
                                            clock=clock, **kw)
    return clock


def test_rpc_edge_shed_is_typed_429(pinned_servers):
    """The instance RPC ingest edge sheds with a typed code=429 error frame
    carrying retryAfterS."""
    async def go(P, log):
        (_instance, RpcClient, _, RpcError, build_instance_rpc,
         system_jwt) = rpc_names(P, log)
        inst = _instance()
        _qos(P, inst, {"default": 10.0}, 0.1)
        srv = build_instance_rpc(inst)
        port = await srv.start()
        cli = await RpcClient(port=port, tenant="default",
                              auth_token=system_jwt(inst)).connect()
        env = {"deviceToken": "rpc-shed-0", "type": "DeviceMeasurement",
               "request": {"name": "t", "value": 1.0}}
        assert (await cli.call("DeviceEventManagement.addDeviceEvent",
                               envelope=env))["accepted"]
        with pytest.raises(RpcError) as ei:
            await cli.call("DeviceEventManagement.addDeviceEvent", envelope=env)
        assert ei.value.code == 429
        assert ei.value.retry_after_s == pytest.approx(0.1)
        log.append(("retry_after_s", ei.value.retry_after_s))
        await cli.close()
        await srv.stop()

    run_rpc_twin(go)


def test_rest_edge_sheds_429_with_retry_after(twin):
    """The REST ingest edge answers a shed with 429, an integer-ceiled
    Retry-After header and a machine-readable retryAfterS body, for the
    single-event POST and the bulk batch endpoint."""
    def make(P):
        inst = make_instance(P)
        _qos(P, inst, {"default": 4.0}, 0.5)
        return inst

    def case(S):
        body = {"type": "DeviceMeasurement", "request": {"name": "t", "value": 1.0}}
        for _ in range(2):
            st, _ = S.call("POST", "/api/devices/rq-0/events", body)
            assert st == 201
        st, resp = S.call("POST", "/api/devices/rq-0/events", body)
        assert st == 429
        assert int(S.log[-1][4]["Retry-After"]) >= 1
        assert resp["retryAfterS"] == pytest.approx(0.25)
        assert resp["reason"] == "rate"
        rows = [{"deviceToken": f"rq-b{i}", "type": "DeviceMeasurement",
                 "request": {"name": "t", "value": 1.0,
                             "metadata": {"seq": "0"}}} for i in range(4)]
        st, _ = S.call("POST", "/api/events/batch", rows)
        assert st == 429 and S.log[-1][4]["Retry-After"] is not None

    twin(case, make=make)


# ------------------------------------------------- tests/test_geofence.py:87
def test_zone_contains_rest(twin):
    def make(P):
        inst = make_instance(P, dict(device_capacity=32, token_capacity=64,
                                     assignment_capacity=64, store_capacity=1024,
                                     batch_capacity=8))
        dm = inst.device_management
        dm.create_area_type("site", "Site")
        dm.create_area("plant", "site", "Plant")
        dm.create_zone("z1", "plant", "Z1",
                       bounds=[(0.0, 0.0), (0.0, 4.0), (4.0, 4.0), (4.0, 0.0)])
        return inst

    def case(S):
        _, body = S.call("GET", "/api/zones/z1/contains",
                         params={"latitude": "2", "longitude": "2"})
        assert body["contains"] is True
        _, body = S.call("GET", "/api/zones/z1/contains",
                         params={"latitude": "9", "longitude": "9"})
        assert body["contains"] is False
        status, _ = S.call("GET", "/api/zones/z1/contains", params={"latitude": "9"})
        assert status == 400
        status, _ = S.call("GET", "/api/zones/ghost/contains",
                           params={"latitude": "1", "longitude": "1"})
        assert status == 404

    twin(case, make=make)


# -------------------------------------------- tests/test_management.py:328
def test_stream_commands_roundtrip_via_downlink(pinned_servers):
    """Device stream requests routed by the instance (``_route_device_request``)
    reach the stream service; the ack and the requested chunk come back
    over command delivery."""
    def case(P, note):
        inst = make_instance(P)
        provider = P.LocalDeliveryProvider()
        inst.commands.add_destination(P.CommandDestination(
            "default", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(),
            provider))
        inst.engine.register_device("cam-1")
        dec = P.JsonDeviceRequestDecoder()

        def send(envelope):
            for req in dec.decode(json.dumps(envelope).encode(), {}):
                inst._route_device_request(req)

        async def go():
            send({"deviceToken": "cam-1", "type": "DeviceStream",
                  "request": {"streamId": "vid-1", "contentType": "video/mjpeg"}})
            for seq in (0, 1):
                send({"deviceToken": "cam-1", "type": "DeviceStreamData",
                      "request": {"streamId": "vid-1", "sequenceNumber": seq,
                                  "data": base64.b64encode(
                                      f"frame-{seq}".encode()).decode()}})
            send({"deviceToken": "cam-1", "type": "SendDeviceStreamData",
                  "request": {"streamId": "vid-1", "sequenceNumber": 1}})
            await asyncio.sleep(0.1)   # let the downlink tasks run

        asyncio.new_event_loop().run_until_complete(go())
        assert inst.streams.read_all("vid-1") == b"frame-0frame-1"
        payloads = [json.loads(p.decode()) for _, p, system in provider.delivered
                    if system]
        kinds = [p["systemCommand"] for p in payloads]
        assert "DeviceStreamAck" in kinds and "DeviceStreamData" in kinds
        chunk = next(p for p in payloads if p["systemCommand"] == "DeviceStreamData")
        assert base64.b64decode(chunk["payload"]["data"]) == b"frame-1"
        assert chunk["payload"]["found"] is True
        note(sorted(kinds), chunk)
        return inst

    notes_twin(case)


# ------------------------------------------------------ the instance itself
def test_instance_defaults_to_the_card():
    """``SiteWhereTpuInstance`` builds its engine on the card unless asked
    for the CPU: with no GPU visible, the default raises; with an engine
    given, that engine's device rules."""
    I = T.mod("instance.instance")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            I.SiteWhereTpuInstance(I.InstanceConfig())
    inst = I.SiteWhereTpuInstance(I.InstanceConfig(engine=T.EngineConfig(
        device_capacity=64, token_capacity=128, assignment_capacity=128,
        store_capacity=1024, batch_capacity=16, channels=4)), device="cpu")
    assert torch.device(inst.engine.device).type == "cpu"
    again = I.SiteWhereTpuInstance(I.InstanceConfig(), engine=inst.engine)
    assert again.engine is inst.engine


def test_debug_bundle_keys_match_jax_on_single_and_mesh_engines(pinned_servers):
    """The port's debug bundle carries the JAX package's blocks, the
    replication, forward, placement and shard-heat ones included, on the
    single engine and on the 2-shard mesh engine."""
    def bundles(P):
        tracing = P.mod("utils.tracing")
        single = make_instance(P).engine
        single.ingest_json_batch([json.dumps({
            "deviceToken": "b-1", "type": "DeviceMeasurement",
            "request": {"name": "t", "value": 1.0}}).encode()])
        single.flush()
        mesh = mesh_engine(P, n_shards=2)
        return [tracing.debug_bundle(e) for e in (single, mesh)]

    jb, tb = bundles(J), bundles(T)
    for j, t in zip(jb, tb):
        assert sorted(t) == sorted(j)
        assert t["replication"] == j["replication"] == {"clustered": False}
