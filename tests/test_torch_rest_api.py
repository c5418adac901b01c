"""Twins of ``tests/test_rest_api.py``: every case drives the JAX
instance's gateway and the port's (``device="cpu"``) with the same
requests, makes the JAX test's assertions on both, and holds the two runs
equal (``tests/torch_servers.py``): statuses, the headers that matter,
masked bodies, and the engines leaf for leaf."""

import re

import pytest

from tests.test_metrics_exposition import lint_prometheus
from tests.torch_servers import BOTH, J, T, pin_servers, run_twin


@pytest.fixture
def twin(monkeypatch):
    pin_servers(monkeypatch)
    return run_twin


def shape(x):
    """The structure of a document whose values are timings: its keys and
    the types of its leaves."""
    if isinstance(x, dict):
        return {k: shape(v) for k, v in x.items()}
    if isinstance(x, list):
        return [shape(v) for v in x]
    return type(x).__name__


def without_device_count(v: dict) -> dict:
    """``/api/system/version`` less ``deviceCount``: JAX counts the host
    devices the tests force (8), the port the visible GPUs (at least 1);
    pinned by ``test_system_version_device_count_diverges``."""
    return {k: x for k, x in v.items() if k != "deviceCount"}


def untimed(doc):
    """A flight-record document less its clock readings: ``startedMs`` and
    the values of ``stagesUs`` (their stage names stay)."""
    if isinstance(doc, list):
        return [untimed(d) for d in doc]
    if isinstance(doc, dict):
        return {k: (sorted(v) if k == "stagesUs" else
                    "<clock>" if k == "startedMs" else untimed(v))
                for k, v in doc.items()}
    return doc


def summary(doc: str) -> str:
    """A route summary less the JAX package's issue tags, which the port's
    docstrings drop, and with the profiler each package names."""
    doc = re.sub(r" \((?:ISSUE \d+|VERDICT r\d+)\)?", "", doc)
    return doc.replace("jax.profiler", "torch.profiler").rstrip(".")


def route_table(spec: dict) -> dict:
    """An OpenAPI document as ``{path: {method: summary}}`` (``summary``)."""
    return {"info": spec["info"], "openapi": spec["openapi"],
            "paths": {p: {m: summary(op["summary"]) for m, op in ops.items()}
                      for p, ops in spec["paths"].items()}}


def families(text: bytes | str) -> list[str]:
    """The metric families of a Prometheus exposition, by ``# TYPE`` line."""
    if isinstance(text, bytes):
        text = text.decode()
    return sorted(set(re.findall(r"^# TYPE (\S+)", text, re.M)))


def test_auth_flow(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop

        # bad credentials rejected
        async def bad_auth():
            import aiohttp

            async with aiohttp.ClientSession() as s:
                basic = base64.b64encode(b"admin:wrong").decode()
                async with s.get(
                    f"http://127.0.0.1:1/api/authapi/jwt"
                ) as r:  # pragma: no cover
                    pass

        status, _ = call("GET", "/api/instance")
        assert status == 200
        # no token -> 401
        async def no_token():
            import aiohttp

            async with aiohttp.ClientSession() as s:
                async with s.get(
                    f"http://127.0.0.1:{0}/api/devices"
                ) as r:  # pragma: no cover
                    return r.status

        # tampered token -> 401 (direct middleware check)
        status, body = call("GET", "/api/devices", headers={"Authorization": "Bearer x.y.z"})
        assert status == 401

    twin(case)


def test_device_lifecycle_over_rest(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        status, dt = call("POST", "/api/devicetypes",
                          {"token": "thermo", "name": "Thermostat"})
        assert status == 201
        status, dev = call("POST", "/api/devices",
                           {"token": "t-1", "deviceTypeToken": "thermo"})
        assert status == 201 and dev["device_type"] == "thermo"
        # duplicate -> conflict via engine get-or-create returns same id (200/201)
        status, listing = call("GET", "/api/devices")
        assert status == 200 and listing["numResults"] == 1

        # ingest events over REST
        status, _ = call("POST", "/api/devices/t-1/events",
                         {"type": "DeviceMeasurement",
                          "request": {"name": "temp", "value": 21.5}})
        assert status == 201
        status, _ = call("POST", "/api/devices/t-1/events",
                         {"type": "DeviceLocation",
                          "request": {"latitude": 33.7, "longitude": -84.4}})
        assert status == 201
        status, state = call("GET", "/api/devices/t-1/state")
        assert status == 200
        assert state["measurements"]["temp"]["value"] == 21.5
        assert state["presence"] == "PRESENT"

        status, events = call("GET", "/api/devices/t-1/events")
        assert status == 200 and events["total"] == 2
        status, events = call("GET", "/api/devices/t-1/events",
                              params={"type": "location"})
        assert events["total"] == 1
        # 404 for unknown device state
        status, _ = call("GET", "/api/devices/ghost/state")
        assert status == 404

    twin(case)


def test_commands_over_rest(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devicetypes", {"token": "pump", "name": "Pump"})
        call("POST", "/api/devices", {"token": "p-1", "deviceTypeToken": "pump"})
        status, cmd = call("POST", "/api/devicetypes/pump/commands",
                           {"token": "prime", "name": "prime",
                            "parameters": [{"name": "seconds", "type": "Int64",
                                            "required": True}]})
        assert status == 201
        # missing required parameter -> 400
        status, err = call("POST", "/api/devices/p-1/invocations",
                           {"commandToken": "prime", "parameterValues": {}})
        assert status == 400 and "required" in err["error"]
        # wire a local destination so delivery succeeds
        P = S.P
        CommandDestination, LocalDeliveryProvider, mqtt_topic_extractor = (
            P.CommandDestination, P.LocalDeliveryProvider, P.mqtt_topic_extractor)
        JsonCommandExecutionEncoder = P.JsonCommandExecutionEncoder
        SingleChoiceCommandRouter = P.SingleChoiceCommandRouter

        provider = LocalDeliveryProvider()
        inst.commands.router = SingleChoiceCommandRouter("local")
        inst.commands.add_destination(CommandDestination(
            "local", mqtt_topic_extractor(), JsonCommandExecutionEncoder(), provider))
        status, inv = call("POST", "/api/devices/p-1/invocations",
                           {"commandToken": "prime", "parameterValues": {"seconds": 5}})
        assert status == 201
        assert len(provider.delivered) == 1
        # batch over the same command
        call("POST", "/api/devices", {"token": "p-2", "deviceTypeToken": "pump"})
        status, op = call("POST", "/api/batch/command",
                          {"token": "op-1", "commandToken": "prime",
                           "deviceTokens": ["p-1", "p-2"],
                           "parameterValues": {"seconds": 1}})
        assert status == 201 and op["counts"]["SUCCEEDED"] == 2
        status, op = call("GET", "/api/batch/op-1")
        assert status == 200 and op["status"] == "Finished"

    twin(case)


def test_hierarchy_assets_labels_search(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/areatypes", {"token": "site", "name": "Site"})
        status, _ = call("POST", "/api/areas",
                         {"token": "atl", "areaTypeToken": "site", "name": "Atlanta"})
        assert status == 201
        status, _ = call("POST", "/api/zones",
                         {"token": "z1", "areaToken": "atl", "name": "Dock",
                          "bounds": [{"latitude": 1, "longitude": 2},
                                     {"latitude": 2, "longitude": 2},
                                     {"latitude": 2, "longitude": 3}]})
        assert status == 201
        status, zones = call("GET", "/api/areas/atl/zones")
        assert len(zones) == 1
        status, tree = call("GET", "/api/areas/tree")
        assert tree[0]["entity"]["token"] == "atl"

        status, _ = call("POST", "/api/assettypes", {"token": "truck", "name": "Truck"})
        status, _ = call("POST", "/api/assets",
                         {"token": "t17", "assetTypeToken": "truck", "name": "Truck 17"})
        assert status == 201

        status, png = call("GET", "/api/labels/device/any-device", raw=True)
        assert status == 200 and png[:8] == b"\x89PNG\r\n\x1a\n"

        # search: ingest an event, pump the indexing connector, query
        call("POST", "/api/devices", {"token": "s-1"})
        call("POST", "/api/devices/s-1/events",
             {"type": "DeviceMeasurement", "request": {"name": "rpm", "value": 900}})
        loop.run_until_complete(inst.pump_outbound())
        status, res = call("GET", "/api/search/events", params={"q": "deviceToken:s-1"})
        assert status == 200 and res["numResults"] == 1

    twin(case)


def test_groups_schedules_streams_tenants_users(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices", {"token": "g-1"})
        call("POST", "/api/devices", {"token": "g-2"})
        status, _ = call("POST", "/api/devicegroups",
                         {"token": "fleet", "name": "Fleet", "roles": ["all"]})
        assert status == 201
        status, _ = call("POST", "/api/devicegroups/fleet/elements",
                         {"elements": [{"device": "g-1"}, {"device": "g-2"}]})
        assert status == 201
        status, devices = call("GET", "/api/devicegroups/fleet/devices")
        assert devices == ["g-1", "g-2"]

        status, _ = call("POST", "/api/schedules",
                         {"token": "nightly", "name": "Nightly", "triggerType": "Cron",
                          "cron": "0 3 * * *"})
        assert status == 201
        status, err = call("POST", "/api/schedules",
                           {"token": "bad", "name": "Bad", "triggerType": "Cron"})
        assert status == 400

        status, _ = call("POST", "/api/devices/g-1/streams",
                         {"token": "cam", "contentType": "video/mp4"})
        assert status == 201
        status, _ = call("POST", "/api/streams/cam/chunks?sequence=1", raw=True,
                         json_body=None, headers={"Content-Type": "application/octet-stream"})
        status, content = call("GET", "/api/streams/cam/content", raw=True)
        assert status == 200

        # tenants + users (admin-only)
        status, t = call("POST", "/api/tenants",
                         {"token": "acme", "name": "ACME",
                          "datasetTemplate": "construction"})
        assert status == 201 and t["bootstrap_state"] == "Bootstrapped"
        # construction template seeded device types
        assert "acme-excavator" in inst.device_management.device_types

        status, u = call("POST", "/api/users",
                         {"username": "operator", "password": "secret",
                          "roles": ["user"]})
        assert status == 201
        status, auths = call("GET", "/api/users/operator/authorities")
        assert "VIEW_SERVER_INFORMATION" in auths

        # non-admin JWT cannot create users
        non_admin_jwt = inst.jwt.generate("operator", inst.users.authorities_for(
            inst.users.users["operator"]))
        status, err = call("POST", "/api/users",
                           {"username": "x", "password": "y"},
                           headers={"Authorization": f"Bearer {non_admin_jwt}"})
        assert status == 403

    twin(case)


@pytest.mark.parametrize("P", BOTH, ids=["jax", "port"])
def test_jwt_and_password_primitives(P):
    """The JAX test's checks on each package, and a token of one package
    validates under the other's service with the same secret."""
    auth = P.mod("instance.auth")
    JwtService, JwtError = auth.JwtService, auth.JwtError
    hash_password, verify_password = auth.hash_password, auth.verify_password
    svc = JwtService(secret=b"k" * 32, expiration_s=60)
    token = svc.generate("alice", ["A", "B"], tenant="t1")
    claims = svc.validate(token)
    assert claims["sub"] == "alice" and claims["tenant"] == "t1"
    with pytest.raises(JwtError, match="signature"):
        svc.validate(token[:-4] + "AAAA")
    with pytest.raises(JwtError, match="malformed"):
        svc.validate("nope")
    expired = JwtService(secret=b"k" * 32, expiration_s=-10)
    with pytest.raises(JwtError, match="expired"):
        expired.validate(expired.generate("bob", []))
    # wrong key
    other = JwtService(secret=b"j" * 32)
    with pytest.raises(JwtError):
        other.validate(token)

    h = hash_password("hunter2")
    assert verify_password("hunter2", h)
    assert not verify_password("hunter3", h)
    assert not verify_password("hunter2", "garbage")
    # the same secret signs the same claims the same way in both packages
    other_pkg = T if P is J else J
    twin_svc = other_pkg.mod("instance.auth").JwtService(secret=b"k" * 32,
                                                         expiration_s=60)
    assert twin_svc.validate(token) == claims
    assert other_pkg.mod("instance.auth").verify_password("hunter2", h)


def test_assignments_over_rest(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devicetypes", {"token": "meter", "name": "Meter"})
        call("POST", "/api/devices", {"token": "m-1", "deviceTypeToken": "meter"})

        # registering a device creates a default ACTIVE assignment
        status, existing = call("GET", "/api/devices/m-1/assignments")
        assert status == 200 and len(existing) == 1
        assert existing[0]["status"] == "ACTIVE"

        # attach a second assignment with an explicit token
        status, a = call("POST", "/api/assignments",
                         {"deviceToken": "m-1", "token": "m-1-winter",
                          "areaToken": "plant-a"})
        assert status == 201 and a["token"] == "m-1-winter"
        status, got = call("GET", "/api/assignments/m-1-winter")
        assert status == 200 and got["areaToken"] == "plant-a"

        # events now expand to both active assignments
        call("POST", "/api/devices/m-1/events",
             {"type": "DeviceMeasurement", "request": {"name": "kwh", "value": 5.0}})
        status, evs = call("GET", "/api/assignments/m-1-winter/events")
        assert status == 200 and evs["total"] == 1

        # mark missing keeps it active; end releases + detaches the slot
        status, a = call("POST", "/api/assignments/m-1-winter/missing")
        assert status == 200 and a["status"] == "MISSING"
        status, a = call("POST", "/api/assignments/m-1-winter/end")
        assert status == 200 and a["status"] == "RELEASED"
        assert a["releasedDateMs"] is not None
        status, active = call("GET", "/api/assignments",
                              params={"deviceToken": "m-1", "status": "ACTIVE"})
        assert status == 200 and len(active) == 1

        # released assignment no longer receives expanded events
        call("POST", "/api/devices/m-1/events",
             {"type": "DeviceMeasurement", "request": {"name": "kwh", "value": 6.0}})
        status, evs = call("GET", "/api/assignments/m-1-winter/events")
        assert evs["total"] == 1

        # unknown device / assignment -> 404
        status, _ = call("POST", "/api/assignments", {"deviceToken": "ghost"})
        assert status == 404
        status, _ = call("GET", "/api/assignments/ghost")
        assert status == 404

    twin(case)


def test_crud_update_delete_over_rest(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devicetypes", {"token": "cam", "name": "Camera"})
        status, dt = call("PUT", "/api/devicetypes/cam",
                          {"name": "IP Camera", "description": "PoE"})
        assert status == 200 and dt["name"] == "IP Camera"

        call("POST", "/api/devices", {"token": "c-1", "deviceTypeToken": "cam"})
        call("POST", "/api/areatypes", {"token": "site", "name": "Site"})
        call("POST", "/api/areas", {"token": "hq", "areaTypeToken": "site",
                                    "name": "HQ"})
        status, dev = call("PUT", "/api/devices/c-1",
                           {"areaToken": "hq", "metadata": {"rack": "r7"}})
        assert status == 200 and dev["area"] == "hq"

        # asset type + asset get/update/delete
        call("POST", "/api/assettypes", {"token": "person", "name": "Person"})
        call("POST", "/api/assets", {"token": "bob", "assetTypeToken": "person",
                                     "name": "Bob"})
        status, a = call("PUT", "/api/assets/bob", {"name": "Robert"})
        assert status == 200 and a["name"] == "Robert"
        status, a = call("GET", "/api/assets/bob")
        assert a["name"] == "Robert"
        status, _ = call("DELETE", "/api/assets/bob")
        assert status == 200
        status, _ = call("GET", "/api/assets/bob")
        assert status == 404

        # delete propagates 404 afterwards across stores
        status, _ = call("DELETE", "/api/devicetypes/cam")
        assert status == 200
        status, _ = call("GET", "/api/devicetypes/cam")
        assert status == 404

    twin(case)


def test_roles_system_and_state_search(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        # roles / authorities (Roles.java / Authorities.java analogs)
        status, roles = call("GET", "/api/roles")
        assert status == 200 and {r["role"] for r in roles} >= {"admin", "user"}
        status, _ = call("POST", "/api/roles",
                         {"role": "operator", "authorities": ["VIEW_SERVER_INFORMATION"]})
        assert status == 201
        status, auths = call("GET", "/api/authorities")
        assert status == 200 and "ADMINISTER_USERS" in auths

        # user get/update/delete
        call("POST", "/api/users", {"username": "carol", "password": "pw",
                                    "roles": ["user"]})
        status, u = call("PUT", "/api/users/carol", {"roles": ["operator"]})
        assert status == 200 and u["roles"] == ["operator"]
        status, _ = call("DELETE", "/api/users/carol")
        assert status == 200
        status, _ = call("GET", "/api/users/carol")
        assert status == 404

        # system version (System.java analog)
        status, v = call("GET", "/api/system/version", keep=without_device_count)
        assert status == 200 and v["edition"] == "SiteWhere-TPU"

        # device-state search (DeviceStates.java POST /search analog)
        call("POST", "/api/devices", {"token": "s-1", "deviceTypeToken": "default"})
        call("POST", "/api/devices/s-1/events",
             {"type": "DeviceMeasurement", "request": {"name": "t", "value": 1.0}})
        status, res = call("POST", "/api/devicestates/search",
                           {"presence": "PRESENT"})
        assert status == 200 and res["numResults"] == 1
        assert res["results"][0]["device"] == "s-1"
        status, res = call("POST", "/api/devicestates/search",
                           {"deviceTokens": ["nope"]})
        assert res["numResults"] == 0

        # command invocation retained queries (CommandInvocations.java analog)
        call("POST", "/api/devicetypes/default/commands",
             {"token": "ping", "name": "ping"})
        status, inv = call("POST", "/api/devices/s-1/invocations",
                           {"commandToken": "ping"})
        assert status == 201
        inv_id = inv["invocationId"]
        status, got = call("GET", f"/api/invocations/{inv_id}")
        assert status == 200 and got["commandToken"] == "ping"
        # device posts a response naming the invocation id
        call("POST", "/api/devices/s-1/events",
             {"type": "DeviceCommandResponse",
              "request": {"originatingEventId": str(inv_id), "response": "pong"}})
        status, resp = call("GET", f"/api/invocations/{inv_id}/responses")
        assert status == 200 and len(resp) == 1

    twin(case)


def test_trace_endpoints(twin):
    """Flight recorder REST surface (PR 3): a batch id returned by ingest
    resolves to a complete lifecycle record via /api/instance/trace/<id>,
    and /recent lists it."""
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        rows = [
            {"deviceToken": f"tr-{i % 2}", "type": "DeviceMeasurement",
             "request": {"name": "t", "value": float(i)}}
            for i in range(6)
        ]
        status, res = call("POST", "/api/events/batch", rows)
        assert status == 201
        tid = res["trace_id"]
        assert tid
        status, trace = call("GET", f"/api/instance/trace/{tid}", keep=untimed)
        assert status == 200 and trace["traceId"] == tid
        stages = trace["records"][0]["stagesUs"]
        for name in ("decode", "commit", "dispatch", "device_ready",
                     "readback"):
            assert name in stages, stages
        status, recent = call("GET", "/api/instance/trace/recent", keep=untimed)
        assert status == 200
        assert any(r["traceId"] == tid for r in recent)
        status, _ = call("GET", "/api/instance/trace/" + "0" * 32)
        assert status == 404
        status, _ = call("GET", "/api/instance/trace/recent",
                         params={"limit": "nope"})
        assert status == 400

    twin(case)


def test_span_plane_endpoints(twin):
    """Span-plane REST surface: /trace/<id>/timeline serves a
    Perfetto-loadable Chrome-trace document, /profile serves folded
    stacks (flamegraph.pl-ready) or structured JSON, and /debug/bundle
    is one self-contained triage snapshot whose embedded exposition
    stays on the strict 0.0.4 surface — lint-clean, NO exemplar syntax.
    Timings and sampled stacks are compared by their shape."""
    def case(S):
        call = S.call
        rows = [
            {"deviceToken": f"sp-{i % 2}", "type": "DeviceMeasurement",
             "request": {"name": "t", "value": float(i)}}
            for i in range(6)
        ]
        status, res = call("POST", "/api/events/batch", rows)
        assert status == 201
        tid = res["trace_id"]
        # stitched timeline document: root lifecycle + stage intervals,
        # numeric pids/tids with naming metadata (chrome://tracing loads it)
        status, doc = call("GET", f"/api/instance/trace/{tid}/timeline",
                           keep=lambda d: sorted(
                               {(e["ph"], e["name"]) for e in d["traceEvents"]}))
        assert status == 200 and doc["traceId"] == tid
        xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
        assert {"ingest", "ingest.decode", "ingest.device"} <= \
            {e["name"] for e in xs}
        assert any(e["name"] == "process_name" for e in doc["traceEvents"])
        status, _ = call("GET", "/api/instance/trace/" + "0" * 32 + "/timeline")
        assert status == 404
        # profiler: folded stacks by default, JSON on request, clamped input
        status, folded = call("GET", "/api/instance/profile",
                              params={"seconds": "0.1"}, raw=True,
                              keep=lambda b: bool(b.strip()))
        assert status == 200
        for line in folded.decode().strip().splitlines():
            stack, n = line.rsplit(" ", 1)
            assert ";" in stack and int(n) >= 1
        status, prof = call("GET", "/api/instance/profile",
                            params={"seconds": "0.1", "format": "json"},
                            keep=sorted)
        assert status == 200 and prof["samples"] >= 1
        status, _ = call("GET", "/api/instance/profile",
                         params={"seconds": "nope"})
        assert status == 400
        # debug bundle: self-contained, exposition lint-clean, exemplar-free
        status, bundle = call("GET", "/api/instance/debug/bundle", keep=sorted)
        assert status == 200
        assert bundle["flights"] and bundle["config"]
        assert any(t["traceId"] == tid for t in bundle["slowestTraces"])
        lint_prometheus(bundle["prometheus"])
        assert "# {" not in bundle["prometheus"]
        S.note(sorted(bundle["config"]), shape(bundle["flights"][-1]))

    twin(case)


def test_prometheus_exposition_lints_over_rest(twin):
    """The full /api/instance/metrics/prometheus payload passes the
    promtool-style structural lint on both packages; the engine's own
    families are the same."""
    def case(S):
        rows = [{"deviceToken": "px-1", "type": "DeviceMeasurement",
                 "request": {"name": "t", "value": 1.0}}]
        status, _ = S.call("POST", "/api/events/batch", rows)
        assert status == 201
        status, body = S.call("GET", "/api/instance/metrics/prometheus",
                              raw=True, keep=lambda b: [
                                  f for f in families(b)
                                  if f.startswith("swtpu_engine_")])
        assert status == 200
        lint_prometheus(body.decode())

    twin(case)

def test_batch_ingest_and_openapi(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        rows = [
            {"deviceToken": f"bi-{i % 4}", "type": "DeviceMeasurement",
             "request": {"name": "t", "value": float(i)}}
            for i in range(20)
        ]
        status, res = call("POST", "/api/events/batch", rows)
        assert status == 201 and res["decoded"] == 20 and res["failed"] == 0
        status, ev = call("GET", "/api/events")
        assert ev["total"] == 20

        # malformed body -> 400, and bad rows count as failed decodes
        status, _ = call("POST", "/api/events/batch", {"not": "a list"})
        assert status == 400
        status, res = call("POST", "/api/events/batch",
                           [{"type": "DeviceMeasurement", "request": {}}])
        assert status == 201 and res["failed"] == 1

        status, spec = call("GET", "/api/openapi.json", keep=route_table)
        assert status == 200 and spec["openapi"] == "3.0.0"
        assert "/api/devices" in spec["paths"]
        assert "post" in spec["paths"]["/api/events/batch"]
        assert len(spec["paths"]) > 60

    twin(case)


def test_device_mapping_and_nested_routing(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices", {"token": "gw-1"})
        call("POST", "/api/devices", {"token": "leaf-1"})

        status, res = call("POST", "/api/devices/leaf-1/parent",
                           {"parentToken": "gw-1"})
        assert status == 201 and res["parentToken"] == "gw-1"
        # unknown parent -> 404; self-parent -> 400
        status, _ = call("POST", "/api/devices/leaf-1/parent",
                         {"parentToken": "ghost"})
        assert status == 404
        status, _ = call("POST", "/api/devices/gw-1/parent",
                         {"parentToken": "gw-1"})
        assert status == 400

        # MapDevice ingest envelope takes the same path
        status, _ = call("POST", "/api/devices/leaf-1/events",
                         {"type": "MapDevice",
                          "request": {"parentToken": "gw-1"}})
        assert status == 201

        # nested command routing resolves to the gateway parent
        NestedDeviceSupport = S.mod("commands.routing").NestedDeviceSupport

        nested = NestedDeviceSupport(inst.engine)
        assert nested.resolve_target_token("leaf-1") == "gw-1"
        # on-device parent column mirrors the mapping
        import numpy as np

        tid = inst.engine.tokens.lookup("leaf-1")
        did = inst.engine.token_device[tid]
        pdid = int(inst.engine.state.registry.device_parent[did])
        assert inst.engine.devices[pdid].token == "gw-1"

    twin(case)


def test_batch_operation_listing(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devicetypes/default/commands",
             {"token": "blink", "name": "blink"})
        call("POST", "/api/devices", {"token": "bl-1"})
        call("POST", "/api/batch/command",
             {"token": "op-1", "deviceTokens": ["bl-1"], "commandToken": "blink"})
        status, listing = call("GET", "/api/batch")
        assert status == 200 and listing["numResults"] == 1
        assert listing["results"][0]["token"] == "op-1"
        assert listing["results"][0]["status"] == "Finished"

    twin(case)


def test_assignment_put_delete_over_rest(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices", {"token": "ap-1"})
        status, a = call("POST", "/api/assignments",
                         {"deviceToken": "ap-1", "token": "ap-1-extra"})
        assert status == 201
        # PUT updates associations + metadata
        status, a = call("PUT", "/api/assignments/ap-1-extra",
                         {"areaToken": "plant-a", "assetToken": "pump-7",
                          "metadata": {"k": "v"}})
        assert status == 200
        assert a["areaToken"] == "plant-a" and a["assetToken"] == "pump-7"
        assert a["metadata"] == {"k": "v"}
        # criteria filters on the listing surface see the update
        status, listing = call("GET", "/api/assignments",
                               params={"assetToken": "pump-7"})
        assert status == 200 and [x["token"] for x in listing] == ["ap-1-extra"]
        # DELETE removes it; device keeps its default assignment
        status, body = call("DELETE", "/api/assignments/ap-1-extra")
        assert status == 200 and body["deleted"]
        status, _ = call("GET", "/api/assignments/ap-1-extra")
        assert status == 404
        status, listing = call("GET", "/api/assignments",
                               params={"deviceToken": "ap-1"})
        assert status == 200 and len(listing) == 1
        # PUT on a missing assignment -> 404
        status, _ = call("PUT", "/api/assignments/nope", {"areaToken": "x"})
        assert status == 404

    twin(case)


def test_batch_elements_and_criteria_over_rest(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devicetypes", {"token": "valve", "name": "Valve"})
        call("POST", "/api/devicetypes", {"token": "pump", "name": "Pump"})
        for i in range(3):
            call("POST", "/api/devices",
                 {"token": f"bv-{i}", "deviceTypeToken": "valve"})
        call("POST", "/api/devices", {"token": "bp-0", "deviceTypeToken": "pump"})
        call("POST", "/api/devicetypes/valve/commands",
             {"token": "close", "name": "close"})
        call("POST", "/api/devicetypes/pump/commands",
             {"token": "close", "name": "close"})

        # by device criteria: only the valves
        status, op = call("POST", "/api/batch/command/criteria/device",
                          {"deviceTypeToken": "valve", "commandToken": "close"})
        assert status == 201
        assert op["counts"] == {"SUCCEEDED": 3} or op["counts"].get("SUCCEEDED") == 3

        # element listing is paged + filterable by status
        status, els = call("GET", f"/api/batch/{op['token']}/elements")
        assert status == 200 and els["numResults"] == 3
        assert {e["device_token"] for e in els["results"]} == {"bv-0", "bv-1", "bv-2"}
        status, els = call("GET", f"/api/batch/{op['token']}/elements",
                           params={"status": "failed"})
        assert status == 200 and els["numResults"] == 0
        status, page2 = call("GET", f"/api/batch/{op['token']}/elements",
                             params={"page": "2", "pageSize": "2"})
        assert page2["numResults"] == 3 and len(page2["results"]) == 1

        # by assignment criteria: area-scoped
        call("PUT", "/api/assignments/" +
             inst.engine.list_assignments(device_token="bp-0")[0].token,
             {"areaToken": "zone-9"})
        status, op2 = call("POST", "/api/batch/command/criteria/assignment",
                           {"areaToken": "zone-9", "commandToken": "close"})
        assert status == 201
        status, els = call("GET", f"/api/batch/{op2['token']}/elements")
        assert {e["device_token"] for e in els["results"]} == {"bp-0"}

        # criteria matching nothing -> 400
        status, _ = call("POST", "/api/batch/command/criteria/device",
                         {"deviceTypeToken": "nonexistent", "commandToken": "close"})
        assert status == 400

    twin(case)


def test_command_status_crud_per_token(twin):
    """GET/PUT/DELETE for commands and statuses under their device type
    (reference: DeviceTypes.java /{token}/commands/{commandToken},
    /{token}/statuses/{statusToken})."""
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devicetypes", json_body={"token": "dt-1", "name": "DT"})
        s, _ = call("POST", "/api/devicetypes/dt-1/commands", json_body={
            "token": "cmd-1", "name": "reboot",
            "parameters": [{"name": "delay", "type": "Int64"}]})
        assert s == 201
        s, body = call("GET", "/api/devicetypes/dt-1/commands/cmd-1")
        assert s == 200 and body["name"] == "reboot"
        s, body = call("PUT", "/api/devicetypes/dt-1/commands/cmd-1",
                       json_body={"description": "restart the device"})
        assert s == 200 and body["description"] == "restart the device"
        # wrong device type -> 404
        s, _ = call("GET", "/api/devicetypes/other/commands/cmd-1")
        assert s == 404
        s, body = call("DELETE", "/api/devicetypes/dt-1/commands/cmd-1")
        assert s == 200 and body["deleted"]
        s, _ = call("GET", "/api/devicetypes/dt-1/commands/cmd-1")
        assert s == 404

        s, _ = call("POST", "/api/devicetypes/dt-1/statuses", json_body={
            "token": "st-1", "code": "ok", "name": "OK"})
        assert s == 201
        s, body = call("GET", "/api/devicetypes/dt-1/statuses/st-1")
        assert s == 200
        s, body = call("PUT", "/api/devicetypes/dt-1/statuses/st-1",
                       json_body={"name": "All good"})
        assert s == 200 and body["name"] == "All good"
        s, body = call("DELETE", "/api/devicetypes/dt-1/statuses/st-1")
        assert s == 200 and body["deleted"]
        s, _ = call("GET", "/api/devicetypes/dt-1/statuses/st-1")
        assert s == 404

    twin(case)


def test_group_element_delete(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices", json_body={"token": "ge-1"})
        call("POST", "/api/devices", json_body={"token": "ge-2"})
        call("POST", "/api/devicegroups", json_body={"token": "g-1", "name": "G"})
        s, els = call("POST", "/api/devicegroups/g-1/elements", json_body={
            "elements": [{"device": "ge-1"}, {"device": "ge-2"}]})
        assert s == 201
        ids = [e["element_id"] for e in els]
        s, body = call("DELETE", f"/api/devicegroups/g-1/elements/{ids[0]}")
        assert s == 200 and body["deleted"]
        s, body = call("GET", "/api/devicegroups/g-1/elements")
        assert len(body) == 1
        s, body = call("DELETE", "/api/devicegroups/g-1/elements",
                       json_body=[ids[1]])
        assert s == 200 and body["deleted"] == 1
        s, _ = call("DELETE", f"/api/devicegroups/g-1/elements/{ids[0]}")
        assert s == 404

    twin(case)


def test_event_lookup_by_id_and_alternate(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices/ev-1/events", json_body={
            "deviceToken": "ev-1", "type": "DeviceMeasurement",
            "request": {"name": "temp", "value": 7.5, "alternateId": "alt-99"}})
        inst.engine.flush()
        s, body = call("GET", "/api/events/alternate/alt-99")
        assert s == 200 and body["measurements"]["temp"] == 7.5
        s, _ = call("GET", "/api/events/alternate/no-such")
        assert s == 404
        s, body = call("GET", "/api/events/id/0")
        assert s == 200 and body["type"] == "MEASUREMENT"
        s, _ = call("GET", "/api/events/id/999999")
        assert s == 404

    twin(case)


def test_area_customer_event_rollups(twin):
    """Per-area and per-customer event rollups come from the on-device
    area/customer store lanes (reference: Areas.java:{token}/measurements)."""
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/areatypes", json_body={"token": "at", "name": "AT"})
        call("POST", "/api/areas", json_body={
            "token": "plant", "areaType": "at", "name": "Plant"})
        call("POST", "/api/customertypes", json_body={"token": "ct", "name": "CT"})
        call("POST", "/api/customers", json_body={
            "token": "acme", "customerType": "ct", "name": "ACME"})
        inst.engine.register_device("roll-1", area="plant", customer="acme")
        inst.engine.register_device("roll-2")   # no area/customer
        for tok in ("roll-1", "roll-2"):
            call("POST", f"/api/devices/{tok}/events", json_body={
                "deviceToken": tok, "type": "DeviceMeasurement",
                "request": {"name": "t", "value": 1.0}})
        inst.engine.flush()
        s, body = call("GET", "/api/areas/plant/measurements")
        assert s == 200 and body["numResults"] == 1
        assert body["results"][0]["deviceToken"] == "roll-1"
        s, body = call("GET", "/api/customers/acme/measurements")
        assert s == 200 and body["numResults"] == 1
        s, body = call("GET", "/api/areas/plant/alerts")
        assert s == 200 and body["numResults"] == 0
        s, body = call("GET", "/api/areas/plant/assignments")
        assert s == 200 and len(body) == 1
        s, _ = call("GET", "/api/areas/plant/bogus")
        assert s == 404

    twin(case)


def test_device_summaries_group_listings_mappings(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices", json_body={"token": "sum-1"})
        call("POST", "/api/devices", json_body={"token": "sum-2"})
        s, body = call("GET", "/api/devices/summaries")
        assert s == 200 and len(body) >= 2
        call("POST", "/api/devicegroups", json_body={
            "token": "sg", "name": "SG", "roles": ["prod"]})
        call("POST", "/api/devicegroups/sg/elements",
             json_body={"elements": [{"device": "sum-1", "roles": ["prod"]}]})
        s, body = call("GET", "/api/devices/group/sg")
        assert s == 200 and body == ["sum-1"]
        s, body = call("GET", "/api/devices/grouprole/prod")
        assert s == 200 and body == ["sum-1"]
        # parent mappings
        call("POST", "/api/devices/sum-2/parent", json_body={"parentToken": "sum-1"})
        s, body = call("GET", "/api/devices/sum-2/mappings")
        assert s == 200 and body["parentToken"] == "sum-1"
        s, body = call("DELETE", "/api/devices/sum-2/mappings")
        assert s == 200 and body["parentToken"] is None
        s, body = call("GET", "/api/devices/sum-2/mappings")
        assert s == 200 and body == {}

    twin(case)


def test_invocation_summary(twin):
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/devices", json_body={"token": "is-1"})
        call("POST", "/api/devicetypes/default/commands", json_body={
            "token": "ping", "name": "ping"})
        s, inv = call("POST", "/api/devices/is-1/invocations",
                      json_body={"commandToken": "ping"})
        assert s in (200, 201)
        inv_id = inv["invocationId"] if "invocationId" in inv else inv.get("id")
        s, body = call("GET", f"/api/invocations/{inv_id}/summary")
        assert s == 200 and body["invocation"]["command_token"] == "ping"
        assert body["responses"] == []
        # a device response must surface in the summary (ADVICE r2: responses
        # store aux0 = interner id of originatingEventId, not the raw counter)
        call("POST", "/api/devices/is-1/events", json_body={
            "type": "DeviceCommandResponse",
            "request": {"originatingEventId": str(inv_id), "response": "pong"}})
        s, body = call("GET", f"/api/invocations/{inv_id}/summary")
        assert s == 200 and len(body["responses"]) == 1

    twin(case)


def test_tenant_templates_endpoints(twin):
    """VERDICT r2 missing #5: Tenants.java /templates/configuration and
    /templates/dataset."""
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        s, body = call("GET", "/api/tenants/templates/configuration")
        assert s == 200 and {t["id"] for t in body} >= {"default", "mqtt"}
        assert all("configuration" in t and "description" in t for t in body)
        s, body = call("GET", "/api/tenants/templates/dataset")
        assert s == 200
        ids = {t["id"] for t in body}
        assert ids >= {"empty", "construction"}
        # a listed configuration template actually applies
        apply_tenant_config = S.mod("config").apply_tenant_config
        s, cfg_tpls = call("GET", "/api/tenants/templates/configuration")
        tpl = next(t for t in cfg_tpls if t["id"] == "default")
        summary = apply_tenant_config(inst, tpl["configuration"])
        assert summary["eventSources"] == ["default-in"]
        # /api/tenants/{token} still resolves normal tokens
        s, body = call("GET", "/api/tenants/default")
        assert s == 200 and body["token"] == "default"

    twin(case)


def test_user_role_mutation(twin):
    """VERDICT r2 missing #5: Users.java @PUT/@DELETE /{username}/roles."""
    def case(S):
        call, inst, loop = S.call, S.inst, S.loop
        call("POST", "/api/users", {"username": "roley", "password": "pw",
                                    "roles": ["user"]})
        s, body = call("GET", "/api/users/roley/roles")
        assert s == 200 and body["results"] == ["user"]
        s, body = call("PUT", "/api/users/roley/roles", ["admin"])
        assert s == 200 and set(body["roles"]) == {"user", "admin"}
        # adding an existing role is idempotent
        s, body = call("PUT", "/api/users/roley/roles", ["admin"])
        assert s == 200 and body["roles"].count("admin") == 1
        # unknown role rejected
        s, body = call("PUT", "/api/users/roley/roles", ["ghost-role"])
        assert s == 400
        s, body = call("DELETE", "/api/users/roley/roles", ["user"])
        assert s == 200 and body["roles"] == ["admin"]
        # empty list is an error (reference: InvalidUserInformation)
        s, body = call("PUT", "/api/users/roley/roles", [])
        assert s == 400
        s, body = call("GET", "/api/users/ghost/roles")
        assert s == 404
        # advisor r3 (low): a non-admin may read their OWN roles but cannot
        # enumerate another user's (the mutations are admin-only already)
        call("POST", "/api/users", {"username": "peeker", "password": "pw",
                                    "roles": ["user"]})
        peeker_jwt = inst.jwt.generate("peeker", inst.users.authorities_for(
            inst.users.users["peeker"]))
        hdr = {"Authorization": f"Bearer {peeker_jwt}"}
        s, body = call("GET", "/api/users/peeker/roles", headers=hdr)
        assert s == 200 and body["results"] == ["user"]
        s, body = call("GET", "/api/users/roley/roles", headers=hdr)
        assert s == 403
        # ...and the sibling read paths that expose the same data share the gate
        s, _ = call("GET", "/api/users/roley", headers=hdr)
        assert s == 403
        s, _ = call("GET", "/api/users/roley/authorities", headers=hdr)
        assert s == 403
        s, _ = call("GET", "/api/users", headers=hdr)
        assert s == 403
        s, _ = call("GET", "/api/users/peeker", headers=hdr)
        assert s == 200
        s, _ = call("GET", "/api/users/peeker/authorities", headers=hdr)
        assert s == 200

    twin(case)


def test_system_version_device_count_diverges(twin):
    """The one field of ``/api/system/version`` that differs: JAX reports
    ``jax.device_count()`` (the tests force 8 CPU devices), the port
    ``torch.cuda.device_count()`` on a card instance and 1 on a CPU
    instance, whatever cards the machine has; both say ``cpu`` here."""
    from unittest import mock

    import torch

    def case(S):
        status, v = S.call("GET", "/api/system/version", keep=without_device_count)
        assert status == 200 and v["backend"] == "cpu"
        assert v["deviceCount"] == (1 if S.P.port else 8)
        if S.P.port:    # a CPU instance on a machine with four cards
            with mock.patch.object(torch.cuda, "device_count", lambda: 4):
                status, v = S.call("GET", "/api/system/version")
            S.log.pop()     # the port's extra call stays out of the twin log
            assert status == 200 and (v["backend"], v["deviceCount"]) == ("cpu", 1)

    twin(case)
