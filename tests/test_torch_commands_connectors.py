"""The port's downlink, outbound connectors and event search (``commands/``,
``connectors/``, ``search/``) held to the JAX package's.

Every case of ``tests/test_commands_connectors.py`` and
``tests/test_aws_sqs.py``, the connector cases ``tests/test_amqp.py:190``
and ``tests/test_eventhub.py:157``, ``tests/test_ingest.py:829`` and
``tests/test_distributed.py:294`` run on both packages: the JAX services
over a JAX engine and the port's over ``Engine(device="cpu")`` (the mesh
case over each package's ``DistributedEngine``), engine clocks and the
invocation counters pinned. Deliveries must be equal byte for byte, sink
events, dead letters and search hits in plain form, and the engines leaf
for leaf, besides the JAX test's own assertions. The SigV4 date is pinned
by ``amz_date``; the SQS connector's request goes to one local server from
both packages, so its signed headers must match too.
"""

import asyncio
import functools
import json
import urllib.parse

import pytest

from tests.test_distributed import meas_payload
from tests.test_torch_distributed import assert_engines_equal
from tests.test_torch_distributed import engines as dist_engines
from tests.torch_parity import plain
from tests.torch_services import (BOTH, J, T, engine, measure, pin_services, twin,
                                  twin_engines)

AMZ_DATE = "20250101T000000Z"


@pytest.fixture(autouse=True)
def _pinned(monkeypatch):
    pin_services(monkeypatch)


def _service(P, eng, router=None):
    svc = P.CommandDeliveryService(eng, router or P.SingleChoiceCommandRouter("local"))
    svc.registry.create(P.DeviceCommand(
        token="reboot", device_type="default", name="reboot",
        parameters=(P.CommandParameter("delay", P.ParameterType.INT64, required=True),)))
    provider = P.LocalDeliveryProvider()
    svc.add_destination(P.CommandDestination(
        "local", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(), provider))
    return svc, provider


def _event(P, **kw):
    base = dict(event_id=1, etype=P.EventType.MEASUREMENT, device_token="d-1",
                device_id=0, assignment_id=0, tenant="default", area_id=0, asset_id=0,
                ts_ms=1000, received_ms=1001, measurements={"temp": 20.5},
                values=[20.5], aux0=0, aux1=0)
    return P.OutboundEvent(**{**base, **kw})


# ------------------------------------------------------------- command delivery

def test_command_invoke_end_to_end():
    def run(P):
        eng = engine(P)
        measure(P, eng, "dev-1")
        eng.flush()
        svc, provider = _service(P, eng)
        inv = svc.invoke("dev-1", "reboot", {"delay": 5})
        assert asyncio.run(svc.pump()) == 1
        assert len(provider.delivered) == 1
        token, payload, system = provider.delivered[0]
        assert token == "dev-1" and not system
        body = json.loads(payload)
        assert body["command"] == "reboot"
        assert body["parameters"] == {"delay": 5}
        assert body["invocationId"] == inv.invocation_id
        st = eng.get_device_state("dev-1")
        assert st["event_counts"]["COMMAND_INVOCATION"] == 1
        return {"inv": inv, "delivered": provider.delivered, "state": st,
                "count": svc.delivered_count}, eng

    twin_engines(run)


def test_command_validation_and_unknown():
    def run(P):
        eng = engine(P)
        measure(P, eng, "dev-1")
        eng.flush()
        svc, _ = _service(P, eng)
        errors = []
        for params, match in (({}, "missing required parameter"),
                              ({"delay": 1, "bogus": 2}, "unknown parameters")):
            with pytest.raises(ValueError, match=match) as e:
                svc.invoke("dev-1", "reboot", params)
            errors.append(str(e.value))
        with pytest.raises(ValueError, match="unknown command") as e:
            svc.invoke("dev-1", "nope", {})
        errors.append(str(e.value))
        return errors, eng

    twin_engines(run)


def test_command_undelivered_dead_letter():
    def run(P):
        eng = engine(P)
        measure(P, eng, "dev-1")
        eng.flush()
        svc, provider = _service(P, eng)
        provider.fail = True
        svc.invoke("dev-1", "reboot", {"delay": 1})
        asyncio.run(svc.pump())
        assert len(svc.undelivered) == 1
        assert svc.undelivered[0].destination_id == "local"
        svc2, _ = _service(P, eng, P.SingleChoiceCommandRouter("missing"))
        svc2.invoke("dev-1", "reboot", {"delay": 1})
        asyncio.run(svc2.pump())
        assert svc2.undelivered[0].error == "unknown destination"
        eng.flush()
        return {"a": svc.undelivered, "b": svc2.undelivered}, eng

    twin_engines(run)


def test_device_type_router_and_nested_target():
    def run(P):
        eng = engine(P)
        eng.register_device("gw-1", device_type="gateway")
        eng.register_device("child-1", device_type="sensor",
                            metadata={"parentToken": "gw-1"})
        svc = P.CommandDeliveryService(eng, P.DeviceTypeMappingCommandRouter(
            {"sensor": "local"}))
        svc.registry.create(P.DeviceCommand(token="ping", device_type="sensor",
                                            name="ping"))
        provider = P.LocalDeliveryProvider()
        svc.add_destination(P.CommandDestination(
            "local", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(), provider))
        svc.invoke("child-1", "ping")
        asyncio.run(svc.pump())
        assert provider.delivered[0][0] == "gw-1"
        return provider.delivered, eng

    twin_engines(run)


def test_mqtt_command_destination_end_to_end():
    """Over each package's embedded MQTT broker: the device receives the
    same binary execution bytes."""
    def run(P):
        async def go():
            broker = P.MqttBroker()
            await broker.start()
            eng = engine(P)
            measure(P, eng, "dev-9")
            eng.flush()
            svc = P.CommandDeliveryService(eng, P.SingleChoiceCommandRouter("mqtt"))
            svc.registry.create(P.DeviceCommand(token="blink", device_type="default",
                                                name="blink"))
            svc.add_destination(P.CommandDestination(
                "mqtt", P.mqtt_topic_extractor(), P.BinaryCommandExecutionEncoder(),
                P.MqttDeliveryProvider("127.0.0.1", broker.bound_port)))
            got: list[bytes] = []
            device = P.MqttClient("127.0.0.1", broker.bound_port, "device-9")
            await device.connect()
            device.on_message = lambda t, p: got.append((t, p))
            await device.subscribe("sitewhere/commands/dev-9")
            svc.invoke("dev-9", "blink")
            await svc.pump()
            for _ in range(100):
                if got:
                    break
                await asyncio.sleep(0.01)
            await device.disconnect()
            for dest in svc.destinations.values():
                await dest.stop()
            await broker.stop()
            return got, eng

        got, eng = asyncio.run(go())
        assert len(got) == 1
        assert got[0][1][1] == 1      # binary kind = user
        return got, eng

    twin_engines(run)


def test_system_command_registration_ack():
    def run(P):
        eng = engine(P)
        eng.register_device("dev-s", device_type="default")
        svc, provider = _service(P, eng)
        asyncio.run(svc.send_system_command(
            "dev-s", P.SystemCommand(P.SystemCommandType.REGISTRATION_ACK, "dev-s")))
        token, payload, system = provider.delivered[0]
        assert system and json.loads(payload)["systemCommand"] == "RegistrationAck"
        return provider.delivered, eng

    twin_engines(run)


def test_undelivered_retry_targets_failed_destination():
    def run(P):
        class FlakyProvider(P.LocalDeliveryProvider):
            def __init__(self):
                super().__init__()
                self.fail = True

            async def deliver(self, target, payload, is_system=False):
                if self.fail:
                    raise P.DeliveryError("destination down")
                await super().deliver(target, payload, is_system)

        async def go():
            eng = engine(P, device_capacity=32, token_capacity=64,
                         assignment_capacity=64, store_capacity=512, batch_capacity=8)
            eng.register_device("rt-1")
            svc = P.CommandDeliveryService(eng, P.SingleChoiceCommandRouter("flaky"))
            svc.registry.create(P.DeviceCommand(token="ping", device_type="default",
                                                name="ping"))
            provider = FlakyProvider()
            svc.add_destination(P.CommandDestination(
                "flaky", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(),
                provider))
            svc.invoke("rt-1", "ping", {})
            await svc.pump()
            assert len(svc.undelivered) == 1
            res1 = await svc.retry_undelivered()
            assert res1 == {"retried": 1, "stillUndelivered": 1}
            provider.fail = False
            res2 = await svc.retry_undelivered()
            assert res2 == {"retried": 1, "stillUndelivered": 0}
            assert svc.delivered_count == 1
            assert provider.delivered
            return {"r": [res1, res2], "delivered": provider.delivered}, eng

        return asyncio.new_event_loop().run_until_complete(go())

    twin_engines(run)


# ------------------------------------------------------------------ connectors

def test_connector_host_filters_and_offsets():
    def run(P):
        eng = engine(P)
        sink = P.InMemoryConnector("sink", filters=[
            P.ScriptedFilter(lambda ev: ev.etype is not P.EventType.MEASUREMENT)])
        host = P.ConnectorHost(eng, sink)
        measure(P, eng, "c-1", "temp", 20.0)
        measure(P, eng, "c-2", "temp", 21.0)
        eng.process(P.DecodedRequest(type=P.RequestType.DEVICE_LOCATION,
                                     device_token="c-1", latitude=1, longitude=2))
        eng.flush()
        counts = [asyncio.run(host.pump())]
        assert counts[0] == 2
        assert {e.device_token for e in sink.events} == {"c-1", "c-2"}
        assert all(e.etype is P.EventType.MEASUREMENT for e in sink.events)
        counts.append(asyncio.run(host.pump()))
        assert counts[1] == 0
        measure(P, eng, "c-3", "temp", 22.0)
        eng.flush()
        counts.append(asyncio.run(host.pump()))
        assert counts[2] == 1
        return {"counts": counts, "events": sink.events,
                "offsets": host.consumer.offsets}, eng

    twin_engines(run)


def test_connector_failed_batch_dead_letter():
    def run(P):
        eng = engine(P)

        class Exploding(P.InMemoryConnector):
            async def process_batch(self, events):
                raise RuntimeError("boom")

        conn = Exploding("explode")
        host = P.ConnectorHost(eng, conn)
        measure(P, eng, "x-1")
        eng.flush()
        asyncio.run(host.pump())
        assert len(conn.failed_batches) == 1
        again = asyncio.run(host.pump())
        assert again == 0
        return {"failed": conn.failed_batches, "again": again}, eng

    twin_engines(run)


def test_device_type_and_area_filters():
    """The JAX case's device-type filter, then an area filter and an
    exclusion over devices registered under areas."""
    def run(P):
        eng = engine(P)
        eng.register_device("t-1", device_type="thermostat", area="north")
        eng.register_device("t-2", device_type="camera", area="south")
        eng.register_device("t-3", device_type="thermostat", area="south")
        typed = P.InMemoryConnector("typed", filters=[
            P.DeviceTypeFilter(eng, ["thermostat"], "include")])
        south = eng.areas.lookup("south")
        areas = P.InMemoryConnector("areas", filters=[
            P.AreaFilter([south], "include"),
            P.DeviceTypeFilter(eng, ["camera"], "exclude")])
        hosts = [P.ConnectorHost(eng, typed), P.ConnectorHost(eng, areas)]
        for tok in ("t-1", "t-2", "t-3"):
            measure(P, eng, tok)
        eng.flush()
        for h in hosts:
            asyncio.run(h.pump())
        assert [e.device_token for e in typed.events if e.device_token != "t-3"] == ["t-1"]
        assert [e.device_token for e in areas.events] == ["t-3"]
        return {"typed": typed.events, "areas": areas.events}, eng

    twin_engines(run)


def test_search_index_connector_and_queries():
    def run(P):
        eng = engine(P)
        index = P.EventSearchIndex()
        host = P.ConnectorHost(eng, P.SearchIndexConnector("solr", index))
        measure(P, eng, "s-1", "fuel.level", 10.0)
        measure(P, eng, "s-2", "temp", 30.0)
        eng.process(P.DecodedRequest(type=P.RequestType.DEVICE_ALERT,
                                     device_token="s-1", alert_type="hot"))
        eng.flush()
        asyncio.run(host.pump())
        queries = ["*:*", "deviceToken:s-1", "type:ALERT",
                   "deviceToken:s-1 type:MEASUREMENT", "measurement:fuel.level",
                   "type:MEASUREMENT eventDateMs:[0 TO *]"]
        hits = {q: index.search(q) for q in queries}
        assert [len(hits[q]) for q in queries] == [3, 2, 1, 1, 1, 2]
        return hits, eng

    twin_engines(run)


def test_connector_surface_importable():
    def run(P):
        names = ("EventHubConnector", "HttpConnector", "MqttConnector",
                 "RabbitMqConnector", "ScriptedConnector", "SearchIndexConnector",
                 "SqsConnector")
        return {n: [c.__name__ for c in getattr(P, n).__mro__] for n in names}

    twin(run)


def test_rabbitmq_connector_publishes_to_topic_exchange():
    """``tests/test_amqp.py:190`` on both packages' brokers and clients: the
    same routing key and body."""
    def run(P):
        async def go():
            broker = P.AmqpBroker()
            await broker.start()
            got: list[tuple[str, bytes]] = []
            try:
                sub = P.AmqpClient("127.0.0.1", broker.bound_port)
                sub.on_message = lambda ex, key, body: got.append((key, body))
                await sub.connect()
                await sub.declare_exchange("sitewhere.events", "topic")
                await sub.declare_queue("sink")
                await sub.bind_queue("sink", "sitewhere.events", "#")
                await sub.consume("sink")
                conn = P.RabbitMqConnector("rmq", "127.0.0.1", broker.bound_port)
                await conn.process_event(_event(P))
                for _ in range(100):
                    if got:
                        break
                    await asyncio.sleep(0.01)
                await conn.on_stop()
                await sub.close()
            finally:
                await broker.stop()
            return got

        got = asyncio.run(go())
        assert len(got) == 1
        key, body = got[0]
        assert key == "sitewhere.output"
        assert json.loads(body)["deviceToken"] == "d-1"
        return got

    twin(run)


def test_eventhub_connector():
    """``tests/test_eventhub.py:157`` on both packages' hubs."""
    def run(P):
        hub = P.EventHub("out", partition_count=2)
        asyncio.run(P.EventHubConnector("hub", hub).process_event(_event(P)))
        bodies = [e for p in range(hub.partition_count) for e in hub.read(p, 0, 100)]
        assert len(bodies) == 1
        assert json.loads(bodies[0].body)["deviceToken"] == "d-1"
        assert bodies[0].partition_key == "d-1"
        return [(p, [(e.body, e.partition_key) for e in hub.read(p, 0, 100)])
                for p in range(hub.partition_count)]

    twin(run)


# ------------------------------------------------------------------- AWS SigV4

def _creds(P):
    return P.AwsCredentials(access_key="AKIDEXAMPLE",
                            secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
                            region="us-east-1")


def test_sigv4_matches_aws_published_example():
    def run(P):
        headers = P.sigv4_headers(
            _creds(P), "iam", "GET",
            "https://iam.amazonaws.com/?Action=ListUsers&Version=2010-05-08", b"",
            headers={"Content-Type": "application/x-www-form-urlencoded; charset=utf-8"},
            amz_date="20150830T123600Z")
        auth = headers["Authorization"]
        assert auth.startswith(
            "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/"
            "aws4_request, SignedHeaders=content-type;host;x-amz-date, ")
        assert auth.endswith(
            "Signature=5d672d79c15b13162d9279b0855cfba6789a8edb4c82c400e06b5924a6f2b5d7")
        return headers

    twin(run)


def test_sigv4_query_ordering_and_body_hash():
    def run(P):
        def sign(url, body):
            return P.sigv4_headers(_creds(P), "sqs", "POST", url, body, amz_date=AMZ_DATE)

        h1 = sign("https://sqs.us-east-1.amazonaws.com/123/q?b=2&a=1", b"payload")
        h2 = sign("https://sqs.us-east-1.amazonaws.com/123/q?a=1&b=2", b"payload")
        assert h1["Authorization"] == h2["Authorization"]
        h3 = sign("https://sqs.us-east-1.amazonaws.com/123/q?a=1&b=2", b"other")
        assert h1["Authorization"] != h3["Authorization"]
        return [h1, h2, h3]

    twin(run)


def test_sigv4_literal_plus_and_encoded_sort():
    def run(P):
        def sign(url):
            return P.sigv4_headers(_creds(P), "s3", "GET", url, b"", amz_date=AMZ_DATE)

        h_plus = sign("https://s3.amazonaws.com/b?tok=a+b")
        h_enc = sign("https://s3.amazonaws.com/b?tok=a%2Bb")
        h_space = sign("https://s3.amazonaws.com/b?tok=a%20b")
        assert h_plus["Authorization"] == h_enc["Authorization"]
        assert h_plus["Authorization"] != h_space["Authorization"]
        return [h_plus, h_enc, h_space, sign("https://s3.amazonaws.com/b?z=1&a=%7E&m")]

    twin(run)


def test_sqs_connector_requires_credentials():
    def run(P):
        msgs = []
        for args, match in ((("s", "", "sk", "https://q"), "access key"),
                            (("s", "ak", "", "https://q"), "secret key"),
                            (("s", "ak", "sk", ""), "queue URL")):
            with pytest.raises(ValueError, match=match) as e:
                P.SqsConnector(*args)
            msgs.append(str(e.value))
        return msgs

    twin(run)


def test_sqs_connector_sends_signed_request(monkeypatch):
    """Both packages' connectors POST to one local SQS-shaped server with
    the signing date pinned: the same signed headers and form body."""
    from aiohttp import web

    for P in BOTH:
        mod = P.mod("connectors.aws")
        monkeypatch.setattr(mod, "sigv4_headers",
                            functools.partial(mod.sigv4_headers, amz_date=AMZ_DATE))
    received = []

    async def handler(request: web.Request) -> web.Response:
        received.append({"auth": request.headers.get("Authorization", ""),
                         "date": request.headers.get("x-amz-date", ""),
                         "body": await request.text()})
        return web.Response(text="<SendMessageResponse><MessageId>1</MessageId>"
                                 "</SendMessageResponse>")

    async def go():
        app = web.Application()
        app.router.add_post("/123456789/events", handler)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        try:
            for P in (J, T):
                conn = P.SqsConnector("sqs", "AKIDEXAMPLE", "secret",
                                      f"http://127.0.0.1:{port}/123456789/events")
                try:
                    await conn.process_event(_event(
                        P, event_id=7, etype=P.EventType.ALERT, device_token="d-9",
                        measurements={}, values=[]))
                finally:
                    await conn.on_stop()
        finally:
            await runner.cleanup()

    asyncio.run(go())
    assert len(received) == 2 and received[1] == received[0]
    assert received[1]["auth"].startswith("AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/")
    assert received[1]["date"] == AMZ_DATE
    form = dict(urllib.parse.parse_qsl(received[1]["body"]))
    assert form["Action"] == "SendMessage"
    assert json.loads(form["MessageBody"])["deviceToken"] == "d-9"


# -------------------------------------------------------------------- search

def _doc(P, i, **kw):
    base = dict(event_id=i, etype=P.EventType.MEASUREMENT, device_token=f"d-{i % 2}",
                device_id=i % 2, assignment_id=i, tenant="default", area_id=-1,
                asset_id=-1, ts_ms=i, received_ms=i, measurements={f"m{i}": 1.0},
                values=[], aux0=-1, aux1=-1)
    return P.OutboundEvent(**{**base, **kw})


def test_search_index_eviction_keeps_postings_consistent():
    def run(P):
        idx = P.EventSearchIndex(capacity=4)
        for i in range(6):
            idx.add(_doc(P, i))
        assert sorted(idx.docs) == [2, 3, 4, 5]
        assert idx.search("measurement:m0") == []
        assert idx.search("measurement:m1") == []
        assert ("measurement", "m0") not in idx.postings
        assert [d["eventId"] for d in idx.search("deviceToken:d-0")] == [4, 2]
        return {"docs": sorted(idx.docs), "postings": {
            k: sorted(v) for k, v in idx.postings.items()},
            "d0": idx.search("deviceToken:d-0")}

    twin(run)


def test_search_index_event_time_order_survives_truncation():
    def run(P):
        def ev(i, ts, recv=None):
            return _doc(P, i, device_token=f"d-{i}", device_id=i, ts_ms=ts,
                        received_ms=recv if recv is not None else i,
                        measurements={"m": 1.0})

        idx = P.EventSearchIndex()
        idx.add(ev(0, ts=9_000))
        for i in range(1, 6):
            idx.add(ev(i, ts=100 + i))
        by_id = idx.search("*:*", 3, order="id")
        assert [d["eventId"] for d in by_id] == [5, 4, 3]
        by_time = idx.search("*:*", 3)
        assert by_time[0]["eventId"] == 0
        idx2 = P.EventSearchIndex()
        idx2.add(ev(7, ts=500, recv=1))
        idx2.add(ev(3, ts=500, recv=1))
        docs = idx2.search("*:*", 10, order="eventDate")
        assert [d["deviceToken"] for d in docs] == ["d-3", "d-7"]
        return [by_id, by_time, docs]

    twin(run)


def test_search_index_readd_purges_stale_postings():
    """``tests/test_ingest.py:829``: a re-delivered id replaces its old
    posting keys."""
    def run(P):
        idx = P.EventSearchIndex(capacity=4)

        def ev(i, name):
            return _doc(P, i, device_token="d-0", device_id=0,
                        measurements={name: 1.0})

        idx.add(ev(1, "old"))
        idx.add(ev(1, "new"))
        assert idx.search("measurement:old") == []
        assert [d["eventId"] for d in idx.search("measurement:new")] == [1]
        assert ("measurement", "old") not in idx.postings
        return {"new": idx.search("measurement:new"),
                "keys": sorted(idx.postings)}

    twin(run)


def test_search_provider_manager_and_seeded_queries():
    """A seeded feed of 300 events through ``SearchIndexConnector`` into a
    600-doc index behind ``SearchProviderManager``: a fixed set of queries
    (fields, ranges, wildcards, limits, both orders) answers alike."""
    import numpy as np

    def run(P):
        rng = np.random.default_rng(5)
        eng = engine(P, store_capacity=4096)
        mgr = P.SearchProviderManager()
        index = P.EventSearchIndex(capacity=600)
        mgr.add_provider("embedded", index)
        host = P.ConnectorHost(eng, P.SearchIndexConnector("idx", index))
        for i in range(300):
            tok = f"q-{int(rng.integers(20))}"
            k = int(rng.integers(3))
            if k == 0:
                measure(P, eng, tok, f"m{int(rng.integers(4))}", float(rng.normal()))
            elif k == 1:
                eng.process(P.DecodedRequest(type=P.RequestType.DEVICE_ALERT,
                                             device_token=tok,
                                             alert_type=f"a{int(rng.integers(3))}"))
            else:
                eng.process(P.DecodedRequest(type=P.RequestType.DEVICE_LOCATION,
                                             device_token=tok,
                                             latitude=float(rng.uniform(-5, 5)),
                                             longitude=float(rng.uniform(-5, 5))))
        eng.flush()
        while asyncio.run(host.pump()):
            pass
        queries = ["*:*", "type:ALERT", "type:LOCATION deviceToken:q-3",
                   "measurement:m1", "deviceToken:q-1 type:MEASUREMENT",
                   "eventDateMs:[0 TO *]", "alertType:a2", "deviceToken:q-19"]
        prov = mgr.get("embedded")
        assert prov is index
        return ({q: [prov.search(q, 25), prov.search(q, 7, order="id")] for q in queries},
                eng)

    twin_engines(run)


# ------------------------------------------------------------- the mesh engine

def test_distributed_feed_and_command_delivery():
    """``tests/test_distributed.py:294`` on both mesh engines: the feed over
    the per-shard rings and command delivery consuming the same rings."""
    j, t = dist_engines()
    out = {}
    for P, eng in ((J, j), (T, t)):
        eng.ingest_json_batch([meas_payload(f"fd-{i}", float(i)) for i in range(12)])
        eng.flush()
        feed = P.mod("parallel.distributed").DistributedFeedConsumer(eng, "grp")
        evs = feed.poll()
        assert len(evs) == 12
        assert len({e.event_id for e in evs}) == 12
        assert {e.device_token for e in evs} == {f"fd-{i}" for i in range(12)}
        feed.commit(evs)
        assert feed.poll() == []
        svc = P.CommandDeliveryService(eng, P.SingleChoiceCommandRouter("local"))
        svc.registry.create(P.DeviceCommand(token="ping", device_type="default",
                                            name="ping"))
        provider = P.LocalDeliveryProvider()
        svc.add_destination(P.CommandDestination(
            "local", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(), provider))
        inv = svc.invoke("fd-3", "ping")
        eng.flush()
        n = asyncio.new_event_loop().run_until_complete(svc.pump())
        assert n == 1 and len(provider.delivered) == 1
        target, payload, system = provider.delivered[0]
        assert target == "fd-3" and not system
        out[P.root] = plain({"events": evs, "inv": inv, "delivered": provider.delivered})
    assert out["sitewhere_tpu_torch"] == out["sitewhere_tpu"]
    assert_engines_equal(j, t)
