"""Concrete outbound connectors (port of ``sitewhere_tpu/connectors/impl.py``):

  * Log / InMemory: debug and test sinks.
  * Mqtt: publishes event JSON through the port's MQTT client.
  * Http: generic async POST (``aiohttp``, imported when built) with
    optional URI and payload builders; InitialState and dweet.io are thin
    presets of it.
  * Scripted: an arbitrary user callable per event.
  * SearchIndex: feeds the embedded event search index
    (``search/index.py``).
  * RabbitMq: publishes event JSON to a topic exchange through the port's
    AMQP 0-9-1 client (``ingest/amqp.py``), with optional multicaster and
    route-builder routing.
  * EventHub: sends into a partitioned event hub keyed by device token
    (``ingest/eventhub.py``).
  * Sqs: SigV4-signed SQS SendMessage (``connectors/aws.py``; re-exported
    here).
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Any, Callable

from sitewhere_tpu_torch.connectors.base import OutboundConnector, SerialOutboundConnector
from sitewhere_tpu_torch.outbound.feed import OutboundEvent

logger = logging.getLogger(__name__)


class LogConnector(OutboundConnector):
    async def process_event(self, event: OutboundEvent) -> None:
        logger.info("outbound event: %s", event.to_json_dict())


class InMemoryConnector(OutboundConnector):
    """Collects events (test/embedded sink)."""

    def __init__(self, connector_id: str = "inmemory", filters=None):
        super().__init__(connector_id, filters)
        self.events: list[OutboundEvent] = []

    async def process_event(self, event: OutboundEvent) -> None:
        self.events.append(event)


class MqttConnector(SerialOutboundConnector):
    """Publish each event as JSON to a topic pattern (reference:
    connectors/mqtt/MqttOutboundConnector)."""

    def __init__(self, connector_id: str, host: str, port: int,
                 topic_pattern: str = "sitewhere/outbound/{token}",
                 qos: int = 0, filters=None):
        super().__init__(connector_id, filters)
        from sitewhere_tpu_torch.ingest.mqtt import MqttClient

        self.client = MqttClient(host, port, f"sw-connector-{connector_id}")
        self.topic_pattern = topic_pattern
        self.qos = qos
        self._connected = False

    async def process_event(self, event: OutboundEvent) -> None:
        if not self._connected:
            await self.client.connect()
            self._connected = True
        topic = self.topic_pattern.format(token=event.device_token,
                                          type=event.etype.name)
        await self.client.publish(topic, json.dumps(event.to_json_dict()).encode(),
                                  self.qos)

    async def on_stop(self) -> None:
        if self._connected:
            await self.client.disconnect()
            self._connected = False


UriBuilder = Callable[[OutboundEvent], str]
PayloadBuilder = Callable[[OutboundEvent], bytes]


class HttpConnector(SerialOutboundConnector):
    """POST events to an HTTP endpoint with scripted URI/payload builders
    (reference: connectors/http/* with Groovy uri-builder / payload-builder
    script templates)."""

    def __init__(self, connector_id: str, uri: str | UriBuilder,
                 payload_builder: PayloadBuilder | None = None,
                 headers: dict[str, str] | None = None, method: str = "POST",
                 filters=None):
        super().__init__(connector_id, filters)
        self.uri = uri
        self.payload_builder = payload_builder or (
            lambda ev: json.dumps(ev.to_json_dict()).encode()
        )
        self.headers = {"Content-Type": "application/json", **(headers or {})}
        self.method = method
        self._session = None

    async def _get_session(self):
        if self._session is None:
            import aiohttp

            self._session = aiohttp.ClientSession()
        return self._session

    async def process_event(self, event: OutboundEvent) -> None:
        session = await self._get_session()
        uri = self.uri(event) if callable(self.uri) else self.uri
        async with session.request(
            self.method, uri, data=self.payload_builder(event), headers=self.headers
        ) as resp:
            if resp.status >= 300:
                raise RuntimeError(f"http connector status {resp.status}")

    async def on_stop(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None


def initial_state_connector(connector_id: str, streaming_access_key: str,
                            bucket_key: str, filters=None) -> HttpConnector:
    """InitialState events API preset (reference: connectors/initialstate/)."""

    def payload(ev: OutboundEvent) -> bytes:
        items = [
            {"key": name, "value": val, "epoch": ev.ts_ms / 1000.0}
            for name, val in ev.measurements.items()
        ]
        return json.dumps(items).encode()

    return HttpConnector(
        connector_id,
        "https://groker.init.st/api/events",
        payload_builder=payload,
        headers={"X-IS-AccessKey": streaming_access_key,
                 "X-IS-BucketKey": bucket_key},
        filters=filters,
    )


def dweet_connector(connector_id: str, thing_name_pattern: str = "{token}",
                    filters=None) -> HttpConnector:
    """dweet.io preset (reference: connectors/dweetio/)."""

    def uri(ev: OutboundEvent) -> str:
        return f"https://dweet.io/dweet/for/{thing_name_pattern.format(token=ev.device_token)}"

    return HttpConnector(connector_id, uri, filters=filters)


class ScriptedConnector(OutboundConnector):
    """User Python callable per event (reference: connectors/groovy/
    GroovyOutboundConnector + script templates)."""

    def __init__(self, connector_id: str, fn: Callable[[OutboundEvent], Any],
                 filters=None):
        super().__init__(connector_id, filters)
        self.fn = fn

    async def process_event(self, event: OutboundEvent) -> None:
        res = self.fn(event)
        if hasattr(res, "__await__"):
            await res


class SearchIndexConnector(OutboundConnector):
    """Index events into the embedded search service (the Solr connector
    slot, connectors/solr/SolrOutboundConnector — see search/index.py)."""

    def __init__(self, connector_id: str, index, filters=None):
        super().__init__(connector_id, filters)
        self.index = index

    async def process_event(self, event: OutboundEvent) -> None:
        self.index.add(event)


class RabbitMqConnector(SerialOutboundConnector):
    """Publish each event as JSON to an AMQP topic exchange (reference:
    connectors/rabbitmq/RabbitMqOutboundConnector.java:96-97,200-237 —
    per-tenant topic exchange, fixed topic by default, multicaster routes or
    a route builder when configured)."""

    def __init__(self, connector_id: str, host: str, port: int,
                 exchange: str = "sitewhere.events",
                 topic: str = "sitewhere.output", multicaster=None,
                 route_builder=None, username: str = "guest",
                 password: str = "guest", filters=None):
        super().__init__(connector_id, filters)
        self.host, self.port = host, port
        self.username, self.password = username, password
        self.exchange, self.topic = exchange, topic
        self.multicaster, self.route_builder = multicaster, route_builder
        self.client = None

    async def _ensure_connected(self):
        if self.client is not None:
            return self.client
        from sitewhere_tpu_torch.ingest.amqp import AmqpClient

        client = AmqpClient(self.host, self.port, self.username, self.password)
        try:
            await client.connect()
            await client.declare_exchange(self.exchange, "topic")
        except Exception:
            await client.close()
            raise
        self.client = client
        return client

    async def process_event(self, event: OutboundEvent) -> None:
        client = await self._ensure_connected()
        if self.multicaster is not None:
            routes = self.multicaster.routes_for(event)
        elif self.route_builder is not None:
            routes = [self.route_builder.build(event, event.device_token)]
        else:
            routes = [self.topic]
        body = json.dumps(event.to_json_dict()).encode()
        try:
            for route in routes:
                await client.publish(self.exchange, route, body)
        except (OSError, ConnectionError, asyncio.TimeoutError):
            # drop the dead connection so the serial retry reconnects
            self.client = None
            await client.close()
            raise

    async def on_stop(self) -> None:
        if self.client is not None:
            await self.client.close()
            self.client = None


class EventHubConnector(SerialOutboundConnector):
    """Send event JSON into a partitioned event hub keyed by device token
    (reference: connectors/azure/EventHubOutboundConnector.java — sendEvent
    per event type; hub semantics in ingest/eventhub.py)."""

    def __init__(self, connector_id: str, hub, filters=None):
        super().__init__(connector_id, filters)
        self.hub = hub

    async def process_event(self, event: OutboundEvent) -> None:
        self.hub.send(json.dumps(event.to_json_dict()).encode(),
                      partition_key=event.device_token)


# real implementation lives in connectors/aws.py (stdlib SigV4 signer)
from sitewhere_tpu_torch.connectors.aws import SqsConnector  # noqa: E402,F401
