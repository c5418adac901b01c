"""Command destinations: parameter extraction + encoding + delivery (port of
``sitewhere_tpu/commands/destinations.py``).

A destination pairs a parameter extractor (e.g. the per-device MQTT topic),
an execution encoder and a delivery provider: MQTT and CoAP over the port's
``ingest/mqtt.py`` and ``ingest/coap.py`` clients, SMS (a gateway-agnostic
HTTP POST of Twilio's shape that falls back to a local outbox when no
gateway URL is configured) and local delivery.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Protocol

from sitewhere_tpu_torch.commands.encoders import ExecutionEncoder
from sitewhere_tpu_torch.commands.model import CommandExecution, SystemCommand
from sitewhere_tpu_torch.utils.lifecycle import LifecycleComponent

logger = logging.getLogger(__name__)


class DeliveryError(Exception):
    """Raised when a provider cannot deliver; routing logic dead-letters."""


@dataclasses.dataclass
class DeliveryTarget:
    """Provider-specific addressing extracted per device."""

    device_token: str
    address: dict[str, Any]


ParameterExtractor = Callable[[str, dict[str, Any]], dict[str, Any]]
"""(device_token, device_metadata) -> provider address dict."""


def mqtt_topic_extractor(command_topic_pattern: str = "sitewhere/commands/{token}",
                         system_topic_pattern: str = "sitewhere/system/{token}") -> ParameterExtractor:
    """Build per-device MQTT topics (reference: destination/mqtt/
    MqttParameterExtractor builds per-device command/system topics)."""

    def extract(token: str, metadata: dict[str, Any]) -> dict[str, Any]:
        return {
            "command_topic": metadata.get(
                "commandTopic", command_topic_pattern.format(token=token)
            ),
            "system_topic": metadata.get(
                "systemTopic", system_topic_pattern.format(token=token)
            ),
        }

    return extract


def coap_metadata_extractor(default_port: int = 5683) -> ParameterExtractor:
    """Pull CoAP host/port/path from device metadata (reference:
    destination/coap/MetadataCoapParameterExtractor)."""

    def extract(token: str, metadata: dict[str, Any]) -> dict[str, Any]:
        if "coapHost" not in metadata:
            raise DeliveryError(f"device {token} has no coapHost metadata")
        return {
            "host": metadata["coapHost"],
            "port": int(metadata.get("coapPort", default_port)),
            "path": metadata.get("coapPath", "commands"),
        }

    return extract


def sms_phone_extractor() -> ParameterExtractor:
    def extract(token: str, metadata: dict[str, Any]) -> dict[str, Any]:
        if "phone" not in metadata:
            raise DeliveryError(f"device {token} has no phone metadata")
        return {"phone": metadata["phone"]}

    return extract


class DeliveryProvider(Protocol):
    async def deliver(self, target: DeliveryTarget, payload: bytes,
                      system: bool) -> None: ...


class MqttDeliveryProvider:
    """Publish command payloads to per-device topics via the native MQTT
    client (reference: destination/mqtt/MqttCommandDeliveryProvider)."""

    def __init__(self, host: str, port: int, qos: int = 1,
                 client_id: str = "sw-command-delivery"):
        from sitewhere_tpu_torch.ingest.mqtt import MqttClient

        self.client = MqttClient(host, port, client_id)
        self.qos = qos
        self._connected = False

    async def deliver(self, target: DeliveryTarget, payload: bytes, system: bool) -> None:
        try:
            if not self._connected:
                await self.client.connect()
                self._connected = True
            topic = target.address["system_topic" if system else "command_topic"]
            await self.client.publish(topic, payload, self.qos)
        except (OSError, ConnectionError, TimeoutError) as e:
            self._connected = False
            raise DeliveryError(f"mqtt delivery failed: {e}") from e

    async def close(self) -> None:
        if self._connected:
            await self.client.disconnect()
            self._connected = False


class CoapDeliveryProvider:
    """POST command payloads to the device's CoAP endpoint (reference:
    destination/coap/CoapCommandDeliveryProvider via Californium client)."""

    async def deliver(self, target: DeliveryTarget, payload: bytes, system: bool) -> None:
        from sitewhere_tpu_torch.ingest.coap import POST, CoapClient

        a = target.address
        try:
            client = CoapClient(a["host"], a["port"])
            reply = await client.request(POST, [a["path"]], payload)
            if reply["code"] >= 0x80:
                raise DeliveryError(f"coap error code {reply['code']:#x}")
        except TimeoutError as e:
            raise DeliveryError(f"coap delivery timed out: {e}") from e


class SmsDeliveryProvider:
    """SMS gateway provider (Twilio-compatible POST form). With no gateway
    configured (zero-egress images), messages land in ``outbox``."""

    def __init__(self, gateway_url: str | None = None,
                 account: str = "", auth_token: str = "", from_number: str = ""):
        self.gateway_url = gateway_url
        self.account = account
        self.auth_token = auth_token
        self.from_number = from_number
        self.outbox: list[tuple[str, bytes]] = []

    async def deliver(self, target: DeliveryTarget, payload: bytes, system: bool) -> None:
        phone = target.address["phone"]
        if self.gateway_url is None:
            self.outbox.append((phone, payload))
            return
        import aiohttp

        try:
            async with aiohttp.ClientSession() as session:
                async with session.post(
                    self.gateway_url.format(account=self.account),
                    data={"To": phone, "From": self.from_number,
                          "Body": payload.decode(errors="replace")},
                    auth=aiohttp.BasicAuth(self.account, self.auth_token),
                ) as resp:
                    if resp.status >= 300:
                        raise DeliveryError(f"sms gateway status {resp.status}")
        except aiohttp.ClientError as e:
            raise DeliveryError(f"sms delivery failed: {e}") from e


class LocalDeliveryProvider:
    """In-process delivery sink for tests/embedded use: records payloads and
    optionally invokes a callback (device-simulator hook)."""

    def __init__(self, callback: Callable[[str, bytes, bool], Any] | None = None):
        self.delivered: list[tuple[str, bytes, bool]] = []
        self.callback = callback
        self.fail = False  # test hook: simulate a down destination

    async def deliver(self, target: DeliveryTarget, payload: bytes, system: bool) -> None:
        if self.fail:
            raise DeliveryError("destination down")
        self.delivered.append((target.device_token, payload, system))
        if self.callback is not None:
            self.callback(target.device_token, payload, system)


class CommandDestination(LifecycleComponent):
    """extractor + encoder + provider, addressable by id."""

    def __init__(self, destination_id: str, extractor: ParameterExtractor,
                 encoder: ExecutionEncoder, provider: DeliveryProvider):
        super().__init__(f"command-destination:{destination_id}")
        self.destination_id = destination_id
        self.extractor = extractor
        self.encoder = encoder
        self.provider = provider

    async def deliver(self, execution: CommandExecution, device_token: str,
                      metadata: dict[str, Any]) -> None:
        target = DeliveryTarget(device_token, self.extractor(device_token, metadata))
        await self.provider.deliver(target, self.encoder.encode(execution), False)

    async def deliver_system(self, command: SystemCommand, device_token: str,
                             metadata: dict[str, Any]) -> None:
        target = DeliveryTarget(device_token, self.extractor(device_token, metadata))
        await self.provider.deliver(target, self.encoder.encode_system(command), True)

    async def on_stop(self) -> None:
        close = getattr(self.provider, "close", None)
        if close is not None:
            await close()
