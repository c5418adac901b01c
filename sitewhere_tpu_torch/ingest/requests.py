"""Host-side decoded device requests — the boundary record between protocol
receivers and the engine's staging buffer (a copy of
``sitewhere_tpu/ingest/requests.py``; the port keeps its own).

Mirrors the reference's ``DeviceRequest`` JSON envelope
(service-event-sources test fixture EventsHelper.java:55-80 builds
``{"deviceToken": ..., "type": "DeviceMeasurement", "request": {...}}``; the
decoder maps it via JsonDeviceRequestMarshaler in
sources/decoder/json/JsonDeviceRequestDecoder.java). Decoders produce these;
the engine (engine.py) interns tokens and packs them into ``EventBatch``
tensors.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from sitewhere_tpu_torch.core.types import AlertLevel, EventType


class RequestType(enum.Enum):
    """Device request envelope types (reference: DeviceRequest.Type)."""

    REGISTER_DEVICE = "RegisterDevice"
    DEVICE_MEASUREMENT = "DeviceMeasurement"
    DEVICE_LOCATION = "DeviceLocation"
    DEVICE_ALERT = "DeviceAlert"
    DEVICE_STATE_CHANGE = "DeviceStateChange"
    ACKNOWLEDGE = "Acknowledge"          # command response
    DEVICE_STREAM = "DeviceStream"
    DEVICE_STREAM_DATA = "DeviceStreamData"
    SEND_DEVICE_STREAM_DATA = "SendDeviceStreamData"
    MAP_DEVICE = "MapDevice"             # nested-device mapping


# aliases accepted on the wire (the reference models evolved names)
_TYPE_ALIASES = {
    "DeviceMeasurements": RequestType.DEVICE_MEASUREMENT,
    "RegisterDevice": RequestType.REGISTER_DEVICE,
    "DeviceCommandResponse": RequestType.ACKNOWLEDGE,
}


def parse_request_type(raw: str) -> RequestType:
    alias = _TYPE_ALIASES.get(raw)
    if alias is not None:
        return alias
    return RequestType(raw)


@dataclasses.dataclass
class DecodedRequest:
    """One decoded device request. ``values`` layout follows EventType
    conventions (core/types.py); registration/stream requests carry their
    payload in ``extras``."""

    type: RequestType
    device_token: str
    tenant: str = "default"
    event_ts_ms: int | None = None       # absolute unix ms (None = now);
                                         # the engine converts to its int32
                                         # epoch-relative clock when staging
    # measurement: {name: value}; retained as dict until channel mapping
    measurements: dict[str, float] | None = None
    # location
    latitude: float | None = None
    longitude: float | None = None
    elevation: float | None = None
    # alert
    alert_type: str | None = None
    alert_level: AlertLevel = AlertLevel.INFO
    alert_message: str | None = None
    # command response (Acknowledge)
    originating_event_id: str | None = None
    response: str | None = None
    # state change
    attribute: str | None = None
    state_type: str | None = None
    previous_state: str | None = None
    new_state: str | None = None
    # dedup
    alternate_id: str | None = None
    # free-form (registration device type/area tokens, stream ids, ...)
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def event_type(self) -> EventType | None:
        return {
            RequestType.DEVICE_MEASUREMENT: EventType.MEASUREMENT,
            RequestType.DEVICE_LOCATION: EventType.LOCATION,
            RequestType.DEVICE_ALERT: EventType.ALERT,
            RequestType.ACKNOWLEDGE: EventType.COMMAND_RESPONSE,
            RequestType.DEVICE_STATE_CHANGE: EventType.STATE_CHANGE,
        }.get(self.type)


class EventDecodeException(Exception):
    """Raised by decoders on malformed payloads; the engine counts the
    payload as a failed decode."""
