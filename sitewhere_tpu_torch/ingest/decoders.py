"""JSON device-request decoding: bytes -> DecodedRequest list (the port's
copy of the parts of ``sitewhere_tpu/ingest/decoders.py`` that
``Engine.ingest_json_batch`` needs; the native batch decoder is not
ported).
"""

from __future__ import annotations

import datetime
import json
from typing import Any

from sitewhere_tpu_torch.core.types import AlertLevel
from sitewhere_tpu_torch.ingest.requests import (DecodedRequest,
                                                 EventDecodeException,
                                                 RequestType,
                                                 parse_request_type)


def _parse_event_date(req: dict) -> int | None:
    ts = req.get("eventDate")
    if ts is None:
        return None
    if isinstance(ts, (int, float)):
        return int(ts)
    # ISO-8601 strings accepted for REST parity
    try:
        return int(
            datetime.datetime.fromisoformat(str(ts).replace("Z", "+00:00")).timestamp() * 1000
        )
    except ValueError as e:
        raise EventDecodeException(f"bad eventDate: {ts!r}") from e


def request_from_envelope(envelope: dict, metadata: dict | None = None) -> DecodedRequest:
    """Map one DeviceRequest JSON envelope to a DecodedRequest."""
    try:
        rtype = parse_request_type(envelope["type"])
        token = envelope.get("deviceToken") or envelope.get("hardwareId")
        if not token:
            raise EventDecodeException("missing deviceToken")
        req = envelope.get("request", {}) or {}
        out = DecodedRequest(
            type=rtype,
            device_token=str(token),
            tenant=str(envelope.get("tenant", "default")),
            event_ts_ms=_parse_event_date(req),
            alternate_id=req.get("alternateId"),
            metadata=dict(metadata or {}) | dict(req.get("metadata") or {}),
        )
        if rtype is RequestType.DEVICE_MEASUREMENT:
            # JSON null values parse as absent (a measurement with a null
            # value still decodes, with no lanes)
            if "measurements" in req and isinstance(req["measurements"], dict):
                out.measurements = {str(k): float(v)
                                    for k, v in req["measurements"].items()
                                    if v is not None}
            elif "name" in req:
                out.measurements = (
                    {str(req["name"]): float(req["value"])}
                    if req.get("value") is not None else {}
                )
            else:
                raise EventDecodeException("measurement request missing name/value")
        elif rtype is RequestType.DEVICE_LOCATION:
            # null coordinates decode as an absent location — never as
            # null island (0, 0)
            if req["latitude"] is not None and req["longitude"] is not None:
                out.latitude = float(req["latitude"])
                out.longitude = float(req["longitude"])
            out.elevation = float(req.get("elevation") or 0.0)
        elif rtype is RequestType.DEVICE_ALERT:
            out.alert_type = str(req.get("type") or "alert")
            lvl = req.get("level") or "Info"
            out.alert_level = (
                AlertLevel[str(lvl).upper()] if isinstance(lvl, str) else AlertLevel(int(lvl))
            )
            out.alert_message = req.get("message")
        elif rtype is RequestType.ACKNOWLEDGE:
            out.originating_event_id = req.get("originatingEventId")
            out.response = req.get("response")
        elif rtype is RequestType.DEVICE_STATE_CHANGE:
            out.attribute = str(req.get("attribute", ""))
            out.state_type = str(req.get("type", ""))
            out.previous_state = req.get("previousState")
            out.new_state = req.get("newState")
        else:
            out.extras = {k: v for k, v in req.items() if k not in ("metadata",)}
        return out
    except EventDecodeException:
        raise
    except (KeyError, TypeError, ValueError) as e:
        raise EventDecodeException(str(e)) from e


class JsonDeviceRequestDecoder:
    """Parse a single DeviceRequest envelope
    (reference: sources/decoder/json/JsonDeviceRequestDecoder.java)."""

    def decode(self, payload: bytes, metadata: dict[str, Any]) -> list[DecodedRequest]:
        try:
            envelope = json.loads(payload)
        except ValueError as e:      # JSONDecodeError, or bytes not UTF-8
            raise EventDecodeException(f"invalid JSON: {e}") from e
        if not isinstance(envelope, dict):
            raise EventDecodeException("payload is not a JSON object")
        return [request_from_envelope(envelope, metadata)]
