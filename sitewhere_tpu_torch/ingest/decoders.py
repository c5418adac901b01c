"""Device-request decoding: bytes -> DecodedRequest list (the port's copy
of the parts of ``sitewhere_tpu/ingest/decoders.py`` that the engine
needs): the JSON envelope decoder, and the flat binary format with its
encoder, which the write-ahead log uses to record per-request ingest and
admin registrations.
"""

from __future__ import annotations

import datetime
import json
import struct
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


# --- binary flat format ------------------------------------------------------
#
# Layout (little-endian), versioned:
#   u8 version=1 | u8 type | u16 token_len | token utf8 | i64 ts_ms |
#   u16 n_pairs | n_pairs * (u16 name_len | name | f64 value)      (measurement)
#   f64 lat | f64 lon | f64 elev  (NaN = absent coordinate)         (location)
#   u16 type_len | type | u8 level | u16 msg_len | msg              (alert)
#   u16 n_extras | n * (u16 klen | k | u16 vlen | v)  [optional]    (register)
#   u16 orig_len | orig | u16 resp_len | resp         [optional]    (ack)

_BIN_MAGIC_VERSION = 1
_BIN_TYPES = {
    1: RequestType.DEVICE_MEASUREMENT,
    2: RequestType.DEVICE_LOCATION,
    3: RequestType.DEVICE_ALERT,
    4: RequestType.REGISTER_DEVICE,
    5: RequestType.ACKNOWLEDGE,
}
_BIN_TYPE_IDS = {v: k for k, v in _BIN_TYPES.items()}


def encode_binary_request(req: DecodedRequest) -> bytes:
    """Inverse of :class:`BinaryEventDecoder`. Raises KeyError for a request
    type the format does not carry."""
    tid = _BIN_TYPE_IDS[req.type]
    tok = req.device_token.encode()
    out = struct.pack("<BBH", _BIN_MAGIC_VERSION, tid, len(tok)) + tok
    out += struct.pack("<q", req.event_ts_ms if req.event_ts_ms is not None else -1)
    if req.type is RequestType.DEVICE_MEASUREMENT:
        pairs = req.measurements or {}
        out += struct.pack("<H", len(pairs))
        for name, value in pairs.items():
            nb = name.encode()
            out += struct.pack("<H", len(nb)) + nb + struct.pack("<d", float(value))
    elif req.type is RequestType.DEVICE_LOCATION:
        # NaN wires "absent coordinates": a null-coordinate location survives
        # a round trip without turning into null island (0, 0)
        out += struct.pack(
            "<ddd",
            req.latitude if req.latitude is not None else float("nan"),
            req.longitude if req.longitude is not None else float("nan"),
            req.elevation or 0.0)
    elif req.type is RequestType.DEVICE_ALERT:
        tb = (req.alert_type or "alert").encode()
        mb = (req.alert_message or "").encode()
        out += struct.pack("<H", len(tb)) + tb
        out += struct.pack("<B", int(req.alert_level))
        out += struct.pack("<H", len(mb)) + mb
    elif req.type is RequestType.REGISTER_DEVICE:
        # the string extras (deviceTypeToken/areaToken/customerToken) must
        # survive the wire, or WAL replay loses registration fidelity
        pairs = [(k, v) for k, v in (req.extras or {}).items()
                 if isinstance(v, str)]
        out += struct.pack("<H", len(pairs))
        for k, v in pairs:
            kb, vb = k.encode(), v.encode()
            out += struct.pack("<H", len(kb)) + kb
            out += struct.pack("<H", len(vb)) + vb
    elif req.type is RequestType.ACKNOWLEDGE:
        ob = (req.originating_event_id or "").encode()
        rb = (req.response or "").encode()
        out += struct.pack("<H", len(ob)) + ob
        out += struct.pack("<H", len(rb)) + rb
    return out


def binary_token_of(payload: bytes) -> str | None:
    """Device token of one binary wire payload without a full decode (a
    router's partition key); None when the header is malformed."""
    if len(payload) < 4 or payload[0] != _BIN_MAGIC_VERSION:
        return None
    (n,) = struct.unpack_from("<H", payload, 2)
    tok = payload[4:4 + n]
    if len(tok) != n:
        return None
    try:
        return tok.decode()
    except UnicodeDecodeError:
        return None


class BinaryEventDecoder:
    """Decode the compact flat binary format above."""

    def decode(self, payload: bytes, metadata: dict[str, Any]) -> list[DecodedRequest]:
        try:
            ver, tid, tlen = struct.unpack_from("<BBH", payload, 0)
            if ver != _BIN_MAGIC_VERSION:
                raise EventDecodeException(f"unknown binary version {ver}")
            off = 4
            token = payload[off: off + tlen].decode()
            off += tlen
            (ts,) = struct.unpack_from("<q", payload, off)
            off += 8
            rtype = _BIN_TYPES.get(tid)
            if rtype is None:
                raise EventDecodeException(f"unknown binary type id {tid}")
            req = DecodedRequest(type=rtype, device_token=token,
                                 event_ts_ms=None if ts < 0 else ts,
                                 metadata=dict(metadata))
            if rtype is RequestType.DEVICE_MEASUREMENT:
                (n,) = struct.unpack_from("<H", payload, off)
                off += 2
                pairs = {}
                for _ in range(n):
                    (nlen,) = struct.unpack_from("<H", payload, off)
                    off += 2
                    name = payload[off: off + nlen].decode()
                    off += nlen
                    (val,) = struct.unpack_from("<d", payload, off)
                    off += 8
                    pairs[name] = val
                req.measurements = pairs
            elif rtype is RequestType.DEVICE_LOCATION:
                lat, lon, elev = struct.unpack_from("<ddd", payload, off)
                req.latitude = None if lat != lat else lat    # NaN = absent
                req.longitude = None if lon != lon else lon
                req.elevation = elev
            elif rtype is RequestType.DEVICE_ALERT:
                (tl,) = struct.unpack_from("<H", payload, off)
                off += 2
                req.alert_type = payload[off: off + tl].decode()
                off += tl
                (lvl,) = struct.unpack_from("<B", payload, off)
                off += 1
                req.alert_level = AlertLevel(lvl)
                (ml,) = struct.unpack_from("<H", payload, off)
                off += 2
                req.alert_message = payload[off: off + ml].decode() or None
            elif rtype is RequestType.REGISTER_DEVICE and off < len(payload):
                # the body is optional: a header-only frame decodes with
                # empty extras
                (n,) = struct.unpack_from("<H", payload, off)
                off += 2
                extras = {}
                for _ in range(n):
                    (kl,) = struct.unpack_from("<H", payload, off)
                    off += 2
                    key = payload[off: off + kl].decode()
                    off += kl
                    (vl,) = struct.unpack_from("<H", payload, off)
                    off += 2
                    extras[key] = payload[off: off + vl].decode()
                    off += vl
                req.extras = extras
            elif rtype is RequestType.ACKNOWLEDGE and off < len(payload):
                (ol,) = struct.unpack_from("<H", payload, off)
                off += 2
                req.originating_event_id = (
                    payload[off: off + ol].decode() or None)
                off += ol
                (rl,) = struct.unpack_from("<H", payload, off)
                off += 2
                req.response = payload[off: off + rl].decode() or None
            return [req]
        except (struct.error, UnicodeDecodeError, IndexError) as e:
            raise EventDecodeException(str(e)) from e
