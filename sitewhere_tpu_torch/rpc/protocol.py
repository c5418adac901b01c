"""Control-plane RPC wire protocol (the reference's gRPC/HTTP2 analog).

The reference's services talk to each other over gRPC with per-service
routers that dispatch each call into the right tenant engine
(service-device-state/.../grpc/DeviceStateRouter.java:40-72,
DeviceStateGrpcServer.java:18-23). gRPC is the sync
control/query plane — not the event hot path — so this
equivalent keeps that role: a compact length-prefixed framing over TCP
(4-byte big-endian length + JSON body) carrying
``{"id", "method", "tenant", "params"}`` requests and
``{"id", "result"} | {"id", "error", "code"}`` responses. Streams
multiplex by id, so one connection carries concurrent in-flight calls the
way HTTP/2 does for gRPC.

Request frames may additionally carry a ``"tp"`` field — a W3C-shaped
``traceparent`` (utils/tracing.py) that the server binds around the
handler, so a batch forwarded across ranks keeps ONE trace id end to end
(the Dapper-context header of the reference's Istio mesh). It rides the
frame, never ``params``: handlers are traceparent-oblivious.
"""

from __future__ import annotations

import json
import struct
from typing import Any

MAX_FRAME = 16 << 20  # 16 MiB, mirrors gRPC's default max message scale

# reserved top-level frame key for the cross-rank traceparent
TRACEPARENT_KEY = "tp"

# high bit of the length word marks a BINARY ATTACHMENT following the
# JSON body (4-byte length + raw bytes). The hot cross-rank forwarding
# path ships event payload blobs this way: base64-in-JSON costs ~3us per
# event in encode/escape/decode, ~10x the native decode itself. MAX_FRAME
# keeps bit 31 free, so old peers reject such frames loudly (oversized)
# rather than misparsing them.
ATTACH_BIT = 0x80000000


class RpcError(Exception):
    """Remote error surfaced to the caller (code mirrors HTTP semantics).
    ``retry_after_s`` rides error frames as ``retryAfterS`` for
    ``code=429`` load-shed rejects: the sender's retry
    machinery honors the OWNER's backoff hint instead of inventing its
    own. ``data`` is an optional JSON-serializable payload riding error
    frames as ``data`` — the placement plane uses it to ship
    the replier's placement map on ``code=473`` ownership redirects so a
    stale sender can re-route mid-flight without another round trip."""

    def __init__(self, message: str, code: int = 500,
                 retry_after_s: float | None = None,
                 data: dict | None = None):
        super().__init__(message)
        self.code = code
        self.retry_after_s = retry_after_s
        self.data = data


def _default(o):
    """Wire coercion for entity payloads: enums marshal as their value
    (the REST layer does the same). Anything else still raises — a
    handler returning an unconverted dataclass/bytes must fail loudly,
    not ship its repr."""
    import enum

    if isinstance(o, enum.Enum):
        return o.value if isinstance(o.value, (str, int)) else o.name
    raise TypeError(
        f"Object of type {o.__class__.__name__} is not RPC-serializable")


def frame_chunks(obj: dict[str, Any],
                 attachment: bytes | None = None) -> list[bytes]:
    """The frame as a chunk list — senders write the chunks directly so
    a multi-MiB attachment is never copied into one concatenated bytes
    object on the hot path."""
    body = json.dumps(obj, separators=(",", ":"), default=_default).encode()
    if len(body) > MAX_FRAME:
        raise RpcError(f"frame too large: {len(body)}", 413)
    if attachment is None:
        return [struct.pack(">I", len(body)), body]
    if len(attachment) > MAX_FRAME:
        raise RpcError(f"attachment too large: {len(attachment)}", 413)
    return [struct.pack(">I", len(body) | ATTACH_BIT), body,
            struct.pack(">I", len(attachment)), attachment]


def encode_frame(obj: dict[str, Any],
                 attachment: bytes | None = None) -> bytes:
    return b"".join(frame_chunks(obj, attachment))


async def read_frame(reader) -> dict[str, Any] | None:
    """Read one frame; None on clean EOF at a frame boundary. An
    attachment comes back under the reserved ``"_attachment"`` key as
    bytes (json can never produce bytes, so the type disambiguates; the
    server additionally strips any json-borne impostor before use)."""
    try:
        # asyncio.IncompleteReadError subclasses EOFError
        header = await reader.readexactly(4)
    except (EOFError, ConnectionError, OSError):
        return None
    (length,) = struct.unpack(">I", header)
    has_attach = bool(length & ATTACH_BIT)
    length &= ATTACH_BIT - 1
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}", 413)
    body = await reader.readexactly(length)
    obj = json.loads(body)
    if has_attach:
        (alen,) = struct.unpack(">I", await reader.readexactly(4))
        if alen > MAX_FRAME:
            raise RpcError(f"attachment too large: {alen}", 413)
        if isinstance(obj, dict):
            obj["_attachment"] = await reader.readexactly(alen)
        else:
            await reader.readexactly(alen)   # drain; malformed body
    return obj
