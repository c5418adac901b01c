"""Native CoAP (RFC 7252) subset: message codec + UDP server receiver +
client for command delivery (port of ``sitewhere_tpu/ingest/coap.py``;
plain Python on the port's ``ingest/sources.py``).

The reference runs an Eclipse Californium CoAP server for ingest
(sources/coap/CoapServerEventReceiver.java:23-62 + CoapMessageDeliverer) and
a Californium client for command destinations (commands destination/coap/*).
No CoAP library ships here, so the needed subset is implemented directly:
confirmable/non-confirmable POST/PUT with ACK piggyback responses, token +
option parsing (Uri-Path), and a matching client.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable

from sitewhere_tpu_torch.ingest.sources import InboundEventReceiver

logger = logging.getLogger(__name__)

# message types
CON, NON, ACK, RST = 0, 1, 2, 3
# method / response codes
GET, POST, PUT, DELETE = 1, 2, 3, 4
CREATED, CHANGED, CONTENT = 0x41, 0x44, 0x45
BAD_REQUEST, NOT_FOUND = 0x80, 0x84
OPT_URI_PATH = 11
PAYLOAD_MARKER = 0xFF


def encode_message(mtype: int, code: int, message_id: int, token: bytes = b"",
                   uri_path: list[str] | None = None, payload: bytes = b"") -> bytes:
    out = bytearray()
    out.append(0x40 | (mtype << 4) | len(token))  # version 1
    out.append(code)
    out += message_id.to_bytes(2, "big")
    out += token
    prev = 0
    for seg in uri_path or []:
        delta = OPT_URI_PATH - prev
        seg_b = seg.encode()
        if delta > 12 or len(seg_b) > 12:
            # extended option encoding (delta/length 13..268)
            d = min(delta, 13) if delta > 12 else delta
            ln = 13 if len(seg_b) > 12 else len(seg_b)
            out.append((d << 4) | ln)
            if d == 13:
                out.append(delta - 13)
            if ln == 13:
                out.append(len(seg_b) - 13)
        else:
            out.append((delta << 4) | len(seg_b))
        out += seg_b
        prev = OPT_URI_PATH
    if payload:
        out.append(PAYLOAD_MARKER)
        out += payload
    return bytes(out)


def decode_message(data: bytes) -> dict:
    if len(data) < 4 or (data[0] >> 6) != 1:
        raise ValueError("not a CoAP v1 message")
    tkl = data[0] & 0x0F
    msg = {
        "type": (data[0] >> 4) & 0x03,
        "code": data[1],
        "message_id": int.from_bytes(data[2:4], "big"),
        "token": data[4: 4 + tkl],
        "uri_path": [],
        "payload": b"",
    }
    off = 4 + tkl
    opt = 0
    while off < len(data):
        if data[off] == PAYLOAD_MARKER:
            msg["payload"] = data[off + 1:]
            break
        delta, ln = data[off] >> 4, data[off] & 0x0F
        off += 1
        if delta == 13:
            delta = 13 + data[off]
            off += 1
        if ln == 13:
            ln = 13 + data[off]
            off += 1
        opt += delta
        val = data[off: off + ln]
        off += ln
        if opt == OPT_URI_PATH:
            msg["uri_path"].append(val.decode())
    return msg


class _ServerProtocol(asyncio.DatagramProtocol):
    def __init__(self, handler: Callable[[dict, tuple], bytes | None]):
        self.handler = handler
        self.transport: asyncio.DatagramTransport | None = None

    def connection_made(self, transport):
        self.transport = transport

    def datagram_received(self, data, addr):
        try:
            msg = decode_message(data)
        except ValueError:
            return
        reply = self.handler(msg, addr)
        if reply is not None:
            self.transport.sendto(reply, addr)


class CoapServerEventReceiver(InboundEventReceiver):
    """CoAP ingest endpoint: POST/PUT to any path submits the payload
    (reference: CoapServerEventReceiver + CoapMessageDeliverer routing)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        super().__init__(f"coap:{port}")
        self.host, self.port = host, port
        self._transport: asyncio.DatagramTransport | None = None
        self._loop: asyncio.AbstractEventLoop | None = None

    @property
    def bound_port(self) -> int:
        assert self._transport is not None
        return self._transport.get_extra_info("sockname")[1]

    def _handle(self, msg: dict, addr: tuple) -> bytes | None:
        if msg["code"] in (POST, PUT):
            code = CREATED if msg["code"] == POST else CHANGED
            meta = {"uri_path": "/".join(msg["uri_path"]), "remote": str(addr)}
            batched = (self.source is not None
                       and self.source.batcher is not None
                       and self.source._wire_tag is not None)
            if batched and msg["type"] == CON:
                # WAL-before-ack: on the batched path the piggyback ACK
                # would outrun durability, so withhold it and send a
                # detached ACK once the batch clears the durability gate
                # (on_durable fires on the flusher thread — marshal the
                # sendto back onto the receiver's loop).
                ack = encode_message(ACK, code, msg["message_id"], msg["token"])

                def _send_ack() -> None:
                    if self._transport is not None:
                        self._transport.sendto(ack, addr)

                def _on_durable() -> None:
                    if self._loop is not None and not self._loop.is_closed():
                        self._loop.call_soon_threadsafe(_send_ack)

                self.submit(msg["payload"], meta, on_durable=_on_durable)
                return None
            self.submit(msg["payload"], meta)
        elif msg["code"] == 0:  # empty/ping
            return encode_message(RST, 0, msg["message_id"])
        else:
            code = BAD_REQUEST
        if msg["type"] == CON:
            return encode_message(ACK, code, msg["message_id"], msg["token"])
        return None

    async def on_start(self) -> None:
        loop = asyncio.get_running_loop()
        self._loop = loop
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _ServerProtocol(self._handle), local_addr=(self.host, self.port)
        )

    async def on_stop(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None


class CoapClient:
    """Fire a confirmable request and await the ACK (command delivery)."""

    def __init__(self, host: str, port: int, timeout: float = 5.0):
        self.host, self.port, self.timeout = host, port, timeout
        self._mid = 0

    async def request(self, code: int, uri_path: list[str], payload: bytes = b"") -> dict:
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self._mid = (self._mid + 1) % 0xFFFF

        class _P(asyncio.DatagramProtocol):
            def connection_made(self, transport):
                self.transport = transport

            def datagram_received(self, data, addr):
                if not fut.done():
                    try:
                        fut.set_result(decode_message(data))
                    except ValueError:
                        pass

        transport, _ = await loop.create_datagram_endpoint(
            _P, remote_addr=(self.host, self.port)
        )
        try:
            transport.sendto(
                encode_message(CON, code, self._mid, b"\x01", uri_path, payload)
            )
            return await asyncio.wait_for(fut, self.timeout)
        finally:
            transport.close()
