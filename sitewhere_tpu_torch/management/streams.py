"""Device streaming media: binary stream storage per assignment (port of
``sitewhere_tpu/management/streams.py``, host only).

Chunked append with sequence numbers, ordered readback, bounded memory per
stream with spill-to-disk for the tail, and the device-initiated command
path: stream create / data / send-data requests arriving through ingest are
handled by :class:`DeviceStreamService`, with acks and chunk deliveries
going back over command delivery.
"""

from __future__ import annotations

import base64
import dataclasses
import pathlib
import tempfile
import threading
from typing import Iterator

from sitewhere_tpu_torch.management.entities import EntityMeta, EntityNotFound, EntityStore


@dataclasses.dataclass
class DeviceStream:
    meta: EntityMeta
    device_token: str
    content_type: str = "application/octet-stream"
    chunk_count: int = 0
    total_bytes: int = 0


class DeviceStreamManager:
    """Chunk store: recent chunks stay in memory (up to
    ``memory_budget_bytes`` per stream); older chunks spill to an
    append-only file per stream and read back transparently."""

    def __init__(self, max_chunks_per_stream: int = 1 << 16,
                 memory_budget_bytes: int = 1 << 20,
                 spill_dir: str | None = None):
        self.streams: EntityStore[DeviceStream] = EntityStore("device-stream")
        self._chunks: dict[str, list[tuple[int, bytes]]] = {}
        self._mem_bytes: dict[str, int] = {}
        # stream token -> {sequence: (offset, length)} in the spill file
        self._spill_index: dict[str, dict[int, tuple[int, int]]] = {}
        self._lock = threading.Lock()
        self.max_chunks = max_chunks_per_stream
        self.memory_budget = memory_budget_bytes
        self._spill_dir = pathlib.Path(spill_dir) if spill_dir else None

    def _spill_path(self, token: str) -> pathlib.Path:
        if self._spill_dir is None:
            self._spill_dir = pathlib.Path(tempfile.mkdtemp(prefix="swtpu-streams-"))
        sid = self.streams.get(token).meta.id
        return self._spill_dir / f"stream-{sid}.bin"

    def create_stream(self, token: str, device_token: str,
                      content_type: str = "application/octet-stream") -> DeviceStream:
        stream = self.streams.create(
            token,
            lambda m: DeviceStream(meta=m, device_token=device_token,
                                   content_type=content_type),
        )
        self._chunks[token] = []
        self._mem_bytes[token] = 0
        self._spill_index[token] = {}
        return stream

    def append_chunk(self, stream_token: str, sequence: int, data: bytes) -> None:
        stream = self.streams.get(stream_token)
        with self._lock:
            chunks = self._chunks[stream_token]
            spilled = self._spill_index[stream_token]
            if len(chunks) + len(spilled) >= self.max_chunks:
                # evict the oldest chunk overall: spilled first (no memory
                # accounting), else the oldest resident chunk WITH its bytes
                if spilled:
                    del spilled[min(spilled)]
                elif chunks:
                    _, old = chunks.pop(0)
                    self._mem_bytes[stream_token] -= len(old)
            chunks.append((sequence, data))
            self._mem_bytes[stream_token] += len(data)
            stream.chunk_count = (len(chunks)
                                  + len(self._spill_index[stream_token]))
            stream.total_bytes += len(data)
            # over budget: spill the OLDEST in-memory chunks to disk so hot
            # (recent) chunks stay in memory
            while (self._mem_bytes[stream_token] > self.memory_budget
                   and len(chunks) > 1):
                seq, old = chunks.pop(0)
                path = self._spill_path(stream_token)
                with open(path, "ab") as fh:
                    offset = fh.tell()
                    fh.write(old)
                self._spill_index[stream_token][seq] = (offset, len(old))
                self._mem_bytes[stream_token] -= len(old)

    def _read_spilled(self, stream_token: str, seq: int) -> bytes | None:
        entry = self._spill_index.get(stream_token, {}).get(seq)
        if entry is None:
            return None
        offset, length = entry
        with open(self._spill_path(stream_token), "rb") as fh:
            fh.seek(offset)
            return fh.read(length)

    def get_chunk(self, stream_token: str, sequence: int) -> bytes | None:
        self.streams.get(stream_token)
        for seq, data in self._chunks.get(stream_token, []):
            if seq == sequence:
                return data
        return self._read_spilled(stream_token, sequence)

    def iter_content(self, stream_token: str) -> Iterator[bytes]:
        """Chunks in sequence order (request-stream command response path),
        merging spilled and in-memory chunks."""
        self.streams.get(stream_token)
        mem = {seq: data for seq, data in self._chunks.get(stream_token, [])}
        seqs = sorted(set(mem) | set(self._spill_index.get(stream_token, {})))
        for seq in seqs:
            if seq in mem:
                yield mem[seq]
            else:
                yield self._read_spilled(stream_token, seq) or b""

    def read_all(self, stream_token: str) -> bytes:
        return b"".join(self.iter_content(stream_token))

    def memory_resident_bytes(self, stream_token: str) -> int:
        return self._mem_bytes.get(stream_token, 0)

    def spilled_chunks(self, stream_token: str) -> int:
        return len(self._spill_index.get(stream_token, {}))


class DeviceStreamService:
    """Device-initiated stream commands (reference:
    media/DeviceStreamManager.java:36-80 handleDeviceStreamRequest /
    handleDeviceStreamDataRequest / handleSendDeviceStreamDataRequest).

    Requests arrive through the ingest edge like any device request;
    responses — stream-create acks and requested chunks — travel back over
    the command-delivery downlink as system commands."""

    def __init__(self, manager: DeviceStreamManager, commands):
        self.manager = manager
        self.commands = commands
        # strong refs: the event loop holds tasks only weakly — an
        # unanchored downlink task could be GC'd mid-send
        self._downlink_tasks: set = set()

    def handles(self, req) -> bool:
        from sitewhere_tpu_torch.ingest.requests import RequestType

        return req.type in (RequestType.DEVICE_STREAM,
                            RequestType.DEVICE_STREAM_DATA,
                            RequestType.SEND_DEVICE_STREAM_DATA)

    def handle_request(self, req) -> None:
        """Dispatch one stream request; downlink responses are scheduled on
        the running loop (ingest receivers are async) or sent inline."""
        from sitewhere_tpu_torch.ingest.requests import RequestType

        if req.type is RequestType.DEVICE_STREAM:
            self._handle_create(req)
        elif req.type is RequestType.DEVICE_STREAM_DATA:
            self._handle_data(req)
        elif req.type is RequestType.SEND_DEVICE_STREAM_DATA:
            self._handle_send(req)

    def _downlink(self, command) -> None:
        import asyncio

        coro = self.commands.send_system_command(command.device_token, command)
        try:
            task = asyncio.get_running_loop().create_task(coro)
            self._downlink_tasks.add(task)
            task.add_done_callback(self._downlink_tasks.discard)
        except RuntimeError:
            asyncio.run(coro)

    def _handle_create(self, req) -> None:
        from sitewhere_tpu_torch.commands.model import SystemCommand, SystemCommandType

        token = str(req.extras.get("streamId") or req.extras.get("streamToken"))
        try:
            self.manager.create_stream(
                token, req.device_token,
                content_type=str(req.extras.get("contentType",
                                                "application/octet-stream")))
            ok = True
        except Exception:
            ok = self.manager.streams.try_get(token) is not None  # idempotent
        self._downlink(SystemCommand(
            SystemCommandType.DEVICE_STREAM_ACK, req.device_token,
            {"streamId": token, "status": "Ready" if ok else "Failed"}))

    def _handle_data(self, req) -> None:
        import binascii
        import logging

        token = str(req.extras.get("streamId") or req.extras.get("streamToken"))
        try:
            seq = int(req.extras.get("sequenceNumber", 0))
            data = base64.b64decode(req.extras.get("data", ""))
            self.manager.append_chunk(token, seq, data)
        except (EntityNotFound, binascii.Error, ValueError, TypeError) as e:
            # a malformed/orphan chunk must never kill the ingest reader
            # loop it arrived on — drop it like a failed decode
            logging.getLogger(__name__).warning(
                "dropping stream chunk for %r: %s", token, e)

    def _handle_send(self, req) -> None:
        from sitewhere_tpu_torch.commands.model import SystemCommand, SystemCommandType

        token = str(req.extras.get("streamId") or req.extras.get("streamToken"))
        seq = int(req.extras.get("sequenceNumber", 0))
        try:
            chunk = self.manager.get_chunk(token, seq)
        except EntityNotFound:
            chunk = None
        self._downlink(SystemCommand(
            SystemCommandType.DEVICE_STREAM_DATA, req.device_token,
            {"streamId": token, "sequenceNumber": seq,
             "data": base64.b64encode(chunk or b"").decode(),
             "found": chunk is not None}))
