"""Control-plane RPC client with optional response caching.

The reference's services consume each other's gRPC APIs through
``*ApiChannel`` clients, and hot lookups go through
``CachedDeviceManagementApiChannel`` (created at
InboundProcessingMicroservice.java:159-167) so the per-event
getDeviceByToken doesn't hit the wire every time. Same split here: one
multiplexed connection with concurrent in-flight calls, plus a TTL cache
wrapper for the device-lookup family.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from typing import Any

from sitewhere_tpu_torch.rpc.protocol import (RpcError, frame_chunks,
                                        read_frame)


class RpcClient:
    """Async client over one connection; calls multiplex by request id."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tenant: str | None = None, auth_token: str | None = None):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.auth_token = auth_token
        self._ids = itertools.count(1)
        self._pending: dict[int, asyncio.Future] = {}
        self._reader = None
        self._writer = None
        self._recv_task = None
        self._send_lock: asyncio.Lock | None = None
        self._dead: BaseException | None = None   # terminal connection error

    async def connect(self) -> "RpcClient":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        self._send_lock = asyncio.Lock()
        self._recv_task = asyncio.ensure_future(self._recv_loop())
        if self.auth_token is not None:
            # system-user security context: authenticate the connection
            # before any call rides it (SystemUserRunnable analog)
            try:
                await self.call("Auth.handshake", token=self.auth_token)
            except BaseException:
                await self.close()
                raise
        return self

    async def close(self) -> None:
        if self._recv_task is not None:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except (asyncio.CancelledError, Exception):
                pass
        if self._writer is not None:
            self._writer.close()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionError("client closed"))
        self._pending.clear()

    async def _recv_loop(self) -> None:
        error: BaseException = ConnectionError("server closed")
        try:
            while True:
                frame = await read_frame(self._reader)
                if frame is None:
                    break
                fut = self._pending.pop(frame.get("id"), None)
                if fut is None or fut.done():
                    continue
                if "error" in frame:
                    fut.set_exception(
                        RpcError(frame["error"], frame.get("code", 500),
                                 retry_after_s=frame.get("retryAfterS"),
                                 data=frame.get("data")))
                else:
                    fut.set_result(frame.get("result"))
        except asyncio.CancelledError:
            error = ConnectionError("client closed")
            raise
        except Exception as e:
            # protocol violation (oversized frame, corrupt JSON): the
            # connection is unusable — fail every in-flight call loudly
            error = e
        finally:
            self._dead = error   # later call()s fail fast, never hang
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(error)
            self._pending.clear()

    async def call(self, method: str, **params: Any) -> Any:
        if self._dead is not None:
            # writes to a lost asyncio transport do not raise; without this
            # check a post-disconnect call would park a future forever
            raise ConnectionError(f"rpc connection dead: {self._dead}")
        # reserved: a bytes blob under _attachment rides the frame RAW
        # (no base64/json escaping) — the cross-rank payload hot path
        attachment = params.pop("_attachment", None)
        # reserved: _tp carries the W3C traceparent OUTSIDE params (the
        # handler never sees it as an argument); explicit wins over the
        # caller task's bound context
        traceparent = params.pop("_tp", None)
        if traceparent is None:
            from sitewhere_tpu_torch.utils.tracing import current_traceparent

            traceparent = current_traceparent()
        rid = next(self._ids)
        fut = asyncio.get_event_loop().create_future()
        self._pending[rid] = fut
        req = {"id": rid, "method": method, "params": params}
        if traceparent is not None:
            req["tp"] = traceparent
        if self.tenant is not None:
            req["tenant"] = self.tenant
        try:
            async with self._send_lock:
                for chunk in frame_chunks(req, attachment):
                    self._writer.write(chunk)
                await self._writer.drain()
        except BaseException:
            self._pending.pop(rid, None)   # never leak an unsent call
            raise
        return await fut


class CachedDeviceClient:
    """TTL cache over the device-lookup family
    (CachedDeviceManagementApiChannel analog)."""

    def __init__(self, client: RpcClient, ttl_s: float = 60.0,
                 max_entries: int = 100_000):
        self.client = client
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self._cache: dict[str, tuple[float, Any]] = {}
        self.hits = 0
        self.misses = 0

    async def get_device_by_token(self, token: str) -> Any:
        ent = self._cache.get(token)
        now = time.monotonic()
        if ent is not None and now - ent[0] < self.ttl_s:
            self.hits += 1
            return ent[1]
        self.misses += 1
        result = await self.client.call(
            "DeviceManagement.getDeviceByToken", token=token)
        if result is not None:          # negative results are not cached
            if len(self._cache) >= self.max_entries:
                self._cache.pop(next(iter(self._cache)))
            self._cache[token] = (now, result)
        return result

    def invalidate(self, token: str | None = None) -> None:
        if token is None:
            self._cache.clear()
        else:
            self._cache.pop(token, None)
