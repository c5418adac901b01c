"""Partitioned event hub: the Azure Event Hubs consumption model, in-process
(port of ``sitewhere_tpu/ingest/eventhub.py``; plain Python on the port's
``ingest/sources.py``).

The reference consumes Azure Event Hubs through an ``EventProcessorHost``
(sources/azure/EventHubInboundEventReceiver.java): a named hub with fixed
partitions, a consumer group, one processor per owned partition receiving
*batches* (``onEvents``), offsets/sequence numbers per event, and periodic
checkpointing to a storage container every 5 events
(``checkpointBatchingCount % 5``, lines 77-92) so a restarted host resumes
from the last checkpoint. The Azure SDK and network egress don't exist in
this image, so the *consumption semantics* are implemented here natively:
``EventHub`` (partitioned log, partition-key hashing), ``CheckpointStore``
(per consumer-group/partition offsets, optionally file-backed),
``EventProcessorHost`` (partition ownership split across hosts of a group,
batch delivery, periodic checkpoint, resume), and the ingest receiver
built on them.

Legacy-compat receiver: delivery lands on the per-event
``InboundEventSource`` path. New high-rate device transports should use
the batched persistent-connection edge (``ingest/wire_edge.py``);
sources kept on this receiver inherit the manager's shared
``WireBatcher`` (batched arena submission) when their decoder declares
a ``wire_tag``.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import pathlib
import zlib
from collections import deque
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from sitewhere_tpu_torch.ingest.sources import InboundEventReceiver

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class EventData:
    """One hub record (EventData analog: body + system properties)."""

    body: bytes
    offset: int
    sequence_number: int
    partition_id: int
    partition_key: str | None = None


class _Partition:
    """One retention-bounded partition log. ``base`` is the offset of the
    first retained event; offsets are absolute and survive trimming (Kafka/
    EventHub retention semantics)."""

    def __init__(self, retention: int):
        self.events: deque[EventData] = deque()
        self.base = 0
        self.retention = retention

    @property
    def end(self) -> int:
        return self.base + len(self.events)

    def append(self, ev: EventData) -> None:
        self.events.append(ev)
        while len(self.events) > self.retention:
            self.events.popleft()
            self.base += 1

    def read(self, from_offset: int, max_batch: int) -> list[EventData]:
        start = max(from_offset, self.base) - self.base
        return list(self.events)[start: start + max_batch]


class EventHub:
    """A named hub with a fixed number of retention-bounded partitions.

    Send with a partition key (stable hash, like the reference keying Kafka
    by device token) or round-robin without one. ``retention`` bounds each
    partition; readers behind the retention window age out to the oldest
    retained offset.
    """

    def __init__(self, name: str, partition_count: int = 4,
                 retention: int = 100_000):
        assert partition_count > 0
        self.name = name
        # log generation id: a checkpoint taken against a different (e.g.
        # pre-restart) hub instance must not be applied to this log
        self.epoch = os.urandom(8).hex()
        self.partitions: list[_Partition] = [
            _Partition(retention) for _ in range(partition_count)]
        self._rr = 0
        self._waiters: list[asyncio.Event] = []

    @property
    def partition_count(self) -> int:
        return len(self.partitions)

    def send(self, body: bytes, partition_key: str | None = None) -> EventData:
        if partition_key is not None:
            pid = zlib.crc32(partition_key.encode()) % self.partition_count
        else:
            pid = self._rr
            self._rr = (self._rr + 1) % self.partition_count
        part = self.partitions[pid]
        ev = EventData(body=body, offset=part.end,
                       sequence_number=part.end, partition_id=pid,
                       partition_key=partition_key)
        part.append(ev)
        for w in self._waiters:
            w.set()
        return ev

    def read(self, partition_id: int, from_offset: int,
             max_batch: int = 64) -> list[EventData]:
        return self.partitions[partition_id].read(from_offset, max_batch)

    def end_offset(self, partition_id: int) -> int:
        return self.partitions[partition_id].end

    def register_waiter(self, event: asyncio.Event) -> None:
        self._waiters.append(event)

    def unregister_waiter(self, event: asyncio.Event) -> None:
        if event in self._waiters:
            self._waiters.remove(event)


class CheckpointStore:
    """Per (consumer group, partition) offset checkpoints — the storage-
    container analog. Optionally file-backed so a new host resumes. Each
    checkpoint records the hub's log epoch; a checkpoint from a different
    log generation is ignored (resume from the log start, at-least-once)."""

    def __init__(self, path: str | pathlib.Path | None = None):
        self.path = pathlib.Path(path) if path is not None else None
        self._data: dict[str, dict] = {}
        if self.path is not None and self.path.exists():
            self._data = json.loads(self.path.read_text())

    @staticmethod
    def _key(group: str, partition_id: int) -> str:
        return f"{group}/{partition_id}"

    def get(self, group: str, partition_id: int, epoch: str) -> int:
        entry = self._data.get(self._key(group, partition_id))
        if entry is None or entry.get("epoch") != epoch:
            return 0
        return entry["offset"]

    def checkpoint(self, group: str, partition_id: int, next_offset: int,
                   epoch: str) -> None:
        self._data[self._key(group, partition_id)] = {
            "offset": next_offset, "epoch": epoch}
        if self.path is not None:
            self.path.write_text(json.dumps(self._data))


OnEvents = Callable[[int, list[EventData]], Awaitable[None] | None]


class EventProcessorHost:
    """Owns a subset of a hub's partitions for one consumer group and drives
    a processor callback with event batches, checkpointing every
    ``checkpoint_every`` events (reference default: 5)."""

    _groups: dict[tuple[int, str], list["EventProcessorHost"]] = {}

    def __init__(self, hub: EventHub, consumer_group: str,
                 store: CheckpointStore | None = None,
                 checkpoint_every: int = 5, max_batch: int = 64,
                 host_name: str = "host"):
        self.hub = hub
        self.consumer_group = consumer_group
        self.store = store or CheckpointStore()
        self.checkpoint_every = checkpoint_every
        self.max_batch = max_batch
        self.host_name = host_name
        self.on_events: OnEvents | None = None
        self._tasks: list[asyncio.Task] = []
        self._wake = asyncio.Event()
        self._since_checkpoint: dict[int, int] = {}
        self._next: dict[int, int] = {}

    def _group_key(self) -> tuple[int, str]:
        return (id(self.hub), self.consumer_group)

    def owned_partitions(self) -> list[int]:
        """Partitions leased to this host: the group's hosts split the
        partition space evenly (the EventProcessorHost lease analog)."""
        peers = self._groups.get(self._group_key(), [self])
        idx = peers.index(self)
        return [p for p in range(self.hub.partition_count)
                if p % len(peers) == idx]

    async def register(self) -> None:
        self._groups.setdefault(self._group_key(), []).append(self)
        self.hub.register_waiter(self._wake)
        self._tasks.append(asyncio.create_task(self._pump()))

    async def unregister(self) -> None:
        peers = self._groups.get(self._group_key(), [])
        if self in peers:
            peers.remove(self)
        self.hub.unregister_waiter(self._wake)
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()

    async def _pump(self) -> None:
        try:
            while True:
                drained = await self._drain_once()
                if not drained:
                    self._wake.clear()
                    try:
                        await asyncio.wait_for(self._wake.wait(), 0.5)
                    except asyncio.TimeoutError:
                        pass
        except asyncio.CancelledError:
            pass

    async def _drain_once(self) -> bool:
        any_events = False
        for pid in self.owned_partitions():
            if pid not in self._next:
                self._next[pid] = self.store.get(self.consumer_group, pid,
                                                 self.hub.epoch)
                self._since_checkpoint[pid] = 0
            batch = self.hub.read(pid, self._next[pid], self.max_batch)
            if not batch:
                continue
            any_events = True
            if self.on_events is not None:
                res = self.on_events(pid, batch)
                if asyncio.iscoroutine(res):
                    await res
            # offsets are absolute; a reader behind the retention window
            # ages out to wherever the log actually resumed
            self._next[pid] = batch[-1].offset + 1
            self._since_checkpoint[pid] += len(batch)
            if self._since_checkpoint[pid] >= self.checkpoint_every:
                self.store.checkpoint(self.consumer_group, pid,
                                      self._next[pid], self.hub.epoch)
                self._since_checkpoint[pid] = 0
        return any_events


class EventHubEventReceiver(InboundEventReceiver):
    """Consume a hub through a processor host and submit payloads to the
    event source (reference: sources/azure/EventHubInboundEventReceiver)."""

    def __init__(self, hub: EventHub, consumer_group: str = "$Default",
                 store: CheckpointStore | None = None,
                 checkpoint_every: int = 5):
        super().__init__(f"eventhub:{hub.name}")
        self.host = EventProcessorHost(hub, consumer_group, store,
                                       checkpoint_every)

    async def on_start(self) -> None:
        async def on_events(pid: int, batch: list[EventData]) -> None:
            for ev in batch:
                self.submit(ev.body, {"partition": pid, "offset": ev.offset})

        self.host.on_events = on_events
        await self.host.register()

    async def on_stop(self) -> None:
        await self.host.unregister()
