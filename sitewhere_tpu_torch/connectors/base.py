"""Outbound connectors: fan persisted events out to external systems (port
of ``sitewhere_tpu/connectors/base.py``).

An ``OutboundConnector`` base with filtered and serial (retrying) variants,
event filters (area, device type, scripted predicate), and the
per-connector consumer host with batch processing, offset commits and a
failed-batch hook. The consumer group is a ``FeedConsumer`` over the
engine's event store.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Iterable, Protocol

from sitewhere_tpu_torch.outbound.feed import FeedConsumer, OutboundEvent
from sitewhere_tpu_torch.utils.lifecycle import LifecycleComponent

logger = logging.getLogger(__name__)


# --- filters -----------------------------------------------------------------


class EventFilter(Protocol):
    def is_excluded(self, event: OutboundEvent) -> bool: ...


class AreaFilter:
    """Include or exclude by area id (reference: connectors/filter/AreaFilter)."""

    def __init__(self, area_ids: Iterable[int], operation: str = "include"):
        self.area_ids = set(area_ids)
        self.include = operation == "include"

    def is_excluded(self, event: OutboundEvent) -> bool:
        member = event.area_id in self.area_ids
        return (not member) if self.include else member


class DeviceTypeFilter:
    """Include/exclude by device type (connectors/filter/DeviceTypeFilter)."""

    def __init__(self, engine, device_types: Iterable[str], operation: str = "include"):
        self.engine = engine
        self.device_types = set(device_types)
        self.include = operation == "include"

    def is_excluded(self, event: OutboundEvent) -> bool:
        from sitewhere_tpu_torch.engine import local_device_info

        # feed records carry THIS rank's local device ids
        info = local_device_info(self.engine, event.device_id)
        member = info is not None and info.device_type in self.device_types
        return (not member) if self.include else member


class ScriptedFilter:
    """User predicate; True = exclude (connectors/groovy/filter/ScriptedFilter)."""

    def __init__(self, fn: Callable[[OutboundEvent], bool]):
        self.fn = fn

    def is_excluded(self, event: OutboundEvent) -> bool:
        return bool(self.fn(event))


# --- connectors --------------------------------------------------------------


class OutboundConnector(LifecycleComponent):
    """Base connector: override ``process_batch`` (or ``process_event``)."""

    def __init__(self, connector_id: str, filters: list[EventFilter] | None = None):
        super().__init__(f"connector:{connector_id}")
        self.connector_id = connector_id
        self.filters = filters or []
        self.processed_count = 0
        self.failed_batches: list[list[OutboundEvent]] = []

    def accepts(self, event: OutboundEvent) -> bool:
        return not any(f.is_excluded(event) for f in self.filters)

    async def process_batch(self, events: list[OutboundEvent]) -> None:
        for ev in events:
            await self.process_event(ev)

    async def process_event(self, event: OutboundEvent) -> None:
        raise NotImplementedError


class SerialOutboundConnector(OutboundConnector):
    """Per-event processing with bounded retries + backoff (reference:
    SerialOutboundConnector's per-event semantics with retry)."""

    def __init__(self, connector_id: str, filters=None, max_retries: int = 3,
                 backoff_s: float = 0.05):
        super().__init__(connector_id, filters)
        self.max_retries = max_retries
        self.backoff_s = backoff_s

    async def process_batch(self, events: list[OutboundEvent]) -> None:
        for ev in events:
            for attempt in range(self.max_retries + 1):
                try:
                    await self.process_event(ev)
                    break
                except Exception:
                    if attempt == self.max_retries:
                        raise
                    await asyncio.sleep(self.backoff_s * (2**attempt))


class ConnectorHost(LifecycleComponent):
    """Drives one connector from its own feed consumer (consumer-group
    analog: group id = "connector.{id}", KafkaOutboundConnectorHost.java:82-87).
    ``pump()`` polls, filters, processes, commits; a failing batch lands in
    the connector's failed-batch list and the offset still advances
    (at-least-once with dead-letter, mirroring the reference's
    failed-batch hook)."""

    def __init__(self, engine, connector: OutboundConnector,
                 max_batch: int = 1024, start_from_latest: bool = False):
        super().__init__(f"connector-host:{connector.connector_id}")
        self.engine = engine
        self.connector = connector
        self.add_child(connector)
        self.consumer = engine.make_feed_consumer(
            f"connector.{connector.connector_id}", max_batch=max_batch,
            start_from_latest=start_from_latest,
        )
        self._task: asyncio.Task | None = None
        self.poll_interval_s = 0.05

    async def pump(self) -> int:
        events = self.consumer.poll()
        if not events:
            return 0
        accepted = [e for e in events if self.connector.accepts(e)]
        if accepted:
            try:
                await self.connector.process_batch(accepted)
                self.connector.processed_count += len(accepted)
            except Exception as e:
                logger.warning("connector %s batch failed: %s",
                               self.connector.connector_id, e)
                self.connector.failed_batches.append(accepted)
        self.consumer.commit(events)
        return len(accepted)

    async def _loop(self) -> None:
        while True:
            try:
                n = await self.pump()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("connector host %s pump error", self.name)
                n = 0
            if not n:
                await asyncio.sleep(self.poll_interval_s)

    async def on_start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def on_stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
