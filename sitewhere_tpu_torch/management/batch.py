"""Batch operations: fan one operation out to many devices (port of
``sitewhere_tpu/management/batch.py``, host only).

``BatchOperationManager`` processes queued operations with a bounded worker
pool and an optional per-element throttling delay, a handler registry keyed
by operation type (``BatchCommandInvocationHandler`` invokes a command per
device), per-element status and processed-date tracking, and a dead letter
of failed elements.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Callable, Protocol

from sitewhere_tpu_torch.core.types import BatchElementStatus
from sitewhere_tpu_torch.management.entities import EntityMeta, EntityStore


@dataclasses.dataclass
class BatchElement:
    device_token: str
    status: BatchElementStatus = BatchElementStatus.UNPROCESSED
    processed_ms: float | None = None
    error: str | None = None
    response_metadata: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BatchOperation:
    meta: EntityMeta
    operation_type: str
    parameters: dict[str, Any]
    elements: list[BatchElement]
    status: str = "Unprocessed"   # Unprocessed -> Processing -> Finished
    started_ms: float | None = None
    finished_ms: float | None = None

    def counts(self) -> dict[str, int]:
        out = {s.name: 0 for s in BatchElementStatus}
        for el in self.elements:
            out[el.status.name] += 1
        return out


class BatchOperationHandler(Protocol):
    operation_type: str

    async def process(self, operation: BatchOperation, element: BatchElement) -> dict: ...


class BatchCommandInvocationHandler:
    """Invoke a device command per element (reference:
    batch/handler/BatchCommandInvocationHandler.java). Parameters:
    ``commandToken`` + ``parameterValues``."""

    operation_type = "InvokeCommand"

    def __init__(self, command_service):
        self.command_service = command_service

    async def process(self, operation: BatchOperation, element: BatchElement) -> dict:
        inv = self.command_service.invoke(
            element.device_token,
            operation.parameters["commandToken"],
            operation.parameters.get("parameterValues", {}),
            initiator="BatchOperation",
            initiator_id=operation.meta.token,
        )
        await self.command_service.pump()
        return {"invocationId": inv.invocation_id}


class BatchOperationManager:
    """Creates + executes batch operations with bounded concurrency and
    throttling."""

    def __init__(self, concurrency: int = 10, throttle_delay_s: float = 0.0):
        self.operations: EntityStore[BatchOperation] = EntityStore("batch-operation")
        self.handlers: dict[str, BatchOperationHandler] = {}
        self.concurrency = concurrency
        self.throttle_delay_s = throttle_delay_s
        self.failed_elements: list[tuple[str, BatchElement]] = []

    def register_handler(self, handler: BatchOperationHandler) -> None:
        self.handlers[handler.operation_type] = handler

    def create_operation(self, token: str, operation_type: str,
                         device_tokens: list[str],
                         parameters: dict[str, Any] | None = None) -> BatchOperation:
        """Create (and queue) a batch operation — the BatchManagementTriggers
        -> unprocessed-batch-operations path."""
        if operation_type not in self.handlers:
            raise ValueError(f"no handler for operation type {operation_type!r}")
        if not device_tokens:
            raise ValueError("batch operation requires at least one device")
        return self.operations.create(
            token,
            lambda m: BatchOperation(
                meta=m,
                operation_type=operation_type,
                parameters=parameters or {},
                elements=[BatchElement(t) for t in device_tokens],
            ),
        )

    async def process_operation(self, token: str) -> BatchOperation:
        """Run all unprocessed elements through the handler."""
        op = self.operations.get(token)
        handler = self.handlers[op.operation_type]
        op.status = "Processing"
        op.started_ms = time.time() * 1000
        sem = asyncio.Semaphore(self.concurrency)

        async def run(element: BatchElement) -> None:
            async with sem:
                element.status = BatchElementStatus.PROCESSING
                try:
                    meta = await handler.process(op, element)
                    element.status = BatchElementStatus.SUCCEEDED
                    element.response_metadata = meta or {}
                except Exception as e:
                    element.status = BatchElementStatus.FAILED
                    element.error = str(e)
                    self.failed_elements.append((op.meta.token, element))
                element.processed_ms = time.time() * 1000
                if self.throttle_delay_s:
                    await asyncio.sleep(self.throttle_delay_s)

        await asyncio.gather(*(
            run(el) for el in op.elements
            if el.status is BatchElementStatus.UNPROCESSED
        ))
        op.status = "Finished"
        op.finished_ms = time.time() * 1000
        return op
