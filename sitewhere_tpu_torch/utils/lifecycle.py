"""Minimal lifecycle runtime for host-side components (port of
``sitewhere_tpu/utils/lifecycle.py``, a copy: the module is plain Python).

Every component runs an initialize -> start -> stop state machine with
nested children, as the reference's microservice framework does
(LifecycleComponent / CompositeLifecycleStep). An error marks a component
FAILED instead of crashing the engine; a required component re-raises,
a non-required one does not (EventSourcesManager.java:86-88).
"""

from __future__ import annotations

import asyncio
import enum
import logging

logger = logging.getLogger(__name__)


class LifecycleStatus(enum.Enum):
    STOPPED = "stopped"
    INITIALIZING = "initializing"
    INITIALIZED = "initialized"
    STARTING = "starting"
    STARTED = "started"
    STOPPING = "stopping"
    TERMINATED = "terminated"
    FAILED = "failed"


class LifecycleComponent:
    """Base host component with async lifecycle and nested children."""

    def __init__(self, name: str | None = None, required: bool = True):
        self.name = name or type(self).__name__
        self.required = required
        self.status = LifecycleStatus.STOPPED
        self.error: Exception | None = None
        self.children: list["LifecycleComponent"] = []

    def add_child(self, child: "LifecycleComponent") -> "LifecycleComponent":
        self.children.append(child)
        return child

    # subclass hooks -------------------------------------------------------
    async def on_initialize(self) -> None: ...

    async def on_start(self) -> None: ...

    async def on_stop(self) -> None: ...

    # phase runners ---------------------------------------------------------
    async def _guard(self, phase: str, status: LifecycleStatus,
                     final: LifecycleStatus, fn, children_first: bool) -> None:
        self.status = status
        try:
            if children_first:
                for c in self.children:
                    await getattr(c, phase)()
                await fn()
            else:
                await fn()
                for c in self.children:
                    await getattr(c, phase)()
            self.status = final
        except Exception as e:
            self.error = e
            self.status = LifecycleStatus.FAILED
            logger.exception("%s %s failed", self.name, phase)
            if self.required:
                raise

    async def initialize(self) -> None:
        await self._guard("initialize", LifecycleStatus.INITIALIZING,
                          LifecycleStatus.INITIALIZED, self.on_initialize, False)

    async def start(self) -> None:
        await self._guard("start", LifecycleStatus.STARTING,
                          LifecycleStatus.STARTED, self.on_start, False)

    async def stop(self) -> None:
        await self._guard("stop", LifecycleStatus.STOPPING,
                          LifecycleStatus.STOPPED, self.on_stop, True)

    async def run_lifespan(self) -> None:
        await self.initialize()
        await self.start()

    def describe(self) -> dict:
        return {
            "name": self.name,
            "status": self.status.value,
            "error": str(self.error) if self.error else None,
            "children": [c.describe() for c in self.children],
        }
