"""Command routing: invocation -> execution -> destination set (port of
``sitewhere_tpu/commands/routing.py``).

``CommandProcessingStrategy`` resolves the command and validates its
parameters, a router picks destinations (single choice, device-type
mapping, scripted, no-op), and ``CommandRoutingLogic`` delivers to every
resolved destination, parking the invocation in the undelivered dead
letter when a destination is down. ``NestedDeviceSupport`` resolves
gateway-nested targets to the parent device through ``engine.get_device``.
"""

from __future__ import annotations

import logging
from typing import Callable, Protocol

from sitewhere_tpu_torch.commands.model import (
    CommandExecution,
    CommandInvocation,
    DeviceCommand,
    SystemCommand,
)

logger = logging.getLogger(__name__)


class CommandRegistry:
    """Device-command definitions keyed by token, scoped by device type
    (the command slice of RdbDeviceManagement)."""

    def __init__(self):
        self._by_token: dict[str, DeviceCommand] = {}
        # fires ("upsert"|"delete", "device-command", token, cmd) after
        # each mutation — the cluster replicator's tap
        self.on_change = None

    def _notify(self, action: str, token: str, cmd) -> None:
        cb = self.on_change
        if cb is not None:
            cb(action, "device-command", token, cmd)

    def create(self, command: DeviceCommand) -> DeviceCommand:
        if command.token in self._by_token:
            raise ValueError(f"duplicate command token {command.token!r}")
        self._by_token[command.token] = command
        self._notify("upsert", command.token, command)
        return command

    def get(self, token: str) -> DeviceCommand | None:
        return self._by_token.get(token)

    def update(self, token: str, apply) -> DeviceCommand:
        """Mutate one command definition in place (REST PUT path; reference:
        DeviceTypes.java PUT /{token}/commands/{commandToken})."""
        cmd = self._by_token.get(token)
        if cmd is None:
            raise KeyError(f"unknown command {token!r}")
        apply(cmd)
        self._notify("upsert", token, cmd)
        return cmd

    def delete(self, token: str) -> bool:
        existed = self._by_token.pop(token, None) is not None
        if existed:
            self._notify("delete", token, None)
        return existed

    def apply_replicated(self, token: str,
                         command: "DeviceCommand | None") -> None:
        """Peer-shipped state; no hook (must not re-broadcast)."""
        if command is None:
            self._by_token.pop(token, None)
        else:
            self._by_token[token] = command

    def list_for_type(self, device_type: str) -> list[DeviceCommand]:
        return [c for c in self._by_token.values() if c.device_type == device_type]


class CommandProcessingStrategy:
    """Build a validated CommandExecution from an invocation."""

    def __init__(self, registry: CommandRegistry):
        self.registry = registry

    def build_execution(self, invocation: CommandInvocation) -> CommandExecution:
        command = self.registry.get(invocation.command_token)
        if command is None:
            raise ValueError(f"unknown command {invocation.command_token!r}")
        command.validate(invocation.parameter_values)
        return CommandExecution(
            invocation=invocation,
            command=command,
            parameters=dict(invocation.parameter_values),
        )


class CommandRouter(Protocol):
    def destinations_for(self, execution: CommandExecution) -> list[str]: ...

    def destinations_for_system(self, command: SystemCommand,
                                device_type: str | None) -> list[str]: ...


class SingleChoiceCommandRouter:
    """Route everything to the one configured destination
    (reference: SingleChoiceCommandRouter)."""

    def __init__(self, destination_id: str):
        self.destination_id = destination_id

    def destinations_for(self, execution):
        return [self.destination_id]

    def destinations_for_system(self, command, device_type):
        return [self.destination_id]


class DeviceTypeMappingCommandRouter:
    """Map device type -> destination id with optional default
    (reference: DeviceTypeMappingCommandRouter)."""

    def __init__(self, mappings: dict[str, str], default: str | None = None):
        self.mappings = mappings
        self.default = default

    def _route(self, device_type: str | None) -> list[str]:
        dest = self.mappings.get(device_type or "", self.default)
        if dest is None:
            raise ValueError(f"no destination mapped for device type {device_type!r}")
        return [dest]

    def destinations_for(self, execution):
        return self._route(execution.command.device_type)

    def destinations_for_system(self, command, device_type):
        return self._route(device_type)


class ScriptedCommandRouter:
    """User Python callable returning destination ids
    (reference: ScriptedCommandRouter, Groovy)."""

    def __init__(self, fn: Callable[[CommandExecution], list[str]]):
        self.fn = fn

    def destinations_for(self, execution):
        return list(self.fn(execution))

    def destinations_for_system(self, command, device_type):
        return []


class NoOpCommandRouter:
    def destinations_for(self, execution):
        return []

    def destinations_for_system(self, command, device_type):
        return []


class NestedDeviceSupport:
    """Resolve delivery target for nested devices: commands for a child
    device route to its gateway parent (commands/NestedDeviceSupport.java)."""

    def __init__(self, engine):
        self.engine = engine

    def resolve_target_token(self, device_token: str) -> str:
        info = self.engine.get_device(device_token)
        if info is None:
            return device_token
        # walk to the root gateway via host metadata
        seen = {device_token}
        current = info
        while current.metadata.get("parentToken") and current.metadata["parentToken"] not in seen:
            parent = self.engine.get_device(current.metadata["parentToken"])
            if parent is None:
                break
            seen.add(current.metadata["parentToken"])
            current = parent
        return current.token
