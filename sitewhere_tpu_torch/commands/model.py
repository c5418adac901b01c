"""Command model: device commands, invocations, executions (port of
``sitewhere_tpu/commands/model.py``).

A device command definition (token, namespace, parameters) registered per
device type, a ``CommandInvocation`` event targeting a device, and the
``CommandExecution`` the processing strategy builds and the encoders
serialize for delivery. Invocation ids come from a process-global counter
of this package (``next_invocation_id``).
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any


class ParameterType(enum.Enum):
    STRING = "String"
    DOUBLE = "Double"
    INT64 = "Int64"
    BOOL = "Bool"


@dataclasses.dataclass(frozen=True)
class CommandParameter:
    name: str
    type: ParameterType = ParameterType.STRING
    required: bool = False


@dataclasses.dataclass
class DeviceCommand:
    """A command definition bound to a device type (reference: RdbDeviceCommand
    entity, created via RdbDeviceManagement.createDeviceCommand)."""

    token: str
    device_type: str
    name: str
    namespace: str = "http://sitewhere/tpu"
    description: str = ""
    parameters: tuple[CommandParameter, ...] = ()

    def validate(self, values: dict[str, Any]) -> None:
        known = {p.name for p in self.parameters}
        for p in self.parameters:
            if p.required and p.name not in values:
                raise ValueError(f"missing required parameter {p.name!r}")
        unknown = set(values) - known
        if unknown:
            raise ValueError(f"unknown parameters {sorted(unknown)}")


def command_from_json(token: str, device_type: str, name: str,
                      namespace: str = "http://sitewhere/tpu",
                      description: str = "",
                      parameters: list[dict] | None = None) -> DeviceCommand:
    """Build a DeviceCommand from the wire/JSON shape shared by the REST
    and RPC create-command surfaces (reference: DeviceCommandCreateRequest
    marshaling)."""
    return DeviceCommand(
        token=token, device_type=device_type, name=name,
        namespace=namespace, description=description,
        parameters=tuple(
            CommandParameter(p["name"],
                             ParameterType(p.get("type", "String")),
                             p.get("required", False))
            for p in (parameters or [])))


class SystemCommandType(enum.Enum):
    """Built-in system commands (reference: RegistrationAck et al. sent by
    DeviceRegistrationManager.java:150-163)."""

    REGISTRATION_ACK = "RegistrationAck"
    REGISTRATION_FAILED = "RegistrationFailed"
    DEVICE_STREAM_ACK = "DeviceStreamAck"
    DEVICE_STREAM_DATA = "DeviceStreamData"   # chunk delivery to the device


_invocation_ids = itertools.count(1)
_invocation_lock = threading.Lock()


def next_invocation_id() -> int:
    with _invocation_lock:
        return next(_invocation_ids)


@dataclasses.dataclass
class CommandInvocation:
    """One command targeted at a device/assignment (CommandInvocation event)."""

    invocation_id: int
    command_token: str
    device_token: str
    tenant: str = "default"
    assignment_id: int = -1
    parameter_values: dict[str, Any] = dataclasses.field(default_factory=dict)
    initiator: str = "REST"            # reference: CommandInitiator
    initiator_id: str = ""
    target: str = "Assignment"         # reference: CommandTarget
    ts_ms: int = 0


@dataclasses.dataclass
class SystemCommand:
    """System (non-user) command, e.g. registration ack."""

    type: SystemCommandType
    device_token: str
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CommandExecution:
    """Invocation + resolved command + validated parameters — the unit the
    encoders serialize (IDeviceCommandExecution analog)."""

    invocation: CommandInvocation
    command: DeviceCommand
    parameters: dict[str, Any]
