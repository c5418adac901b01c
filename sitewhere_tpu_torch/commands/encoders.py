"""Command execution encoders (port of ``sitewhere_tpu/commands/encoders.py``):
JSON, string, binary and scripted.

The binary encoder uses the same compact flat framing as ingest
(``ingest/decoders.py``), so a device SDK speaks one wire dialect both
ways.
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Protocol

from sitewhere_tpu_torch.commands.model import CommandExecution, SystemCommand


class ExecutionEncoder(Protocol):
    def encode(self, execution: CommandExecution) -> bytes: ...

    def encode_system(self, command: SystemCommand) -> bytes: ...


class JsonCommandExecutionEncoder:
    """JSON envelope (reference: encoding/json/JsonCommandExecutionEncoder)."""

    def encode(self, execution: CommandExecution) -> bytes:
        return json.dumps(
            {
                "command": execution.command.name,
                "commandToken": execution.command.token,
                "namespace": execution.command.namespace,
                "invocationId": execution.invocation.invocation_id,
                "parameters": execution.parameters,
            }
        ).encode()

    def encode_system(self, command: SystemCommand) -> bytes:
        return json.dumps(
            {"systemCommand": command.type.value, "payload": command.payload}
        ).encode()


class JsonStringCommandExecutionEncoder(JsonCommandExecutionEncoder):
    """String-payload variant (reference: encoding/string/
    JsonStringCommandExecutionEncoder) — same JSON, declared text."""


class BinaryCommandExecutionEncoder:
    """Compact flat binary framing (the protobuf/java-hybrid encoder slot):
    u8 ver=1 | u8 kind(1=user,2=system) | u32 invocation_id |
    u16 token_len | token | u16 n_params | n*(u16 klen|k|u16 vlen|v-json)."""

    def encode(self, execution: CommandExecution) -> bytes:
        tok = execution.command.token.encode()
        out = struct.pack("<BBIH", 1, 1, execution.invocation.invocation_id, len(tok)) + tok
        out += struct.pack("<H", len(execution.parameters))
        for k, v in execution.parameters.items():
            kb, vb = k.encode(), json.dumps(v).encode()
            out += struct.pack("<H", len(kb)) + kb + struct.pack("<H", len(vb)) + vb
        return out

    def encode_system(self, command: SystemCommand) -> bytes:
        tok = command.type.value.encode()
        payload = json.dumps(command.payload).encode()
        return (
            struct.pack("<BBIH", 1, 2, 0, len(tok)) + tok
            + struct.pack("<I", len(payload)) + payload
        )


class ScriptedCommandExecutionEncoder:
    """User Python callable (reference: scripted encoder variants under
    commands/scripting/)."""

    def __init__(self, fn: Callable[[CommandExecution], bytes],
                 system_fn: Callable[[SystemCommand], bytes] | None = None):
        self.fn = fn
        self.system_fn = system_fn

    def encode(self, execution: CommandExecution) -> bytes:
        return self.fn(execution)

    def encode_system(self, command: SystemCommand) -> bytes:
        if self.system_fn is None:
            return JsonCommandExecutionEncoder().encode_system(command)
        return self.system_fn(command)
