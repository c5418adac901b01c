"""Core type constants for the event engine (a copy of
``sitewhere_tpu/core/types.py``; the port keeps its own so it never imports
the JAX package).

The six device-event classes mirror the reference's event taxonomy
(reference: service-event-management/.../kafka/EventPersistenceMapper.java:92-115,
which dispatches addDeviceMeasurements / addDeviceLocations / addDeviceAlerts /
addDeviceCommandInvocations / addDeviceCommandResponses / addDeviceStateChanges).

Unlike the reference's per-event Java POJOs, events here are fixed-width
structure-of-arrays records (see events.py) so that a whole batch is a few
flat device tensors.
"""

from __future__ import annotations

import enum


class EventType(enum.IntEnum):
    """Device event classes (order is part of the wire format)."""

    MEASUREMENT = 0
    LOCATION = 1
    ALERT = 2
    COMMAND_INVOCATION = 3
    COMMAND_RESPONSE = 4
    STATE_CHANGE = 5


NUM_EVENT_TYPES = len(EventType)

# Payload layout: every event carries a fixed float32 value vector.
# MEASUREMENT   -> values[0:C] are per-channel measurement values
# LOCATION      -> values[0]=lat values[1]=lon values[2]=elevation
# ALERT         -> values[0]=severity level (AlertLevel), values[1]=source
# COMMAND_*     -> values unused (aux ids carry command/invocation ids)
# STATE_CHANGE  -> values[0]=state attribute ordinal
DEFAULT_VALUE_CHANNELS = 8

# aux int lane layout (interned host-side string ids):
# aux[0] = per-type discriminator id (measurement-name set id / alert-type id /
#          command id / state-attribute id)
# aux[1] = alternate/correlation id (dedup alternate id, invocation correlation)
AUX_LANES = 2


class AlertLevel(enum.IntEnum):
    """Alert severity (reference: IDeviceAlert.AlertLevel semantics)."""

    INFO = 0
    WARNING = 1
    ERROR = 2
    CRITICAL = 3


class AlertSource(enum.IntEnum):
    DEVICE = 0
    SYSTEM = 1


class DeviceAssignmentStatus(enum.IntEnum):
    """Assignment lifecycle (reference: device assignment status values used by
    RdbDeviceManagement device-assignment CRUD)."""

    ACTIVE = 0
    MISSING = 1
    RELEASED = 2


class PresenceState(enum.IntEnum):
    """Device presence (reference: service-device-state/.../presence/
    DevicePresenceManager.java:45-160 marks devices present/missing)."""

    PRESENT = 0
    MISSING = 1
    UNKNOWN = 2


class BatchElementStatus(enum.IntEnum):
    """Batch-operation element lifecycle (reference: service-batch-operations/
    .../BatchOperationManager.java element processing states)."""

    UNPROCESSED = 0
    PROCESSING = 1
    SUCCEEDED = 2
    FAILED = 3


# Sentinel for "no id" in int32 id lanes (device ids, assignment ids, ...).
NULL_ID = -1
