"""EventBatch: fixed-width structure-of-arrays device-event records, as
tensors (port of ``sitewhere_tpu/core/events.py``).

A batch of decoded events is one dataclass of flat tensors, so one pipeline
step runs over the whole batch. Timestamps are int32 milliseconds relative
to a host-held epoch base (:class:`EpochBase`), as in the JAX package.
:func:`pack_batches` / :func:`unpack_batch` carry K host batches to the
device as one contiguous byte buffer (the engine's scan-chunk copy path).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE, resolve_device
from sitewhere_tpu_torch.core.types import (AUX_LANES, DEFAULT_VALUE_CHANNELS,
                                            NULL_ID)


@dataclasses.dataclass(frozen=True)
class EventBatch:
    """A padded batch of decoded device events (structure-of-arrays).

    Shapes use B = batch capacity, C = value channels. Padding rows have
    ``valid == False`` and id lanes set to NULL_ID.
    """

    valid: torch.Tensor        # bool[B]
    etype: torch.Tensor        # int32[B]   EventType ordinal
    token_id: torch.Tensor     # int32[B]   interned device-token id
    tenant_id: torch.Tensor    # int32[B]
    ts_ms: torch.Tensor        # int32[B]   event time, ms since EpochBase
    received_ms: torch.Tensor  # int32[B]
    values: torch.Tensor       # float32[B, C]
    vmask: torch.Tensor        # bool[B, C]
    aux: torch.Tensor          # int32[B, AUX_LANES]
    seq: torch.Tensor          # int32[B]   per-batch sequence

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def channels(self) -> int:
        return self.values.shape[1]

    def count(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int32)

    @staticmethod
    def zeros(capacity: int, channels: int = DEFAULT_VALUE_CHANNELS,
              device: str | torch.device = DEFAULT_DEVICE) -> "EventBatch":
        dev = resolve_device(device)
        i32 = dict(dtype=torch.int32, device=dev)
        return EventBatch(
            valid=torch.zeros(capacity, dtype=torch.bool, device=dev),
            etype=torch.zeros(capacity, **i32),
            token_id=torch.full((capacity,), NULL_ID, **i32),
            tenant_id=torch.full((capacity,), NULL_ID, **i32),
            ts_ms=torch.zeros(capacity, **i32),
            received_ms=torch.zeros(capacity, **i32),
            values=torch.zeros((capacity, channels), dtype=torch.float32,
                               device=dev),
            vmask=torch.zeros((capacity, channels), dtype=torch.bool,
                              device=dev),
            aux=torch.full((capacity, AUX_LANES), NULL_ID, **i32),
            seq=torch.arange(capacity, **i32),
        )

    @staticmethod
    def from_numpy(device: str | torch.device = DEFAULT_DEVICE,
                   **cols: np.ndarray) -> "EventBatch":
        """Batch from host numpy columns (the field names above). The
        columns are copied to ``device``; dtypes must already be the
        batch's (int32 / float32 / bool)."""
        dev = resolve_device(device)
        out = {}
        for f in dataclasses.fields(EventBatch):
            arr = np.ascontiguousarray(cols[f.name])
            out[f.name] = torch.from_numpy(arr).to(dev, copy=True)
        return EventBatch(**out)


def pack_batches(batches: list[EventBatch]) -> np.ndarray:
    """Pack numpy-backed EventBatches (``HostEventBuffer.emit_host``) into
    ONE contiguous uint8 array [K, row_bytes], so K batches reach the
    device in one transfer; :func:`unpack_batch` reads a row back."""
    rows = []
    for b in batches:
        rows.append(np.concatenate([
            np.ascontiguousarray(getattr(b, name)).view(np.uint8).ravel()
            for name in _PACKED_FIELDS]))
    return np.stack(rows)


# the packed row layout, in order (seq is not packed: it is arange(B))
_PACKED_FIELDS = ("valid", "etype", "token_id", "tenant_id", "ts_ms",
                  "received_ms", "values", "vmask", "aux")


def unpack_batch(row: torch.Tensor, capacity: int, channels: int) -> EventBatch:
    """Inverse of :func:`pack_batches` for one packed uint8 row (on any
    device): byte slices reinterpreted as the batch's dtypes."""
    b, c = capacity, channels
    off = 0

    def take(nbytes: int) -> torch.Tensor:
        nonlocal off
        part = row[off:off + nbytes]
        off += nbytes
        return part

    def as_type(part: torch.Tensor, dtype, shape) -> torch.Tensor:
        # clone: a reinterpreting view needs an aligned, zero-offset buffer
        return part.clone().view(dtype).reshape(shape)

    i32 = torch.int32
    return EventBatch(
        valid=take(b).to(torch.bool),
        etype=as_type(take(4 * b), i32, (b,)),
        token_id=as_type(take(4 * b), i32, (b,)),
        tenant_id=as_type(take(4 * b), i32, (b,)),
        ts_ms=as_type(take(4 * b), i32, (b,)),
        received_ms=as_type(take(4 * b), i32, (b,)),
        values=as_type(take(4 * b * c), torch.float32, (b, c)),
        vmask=take(b * c).reshape(b, c).to(torch.bool),
        aux=as_type(take(4 * b * AUX_LANES), i32, (b, AUX_LANES)),
        seq=torch.arange(b, dtype=i32, device=row.device),
    )


class EpochBase:
    """Host-side epoch base for int32 millisecond timestamps.

    int32 ms wraps at ~24.8 days; the base is refreshed by the ingest host at
    checkpoint boundaries. All device-side comparisons are within one epoch.
    """

    def __init__(self, base_unix_s: float | None = None):
        self.base_unix_s = float(base_unix_s if base_unix_s is not None else time.time())

    def to_ms(self, unix_s: float) -> int:
        return int((unix_s - self.base_unix_s) * 1000.0)

    def now_ms(self) -> int:
        return self.to_ms(time.time())


class HostEventBuffer:
    """Host-side staging buffer that accumulates decoded events into numpy
    arrays and emits padded ``EventBatch``es.

    This is the boundary between the variable-rate protocol edge and the
    fixed-shape pipeline step: batches are always emitted at full
    ``capacity`` with a valid mask.
    """

    def __init__(self, capacity: int, channels: int = DEFAULT_VALUE_CHANNELS):
        self.capacity = capacity
        self.channels = channels
        self._n = 0
        self._alloc()

    def _alloc(self) -> None:
        cap, ch = self.capacity, self.channels
        self.etype = np.zeros(cap, np.int32)
        self.token_id = np.full(cap, NULL_ID, np.int32)
        self.tenant_id = np.full(cap, NULL_ID, np.int32)
        self.ts_ms = np.zeros(cap, np.int32)
        self.received_ms = np.zeros(cap, np.int32)
        self.values = np.zeros((cap, ch), np.float32)
        self.vmask = np.zeros((cap, ch), np.bool_)
        self.aux = np.full((cap, AUX_LANES), NULL_ID, np.int32)

    def __len__(self) -> int:
        return self._n

    @property
    def full(self) -> bool:
        return self._n >= self.capacity

    def append(
        self,
        etype: int,
        token_id: int,
        tenant_id: int,
        ts_ms: int,
        received_ms: int,
        values: Any = (),
        aux0: int = NULL_ID,
        aux1: int = NULL_ID,
    ) -> bool:
        """Append one decoded event; returns False when the buffer is full."""
        i = self._n
        if i >= self.capacity:
            return False
        self.etype[i] = etype
        self.token_id[i] = token_id
        self.tenant_id[i] = tenant_id
        self.ts_ms[i] = ts_ms
        self.received_ms[i] = received_ms
        nvals = min(len(values), self.channels)
        if nvals:
            self.values[i, :nvals] = values[:nvals]
            self.vmask[i, :nvals] = True
        self.aux[i, 0] = aux0
        self.aux[i, 1] = aux1
        self._n = i + 1
        return True

    def emit_host(self) -> EventBatch:
        """The staged rows as a numpy-backed EventBatch, and reset the
        buffer (which re-allocates, so the emitted batch never aliases
        later staging)."""
        n = self._n
        valid = np.zeros(self.capacity, np.bool_)
        valid[:n] = True
        batch = EventBatch(
            valid=valid,
            etype=self.etype,
            token_id=self.token_id,
            tenant_id=self.tenant_id,
            ts_ms=self.ts_ms,
            received_ms=self.received_ms,
            values=self.values,
            vmask=self.vmask,
            aux=self.aux,
            seq=np.arange(self.capacity, dtype=np.int32),
        )
        self._n = 0
        self._alloc()
        return batch

    def emit(self, device: str | torch.device = DEFAULT_DEVICE) -> EventBatch:
        """Copy the staged rows to ``device`` as an EventBatch and reset the
        buffer."""
        dev = resolve_device(device)
        host = self.emit_host()
        return EventBatch.from_numpy(dev, **{f.name: getattr(host, f.name)
                                             for f in dataclasses.fields(host)})
