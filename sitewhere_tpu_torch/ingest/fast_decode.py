"""Native batch decoder: list of payloads -> SoA arrays in one C call (port
of ``sitewhere_tpu/ingest/fast_decode.py``).

The C++ scanner fills numpy arrays directly (or a staging arena's own
columns, :meth:`NativeBatchDecoder.decode_into`), and device tokens,
measurement names, alert types and alternate ids come back as interned
int32 ids ready for the ``EventBatch``. The libraries build on first use
(``native/binding.py``); a failed build raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np

from sitewhere_tpu_torch.native.binding import (NativeInterner, load_library,
                                                load_py_library)

# native rtype codes (swtpu.cpp ReqType) -> core EventType / registration
RT_REGISTER = 0
RT_MEASUREMENT = 1
RT_LOCATION = 2
RT_ALERT = 3
RT_STATE_CHANGE = 4
RT_ACK = 5
RT_MAP = 6   # MapDevice envelopes take the host slow path (like REGISTER)

# native rtype -> core EventType ordinal (EventType in core/types.py)
RTYPE_TO_ETYPE = np.full(8, -1, np.int32)
RTYPE_TO_ETYPE[RT_MEASUREMENT] = 0
RTYPE_TO_ETYPE[RT_LOCATION] = 1
RTYPE_TO_ETYPE[RT_ALERT] = 2
RTYPE_TO_ETYPE[RT_ACK] = 4
RTYPE_TO_ETYPE[RT_STATE_CHANGE] = 5


class DecodedArrays(NamedTuple):
    n_ok: int
    rtype: np.ndarray      # int32[N] native request type (-1 = decode failed)
    token_id: np.ndarray   # int32[N]
    ts_ms64: np.ndarray    # int64[N] epoch ms (-1 = absent)
    values: np.ndarray     # float32[N, C]
    chmask: np.ndarray     # bool[N, C]
    aux0: np.ndarray       # int32[N] alert-type id
    aux1: np.ndarray       # int32[N] alternate-id (event-id interner; -1 none)
    level: np.ndarray      # int32[N] alert level
    collisions: int


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


class NativeBatchDecoder:
    """Holds the C++ decoder and its interners. The token interner is
    shared with the engine (ids must be the engine's ids); the event-id
    interner (alternate/correlation ids, the aux1 lane) is decoder-owned
    and the engine adopts it as ``event_ids`` so the batch path and the
    per-request path assign the same ids."""

    def __init__(self, token_interner: NativeInterner, channels: int,
                 name_capacity: int = 1 << 20, alert_capacity: int = 1 << 16,
                 event_capacity: int = 1 << 22):
        self.lib = load_library()
        # the list[bytes] entry points: skip the b"".join, the length scan
        # and the offsets cumsum that the packed ABI makes Python pay
        self.py_lib = load_py_library()
        self.tokens = token_interner
        self.channels = channels
        self.handle = self.lib.swtpu_decoder_create(
            token_interner.handle, name_capacity, alert_capacity,
            event_capacity)
        self.names = NativeInterner(
            name_capacity, self.lib, self.lib.swtpu_decoder_names(self.handle))
        self.alert_types = NativeInterner(
            alert_capacity, self.lib,
            self.lib.swtpu_decoder_alert_types(self.handle))
        self.event_ids = NativeInterner(
            event_capacity, self.lib,
            self.lib.swtpu_decoder_event_ids(self.handle))

    def decode(self, payloads: list[bytes]) -> DecodedArrays:
        """Batched JSON DeviceRequest decode. No thread may mutate
        ``payloads`` until the call returns (the list path scans the
        payload buffers in place)."""
        return self._decode(payloads, binary=False)

    def decode_binary(self, payloads: list[bytes]) -> DecodedArrays:
        """Batched flat-binary decode (the wire format of
        ``ingest/decoders.encode_binary_request``). Same contract as
        :meth:`decode`."""
        return self._decode(payloads, binary=True)

    def _decode_pylist(self, payloads, binary: bool) -> "DecodedArrays | None":
        """List-direct decode; None = not eligible (take the packed path)."""
        if type(payloads) is not list:
            return None
        n, c = len(payloads), self.channels
        out = _empty_outputs(n, c)
        collisions = ctypes.c_int32(0)
        n_ok = int(self.py_lib.swtpu_decode_pylist(
            self.handle, payloads, np.int32(n), np.int32(c),
            _ptr(out["rtype"], ctypes.c_int32), _ptr(out["token"], ctypes.c_int32),
            _ptr(out["ts"], ctypes.c_int64), _ptr(out["values"], ctypes.c_float),
            _ptr(out["chmask"], ctypes.c_uint8), _ptr(out["aux0"], ctypes.c_int32),
            _ptr(out["aux1"], ctypes.c_int32), _ptr(out["level"], ctypes.c_int32),
            ctypes.byref(collisions), np.int32(1 if binary else 0)))
        if n_ok < 0:
            return None   # a non-bytes item: the packed path handles or raises
        return _decoded(n_ok, out, int(collisions.value))

    def decode_packed(self, buf, offsets: np.ndarray, n: int,
                      rtype: np.ndarray, token: np.ndarray, ts: np.ndarray,
                      values: np.ndarray, chmask: np.ndarray,
                      aux0: np.ndarray, aux1: np.ndarray, level: np.ndarray,
                      *, binary: bool = False) -> tuple[int, int]:
        """One scanner call over an already-concatenated wire batch
        (``offsets`` int64[>=n+1]; output arrays sized >= n rows): the
        single marshalling site for ``swtpu_decode_*_batch``. Returns
        (n_ok, channel_collisions)."""
        collisions = ctypes.c_int32(0)
        fn = (self.lib.swtpu_decode_binary_batch if binary
              else self.lib.swtpu_decode_batch)
        n_ok = int(fn(
            self.handle, buf, _ptr(offsets, ctypes.c_int64),
            np.int32(n), np.int32(self.channels),
            _ptr(rtype, ctypes.c_int32), _ptr(token, ctypes.c_int32),
            _ptr(ts, ctypes.c_int64),
            _ptr(values, ctypes.c_float), _ptr(chmask, ctypes.c_uint8),
            _ptr(aux0, ctypes.c_int32), _ptr(aux1, ctypes.c_int32),
            _ptr(level, ctypes.c_int32), ctypes.byref(collisions)))
        return n_ok, int(collisions.value)

    @property
    def has_arena(self) -> bool:
        """The arena-fill entry points are present in the loaded libraries."""
        return (hasattr(self.lib, "swtpu_decode_arena_batch")
                and hasattr(self.py_lib, "swtpu_decode_arena_pylist"))

    @property
    def has_shard(self) -> bool:
        """The sharded arena-decode entry points are present in both
        libraries (the ShardCtx ABI in the packed one, the ranged list
        decode in the py one)."""
        return (hasattr(self.lib, "swtpu_shard_create")
                and hasattr(self.py_lib, "swtpu_shard_decode_arena_pylist"))

    @staticmethod
    def arena_out_args(arena, lo: int, hi: int, collisions):
        """The output-pointer argument tail shared by the arena and shard
        decode entry points: every output aims at the arena's own column
        slices for rows [lo, hi), with the two aux lanes written strided
        in place (stride = the aux row width)."""
        c = ctypes
        stride = c.c_int64(arena.aux.shape[1])
        return (
            _ptr(arena.rtype[lo:hi], c.c_int32),
            _ptr(arena.token_id[lo:hi], c.c_int32),
            _ptr(arena.ts64[lo:hi], c.c_int64),
            _ptr(arena.values[lo:hi], c.c_float),
            _ptr(arena.vmask[lo:hi], c.c_uint8),
            _ptr(arena.aux[lo:hi], c.c_int32), stride,
            _ptr(arena.aux[lo:hi, 1:], c.c_int32), stride,
            _ptr(arena.level[lo:hi], c.c_int32),
            c.byref(collisions),
        )

    def decode_into(self, payloads: list[bytes], arena, lo: int,
                    *, binary: bool = False) -> tuple[int, int]:
        """Decode ``payloads`` straight into ``arena`` rows
        [lo, lo + len(payloads)): the scanner's outputs are the arena's
        own column slices (zero-copy staging). Same contract as
        :meth:`decode`. Returns (n_ok, channel_collisions)."""
        n = len(payloads)
        hi = lo + n
        if hi > arena.rows:
            raise ValueError(f"{n} payloads exceed arena room "
                             f"{arena.rows - lo}")
        collisions = ctypes.c_int32(0)
        args = self.arena_out_args(arena, lo, hi, collisions) \
            + (np.int32(1 if binary else 0),)
        if type(payloads) is list:
            n_ok = int(self.py_lib.swtpu_decode_arena_pylist(
                self.handle, payloads, np.int32(n),
                np.int32(self.channels), *args))
            if n_ok >= 0:
                return n_ok, int(collisions.value)
        # packed path (also covers non-list iterables of bytes)
        payloads = list(payloads)
        buf = b"".join(payloads)
        offsets = _offsets(payloads)
        n_ok = int(self.lib.swtpu_decode_arena_batch(
            self.handle, buf, _ptr(offsets, ctypes.c_int64), np.int32(n),
            np.int32(self.channels), *args))
        return n_ok, int(collisions.value)

    def _decode(self, payloads, binary: bool) -> DecodedArrays:
        fast = self._decode_pylist(payloads, binary=binary)
        if fast is not None:
            return fast
        payloads = list(payloads)
        n = len(payloads)
        out = _empty_outputs(n, self.channels)
        n_ok, collisions = self.decode_packed(
            b"".join(payloads), _offsets(payloads), n, out["rtype"],
            out["token"], out["ts"], out["values"], out["chmask"],
            out["aux0"], out["aux1"], out["level"], binary=binary)
        return _decoded(n_ok, out, collisions)


def _offsets(payloads: list[bytes]) -> np.ndarray:
    n = len(payloads)
    offsets = np.zeros(n + 1, np.int64)
    # fromiter keeps cumsum on the ndarray fast path
    np.cumsum(np.fromiter(map(len, payloads), np.int64, n), out=offsets[1:])
    return offsets


def _empty_outputs(n: int, c: int) -> dict[str, np.ndarray]:
    return {"rtype": np.empty(n, np.int32), "token": np.empty(n, np.int32),
            "ts": np.empty(n, np.int64), "values": np.empty((n, c), np.float32),
            "chmask": np.empty((n, c), np.uint8), "aux0": np.empty(n, np.int32),
            "aux1": np.empty(n, np.int32), "level": np.empty(n, np.int32)}


def _decoded(n_ok: int, out: dict, collisions: int) -> DecodedArrays:
    return DecodedArrays(
        n_ok=n_ok, rtype=out["rtype"], token_id=out["token"],
        ts_ms64=out["ts"], values=out["values"],
        chmask=out["chmask"].view(bool), aux0=out["aux0"], aux1=out["aux1"],
        level=out["level"], collisions=collisions)
