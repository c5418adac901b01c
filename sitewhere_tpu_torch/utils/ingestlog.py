"""Replayable ingest log: the durability half of checkpoint/resume (port of
``sitewhere_tpu/utils/ingestlog.py``, the same byte format: a log written
by either package replays through the other).

The engine appends every accepted raw payload batch to a segmented,
length-prefixed log BEFORE staging it; on restart, replaying segments past
the snapshot's watermark re-feeds the idempotent pipeline. Segments rotate by size and old segments can be
pruned once a snapshot covers them.

Record framing: u32 LE payload length + u32 LE CRC32 + payload bytes. A
record length of 0xFFFFFFFF marks a watermark record whose payload is the
JSON-encoded absolute store cursor. The CRC catches torn and corrupted
records on replay: replay stops cleanly at
the first bad record of the tail segment instead of feeding garbage into
the pipeline.

GROUP COMMIT (``group_commit=True``): the classic DeWitt-style durability
amortizer. Appends land in a user-space buffer and return a sequence
number immediately; a dedicated commit thread drains the buffer, writes
it, and fsyncs ONCE per drain — so concurrent/back-to-back append groups
share an fsync, and the appending (ingest) thread never blocks on disk.
``wait_durable(seq)`` is the durability watermark: it blocks until every
record appended at or before ``seq`` is fsync'd (kicking the commit
thread so a waiter never sits out the quiescent window). Because the
buffer is user-space, a crash loses exactly the un-fsynced tail — which
is why the engine gates every device dispatch on its batch's watermark
(strict WAL-before-dispatch, now with the fsync latency overlapped
against next-batch decode instead of serialized on the ingest thread).
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
import threading
import time
import zlib
from typing import Iterator

_WATERMARK = 0xFFFFFFFF
_MAGIC = b"SWAL1\n"   # segment format marker; absent = legacy length-only


class IngestLog:
    def __init__(self, directory: str | pathlib.Path,
                 segment_bytes: int = 64 << 20, readonly: bool = False,
                 group_commit: bool = False,
                 group_window_s: float = 0.002):
        """``readonly`` opens the log for replay only: no tail segment is
        created and appends raise — the mode for forensic/recovery copies
        that must stay byte-identical. ``group_commit`` starts the commit
        thread (see module docstring); ``group_window_s`` is the
        quiescent window the commit thread waits for more appenders
        before fsyncing, when nobody is blocked on the watermark."""
        self.dir = pathlib.Path(directory)
        self.readonly = readonly
        if not readonly:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.segment_bytes = segment_bytes
        self._lock = threading.Lock()
        existing = sorted(self.dir.glob("segment-*.log"))
        self._seg_index = (
            int(existing[-1].stem.split("-")[1]) + 1 if existing else 0
        )
        self._fh = None
        if not readonly:
            self._open_segment()
        # ---- group commit state (all guarded by _lock via _cv) ----
        self.group_commit = group_commit and not readonly
        self.group_window_s = group_window_s
        self._cv = threading.Condition(self._lock)
        self._buf = bytearray()     # appended, not yet written
        self._seq = 0               # last append sequence handed out
        self._written_seq = 0       # written+flushed through this seq
        self._durable_seq = 0       # fsync'd through this seq
        self._waiters = 0
        self._closed = False
        self._commit_err: BaseException | None = None
        self.fsyncs = 0             # commit fsyncs (amortization proof)
        self.commit_groups = 0      # append groups covered by them
        if self.group_commit:
            self._commit_thread = threading.Thread(
                target=self._commit_loop, name="swtpu-wal-commit",
                daemon=True)
            self._commit_thread.start()

    def _open_segment(self) -> None:
        if self._fh is not None:
            self._fh.close()
        path = self.dir / f"segment-{self._seg_index:08d}.log"
        self._fh = open(path, "ab")
        if self._fh.tell() == 0:
            self._fh.write(_MAGIC)

    # ------------------------------------------------------------- append
    def append(self, payload: bytes) -> int:
        if self.readonly:
            raise RuntimeError("read-only ingest log")
        frame = struct.pack("<II", len(payload), zlib.crc32(payload)) \
            + payload
        with self._lock:
            if self.group_commit:
                return self._buffer_frames(frame)
            self._fh.write(frame)
            self._maybe_rotate()
            self._seq += 1
            return self._seq

    def append_many(self, payloads, head: bytes = b"") -> int:
        """Append one record per payload (each framed as ``head + payload``)
        with ONE buffered write for the whole group — the batch-ingest WAL
        path frames thousands of records per arena, and a write() per
        record was a measurable slice of the staging budget. Identical
        on-disk format to per-record :meth:`append`. Returns the group's
        append sequence — the ticket :meth:`wait_durable` gates on."""
        if self.readonly:
            raise RuntimeError("read-only ingest log")
        head_crc = zlib.crc32(head)
        frames = bytearray()
        for p in payloads:
            frames += struct.pack("<II", len(head) + len(p),
                                  zlib.crc32(p, head_crc))
            frames += head
            frames += p
        with self._lock:
            if self.group_commit:
                return self._buffer_frames(frames)
            self._fh.write(frames)
            self._maybe_rotate()
            self._seq += 1
            return self._seq

    def append_watermark(self, store_cursor: int) -> None:
        """Record that all payloads so far are reflected at this cursor.
        Under group commit the watermark rides the buffer (order with its
        records preserved); a lost un-fsynced watermark only means extra
        replay, never a gap."""
        if self.readonly:
            raise RuntimeError("read-only ingest log")
        body = json.dumps({"cursor": store_cursor}).encode()
        frame = struct.pack("<I", _WATERMARK) \
            + struct.pack("<II", len(body), zlib.crc32(body)) + body
        with self._lock:
            if self.group_commit:
                self._buffer_frames(frame)
                return
            self._fh.write(frame)
            self._fh.flush()

    def _buffer_frames(self, frames) -> int:
        """Queue frames for the commit thread; caller holds the lock."""
        if not frames:
            # an empty group adds no records: its durability requirement
            # is exactly the prior ticket's (a fresh seq here would never
            # wake the commit thread and would hang the gate)
            return self._seq
        if self._commit_err is not None:
            # surface a stuck durability path at the NEXT append rather
            # than only at the gate — the sooner ingest stops accepting,
            # the less there is to lose
            err = self._commit_err
            raise RuntimeError("WAL commit thread failed") from err
        self._buf += frames
        self._seq += 1
        self._cv.notify_all()
        return self._seq

    def _maybe_rotate(self) -> None:
        if self._fh.tell() >= self.segment_bytes:
            self._fh.flush()
            self._seg_index += 1
            self._open_segment()

    # ------------------------------------------------------- group commit
    def _commit_loop(self) -> None:
        while True:
            with self._cv:
                while (not self._buf and self._durable_seq >= self._seq
                       and not self._closed):
                    self._cv.wait()
                if self._closed and not self._buf \
                        and self._durable_seq >= self._seq:
                    return
                if self._buf and not self._waiters and not self._closed:
                    # quiescent window: let back-to-back appenders pile
                    # into this commit — but never make a waiter pay it
                    self._cv.wait(self.group_window_s)
                buf, self._buf = self._buf, bytearray()
                target = self._seq
            try:
                groups = target - self._written_seq
                if buf:
                    self._fh.write(buf)
                    self._fh.flush()
                os.fsync(self._fh.fileno())
                with self._cv:
                    self._written_seq = max(self._written_seq, target)
                    self._durable_seq = max(self._durable_seq, target)
                    self.fsyncs += 1
                    self.commit_groups += max(0, groups)
                    # rotation AFTER the fsync that covers the tail: the
                    # sealed segment is durable before a new one opens
                    if self._fh.tell() >= self.segment_bytes:
                        self._seg_index += 1
                        self._open_segment()
                    self._cv.notify_all()
            except Exception as e:
                # FAIL-STOP: after a failed write/fsync the kernel may
                # have dropped dirty pages while marking them clean
                # (fsyncgate) — retrying would *lie* about durability,
                # and a later successful commit must never unblock gates
                # covering frames that were lost here. Poison the log:
                # every gate and every further append raises.
                with self._cv:
                    self._commit_err = e
                    self._cv.notify_all()
                return

    def wait_durable(self, seq: int, timeout: float = 30.0) -> None:
        """Block until every append at or before ``seq`` is fsync'd — the
        dispatch gate's durability watermark. No-op when group commit is
        off (the non-group path flushes inline, preserving its original
        contract). Raises when the commit thread is failing: a dispatch
        must never proceed on a batch whose durability cannot be
        established."""
        if not self.group_commit:
            return
        deadline = time.monotonic() + timeout
        with self._cv:
            self._waiters += 1
            self._cv.notify_all()   # kick: a waiter skips the window
            try:
                while self._durable_seq < seq:
                    if self._commit_err is not None:
                        err = self._commit_err
                        raise RuntimeError(
                            "WAL group commit failed; refusing to "
                            "dispatch an un-durable batch") from err
                    if self._closed:
                        raise RuntimeError("ingest log closed while "
                                           "awaiting durability")
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"WAL durability watermark {seq} not reached "
                            f"within {timeout}s")
                    self._cv.wait(min(remaining, 0.5))
            finally:
                self._waiters -= 1

    @property
    def durable_seq(self) -> int:
        with self._lock:
            return self._durable_seq

    def flush(self) -> None:
        """Push buffered records to the OS (survives a process crash).
        Under group commit: drain the user-space buffer through the
        commit thread (which fsyncs — strictly stronger)."""
        if self.group_commit:
            with self._lock:
                seq = self._seq
            self.wait_durable(seq)
            return
        with self._lock:
            if self._fh is not None:
                self._fh.flush()

    def sync(self) -> None:
        if self.group_commit:
            self.flush()
            return
        with self._lock:
            if self._fh is None:
                return
            self._fh.flush()
            os.fsync(self._fh.fileno())

    def close(self) -> None:
        if self.group_commit:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._commit_thread.join(timeout=5)
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def replay(self, after_cursor: int = -1) -> Iterator[bytes]:
        """Yield payloads recorded after the last watermark <= after_cursor
        (everything, when no watermark qualifies)."""
        pending: list[bytes] = []
        emitting = after_cursor < 0

        def read_record(fh, checked: bool):
            """(is_watermark, payload), "eof" at a record boundary, or
            "bad" on a torn/corrupt record. ``checked`` = current framing
            (len+crc); False = legacy (length-only) segments written before
            the CRC format."""
            head = fh.read(4)
            if not head:
                return "eof"
            if len(head) < 4:
                return "bad"
            (n,) = struct.unpack("<I", head)
            wm = n == _WATERMARK
            if wm:
                head = fh.read(4)
                if len(head) < 4:
                    return "bad"
                (n,) = struct.unpack("<I", head)
            if checked:
                crc_raw = fh.read(4)
                if len(crc_raw) < 4:
                    return "bad"
                (crc,) = struct.unpack("<I", crc_raw)
            payload = fh.read(n)
            if len(payload) < n:
                return "bad"
            if checked and zlib.crc32(payload) != crc:
                return "bad"
            return wm, payload

        paths = sorted(self.dir.glob("segment-*.log"))
        for si, path in enumerate(paths):
            with open(path, "rb") as fh:
                probe = fh.read(len(_MAGIC))
                checked = probe == _MAGIC
                if not checked:
                    fh.seek(0)   # legacy segment: no marker, no CRC
                while True:
                    rec = read_record(fh, checked)
                    if rec == "eof":
                        break    # clean end of segment
                    if rec == "bad":
                        if si == len(paths) - 1:
                            break   # torn tail of the live segment: expected
                        # corruption in a SEALED segment: stop the WHOLE
                        # replay — skipping ahead (or into later segments)
                        # would leave a silent gap in the stream
                        yield from pending
                        return
                    wm, payload = rec
                    if wm:
                        meta = json.loads(payload)
                        if not emitting:
                            if meta["cursor"] <= after_cursor:
                                pending.clear()  # covered by the snapshot
                            else:
                                # snapshot falls before this watermark: the
                                # held records may not be reflected — replay
                                emitting = True
                                yield from pending
                                pending.clear()
                        continue
                    if emitting:
                        yield payload
                    else:
                        pending.append(payload)
        yield from pending

    def prune(self, keep_segments: int = 2) -> int:
        """Delete old segments (call after a snapshot); returns count."""
        segs = sorted(self.dir.glob("segment-*.log"))
        removed = 0
        for path in segs[:-keep_segments] if keep_segments else segs:
            path.unlink()
            removed += 1
        return removed
