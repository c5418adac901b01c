"""Event deduplicators (port of ``sitewhere_tpu/ingest/dedup.py``, a
copy; reference: sources/deduplicator/*).

``AlternateIdDeduplicator`` checks an event's alternate id against the
ones already seen, as the reference's AlternateIdDeduplicator.java does
against persisted events: here a host-side bounded LRU of (tenant,
token, alternate id), O(1) with no store round trip, sized to cover the
at-least-once redelivery window. ``ScriptedDeduplicator`` takes a user
Python predicate (the Groovy analog).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Protocol

from sitewhere_tpu_torch.ingest.requests import DecodedRequest


class Deduplicator(Protocol):
    def is_duplicate(self, request: DecodedRequest) -> bool:
        ...


class AlternateIdDeduplicator:
    """Bounded LRU of (tenant, token, alternate_id) triples."""

    def __init__(self, capacity: int = 1 << 16):
        self.capacity = capacity
        self._seen: OrderedDict[tuple, None] = OrderedDict()

    def is_duplicate(self, request: DecodedRequest) -> bool:
        if request.alternate_id is None:
            return False
        key = (request.tenant, request.device_token, request.alternate_id)
        if key in self._seen:
            self._seen.move_to_end(key)
            return True
        self._seen[key] = None
        if len(self._seen) > self.capacity:
            self._seen.popitem(last=False)
        return False


class ScriptedDeduplicator:
    """User-provided predicate (reference: ScriptedEventDeduplicator)."""

    def __init__(self, fn: Callable[[DecodedRequest], bool]):
        self.fn = fn

    def is_duplicate(self, request: DecodedRequest) -> bool:
        return bool(self.fn(request))
