"""Embedded event search (port of ``sitewhere_tpu/search/index.py``, host
only).

An in-memory inverted index over outbound event documents with a Solr-like
query surface (field:value clauses, ranges, implicit AND). Filtered scans
over the device ring are the separate ``ops/query.py`` path; this module
never touches the device.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from collections import defaultdict

from sitewhere_tpu_torch.outbound.feed import OutboundEvent

_CLAUSE = re.compile(r"(\w+):(\[([^\]]+) TO ([^\]]+)\]|\S+)")


def event_order_key(doc: dict):
    """THE newest-first ordering for event documents — shared by the
    index's own ranking and every cluster merge (per-rank top-N
    truncation and the cross-rank merge must sort identically or the
    merge drops documents that belong in the top-N). Ties break on
    deviceToken so every rank orders the same."""
    return (-doc.get("eventDateMs", 0), -doc.get("receivedDateMs", 0),
            doc.get("deviceToken") or "")


@dataclasses.dataclass
class SearchProviderInfo:
    provider_id: str = "embedded"
    name: str = "Embedded event index"
    docs: int = 0           # corpus size behind this provider — for a
                            # cluster provider, summed over every rank


class EventSearchIndex:
    """Inverted index over outbound events (documents = event dicts)."""

    def __init__(self, capacity: int = 1 << 20):
        self.capacity = capacity
        self.docs: dict[int, dict] = {}
        self.postings: dict[tuple[str, str], set[int]] = defaultdict(set)
        self.provider_id = "embedded"
        # indexing runs on the server event loop while searches may run
        # on worker threads (REST off-loop search): short critical
        # sections, one lock
        self._lock = threading.Lock()

    @property
    def info(self) -> SearchProviderInfo:
        """Computed, not cached — ``docs`` must track the live corpus."""
        return SearchProviderInfo(provider_id=self.provider_id,
                                  docs=len(self.docs))

    def add(self, event: OutboundEvent) -> None:
        doc = event.to_json_dict()
        doc_id = event.event_id
        with self._lock:
            if doc_id in self.docs:
                # re-delivered id (at-least-once feed): drop the old
                # version's postings first so no stale key survives
                self._remove(doc_id)
            elif len(self.docs) >= self.capacity:
                # drop the oldest — ring semantics like the store.
                # Insertion order == arrival order, so the dict's first
                # key is oldest.
                self._remove(next(iter(self.docs)))
            self.docs[doc_id] = doc
            for key in self._keys_of(doc):
                self.postings[key].add(doc_id)

    @staticmethod
    def _keys_of(doc: dict) -> list[tuple[str, str]]:
        keys = [(f, str(doc[f])) for f in ("type", "deviceToken", "tenant")]
        keys.extend(("measurement", name) for name in doc["measurements"])
        return keys

    def _remove(self, doc_id: int) -> None:
        """Evict one document — O(keys of that doc), not O(all postings)."""
        doc = self.docs.pop(doc_id, None)
        if doc is None:
            return
        for key in self._keys_of(doc):
            ids = self.postings.get(key)
            if ids is not None:
                ids.discard(doc_id)
                if not ids:
                    del self.postings[key]

    def search(self, query: str, max_results: int = 100,
               order: str = "eventDate") -> list[dict]:
        """Solr-flavored query: ``field:value`` clauses are ANDed;
        ``eventDateMs:[a TO b]`` range clauses supported; ``*:*`` matches
        all. ``order``: "eventDate" (default) ranks by event_order_key
        BEFORE truncation — newest event time first, the same ordering
        every deployment topology serves (and the one a multi-index merge
        needs, or backdated events silently fall outside the top-N);
        "id" ranks by arrival (insertion id)."""
        with self._lock:
            if not query or query.strip() == "*:*":
                candidate: set[int] | None = set(self.docs)
                ranges: list[tuple[str, float, float]] = []
            else:
                candidate = None
                ranges = []
                for m in _CLAUSE.finditer(query):
                    field, value = m.group(1), m.group(2)
                    if m.group(3) is not None:  # range clause
                        lo = (-float("inf") if m.group(3) == "*"
                              else float(m.group(3)))
                        hi = (float("inf") if m.group(4) == "*"
                              else float(m.group(4)))
                        ranges.append((field, lo, hi))
                        continue
                    ids = self.postings.get((field, value), set())
                    candidate = (ids.copy() if candidate is None
                                 else candidate & ids)
                if candidate is None:
                    candidate = set(self.docs)
            key = ((lambda i: event_order_key(self.docs[i]))
                   if order == "eventDate" else (lambda i: -i))
            if ranges:
                # range filters drop candidates AFTER ranking, so top-k
                # selection could under-fill — full sort only here
                ranked = sorted(candidate, key=key)
            else:
                # top-k selection: O(n log k) and a far shorter critical
                # section than sorting a near-full index under the lock
                import heapq

                ranked = heapq.nsmallest(max_results, candidate, key=key)
            out = []
            for doc_id in ranked:
                doc = self.docs[doc_id]
                if all(lo <= float(doc.get(f, 0) or 0) <= hi
                       for f, lo, hi in ranges):
                    out.append(doc)
                    if len(out) >= max_results:
                        break
            return out


class SearchProviderManager:
    """Named search providers (reference: SearchProviderManager)."""

    def __init__(self):
        self.providers: dict[str, EventSearchIndex] = {}

    def add_provider(self, provider_id: str, index: EventSearchIndex) -> None:
        index.provider_id = provider_id
        self.providers[provider_id] = index

    def get(self, provider_id: str) -> EventSearchIndex | None:
        return self.providers.get(provider_id)

    def list_providers(self) -> list[SearchProviderInfo]:
        return [p.info for p in self.providers.values()]
