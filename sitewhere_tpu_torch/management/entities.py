"""Generic entity store: token-addressed CRUD with paging and parent trees
(port of ``sitewhere_tpu/management/entities.py``, host only).

The reference's entity classes share one shape: create / get by token /
update / delete, a paged list and parent-tree assembly. One generic,
thread-safe, token-addressed store provides that shape; the managers
(``device_management.py``, ``assets.py``) declare their entity dataclasses
and relations on top. The hot lookup columns live in the engine's device
state; these stores hold the host metadata the device tables do not carry.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Generic, Iterable, TypeVar

T = TypeVar("T")


class EntityNotFound(KeyError):
    pass


class DuplicateToken(ValueError):
    pass


@dataclasses.dataclass
class SearchResults(Generic[T]):
    """Paged results (reference: ISearchResults<T> used by every list API)."""

    results: list[T]
    total: int
    page: int
    page_size: int


@dataclasses.dataclass
class EntityMeta:
    """Common audit columns (reference: every Rdb* entity carries
    id/token/createdDate/updatedDate/metadata)."""

    id: int
    token: str
    created_ms: float
    updated_ms: float
    metadata: dict[str, Any] = dataclasses.field(default_factory=dict)


class EntityStore(Generic[T]):
    """Token-addressed CRUD store for one entity kind.

    ``on_change(action, kind, token, entity)`` — when set — fires after
    every successful mutation, OUTSIDE the lock (the cluster entity
    replicator broadcasts from it; an RPC inside the store lock would
    serialize all CRUD behind the network). ``apply_replicated`` /
    ``remove_replicated`` upsert state received from a peer without
    firing the hook (replication must not re-broadcast)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._lock = threading.RLock()
        self._next_id = 1
        self._id_stride = 1
        self._by_id: dict[int, T] = {}
        self._by_token: dict[str, int] = {}
        self.on_change: Callable[[str, str, str, T | None], None] | None = None

    def configure_id_space(self, offset: int, stride: int) -> None:
        """Namespace locally-assigned ids to ``offset (mod stride)`` —
        the cluster replicator calls this with (rank, n_ranks) so two
        ranks creating entities concurrently can never mint the SAME id
        for different tokens (a replicated upsert would then clobber the
        other rank's entity in ``_by_id``). Entities created before this
        call (deterministic bootstrap, identical on every rank) keep
        their low ids."""
        with self._lock:
            self._id_stride = max(1, stride)
            while self._next_id % self._id_stride != offset % self._id_stride:
                self._next_id += 1

    def _notify(self, action: str, token: str, entity: T | None) -> None:
        cb = self.on_change
        if cb is not None:
            cb(action, self.kind, token, entity)

    def create(self, token: str, build: Callable[[EntityMeta], T]) -> T:
        with self._lock:
            if token in self._by_token:
                raise DuplicateToken(f"{self.kind} token {token!r} already exists")
            now = time.time() * 1000
            meta = EntityMeta(id=self._next_id, token=token,
                              created_ms=now, updated_ms=now)
            self._next_id += self._id_stride
            entity = build(meta)
            self._by_id[meta.id] = entity
            self._by_token[token] = meta.id
        self._notify("upsert", token, entity)
        return entity

    def get(self, token: str) -> T:
        with self._lock:
            eid = self._by_token.get(token)
            if eid is None:
                raise EntityNotFound(f"{self.kind} {token!r} not found")
            return self._by_id[eid]

    def try_get(self, token: str) -> T | None:
        try:
            return self.get(token)
        except EntityNotFound:
            return None

    def get_by_id(self, eid: int) -> T:
        with self._lock:
            if eid not in self._by_id:
                raise EntityNotFound(f"{self.kind} id {eid} not found")
            return self._by_id[eid]

    def update(self, token: str, apply: Callable[[T], None]) -> T:
        with self._lock:
            entity = self.get(token)
            apply(entity)
            meta = getattr(entity, "meta", None)
            if meta is not None:
                meta.updated_ms = time.time() * 1000
        self._notify("upsert", token, entity)
        return entity

    def delete(self, token: str) -> T:
        with self._lock:
            eid = self._by_token.pop(token, None)
            if eid is None:
                raise EntityNotFound(f"{self.kind} {token!r} not found")
            entity = self._by_id.pop(eid)
        self._notify("delete", token, None)
        return entity

    # ---- replication surface (no hook: peers must not re-broadcast) ----
    def apply_replicated(self, token: str, entity: T) -> None:
        """Upsert an entity exactly as shipped from a peer — its meta
        (id, timestamps) is authoritative; the local id counter jumps
        past it so local creates never collide."""
        with self._lock:
            meta = getattr(entity, "meta", None)
            eid = meta.id if meta is not None else self._by_token.get(
                token, self._next_id)
            old = self._by_token.get(token)
            if old is not None and old != eid:
                self._by_id.pop(old, None)
            self._by_id[eid] = entity
            self._by_token[token] = eid
            while self._next_id <= eid:
                self._next_id += self._id_stride

    def remove_replicated(self, token: str) -> None:
        with self._lock:
            eid = self._by_token.pop(token, None)
            if eid is not None:
                self._by_id.pop(eid, None)

    def list(
        self,
        page: int = 1,
        page_size: int = 100,
        where: Callable[[T], bool] | None = None,
        sort_key: Callable[[T], Any] | None = None,
    ) -> SearchResults[T]:
        with self._lock:
            items = list(self._by_id.values())
        if where is not None:
            items = [e for e in items if where(e)]
        items.sort(key=sort_key or (lambda e: e.meta.id))
        total = len(items)
        lo = (page - 1) * page_size
        return SearchResults(items[lo: lo + page_size], total, page, page_size)

    def all(self) -> list[T]:
        with self._lock:
            return list(self._by_id.values())

    def __len__(self) -> int:
        return len(self._by_id)

    def __contains__(self, token: str) -> bool:
        return token in self._by_token


def entity_json(obj, **extra) -> dict:
    """Wire/JSON form of an entity dataclass: the ``meta`` audit columns
    flatten to token/createdDateMs/updatedDateMs, mirroring how the
    reference marshals Rdb* entities over REST and gRPC."""
    out = dataclasses.asdict(obj)
    meta = out.pop("meta", None)
    if meta:
        out.update({"token": meta["token"],
                    "createdDateMs": meta["created_ms"],
                    "updatedDateMs": meta["updated_ms"]})
    out.update(extra)
    return out


def paged_json(res: SearchResults) -> dict:
    """Wire form of SearchResults (reference: ISearchResults envelopes)."""
    return {
        "numResults": res.total,
        "page": res.page,
        "pageSize": res.page_size,
        "results": [(entity_json(e) if hasattr(e, "meta")
                     else dataclasses.asdict(e)) for e in res.results],
    }


@dataclasses.dataclass
class TreeNode(Generic[T]):
    entity: T
    children: list["TreeNode[T]"] = dataclasses.field(default_factory=list)


def build_tree(entities: Iterable[T],
               parent_token_of: Callable[[T], str | None]) -> list[TreeNode[T]]:
    """Assemble parent-linked entities into root trees (reference:
    device/TreeBuilder.java used for area + customer hierarchies)."""
    by_token = {e.meta.token: TreeNode(e) for e in entities}
    roots: list[TreeNode[T]] = []
    for node in by_token.values():
        parent = parent_token_of(node.entity)
        if parent and parent in by_token:
            by_token[parent].children.append(node)
        else:
            roots.append(node)
    return roots
