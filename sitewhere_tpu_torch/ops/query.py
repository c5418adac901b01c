"""Device-side event store queries: filtered scan + top-k by time (port of
``sitewhere_tpu/ops/query.py``).

An event query is a masked scan over the device ring with an on-device
sort; only the top ``limit`` rows travel to the host.

:func:`query_store_batch` is the shared-scan variant: Q predicate sets
evaluate in one pass over the store. The ordering sort is
query-independent (newest first, store index breaking ties), so the
batch runs it once and each query reduces to an O(N) mask plus an O(N)
stable-partition top-k (``ops/segment.stable_partition_topk``), all Q
queries at once as ``[Q, N]`` tensors. Results are byte-identical to Q
sequential :func:`query_store` calls, tie order included.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sitewhere_tpu_torch.compat import INT32_MIN
from sitewhere_tpu_torch.core.store import EventStore
from sitewhere_tpu_torch.core.types import NULL_ID
from sitewhere_tpu_torch.ops.segment import lex_argsort, stable_partition_topk


class QueryResult(NamedTuple):
    n: torch.Tensor        # int32[] matches (capped at limit)
    total: torch.Tensor    # int32[] total matches in store
    etype: torch.Tensor    # int32[limit]
    device: torch.Tensor
    assignment: torch.Tensor
    tenant: torch.Tensor
    area: torch.Tensor
    customer: torch.Tensor
    ts_ms: torch.Tensor
    received_ms: torch.Tensor
    values: torch.Tensor   # float32[limit, C]
    vmask: torch.Tensor
    aux: torch.Tensor


class QueryParams(NamedTuple):
    """One predicate set per lane (int32[Q] each; ``NULL_ID`` = any).
    ``t0``/``t1`` are the inclusive event-time bounds — callers pass the
    full int32 range for an unbounded side."""

    device: torch.Tensor
    etype: torch.Tensor
    tenant: torch.Tensor
    t0: torch.Tensor
    t1: torch.Tensor
    assignment: torch.Tensor
    aux0: torch.Tensor
    aux1: torch.Tensor
    area: torch.Tensor
    customer: torch.Tensor


N_QUERY_PARAMS = len(QueryParams._fields)

# the store columns a page carries, in QueryResult order after n/total
_PAGE_FIELDS = QueryResult._fields[2:]


def bucket_limit(limit: int) -> int:
    """Power-of-two bucket for ``limit`` — one page shape per bucket
    instead of one per distinct ``pageSize`` (callers slice the result
    back to the exact page)."""
    return 1 << max(0, int(limit) - 1).bit_length()


def host_filter_mask(cols: dict, *, device=None, etype=None, tenant=None,
                     assignment=None, aux0=None, aux1=None, area=None,
                     customer=None, since_ms=None,
                     until_ms=None) -> np.ndarray:
    """Host-side (numpy) evaluation of ONE query predicate set over a
    columnar row block — the mirror of the masks :func:`query_store`
    builds on the device. ``cols`` maps ring column names to arrays
    (``aux`` is the 2-d lane column); ``None`` = any, matching the NULL_ID
    convention of :class:`QueryParams`. Validity and eviction caps are
    the caller's concern — this is only the predicate conjunction."""
    n = len(cols["ts_ms"])
    m = np.ones(n, bool)
    if device is not None:
        m &= cols["device"] == device
    if etype is not None:
        m &= cols["etype"] == etype
    if tenant is not None:
        m &= cols["tenant"] == tenant
    if assignment is not None:
        m &= cols["assignment"] == assignment
    if aux0 is not None:
        m &= cols["aux"][:, 0] == aux0
    if aux1 is not None:
        m &= cols["aux"][:, 1] == aux1
    if area is not None:
        m &= cols["area"] == area
    if customer is not None:
        m &= cols["customer"] == customer
    ts = cols["ts_ms"]
    if since_ms is not None:
        m &= ts >= since_ms
    if until_ms is not None:
        m &= ts <= until_ms
    return m


MAX_PAGE_SIZE = 1000


def clamp_page_size(value, default: int = 100) -> int:
    """The pageSize clamp ([1, MAX_PAGE_SIZE]) for every external surface;
    it caps :func:`bucket_limit` at 1024."""
    if value is None:
        value = default
    return max(1, min(int(value), MAX_PAGE_SIZE))


def _newest_first_key(store: EventStore) -> torch.Tensor:
    # clamp before negating: -INT32_MIN wraps in int32
    return -torch.clamp(store.ts_ms, min=INT32_MIN + 1)


def _page(store: EventStore, top: torch.Tensor, total: torch.Tensor,
          limit: int) -> QueryResult:
    top = top.long()
    return QueryResult(torch.clamp(total, max=limit), total,
                       *(getattr(store, f)[top] for f in _PAGE_FIELDS))


def query_store_batch(store: EventStore, params: QueryParams,
                      limit: int = 100) -> QueryResult:
    """Evaluate Q predicate sets in one pass over the ring (leading Q dim
    on every result field). One shared newest-first ordering sort; per
    query only the O(N) mask + stable-partition top-k. Byte-identical to
    Q sequential :func:`query_store` calls at the same ``limit``."""
    limit = min(limit, store.capacity)   # match query_store's perm[:limit]
    # one ordering sort shared by every query: stable ascending on -ts
    # keeps index-ascending ties, so a stable partition by each query's
    # match mask reproduces lex_argsort([~match, -ts]) exactly
    _, perm = lex_argsort([_newest_first_key(store)])
    p = {f: v[:, None] for f, v in params._asdict().items()}     # [Q, 1]
    m = store.valid[None, :].expand(params.device.shape[0], -1).clone()
    for f in ("device", "etype", "tenant", "assignment", "area", "customer"):
        m &= (p[f] == NULL_ID) | (getattr(store, f)[None, :] == p[f])
    m &= (p["aux0"] == NULL_ID) | (store.aux[None, :, 0] == p["aux0"])
    m &= (p["aux1"] == NULL_ID) | (store.aux[None, :, 1] == p["aux1"])
    m &= (store.ts_ms[None, :] >= p["t0"]) & (store.ts_ms[None, :] <= p["t1"])
    total = m.sum(1, dtype=torch.int32)                             # [Q]
    top = stable_partition_topk(perm, m[:, perm.long()], total, limit)
    return _page(store, top, total, limit)


def _filter(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=dev)


def query_store(
    store: EventStore,
    device,              # int32[] filter (NULL_ID = any)
    etype,               # int32[] filter (NULL_ID = any)
    tenant,              # int32[] filter (NULL_ID = any)
    t0,                  # int32[] inclusive lower ts bound
    t1,                  # int32[] inclusive upper ts bound
    limit: int = 100,
    assignment=None,     # int32[] filter (NULL_ID = any)
    aux0=None,           # int32[] filter on aux[:, 0]
    aux1=None,           # int32[] filter on aux[:, 1]
    area=None,           # int32[] filter (NULL_ID = any)
    customer=None,       # int32[] filter (NULL_ID = any)
) -> QueryResult:
    """Newest-first filtered query over the whole ring. Filters are ints
    or 0-d int32 tensors; ``device`` is the device-id filter (the store's
    own torch device is where the scan runs)."""
    dev = store.valid.device
    m = store.valid.clone()
    eq = {"device": device, "etype": etype, "tenant": tenant,
          "assignment": assignment, "area": area, "customer": customer}
    for f, v in eq.items():
        if v is not None:
            v = _filter(v, dev)
            m &= (v == NULL_ID) | (getattr(store, f) == v)
    for lane, v in ((0, aux0), (1, aux1)):
        if v is not None:
            v = _filter(v, dev)
            m &= (v == NULL_ID) | (store.aux[:, lane] == v)
    m &= (store.ts_ms >= _filter(t0, dev)) & (store.ts_ms <= _filter(t1, dev))
    total = m.sum(dtype=torch.int32)
    # sort newest first: key = (~match, -ts)
    _, perm = lex_argsort([(~m).to(torch.int32), _newest_first_key(store)])
    return _page(store, perm[:limit], total, limit)


def merge_shard_pages(pages: QueryResult, limit: int) -> QueryResult:
    """Merge per-shard top-``limit`` pages into the global page (host
    side, numpy). ``pages`` is a :class:`QueryResult` of host arrays with
    a leading shard axis (``ts_ms`` is ``[S, limit]``; ``n``/``total``
    are ``[S]``). The merge key is ``(-ts, shard, in-page rank)`` —
    newest first, shard-ascending then rank-ascending on ts ties. Per-shard
    top-k is sufficient: any global top-``limit`` row is inside its own
    shard's top-``limit``."""
    n = np.asarray(pages.n).astype(np.int64)            # [S]
    ts_all = np.asarray(pages.ts_ms)
    page_len = ts_all.shape[1]
    s_idx, i_idx = np.nonzero(
        np.arange(page_len)[None, :] < n[:, None])
    order = np.lexsort(
        (i_idx, s_idx,
         -ts_all[s_idx, i_idx].astype(np.int64)))[: int(limit)]
    gs, gi = s_idx[order], i_idx[order]
    k = len(order)
    total = int(np.asarray(pages.total).sum())

    def gather(col):
        col = np.asarray(col)
        out = np.zeros((int(limit),) + col.shape[2:], col.dtype)
        out[:k] = col[gs, gi]
        return out

    return QueryResult(
        np.int32(min(total, int(limit))), np.int32(total),
        *(gather(getattr(pages, f)) for f in _PAGE_FIELDS))
