"""Host-side reference semantics for rules and rollups (a copy of
``sitewhere_tpu/rules/oracle.py``).

Plain sequential Python reimplementations of the device kernels in
ops/rules.py, processing the event stream ONE EVENT AT A TIME (the
finest possible batch partition). Because the device kernels are
batch-partition invariant by construction, their fire-key sets and
rollup tables must match this oracle exactly — what the port's rules
tests pin on its engines (tests/test_torch_rules.py,
tests/test_torch_spmd_rules.py).

Events are dicts: ``{"ts": int_ms, "group": int, "value": float | None,
"value_b": float | None}`` — ``group`` already resolved for the rule's
scope, ``value``/``value_b`` are the predicate channels' values (None =
channel not populated on this event). Out-of-filter events should simply
be omitted by the caller.
"""

from __future__ import annotations

INT_MIN = -(2**31)


def _cmp(v: float, op: int, ref: float) -> bool:
    return [v > ref, v >= ref, v < ref, v <= ref][op]


def threshold_fire_keys(events, *, op, value, cooldown_ms) -> set:
    """(group, window_id) keys a threshold rule fires — at most one per
    group per cooldown window."""
    keys = set()
    for e in events:
        v = e.get("value")
        if v is None or not _cmp(v, op, value):
            continue
        keys.add((e["group"], e["ts"] // cooldown_ms))
    return keys


def window_fire_keys(events, *, agg, op, value, window_ms,
                     where=None) -> set:
    """(group, window_id) keys a windowed-aggregate rule fires: the
    running aggregate of the group's current tumbling window crossed the
    predicate. ``where`` (op, value) optionally filters contributing
    events; agg in {'count','sum','min','max'}."""
    acc: dict = {}          # group -> [wid, cnt, sum, mn, mx]
    keys = set()
    for e in events:
        v = e.get("value")
        if v is None:
            continue
        if where is not None and not _cmp(v, where[0], where[1]):
            continue
        g, wid = e["group"], e["ts"] // window_ms
        st = acc.get(g)
        if st is None or wid > st[0]:
            st = acc[g] = [wid, 0, 0.0, float("inf"), float("-inf")]
        elif wid < st[0]:
            continue        # late: never mixed into a newer window
        st[1] += 1
        st[2] += v
        st[3] = min(st[3], v)
        st[4] = max(st[4], v)
        cur = {"count": st[1], "sum": st[2], "min": st[3],
               "max": st[4]}[agg]
        if _cmp(cur, op, value):
            keys.add((g, wid))
    return keys


def sequence_fire_keys(events, *, op_a, val_a, op_b, val_b,
                       within_ms) -> set:
    """(group, window_id) keys of B-after-A pairs within the horizon.
    ``value`` feeds predicate A, ``value_b`` predicate B."""
    mark: dict = {}
    keys = set()
    for e in events:
        g, ts = e["group"], e["ts"]
        vb = e.get("value_b")
        if vb is not None and _cmp(vb, op_b, val_b):
            a = mark.get(g)
            if a is not None and a <= ts <= a + within_ms:
                keys.add((g, ts // within_ms))
        va = e.get("value")
        if va is not None and _cmp(va, op_a, val_a):
            mark[g] = max(mark.get(g, INT_MIN), ts)
    return keys


def absence_fire_keys(events, *, op, value, deadline_ms,
                      final_watermark=None) -> set:
    """(group, silence_opening_ts) keys: the group matched at t, then
    stayed silent past t + deadline (observed either by its own next
    match or by the stream watermark — pass ``final_watermark`` to close
    the stream the way the kernel's trailing check does)."""
    last: dict = {}
    wm = INT_MIN
    keys = set()
    for e in events:
        g, ts = e["group"], e["ts"]
        wm = max(wm, ts)
        v = e.get("value")
        if v is None or not _cmp(v, op, value):
            continue
        prev = last.get(g)
        if prev is not None and ts - prev > deadline_ms:
            keys.add((g, prev))
        last[g] = max(last.get(g, INT_MIN), ts)
    if final_watermark is not None:
        wm = max(wm, final_watermark)
    for g, prev in last.items():
        if wm - prev > deadline_ms:
            keys.add((g, prev))
    return keys


def rollup_oracle(events, *, window_ms, buckets) -> dict:
    """Recompute a rollup's ring exactly as the device maintains it:
    ``{(group, slot): (wid, count, sum, min, max)}`` for non-empty
    slots. Newest window id wins a slot; older events for an already-
    advanced slot are late and dropped (mirrors ops/rules.py)."""
    table: dict = {}
    late = 0
    for e in events:
        v = e.get("value")
        if v is None:
            continue
        g = e["group"]
        wid = e["ts"] // window_ms
        slot = wid % buckets
        st = table.get((g, slot))
        if st is None or wid > st[0]:
            st = table[(g, slot)] = [wid, 0, 0.0, float("inf"),
                                     float("-inf")]
        elif wid < st[0]:
            late += 1
            continue
        st[1] += 1
        st[2] += v
        st[3] = min(st[3], v)
        st[4] = max(st[4], v)
    return {k: tuple(v) for k, v in table.items()}
