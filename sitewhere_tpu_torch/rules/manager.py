"""Host runtime for the streaming-rules tier (port of
``sitewhere_tpu/rules/manager.py``).

The manager owns the active rule set of one engine:

* **validate-before-swap** — a candidate rule set is parsed, validated
  and lowered before the live set is touched; a bad document raises out
  of ``load()`` with the old set still serving. (Eager torch compiles
  nothing, so the JAX manager's ahead-of-time compile has no counterpart.)

* **dedup-keyed emission** — a fire's identity is
  ``swr:<rule>:<group>:<key>`` (rule + group + window). Alerts go out as
  ordinary DeviceAlert JSON envelopes through ``ingest_json_batch`` —
  persisted and queryable — with the key as the event's ``alternateId``.
  Every emitted alert interns its alternate id, so the engine's event-id
  interner doubles as the key registry: ``resync_emitted()`` scans it so
  nothing is emitted twice.

The file watcher, the rollup archive and standby emission are not ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading

import numpy as np

from sitewhere_tpu_torch.ops.rules import KIND_ABSENCE
from sitewhere_tpu_torch.rules.model import RuleSet

logger = logging.getLogger(__name__)

ALERT_KEY_PREFIX = "swr:"


class RulesManager:
    """Rule-set lifecycle + alert emission for one engine."""

    def __init__(self, engine):
        self.engine = engine
        self.ruleset: RuleSet | None = None
        self.meta: list = []
        self.rollup_meta: list = []
        self._mu = threading.Lock()   # manager bookkeeping only; engine
        #                               state swaps take the engine lock
        self._emitted: set[str] = set()
        self._scan_pos = 0            # event-id interner resync cursor
        self.swaps = 0
        self.alerts_emitted = 0
        self.alerts_suppressed = 0
        # every harvested fire lands in exactly one sink: emitted,
        # dedup-suppressed, or skipped (stale meta row / unresolvable
        # group token)
        self.fires_harvested = 0
        self.harvest_skipped = 0

    # ----------------------------------------------------------- install
    def load(self, doc) -> dict:
        """Validate + lower + install a rule set. Raises RuleSetError on a
        bad document without touching the live set. When the new set has
        the same shape signature and positional identity as the live one,
        carried state (window accumulators, sequence marks, absence
        deadlines, fired keys) is preserved."""
        ruleset = doc if isinstance(doc, RuleSet) else RuleSet.parse(doc)
        eng = self.engine
        state, meta, ro_meta = ruleset.lower(eng)
        preserve = (self.ruleset is not None
                    and ruleset.signature() == self.ruleset.signature()
                    and ruleset.identity() == self.ruleset.identity())
        eng.set_rules(state, preserve_state=preserve)
        with self._mu:
            self.ruleset = ruleset
            self.meta = meta
            self.rollup_meta = ro_meta
            self.swaps += 1
        summary = {"name": ruleset.name, "rules": len(meta),
                   "rollups": len(ro_meta), "preservedState": preserve,
                   "precompiled": False}
        logger.info("rule set %r installed: %s", ruleset.name, summary)
        return summary

    def clear(self) -> None:
        """Remove the active rule set."""
        self.engine.set_rules(None)
        with self._mu:
            self.ruleset = None
            self.meta = []
            self.rollup_meta = []

    # ---------------------------------------------------------- emission
    def resync_emitted(self) -> int:
        """Register every rule-alert dedup key the engine has ever seen
        (its event-id interner is append-only). Incremental: scans only
        tokens interned since the last call."""
        ids = self.engine.event_ids
        n = len(ids)
        added = 0
        with self._mu:
            for i in range(self._scan_pos, n):
                tok = ids.token(i)
                if tok.startswith(ALERT_KEY_PREFIX) and tok not in self._emitted:
                    self._emitted.add(tok)
                    added += 1
            self._scan_pos = n
        return added

    def poll(self, flush: bool = False) -> list[dict]:
        """Harvest pending fires and emit their alert events through the
        normal ingest pipeline. Returns the alerts emitted."""
        eng = self.engine
        if flush:
            eng.flush()
        self.resync_emitted()
        out = eng.poll_rule_fires()
        if out is None:
            return []
        pend_key, pend_val, pend_w, pend_h = out
        pending = pend_w - pend_h
        if not (pending > 0).any():
            return []
        depth = pend_key.shape[2]
        fires: list[tuple[int, int, int, float]] = []
        for r, g in zip(*np.nonzero(pending > 0)):
            n = min(int(pending[r, g]), depth)
            w = int(pend_w[r, g])
            for j in range(n):     # oldest -> newest within the ring
                slot = (w - n + j) % depth
                fires.append((int(r), int(g), int(pend_key[r, g, slot]),
                              float(pend_val[r, g, slot])))
        fires.sort()
        alerts: list[dict] = []
        by_tenant: dict[str, list[bytes]] = {}
        with self._mu:
            meta = list(self.meta)
        # the sink counters commit in one _mu block after the alerts were
        # ingested, so a reader sees the pre-poll or the post-poll
        # counters, never harvested ahead of its sinks
        skipped = suppressed = 0
        for r, g, key, val in fires:
            if r >= len(meta):
                skipped += 1       # stale pend row from a narrower set
                continue
            m = meta[r]
            group_tok = self._group_token(m.scope, g)
            if group_tok is None:
                skipped += 1
                continue
            dedup = f"{ALERT_KEY_PREFIX}{m.name}:{group_tok}:{key}"
            with self._mu:
                if dedup in self._emitted:
                    suppressed += 1
                    continue
                self._emitted.add(dedup)
            alerts.append(self._format_alert(m, group_tok, g, key, val,
                                             dedup, by_tenant))
        for tenant, payloads in by_tenant.items():
            eng.ingest_json_batch(payloads, tenant)
        with self._mu:
            self.fires_harvested += len(fires)
            self.harvest_skipped += skipped
            self.alerts_suppressed += suppressed
            self.alerts_emitted += len(alerts)
        if alerts:
            eng.host_counters["rule_alerts"] = \
                eng.host_counters.get("rule_alerts", 0) + len(alerts)
        return alerts

    def _group_token(self, scope: str, g: int) -> str | None:
        eng = self.engine
        if scope == "device":
            info = eng.devices.get(g)
            return info.token if info is not None else None
        interner = eng.areas if scope == "area" else eng.tenants
        return interner.token(g) if 0 <= g < len(interner) else None

    def _format_alert(self, m, group_tok: str, g: int, key: int,
                      val: float, dedup: str, by_tenant: dict) -> dict:
        eng = self.engine
        # deterministic event time from the fire key (never the clock):
        # window rules -> window start; absence -> deadline expiry
        rel = (key + m.window_ms if m.lowered_kind == KIND_ABSENCE
               else key * m.window_ms)
        abs_ms = int(eng.epoch.base_unix_s * 1000) + rel
        if m.scope == "device":
            token, tenant = group_tok, eng.devices[g].tenant
        else:
            # area/tenant-grouped fires attach to a per-tenant emitter
            # device (registered through the admin path)
            tenant = group_tok if m.scope == "tenant" else (
                m.tenant or "default")
            token = f"swrules-{tenant}"
            if eng.tokens.lookup(token) < 0 or \
                    eng.token_device.get(eng.tokens.lookup(token)) is None:
                eng.register_device(token, tenant=tenant)
        envelope = {
            "deviceToken": token, "type": "DeviceAlert", "tenant": tenant,
            "request": {
                "type": m.alert_type, "level": m.level.capitalize(),
                "message": f"rule {m.name} fired for {m.scope} "
                           f"{group_tok}",
                "eventDate": abs_ms, "alternateId": dedup,
            },
        }
        by_tenant.setdefault(tenant, []).append(
            json.dumps(envelope, sort_keys=True).encode())
        return {"rule": m.name, "kind": m.kind, "scope": m.scope,
                "group": group_tok, "key": key, "value": val,
                "alternateId": dedup, "deviceToken": token,
                "tenant": tenant, "eventDateMs": abs_ms,
                "level": m.level, "alertType": m.alert_type}

    # ------------------------------------------------------------- reads
    def status(self) -> dict:
        counters = self.engine.rule_counters()
        with self._mu:
            rs = self.ruleset
            out = {
                "ruleSet": rs.name if rs else None,
                "rules": [dataclasses.asdict(m) for m in self.meta],
                "rollups": [dataclasses.asdict(m) for m in self.rollup_meta],
                "swaps": self.swaps,
                "alertsEmitted": self.alerts_emitted,
                "alertsSuppressed": self.alerts_suppressed,
                "dedupKeys": len(self._emitted),
            }
        out.update(counters)
        return out

    def read_rollup(self, name: str, group: str | None = None,
                    limit: int = 100) -> dict:
        """Serve one rollup's materialized windows (newest first). With
        ``group`` only that device/area/tenant's ring is read; without, up
        to ``limit`` non-empty (group, window) buckets are listed."""
        eng = self.engine
        with self._mu:
            metas = list(self.rollup_meta)
        p = next((i for i, m in enumerate(metas) if m.name == name), None)
        if p is None:
            raise KeyError(f"rollup {name!r} not found")
        m = metas[p]
        with eng.lock:
            eng._sync_mirrors()
            rs = eng.state.rules
            if rs is None or rs.rollups is None:
                # a concurrent clear() raced this read
                return {"rollup": name, "windowMs": m.window_ms,
                        "scope": m.scope, "channel": m.channel,
                        "buckets": []}
            wid, cnt, vsum, vmin, vmax = eng._rollup_tables(p)
            gid = None
            if group is not None:
                gid = self._group_id(m.scope, group)
                if gid is None or not (0 <= gid < wid.shape[0]):
                    return {"rollup": name, "windowMs": m.window_ms,
                            "scope": m.scope, "buckets": []}
        if gid is not None:
            rows = [(gid, b) for b in np.nonzero(cnt[gid] > 0)[0]]
        else:
            gs, bs = np.nonzero(cnt > 0)
            rows = list(zip(gs, bs))
        rows.sort(key=lambda gb: (-int(wid[gb[0], gb[1]]), gb[0]))
        buckets = []
        for g, b in rows[:limit]:
            buckets.append({
                "group": self._group_token(m.scope, int(g)) or int(g),
                "windowStartMs": int(wid[g, b]) * m.window_ms,
                "count": int(cnt[g, b]),
                "sum": float(vsum[g, b]),
                "min": float(vmin[g, b]),
                "max": float(vmax[g, b]),
            })
        return {"rollup": name, "windowMs": m.window_ms, "scope": m.scope,
                "channel": m.channel, "buckets": buckets}

    def _group_id(self, scope: str, token: str) -> int | None:
        eng = self.engine
        if scope == "device":
            tid = eng.tokens.lookup(token)
            return eng.token_device.get(tid) if tid >= 0 else None
        interner = eng.areas if scope == "area" else eng.tenants
        gid = interner.lookup(token)
        return gid if gid >= 0 else None
