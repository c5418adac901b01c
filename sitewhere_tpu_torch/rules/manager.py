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
  Every emitted or applied alert interns its alternate id, so the
  engine's event-id interner doubles as the key registry:
  ``resync_emitted()`` scans it so replay and standby promotion emit
  exactly the fires the previous owner never got out, and nothing twice.

* **leader-only emission** — a standby (``active=False``) runs the same
  rule set over the same stream, but its pending fires are never
  harvested; ``promote()`` flips ``active`` and the next poll drains what
  the old owner left, suppressed against the applied keys.

Around it: mtime hot reload (``watch_file``, ``check_reload``,
``RuleSetWatcher``) and the rollup retention tier (``spill_rollups``
ages closed windows into an ``EventArchive`` under ``<archive>/rollups``,
``read_rollup_history`` reads them back).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib
import threading
from types import SimpleNamespace

import numpy as np

from sitewhere_tpu_torch.ops.rules import KIND_ABSENCE
from sitewhere_tpu_torch.rules.model import RuleSet, RuleSetError

logger = logging.getLogger(__name__)

ALERT_KEY_PREFIX = "swr:"


class RulesManager:
    """Rule-set lifecycle + alert emission for one engine."""

    def __init__(self, engine, active: bool = True):
        from sitewhere_tpu_torch.utils.metrics import rules_metrics

        self.engine = engine
        self.active = active          # leader emits; standbys observe
        self.ruleset: RuleSet | None = None
        self.meta: list = []
        self.rollup_meta: list = []
        self._mu = threading.Lock()   # manager bookkeeping only; engine
        #                               state swaps take the engine lock
        self._emitted: set[str] = set()
        self._scan_pos = 0            # event-id interner resync cursor
        self._path: pathlib.Path | None = None
        self._mtime: float | None = None
        self.swaps = 0
        self.reload_errors = 0
        self.alerts_emitted = 0
        self.alerts_suppressed = 0
        # every harvested fire lands in exactly one sink: emitted,
        # dedup-suppressed, or skipped (stale meta row / unresolvable
        # group token)
        self.fires_harvested = 0
        self.harvest_skipped = 0
        # closed [P, G, NB] rollup windows age out to columnar segments
        # under <archive>/rollups
        self._rollup_arch = None
        self.rollup_windows_spilled = 0
        self.rollup_spill_calls = 0
        self._inst = rules_metrics()

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
        self._inst["swaps"].inc()
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

    # -------------------------------------------------------- hot reload
    def watch_file(self, path) -> dict:
        """Load ``path`` now and arm mtime-based hot reload for it."""
        p = pathlib.Path(path)
        summary = self.load(json.loads(p.read_text()))
        with self._mu:
            self._path = p
            self._mtime = p.stat().st_mtime
        return summary

    def check_reload(self) -> bool:
        """Reload the watched file if its mtime changed. The mtime only
        advances after a successful swap, so a torn write retries on the
        next tick; a bad document raises, is counted, and the active set
        keeps serving. Returns True when a reload ran."""
        with self._mu:
            path, mtime = self._path, self._mtime
        if path is None:
            return False
        try:
            now_mtime = path.stat().st_mtime
        except OSError:
            return False
        if mtime is not None and now_mtime == mtime:
            return False
        try:
            self.load(json.loads(path.read_text()))
        except (RuleSetError, ValueError, OSError) as e:
            with self._mu:
                self.reload_errors += 1
            self._inst["reload_errors"].inc()
            logger.error("rule-set reload of %s rejected (keeping the "
                         "active set): %s", path, e)
            raise
        with self._mu:
            self._mtime = now_mtime
        return True

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

    def promote(self) -> int:
        """Standby -> owner: enable emission and resync the dedup keys
        from the applied stream. The next ``poll()`` emits exactly the
        fires the old owner never shipped."""
        self.active = True
        return self.resync_emitted()

    def poll(self, flush: bool = False) -> list[dict]:
        """Harvest pending fires and emit their alert events through the
        normal ingest pipeline. An inactive (standby) manager only
        resyncs: its pending fires stay on the device for promotion.
        Returns the alerts emitted."""
        eng = self.engine
        if flush:
            eng.flush()
        self.resync_emitted()
        if not self.active:
            return []
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
                    self._inst["suppressed"].inc()
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
            self._inst["alerts"].inc(len(alerts))
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
                "rules": [dataclass_dict(m) for m in self.meta],
                "rollups": [dataclass_dict(m) for m in self.rollup_meta],
                "active": self.active,
                "swaps": self.swaps,
                "reloadErrors": self.reload_errors,
                "alertsEmitted": self.alerts_emitted,
                "alertsSuppressed": self.alerts_suppressed,
                "dedupKeys": len(self._emitted),
                "watchedFile": str(self._path) if self._path else None,
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

    # ----------------------------------------------------- rollup spill
    def rollup_archive(self):
        """The rollup retention tier: a second :class:`EventArchive` under
        ``<archive dir>/rollups`` (made on first use; partition = rollup
        index; segment size and compression follow the main archive).
        ``None`` without a main archive: spill is then a no-op and
        dashboards read the ring only."""
        arch = self.engine.archive
        if arch is None:
            return None
        if self._rollup_arch is None:
            from sitewhere_tpu_torch.utils.archive import EventArchive

            self._rollup_arch = EventArchive(
                arch.dir / "rollups", segment_rows=arch.segment_rows,
                cache_segments=2, compress=arch.compress)
        return self._rollup_arch

    def spill_rollups(self, lag: int = 1) -> dict:
        """Age closed rollup windows out of the device-resident
        ``[P, G, NB]`` rings into the rollup archive. A window is closed
        once the rollup's newest live window id exceeds it by ``lag``.
        Idempotent: each rollup's spill watermark is recovered from the
        segments' ``aux0`` (= window id) zone maps, so a respill or a
        fresh manager writes nothing twice. One archive row per non-empty
        closed (group, window): device = group id, assignment = rollup
        index, ts_ms = window start (relative ms, the ``windowStartMs``
        domain), received_ms = window end, value lanes = [count, sum,
        min, max], aux = [window id, bucket]."""
        eng = self.engine
        ra = self.rollup_archive()
        out = {"spilled": 0, "rollups": 0}
        if ra is None:
            return out
        with self._mu:
            metas = list(self.rollup_meta)
            self.rollup_spill_calls += 1
        c = int(eng.config.channels)
        nlan = min(4, c)
        for p, m in enumerate(metas):
            with eng.lock:
                eng._sync_mirrors()
                rs = eng.state.rules
                if rs is None or rs.rollups is None:
                    break
                wid, cnt, vsum, vmin, vmax = eng._rollup_tables(p)
            live = cnt > 0
            if not live.any():
                continue
            newest = int(wid[live].max())
            mark = max((s.stats["z"]["aux0"][1] for s in ra.segments
                        if s.part == p and s.stats
                        and "aux0" in s.stats.get("z", {})), default=-1)
            gs, bs = np.nonzero(live & (wid <= newest - lag) & (wid > mark))
            if not gs.size:
                continue
            w_sel = wid[gs, bs]
            order = np.lexsort((gs, w_sel))
            gs, bs, w_sel = gs[order], bs[order], w_sel[order]
            n = gs.size
            vals = np.zeros((n, c), np.float32)
            stats_rows = np.stack([cnt[gs, bs], vsum[gs, bs],
                                   vmin[gs, bs], vmax[gs, bs]], axis=1)
            vals[:, :nlan] = stats_rows[:, :nlan]
            vmask = np.zeros((n, c), bool)
            vmask[:, :nlan] = True
            tenant = np.zeros(n, np.int64)
            if m.scope == "tenant":
                tenant[:] = gs
            elif m.scope == "device":
                for i, g in enumerate(gs):      # cold path, small n
                    info = eng.devices.get(int(g))
                    if info is not None:
                        tenant[i] = max(eng.tenants.lookup(info.tenant), 0)
            sl = SimpleNamespace(
                etype=np.zeros(n, np.int64),    # MEASUREMENT
                device=gs.astype(np.int64),
                assignment=np.full(n, p, np.int64),
                tenant=tenant,
                area=gs.astype(np.int64) if m.scope == "area"
                else np.full(n, -1, np.int64),
                customer=np.full(n, -1, np.int64),
                asset=np.full(n, -1, np.int64),
                ts_ms=w_sel.astype(np.int64) * m.window_ms,
                received_ms=(w_sel.astype(np.int64) + 1) * m.window_ms,
                values=vals, vmask=vmask,
                aux=np.stack([w_sel.astype(np.int64), bs.astype(np.int64)],
                             axis=1),
                valid=np.ones(n, bool))
            ra.append_segment(p, ra.spilled(p), sl)
            out["spilled"] += n
            out["rollups"] += 1
        with self._mu:
            self.rollup_windows_spilled += out["spilled"]
        if out["spilled"]:
            eng.host_counters["rollup_windows_spilled"] = \
                eng.host_counters.get("rollup_windows_spilled", 0) \
                + out["spilled"]
        return out

    def read_rollup_history(self, name: str, group: str | None = None,
                            since_ms: int | None = None,
                            until_ms: int | None = None,
                            limit: int = 100) -> dict:
        """Serve one rollup's spilled windows from the rollup archive
        through the pushdown query path (zone maps prune by time, blooms
        by group); :meth:`read_rollup` serves the ring's hot tail."""
        eng = self.engine
        with self._mu:
            metas = list(self.rollup_meta)
        p = next((i for i, m in enumerate(metas) if m.name == name), None)
        if p is None:
            raise KeyError(f"rollup {name!r} not found")
        m = metas[p]
        base = {"rollup": name, "windowMs": m.window_ms, "scope": m.scope,
                "channel": m.channel, "buckets": []}
        ra = self.rollup_archive()
        if ra is None:
            return base
        gid = None
        if group is not None:
            gid = self._group_id(m.scope, group)
            if gid is None:
                return base
        _total, rows = ra.query(assignment=p, device=gid, since_ms=since_ms,
                                until_ms=until_ms, limit=limit)
        nlan = min(4, int(eng.config.channels))
        for r in rows:
            v = np.asarray(r["values"], np.float64)
            stats = [float(v[i]) if i < nlan else 0.0 for i in range(4)]
            base["buckets"].append({
                "group": self._group_token(m.scope, int(r["device"]))
                or int(r["device"]),
                "windowStartMs": int(r["ts_ms"]),
                "count": int(stats[0]), "sum": stats[1],
                "min": stats[2], "max": stats[3],
            })
        return base


def dataclass_dict(m) -> dict:
    return dataclasses.asdict(m)


class RuleSetWatcher:
    """Background mtime poll driving ``check_reload`` + ``poll`` — the
    plain-file analog of a watched rule deployment (a thread, because the
    engine API is synchronous)."""

    def __init__(self, manager: RulesManager, path, interval_s: float = 1.0,
                 poll_alerts: bool = True):
        self.manager = manager
        self.path = path
        self.interval_s = interval_s
        self.poll_alerts = poll_alerts
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.manager.watch_file(self.path)

        def run():
            while not self._stop.wait(self.interval_s):
                try:
                    self.manager.check_reload()
                except Exception:
                    pass               # counted + logged by the manager
                if self.poll_alerts:
                    try:
                        self.manager.poll()
                    except Exception:
                        logger.exception("rule poll failed")

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="swtpu-rules-watch")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
