"""Declarative rule-set model: parse, validate, lower to device tables (the
port's copy of ``sitewhere_tpu/rules/model.py``).

A rule set is a plain JSON document (REST/RPC-postable, file-watchable):

    {
      "name": "default",
      "rules": [
        {"name": "overheat", "kind": "threshold",
         "channel": "engine.temperature", "op": ">", "value": 90,
         "cooldownMs": 1000, "scope": "device",
         "alertType": "overheat", "level": "ERROR"},
        {"name": "hot-burst", "kind": "window", "agg": "count",
         "channel": "engine.temperature", "op": ">=", "value": 5,
         "windowMs": 5000,
         "where": {"channel": "engine.temperature", "op": ">", "value": 90}},
        {"name": "spike-then-drop", "kind": "sequence",
         "first": {"channel": "rpm", "op": ">", "value": 5000},
         "then":  {"channel": "rpm", "op": "<", "value": 100},
         "withinMs": 10000},
        {"name": "went-silent", "kind": "absence",
         "channel": "engine.temperature", "deadlineMs": 60000}
      ],
      "rollups": [
        {"name": "temp-1s", "channel": "engine.temperature",
         "windowMs": 1000, "scope": "device"}
      ]
    }

Validation happens at parse time (loudly — a bad rule set never reaches
the device), lowering at install time against a live engine's interners,
onto the engine's device. Threshold rules LOWER to window rules over the
running extremum — "some event crossed" == "running max/min crossed" — so
the update (ops/rules.py) only knows three kinds. Window (agg, op) combinations are
restricted to the monotone ones; that restriction is what makes fire
detection batch-partition invariant (the replay/standby parity
contract — see ops/rules.py docstring).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

from sitewhere_tpu_torch.core.types import NULL_ID, AlertLevel, EventType
from sitewhere_tpu_torch.ops.rules import (
    AGG_COUNT,
    AGG_MAX,
    AGG_MIN,
    AGG_SUM,
    KIND_ABSENCE,
    KIND_SEQUENCE,
    KIND_WINDOW,
    OP_GE,
    OP_GT,
    OP_LE,
    OP_LT,
    SCOPE_AREA,
    SCOPE_DEVICE,
    SCOPE_TENANT,
    RollupBlock,
    RuleBlock,
    RulesState,
)


class RuleSetError(ValueError):
    """Invalid rule-set document; raised at parse/validate time, BEFORE
    any live state is touched (the validate-before-swap discipline)."""


_OPS = {">": OP_GT, ">=": OP_GE, "<": OP_LT, "<=": OP_LE,
        "gt": OP_GT, "ge": OP_GE, "lt": OP_LT, "le": OP_LE}
_AGGS = {"count": AGG_COUNT, "sum": AGG_SUM, "min": AGG_MIN, "max": AGG_MAX}
_SCOPES = {"device": SCOPE_DEVICE, "area": SCOPE_AREA,
           "tenant": SCOPE_TENANT}
_KINDS = ("threshold", "window", "sequence", "absence")
# monotone (agg, op) combinations: once the running aggregate satisfies
# the predicate within a window it stays satisfied, so fire detection is
# independent of where batch boundaries fall
_MONOTONE_OPS = {AGG_COUNT: (OP_GT, OP_GE), AGG_SUM: (OP_GT, OP_GE),
                 AGG_MAX: (OP_GT, OP_GE), AGG_MIN: (OP_LT, OP_LE)}

MAX_RULES = 64
MAX_ROLLUPS = 16
NO_PRED_OP = -1          # sentinel: predicate slot unused


def _pred(spec, ctx: str) -> tuple[str, int, float]:
    if not isinstance(spec, dict):
        raise RuleSetError(f"{ctx}: predicate must be an object")
    ch = spec.get("channel")
    if not ch or not isinstance(ch, str):
        raise RuleSetError(f"{ctx}: predicate requires a 'channel' name")
    op = spec.get("op", "any")
    if op in ("any", "*"):          # "an event on this channel"
        return ch, OP_GE, float("-inf")
    if op not in _OPS:
        raise RuleSetError(f"{ctx}: unknown op {op!r} "
                           f"(known: {sorted(_OPS)})")
    if "value" not in spec:
        raise RuleSetError(f"{ctx}: op {op!r} requires 'value'")
    return ch, _OPS[op], float(spec["value"])


@dataclasses.dataclass(frozen=True)
class RuleMeta:
    """Host-side per-rule metadata the manager needs at emission time."""

    name: str
    kind: str                    # user-facing kind (threshold stays
    #                              'threshold' even though it lowers)
    scope: str
    tenant: str | None
    window_ms: int
    alert_type: str
    level: str                   # AlertLevel name
    lowered_kind: int            # KIND_* actually on device


@dataclasses.dataclass(frozen=True)
class RollupMeta:
    name: str
    channel: str
    scope: str
    window_ms: int


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """A parsed + validated rule-set document."""

    doc: dict
    rules: tuple
    rollups: tuple

    @property
    def name(self) -> str:
        return self.doc.get("name", "default")

    @staticmethod
    def parse(doc: dict | str | pathlib.Path) -> "RuleSet":
        if isinstance(doc, (str, pathlib.Path)):
            doc = json.loads(pathlib.Path(doc).read_text())
        if not isinstance(doc, dict):
            raise RuleSetError("rule set must be a JSON object")
        rules = doc.get("rules", [])
        rollups = doc.get("rollups", [])
        if not isinstance(rules, list) or not isinstance(rollups, list):
            raise RuleSetError("'rules' and 'rollups' must be arrays")
        if len(rules) > MAX_RULES:
            raise RuleSetError(f"{len(rules)} rules > limit {MAX_RULES}")
        if len(rollups) > MAX_ROLLUPS:
            raise RuleSetError(
                f"{len(rollups)} rollups > limit {MAX_ROLLUPS}")
        # document-level capacity overrides validate at PARSE time, so a
        # pre-validating caller (config.reload_tenant_config) can reject
        # a bad document before tearing anything down — lower() re-checks
        # but must never be the first place a doc error surfaces
        for knob in ("groups", "rollupBuckets", "pending"):
            if knob in doc:
                try:
                    val = int(doc[knob])
                except (TypeError, ValueError):
                    raise RuleSetError(
                        f"'{knob}' must be an integer") from None
                if val < 1:
                    raise RuleSetError(f"'{knob}' must be >= 1")
        seen: set[str] = set()
        parsed_rules = []
        for i, spec in enumerate(rules):
            parsed_rules.append(_parse_rule(spec, i, seen))
        parsed_rollups = []
        for i, spec in enumerate(rollups):
            parsed_rollups.append(_parse_rollup(spec, i, seen))
        if not parsed_rules and not parsed_rollups:
            raise RuleSetError("rule set defines no rules and no rollups")
        return RuleSet(doc=doc, rules=tuple(parsed_rules),
                       rollups=tuple(parsed_rollups))

    # ---------------------------------------------------------- lowering
    def signature(self) -> tuple:
        """Shape/structure signature: two rule sets with equal
        signatures lower to identical device-array shapes AND identical
        static layouts (a swap between them is a pure parameter update —
        carried state preservable). Rollup DEFINITIONS are
        part of it: a changed rollup (channel/scope/window) must get
        fresh rings, never inherit another definition's accumulators."""
        return (len(self.rules), len(self.rollups),
                # window_ms is part of the preserve gate: fire keys and
                # accumulators are denominated in window units, so a
                # window change must reset carried state, never inherit
                # keys computed in the old units
                tuple((r["lowered_kind"], _SCOPES[r["scope"]], r["agg"],
                       r["op_a"], r["op_b"], r["window_ms"])
                      for r in self.rules),
                tuple((p["name"], p["channel"], p["scope"], p["etype"],
                       p["window_ms"]) for p in self.rollups))

    def identity(self) -> tuple:
        """Positional rule identity; carried state is only preserved
        across a swap when this matches (same rules, tweaked params)."""
        return tuple((r["name"], r["kind"], r["scope"]) for r in self.rules)

    def lower(self, engine) -> tuple[RulesState, list[RuleMeta],
                                     list[RollupMeta]]:
        """Resolve names against the engine's interners and build fresh
        device blocks. Channel names intern (rules may precede traffic);
        install the SAME rule set on every replica of a partition so the
        interner streams stay aligned."""
        groups = int(self.doc.get(
            "groups", getattr(engine.config, "rule_groups", 1024)))
        buckets = int(self.doc.get(
            "rollupBuckets", getattr(engine.config, "rollup_buckets", 32)))
        if groups < 1 or buckets < 1:
            raise RuleSetError("groups/rollupBuckets must be >= 1")

        def ch(name: str) -> int:
            return engine.channel_map.channel_of(name)

        def tenant_id(name) -> int:
            return engine.tenants.intern(name) if name else NULL_ID

        meta: list[RuleMeta] = []
        layout: list[tuple] = []
        cols: dict[str, list] = {k: [] for k in (
            "active", "etype", "tenant", "ch_a", "val_a", "ch_b",
            "val_b", "window_ms")}
        for r in self.rules:
            # static structure (the update branches per rule
            # kind/scope/agg/op; changing these resets carried state)
            layout.append((r["lowered_kind"], _SCOPES[r["scope"]],
                           r["agg"], r["op_a"], r["op_b"]))
            cols["active"].append(True)
            cols["etype"].append(r["etype"])
            cols["tenant"].append(tenant_id(r["tenant"]))
            cols["ch_a"].append(ch(r["ch_a"]))
            cols["val_a"].append(r["val_a"])
            cols["ch_b"].append(ch(r["ch_b"]) if r["ch_b"] else 0)
            cols["val_b"].append(r["val_b"])
            cols["window_ms"].append(r["window_ms"])
            meta.append(RuleMeta(
                name=r["name"], kind=r["kind"], scope=r["scope"],
                tenant=r["tenant"], window_ms=r["window_ms"],
                alert_type=r["alert_type"], level=r["level"],
                lowered_kind=r["lowered_kind"]))
        rb = None
        if self.rules:
            table = {k: np.asarray(v) for k, v in cols.items()}
            table["val_a"] = np.asarray(cols["val_a"], np.float32)
            table["val_b"] = np.asarray(cols["val_b"], np.float32)
            pending = int(self.doc.get(
                "pending", getattr(engine.config, "rule_pending", 4)))
            rb = RuleBlock.zeros(table, tuple(layout), groups, pending,
                                 device=engine.device)

        ro = None
        ro_meta: list[RollupMeta] = []
        if self.rollups:
            rt = {k: [] for k in ("channel", "scope", "etype", "window_ms")}
            for p in self.rollups:
                rt["channel"].append(ch(p["channel"]))
                rt["scope"].append(_SCOPES[p["scope"]])
                rt["etype"].append(p["etype"])
                rt["window_ms"].append(p["window_ms"])
                ro_meta.append(RollupMeta(
                    name=p["name"], channel=p["channel"], scope=p["scope"],
                    window_ms=p["window_ms"]))
            ro = RollupBlock.zeros(
                {k: np.asarray(v) for k, v in rt.items()}, groups, buckets,
                device=engine.device)
        return RulesState(rules=rb, rollups=ro), meta, ro_meta


def _etype_of(spec, ctx: str) -> int:
    raw = spec.get("etype", "MEASUREMENT")
    if raw in (None, "any", "*"):
        return NULL_ID
    try:
        return int(EventType[raw] if isinstance(raw, str) else
                   EventType(raw))
    except (KeyError, ValueError):
        raise RuleSetError(f"{ctx}: unknown etype {raw!r}") from None


def _scope_of(spec, ctx: str) -> str:
    scope = spec.get("scope", "device")
    if scope not in _SCOPES:
        raise RuleSetError(f"{ctx}: unknown scope {scope!r} "
                           f"(known: {sorted(_SCOPES)})")
    return scope


def _window_of(spec, key: str, ctx: str, default=None) -> int:
    raw = spec.get(key, default)
    if raw is None:
        raise RuleSetError(f"{ctx}: '{key}' is required")
    w = int(raw)
    if w < 1:
        raise RuleSetError(f"{ctx}: '{key}' must be >= 1 ms")
    return w


def _parse_rule(spec, i: int, seen: set) -> dict:
    if not isinstance(spec, dict):
        raise RuleSetError(f"rule[{i}]: must be an object")
    name = spec.get("name")
    if not name or not isinstance(name, str) or ":" in name:
        raise RuleSetError(f"rule[{i}]: requires a 'name' without ':'")
    if name in seen:
        raise RuleSetError(f"rule[{i}]: duplicate name {name!r}")
    seen.add(name)
    kind = spec.get("kind")
    if kind not in _KINDS:
        raise RuleSetError(
            f"rule {name!r}: unknown kind {kind!r} (known: {_KINDS})")
    ctx = f"rule {name!r}"
    scope = _scope_of(spec, ctx)
    level = str(spec.get("level", "WARNING")).upper()
    if level not in AlertLevel.__members__:
        raise RuleSetError(f"{ctx}: unknown level {level!r}")
    out = {
        "name": name, "kind": kind, "scope": scope,
        "etype": _etype_of(spec, ctx),
        "tenant": spec.get("tenant"),
        "alert_type": str(spec.get("alertType", name)),
        "level": level,
        "ch_b": None, "op_b": NO_PRED_OP, "val_b": 0.0,
        "agg": AGG_MAX,
    }
    if kind == "threshold":
        chn, op, val = _pred(spec, ctx)
        if op not in (OP_GT, OP_GE, OP_LT, OP_LE):
            raise RuleSetError(f"{ctx}: threshold requires a comparison op")
        out.update(
            lowered_kind=KIND_WINDOW, ch_a=chn, op_a=op, val_a=val,
            # "some event crossed" == "running extremum crossed"
            agg=AGG_MAX if op in (OP_GT, OP_GE) else AGG_MIN,
            window_ms=_window_of(spec, "cooldownMs", ctx, default=1000))
    elif kind == "window":
        agg = spec.get("agg")
        if agg not in _AGGS:
            raise RuleSetError(f"{ctx}: unknown agg {agg!r} "
                               f"(known: {sorted(_AGGS)})")
        agg_c = _AGGS[agg]
        chn, op, val = _pred(spec, ctx)
        if op not in _MONOTONE_OPS[agg_c]:
            good = [k for k, v in _OPS.items()
                    if v in _MONOTONE_OPS[agg_c] and len(k) <= 2]
            raise RuleSetError(
                f"{ctx}: agg {agg!r} only supports monotone ops {good} "
                "(batch-partition-invariant fire detection)")
        out.update(lowered_kind=KIND_WINDOW, ch_a=chn, op_a=op, val_a=val,
                   agg=agg_c,
                   window_ms=_window_of(spec, "windowMs", ctx))
        if "where" in spec:
            wb, wop, wval = _pred(spec["where"], f"{ctx} where")
            out.update(ch_b=wb, op_b=wop, val_b=wval)
    elif kind == "sequence":
        ch_a, op_a, val_a = _pred(spec.get("first"), f"{ctx} first")
        ch_b, op_b, val_b = _pred(spec.get("then"), f"{ctx} then")
        out.update(lowered_kind=KIND_SEQUENCE,
                   ch_a=ch_a, op_a=op_a, val_a=val_a,
                   ch_b=ch_b, op_b=op_b, val_b=val_b,
                   window_ms=_window_of(spec, "withinMs", ctx))
    else:  # absence
        chn, op, val = _pred(spec, ctx)
        out.update(lowered_kind=KIND_ABSENCE, ch_a=chn, op_a=op,
                   val_a=val,
                   window_ms=_window_of(spec, "deadlineMs", ctx))
    return out


def _parse_rollup(spec, i: int, seen: set) -> dict:
    if not isinstance(spec, dict):
        raise RuleSetError(f"rollup[{i}]: must be an object")
    name = spec.get("name")
    if not name or not isinstance(name, str):
        raise RuleSetError(f"rollup[{i}]: requires a 'name'")
    if name in seen:
        raise RuleSetError(f"rollup[{i}]: duplicate name {name!r}")
    seen.add(name)
    ctx = f"rollup {name!r}"
    channel = spec.get("channel")
    if not channel or not isinstance(channel, str):
        raise RuleSetError(f"{ctx}: requires a 'channel' name")
    return {"name": name, "channel": channel,
            "scope": _scope_of(spec, ctx),
            "etype": _etype_of(spec, ctx),
            "window_ms": _window_of(spec, "windowMs", ctx)}
