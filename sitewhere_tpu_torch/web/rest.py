"""REST gateway: the external API surface (port of
``sitewhere_tpu/web/rest.py``, served over the port's own HTTP layer,
``web/http.py``, which speaks the subset of ``aiohttp.web`` used here).

Mirrors the reference's API layer: instance-management
hosts 25 JAX-RS controllers (service-instance-management/.../web/rest/
controllers/, 7,639 LoC) with JWT auth (JwtAuthForApi + BasicAuthForJwt),
CORS (web/CorsFilter.java), and per-tenant auth headers
(X-SiteWhere-Tenant-Id / X-SiteWhere-Tenant-Auth). Routes here cover the
same resource families: auth, devices, device types/statuses/alarms,
events, device states, command invocations, areas/types/zones,
customers/types, device groups, assets/types, batch operations, schedules/
jobs, labels, search, streams, tenants, users, and instance info.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import functools
import json
import math
from typing import Any

import numpy as np
from sitewhere_tpu_torch.web import http as web

from sitewhere_tpu_torch.commands.model import (CommandParameter, ParameterType,
                                          command_from_json)
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.ingest.decoders import request_from_envelope
from sitewhere_tpu_torch.ingest.requests import EventDecodeException
from sitewhere_tpu_torch.instance.auth import AUTH_ADMIN, AuthenticationError, JwtError
from sitewhere_tpu_torch.instance.instance import SiteWhereTpuInstance
from sitewhere_tpu_torch.management.entities import (DuplicateToken, EntityNotFound,
                                               entity_json, paged_json)

JSON = "application/json"


def _dumps(obj) -> str:
    import enum as _enum

    def default(o):
        if isinstance(o, _enum.Enum):
            return o.value if isinstance(o.value, (str, int)) else o.name
        return str(o)

    return json.dumps(obj, default=default)


def json_response(data=None, *, status: int = 200, headers=None) -> web.Response:
    return web.json_response(data, status=status, headers=headers, dumps=_dumps)
PUBLIC_PATHS = ("/api/authapi/jwt", "/api/instance/health")


def _sync(fn):
    """Wrap a sync route function as a coroutine handler."""

    async def handler(request: web.Request) -> web.Response:
        return fn(request)

    return handler


def _page_size(src, default: int = 100) -> int:
    """Mapping adapter over the shared clamp (ops/query.clamp_page_size,
    [1, 1000]) used by every paged surface here — it feeds the engine's
    power-of-two-bucketed query compile cache, so an unclamped raw
    pageSize can never mint an unbounded set of compiled programs.
    ``src`` is any Mapping with a ``pageSize`` key (query string or JSON
    body)."""
    from sitewhere_tpu_torch.ops.query import clamp_page_size

    return clamp_page_size(src.get("pageSize"), default)



def _meta_dict(meta) -> dict:
    return {"token": meta.token, "id": meta.id, "createdDateMs": meta.created_ms,
            "updatedDateMs": meta.updated_ms, "metadata": meta.metadata}


_entity = entity_json
_paged = paged_json


@web.middleware
async def cors_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        resp = web.Response()
    else:
        resp = await handler(request)
    resp.headers["Access-Control-Allow-Origin"] = "*"
    resp.headers["Access-Control-Allow-Methods"] = "GET,POST,PUT,DELETE,OPTIONS"
    resp.headers["Access-Control-Allow-Headers"] = (
        "Authorization,Content-Type,X-SiteWhere-Tenant-Id,X-SiteWhere-Tenant-Auth"
    )
    return resp


def make_app(instance: SiteWhereTpuInstance) -> web.Application:
    inst = instance

    @web.middleware
    async def auth_middleware(request: web.Request, handler):
        if request.method == "OPTIONS" or any(
            request.path.startswith(p) for p in PUBLIC_PATHS
        ):
            return await handler(request)
        header = request.headers.get("Authorization", "")
        if not header.startswith("Bearer "):
            return json_response({"error": "missing bearer token"}, status=401)
        try:
            claims = inst.jwt.validate(header[7:])
        except JwtError as e:
            return json_response({"error": str(e)}, status=401)
        request["user"] = claims["sub"]
        request["authorities"] = claims.get("auth", [])
        # tenant-scoped calls check the tenant auth headers like the
        # reference's tenant filters
        tenant = request.headers.get("X-SiteWhere-Tenant-Id")
        if tenant is not None:
            t = inst.tenants.tenants.try_get(tenant)
            if t is None:
                return json_response({"error": "unknown tenant"}, status=404)
            auth = request.headers.get("X-SiteWhere-Tenant-Auth")
            is_admin = AUTH_ADMIN in request["authorities"]
            if auth != t.auth_token and not inst.tenants.user_can_access(
                tenant, request["user"], is_admin
            ):
                return json_response({"error": "tenant access denied"}, status=403)
            request["tenant"] = tenant
        return await handler(request)

    @web.middleware
    async def error_middleware(request: web.Request, handler):
        from sitewhere_tpu_torch.rpc.protocol import RpcError
        from sitewhere_tpu_torch.utils.qos import ShedError

        try:
            return await handler(request)
        except EntityNotFound as e:
            return json_response({"error": str(e)}, status=404)
        except DuplicateToken as e:
            return json_response({"error": str(e)}, status=409)
        except ShedError as e:
            # overload discipline: an admission shed (or a
            # translated arena stall) answers 429 with an explicit
            # Retry-After — the client backs off instead of timing out
            return json_response(
                {"error": str(e), "retryAfterS": e.retry_after_s,
                 "reason": e.reason},
                status=429,
                headers={"Retry-After":
                         str(max(1, math.ceil(e.retry_after_s)))})
        except RpcError as e:
            # a forwarded single request shed at its OWNER rank comes
            # back as a typed code=429 RpcError (the synchronous
            # all-or-nothing envelope contract re-raises owner app
            # errors) — answer the same 429 + Retry-After the local
            # edge would, not a 500
            if getattr(e, "code", None) != 429:
                raise
            ra = getattr(e, "retry_after_s", None) or 0.05
            return json_response(
                {"error": str(e), "retryAfterS": ra, "reason": "shed"},
                status=429,
                headers={"Retry-After": str(max(1, math.ceil(ra)))})
        except (ValueError, KeyError, EventDecodeException) as e:
            return json_response({"error": str(e)}, status=400)

    app = web.Application(middlewares=[cors_middleware, error_middleware,
                                       auth_middleware])
    r = app.router

    # --- auth -------------------------------------------------------------
    async def get_jwt(request: web.Request):
        header = request.headers.get("Authorization", "")
        if not header.startswith("Basic "):
            return json_response({"error": "basic auth required"}, status=401)
        try:
            raw = base64.b64decode(header[6:]).decode()
            username, _, password = raw.partition(":")
            user = inst.users.authenticate(username, password)
        except (ValueError, AuthenticationError):
            return json_response({"error": "bad credentials"}, status=401)
        token = inst.jwt.generate(username, inst.users.authorities_for(user))
        return json_response({"token": token},
                                 headers={"X-Sitewhere-JWT": token})

    r.add_get("/api/authapi/jwt", get_jwt)
    # readiness probe: public (PUBLIC_PATHS), enriched by run_rank with
    # rank/peer/port info so an orchestrator can gate traffic on it
    r.add_get("/api/instance/health", _sync(lambda req: json_response(
        {"status": "UP", **getattr(inst, "health_extra", {})})))

    # --- instance ---------------------------------------------------------
    r.add_get("/api/instance", _sync(lambda req: json_response(inst.info())))

    def _instance_metrics(req: web.Request):
        m = inst.engine.metrics()
        arch = getattr(inst.engine, "archive", None)
        if arch is not None:
            m["archive"] = arch.disk_usage() | {
                "rows": arch.total_rows(),
                "lost_rows": arch.lost_rows,
                "expired_rows": arch.expired_rows,
            }
        return json_response(m)

    r.add_get("/api/instance/metrics", _sync(_instance_metrics))

    async def prometheus_metrics(request: web.Request):
        from sitewhere_tpu_torch.utils.metrics import REGISTRY, export_engine_metrics

        # a clustered engine fans out to peers inside metrics() — keep
        # the scrape off the gateway loop or a down peer freezes REST
        # (including the readiness probe) for its connect timeout
        text = await asyncio.to_thread(
            lambda: (export_engine_metrics(inst.engine),
                     REGISTRY.expose_text())[1])
        return web.Response(text=text, content_type="text/plain")

    r.add_get("/api/instance/metrics/prometheus", prometheus_metrics)

    async def cluster_status(request: web.Request):
        """Cluster topology + per-rank health/durability.
        Off-loop: probing peers blocks, and a DOWN peer without an open
        forward circuit costs a connect attempt."""
        status = getattr(inst.engine, "cluster_status", None)
        if status is None:
            return json_response({"clustered": False, "rank": 0,
                                  "nRanks": 1})
        return json_response(await asyncio.to_thread(status))

    r.add_get("/api/instance/cluster", cluster_status)

    async def cluster_health(request: web.Request):
        """Rank-LOCAL replication/health view (no peer fan-out, so it
        answers instantly even mid-partition) — the surface an operator
        (or the failover gate in bench.py) polls during an outage."""
        from sitewhere_tpu_torch.parallel.replication import (
            cluster_health_payload)

        return json_response(cluster_health_payload(inst.engine))

    r.add_get("/api/instance/cluster/health", cluster_health)

    async def cluster_metrics_text(request: web.Request):
        """Federated metrics plane: ONE rank-labeled Prometheus
        exposition covering every live rank. Off-loop: a clustered
        engine fans out to peers inside cluster_metrics; single-node
        engines degrade to their own registry under rank=\"0\".

        Content negotiation: a scraper that Accepts openmetrics-text
        gets the exemplar-bearing payload (trace-id exemplars on the
        SLO histogram buckets) terminated with the mandatory ``# EOF``;
        everyone else gets strict text-format 0.0.4 — the 0.0.4 parser
        rejects exemplar suffixes, and a failed parse takes EVERY
        rank's metrics down with it."""
        from sitewhere_tpu_torch.utils.metrics import (federated_exposition,
                                                 strip_exemplars)

        text = await asyncio.to_thread(federated_exposition, inst.engine)
        accept = request.headers.get("Accept", "")
        if "application/openmetrics-text" in accept:
            return web.Response(
                text=text + "# EOF\n",
                content_type="application/openmetrics-text")
        return web.Response(text=strip_exemplars(text),
                            content_type="text/plain")

    r.add_get("/api/instance/cluster/metrics", cluster_metrics_text)

    # --- flight recorder (batch-lifecycle tracing; PR 3) -----------------
    async def trace_recent(request: web.Request):
        recent = getattr(inst.engine, "recent_traces", None)
        if recent is None:
            return json_response({"error": "no flight recorder"},
                                 status=404)
        try:
            limit = max(1, min(int(request.query.get("limit", 50)), 1000))
        except ValueError:
            return json_response({"error": "bad limit"}, status=400)
        return json_response(await asyncio.to_thread(recent, limit))

    async def trace_get(request: web.Request):
        get = getattr(inst.engine, "get_trace", None)
        if get is None:
            return json_response({"error": "no flight recorder"},
                                 status=404)
        # clustered engines fan out to peers inside get_trace — off-loop,
        # like every other peer-touching scrape
        res = await asyncio.to_thread(get, request.match_info["traceId"])
        if not res.get("records"):
            return json_response({"error": "trace not found"}, status=404)
        return json_response(res)

    # --- span plane: Perfetto timelines, thread profiler,
    # debug bundle --------------------------------------------------------
    async def trace_timeline(request: web.Request):
        """One trace id -> a Chrome-trace-event document (loads directly
        in Perfetto / chrome://tracing). Clustered engines stitch every
        rank's events into one multi-rank timeline; off-loop like every
        peer-touching surface."""
        fn = getattr(inst.engine, "get_trace_timeline", None)
        if fn is None:
            return json_response({"error": "no span tracer"}, status=404)
        res = await asyncio.to_thread(fn, request.match_info["traceId"])
        if not any(e.get("ph") == "X" for e in res.get("traceEvents", ())):
            return json_response({"error": "trace not found"}, status=404)
        return json_response(res)

    async def profile(request: web.Request):
        """Wall-clock sampling profiler over the live engine threads
        (WAL commit thread, replica senders, forward retry pump, decode
        workers, RPC executors). Default output: folded stacks, one
        ``thread;frame;...;leaf count`` line each — pipe straight into
        flamegraph.pl; ``format=json`` returns the structured form."""
        from sitewhere_tpu_torch.utils.tracing import profile_threads

        try:
            seconds = float(request.query.get("seconds", 1.0))
            interval = float(request.query.get("intervalS", 0.01))
        except ValueError:
            return json_response({"error": "bad seconds/intervalS"},
                                 status=400)
        seconds = max(0.05, min(seconds, 30.0))
        interval = max(0.001, min(interval, 1.0))
        prof = await asyncio.to_thread(profile_threads, seconds, interval)
        if request.query.get("format") == "json":
            return json_response(prof)
        return web.Response(text=prof["folded"] + "\n",
                            content_type="text/plain")

    async def device_memory(request: web.Request):
        """Device-plane memory ledger: byte breakdown of the
        ring store / state tables / staging arenas / segment cache,
        live-array totals, backend memory_stats where available, the
        capacity high-watermarks (peek — only the Prometheus scrape
        resets them) and per-family compile posture."""
        from sitewhere_tpu_torch.utils.devicewatch import device_memory_payload

        return json_response(
            await asyncio.to_thread(device_memory_payload, inst.engine))

    async def device_profile(request: web.Request):
        """Capture a ``torch.profiler`` device trace for ``?ms=N``
        milliseconds into a named directory and return its location —
        the hardware-timeline sibling of the Perfetto export (on the GPU
        the trace carries the card's kernel timeline)."""
        from sitewhere_tpu_torch.utils.devicewatch import capture_device_profile

        try:
            ms = float(request.query.get("ms", 500))
        except ValueError:
            return json_response({"error": "bad ms"}, status=400)
        try:
            res = await asyncio.to_thread(capture_device_profile, ms)
        except Exception as e:   # profiler unavailable on this backend
            return json_response({"error": repr(e)}, status=503)
        return json_response(res)

    async def conservation_doc(request: web.Request):
        """Conservation audit plane: the full per-stage flow
        ledger, monotone watermarks, derived lag, and the conservation-
        equation verdict. A clustered engine fans out to every rank
        (``ClusterEngine.conservation``); off-loop like every
        peer-touching (and device-reading) scrape surface."""
        from sitewhere_tpu_torch.utils.conservation import conservation_payload

        fn = getattr(inst.engine, "conservation", None)
        if callable(fn):
            return json_response(await asyncio.to_thread(fn))
        return json_response(await asyncio.to_thread(
            conservation_payload, inst.engine, inst.rules))

    r.add_get("/api/instance/conservation", conservation_doc)

    async def spmd_heat_doc(request: web.Request):
        """Shard heat & skew plane: per-shard flow counters,
        the (shard, tenant) heat map, top-K hot slots, and the skew
        posture. A clustered engine fans out to every rank
        (``ClusterEngine.spmd_heat``); a non-SPMD engine answers
        ``{"spmd": false}``. Off-loop — the harvest reads the device
        counter grid."""
        from sitewhere_tpu_torch.utils.shardobs import spmd_heat_payload

        fn = getattr(inst.engine, "spmd_heat", None)
        if callable(fn):
            return json_response(await asyncio.to_thread(fn))
        return json_response(await asyncio.to_thread(
            spmd_heat_payload, inst.engine))

    r.add_get("/api/instance/spmd/heat", spmd_heat_doc)

    async def wire_doc(request: web.Request):
        """Persistent-connection wire-edge posture: aggregate
        frame dispositions, batcher flush counters, connection census.
        Admission for socket frames happens at the edge via the SAME
        ``admit_or_raise`` path REST ingest uses (PR-9 rule: QoS at
        edges, never inside the engine), so this doc and the REST shed
        counters describe one admission plane. ``{"wire": false}`` when
        no edge is attached. Off-loop — the snapshot sums per-batcher
        counters under their locks."""
        from sitewhere_tpu_torch.ingest.wire_edge import aggregate_wire_snapshot

        snap = await asyncio.to_thread(aggregate_wire_snapshot, inst.engine)
        if snap is None:
            return json_response({"wire": False})
        return json_response({"wire": True, **snap})

    r.add_get("/api/instance/wire", wire_doc)

    async def placement_doc(request: web.Request):
        """Elastic-placement posture: the installed map
        (epoch, slot assignment, active ranks), this rank's fences and
        in-flight handoffs, and the guard counters. 404s on a
        non-clustered engine — placement is a cluster concept."""
        pm = getattr(inst.engine, "placement", None)
        if pm is None:
            raise web.HTTPNotFound(text="engine is not clustered")
        return json_response(await asyncio.to_thread(pm.payload))

    async def placement_move(request: web.Request):
        """Operator move: ``{"slots": [..], "target": rank}`` runs the
        full epoch-fenced handoff (catch-up, fence, verify, commit)
        and returns its per-move stats. ``{"drain": rank}`` hands off
        EVERY slot the rank owns; ``{"join": rank}`` moves a
        provisioned-but-inactive rank an even share. Off-loop: a
        handoff replays WAL history."""
        pm = getattr(inst.engine, "placement", None)
        if pm is None:
            raise web.HTTPNotFound(text="engine is not clustered")
        from sitewhere_tpu_torch.parallel.placement import (drain_rank,
                                                            join_rank,
                                                            move_slots)

        body = await request.json()
        if "drain" in body:
            return json_response(await asyncio.to_thread(
                drain_rank, inst.engine, int(body["drain"])))
        if "join" in body:
            return json_response(await asyncio.to_thread(
                join_rank, inst.engine, int(body["join"]),
                body.get("share")))
        return json_response(await asyncio.to_thread(
            move_slots, inst.engine, list(body["slots"]),
            int(body["target"])))

    r.add_get("/api/instance/placement", placement_doc)
    r.add_post("/api/instance/placement/move", placement_move)

    async def debug_bundle_doc(request: web.Request):
        """One self-contained JSON snapshot for offline triage: config,
        metrics (dict + strict-0.0.4 exposition), recent flights, the
        slowest traces with timelines, recent spans, and WAL/archive/
        replication/forward/QoS posture. Feed it to
        scripts/trace2perfetto.py for a standalone Perfetto file."""
        from sitewhere_tpu_torch.utils.tracing import debug_bundle

        return json_response(
            await asyncio.to_thread(debug_bundle, inst.engine))

    # register /profile/device BEFORE /profile would not matter (exact
    # paths), but keep the device-plane family together
    r.add_get("/api/instance/profile/device", device_profile)
    r.add_get("/api/instance/profile", profile)
    r.add_get("/api/instance/device/memory", device_memory)
    r.add_get("/api/instance/debug/bundle", debug_bundle_doc)

    # register /recent BEFORE the {traceId} pattern: "recent" must not
    # parse as a trace id
    r.add_get("/api/instance/trace/recent", trace_recent)
    r.add_get("/api/instance/trace/{traceId}/timeline", trace_timeline)
    r.add_get("/api/instance/trace/{traceId}", trace_get)

    # --- script management (reference: Instance.java scripting @Path
    # family — script CRUD, versions, content, clone, activate) -----------
    # ADMIN-ONLY: scripts execute as in-process Python and config pushes
    # rebuild live component graphs — instance-management powers, gated
    # like the user/tenant admin endpoints below
    def _admin(handler):
        async def wrapped(request: web.Request):
            if AUTH_ADMIN not in request.get("authorities", []):
                return json_response({"error": "admin required"}, status=403)
            return await handler(request)

        return wrapped

    # archive maintenance (reference: Influx shard compaction / retention
    # administration): merge small segments, reclaim
    # retired-topology space
    async def compact_archive(request: web.Request):
        arch = getattr(inst.engine, "archive", None)
        if arch is None:
            return json_response({"error": "no archive configured"},
                                 status=404)
        body = (await request.json()
                if request.content_length else {})
        if not isinstance(body, dict):
            return json_response({"error": "JSON object body required"},
                                 status=400)

        def run():
            # long file I/O under the engine lock — keep it OFF the
            # gateway loop (matches the to_thread treatment of
            # presence_sweep/search) so REST stays responsive meanwhile
            with inst.engine.lock:
                return arch.compact(target_rows=body.get("targetRows"))

        return json_response(await asyncio.to_thread(run))

    async def purge_retired_archive(request: web.Request):
        arch = getattr(inst.engine, "archive", None)
        if arch is None:
            return json_response({"error": "no archive configured"},
                                 status=404)
        def run():
            with inst.engine.lock:
                return arch.purge_retired()

        return json_response({"freedBytes": await asyncio.to_thread(run)})

    r.add_post("/api/instance/archive/compact", _admin(compact_archive))
    r.add_post("/api/instance/archive/purge-retired",
               _admin(purge_retired_archive))

    def _sm_args(req: web.Request) -> tuple[str, str]:
        return req.match_info["identifier"], req.match_info["tenant"]

    _scr_base = "/api/microservices/{identifier}/tenants/{tenant}/scripting"

    async def list_tenant_scripts(request: web.Request):
        return json_response(inst.scripts.list_scripts(*_sm_args(request)))

    async def list_scripts_by_category(request: web.Request):
        by_cat = inst.scripts.list_by_category(*_sm_args(request))
        return json_response([
            {"id": cat, "scripts": scripts}
            for cat, scripts in sorted(by_cat.items())
        ])

    async def list_scripts_for_category(request: web.Request):
        by_cat = inst.scripts.list_by_category(*_sm_args(request))
        return json_response(by_cat.get(request.match_info["category"], []))

    async def get_tenant_script(request: web.Request):
        try:
            return json_response(inst.scripts.get_script(
                *_sm_args(request), request.match_info["scriptId"]))
        except KeyError as e:
            raise EntityNotFound(str(e)) from None

    async def create_tenant_script(request: web.Request):
        body = await request.json()
        try:
            meta = inst.scripts.create_script(
                *_sm_args(request),
                script_id=body["id"], name=body.get("name"),
                description=body.get("description", ""),
                category=body.get("category", "uncategorized"),
                content=body.get("content", ""),
                activate=body.get("activate", True))
        except ValueError as e:
            return json_response({"error": str(e)}, status=409)
        return json_response(meta, status=201)

    async def get_script_content(request: web.Request):
        try:
            text = inst.scripts.get_content(
                *_sm_args(request), request.match_info["scriptId"],
                request.match_info["versionId"])
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return web.Response(text=text, content_type="text/plain")

    async def update_tenant_script(request: web.Request):
        body = await request.json()
        try:
            meta = inst.scripts.update_script(
                *_sm_args(request), request.match_info["scriptId"],
                request.match_info["versionId"],
                content=body.get("content"), name=body.get("name"),
                description=body.get("description"),
                category=body.get("category"))
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(meta)

    async def clone_tenant_script(request: web.Request):
        body = await request.json() if request.can_read_body else {}
        try:
            meta = inst.scripts.clone_version(
                *_sm_args(request), request.match_info["scriptId"],
                request.match_info["versionId"],
                comment=body.get("comment", ""))
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(meta, status=201)

    async def activate_tenant_script(request: web.Request):
        try:
            meta = inst.scripts.activate(
                *_sm_args(request), request.match_info["scriptId"],
                request.match_info["versionId"])
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(meta)

    async def delete_tenant_script(request: web.Request):
        if not inst.scripts.delete_script(
                *_sm_args(request), request.match_info["scriptId"]):
            raise EntityNotFound(request.match_info["scriptId"])
        return json_response({"deleted": True})

    r.add_get(f"{_scr_base}/scripts", _admin(list_tenant_scripts))
    r.add_get(f"{_scr_base}/categories", _admin(list_scripts_by_category))
    r.add_get(f"{_scr_base}/categories/{{category}}",
              _admin(list_scripts_for_category))
    r.add_get(f"{_scr_base}/scripts/{{scriptId}}", _admin(get_tenant_script))
    r.add_post(f"{_scr_base}/scripts", _admin(create_tenant_script))
    r.add_get(f"{_scr_base}/scripts/{{scriptId}}/versions/{{versionId}}"
              "/content", _admin(get_script_content))
    r.add_post(f"{_scr_base}/scripts/{{scriptId}}/versions/{{versionId}}",
               _admin(update_tenant_script))
    r.add_post(f"{_scr_base}/scripts/{{scriptId}}/versions/{{versionId}}"
               "/clone", _admin(clone_tenant_script))
    r.add_post(f"{_scr_base}/scripts/{{scriptId}}/versions/{{versionId}}"
               "/activate", _admin(activate_tenant_script))
    r.add_delete(f"{_scr_base}/scripts/{{scriptId}}", _admin(delete_tenant_script))

    # microservice-level script templates (Instance.java
    # /microservices/{id}/scripting/templates; served from the shipped
    # script-templates/ directory, the dockerimage/script-templates analog)
    import pathlib as _pathlib

    _tpl_root = _pathlib.Path(__file__).resolve().parents[2] / "script-templates"

    async def list_script_template_categories(request: web.Request):
        tpls = (sorted(p.stem for p in _tpl_root.glob("*.py"))
                if _tpl_root.exists() else [])
        return json_response([{
            "id": "templates", "name": "Script templates",
            "templates": tpls,
        }])

    async def get_script_template(request: web.Request):
        p = _tpl_root / (request.match_info["templateId"] + ".py")
        if not _tpl_root.exists() or not p.resolve().is_file() \
                or p.resolve().parent != _tpl_root:
            raise EntityNotFound(request.match_info["templateId"])
        return web.Response(text=p.read_text(), content_type="text/plain")

    r.add_get("/api/microservices/{identifier}/scripting/categories",
              _admin(list_script_template_categories))
    r.add_get("/api/microservices/{identifier}/scripting/templates"
              "/{templateId}", _admin(get_script_template))

    # --- tenant configuration get + LIVE hot-reload (reference: ZooKeeper
    # config watch rebuilds tenant component graphs without restart,
    # README "Centralized Configuration Management") -----------------------
    async def get_tenant_configuration(request: web.Request):
        entry = inst.tenant_configs.get(request.match_info["tenant"])
        if entry is None:
            raise EntityNotFound(request.match_info["tenant"])
        return json_response({"configuration": entry["config"],
                              "summary": entry["summary"]})

    async def update_tenant_configuration(request: web.Request):
        from sitewhere_tpu_torch.config import ConfigError, reload_tenant_config

        body = await request.json()
        cfg = body.get("configuration", body)
        try:
            summary = await reload_tenant_config(
                inst, cfg, tenant=request.match_info["tenant"])
        except ConfigError as e:
            return json_response({"error": str(e)}, status=400)
        return json_response({"summary": summary})

    r.add_get("/api/microservices/{identifier}/tenants/{tenant}"
              "/configuration", _admin(get_tenant_configuration))
    r.add_post("/api/microservices/{identifier}/tenants/{tenant}"
               "/configuration", _admin(update_tenant_configuration))

    # --- streaming rules & continuous rollups (the Siddhi-app surface) -----
    async def get_rules(request: web.Request):
        rs = inst.rules.ruleset
        return json_response({
            "ruleSet": rs.doc if rs is not None else None,
            "status": await asyncio.to_thread(inst.rules.status)})

    async def put_rules(request: web.Request):
        from sitewhere_tpu_torch.rules import RuleSetError

        body = await request.json()
        doc = body.get("ruleSet", body)
        try:
            # validate+lower+AOT-compile off the gateway loop; a bad
            # document 400s with the active set untouched
            summary = await asyncio.to_thread(inst.rules.load, doc)
        except RuleSetError as e:
            return json_response({"error": str(e)}, status=400)
        return json_response({"summary": summary}, status=201)

    async def delete_rules(request: web.Request):
        await asyncio.to_thread(inst.rules.clear)
        return json_response({"cleared": True})

    async def poll_rules(request: web.Request):
        body = (await request.json()) if request.content_length else {}
        alerts = await asyncio.to_thread(
            inst.rules.poll, bool(body.get("flush", True)))
        return json_response({"alerts": alerts})

    async def list_rollups(request: web.Request):
        return json_response(
            [dataclasses.asdict(m) for m in inst.rules.rollup_meta])

    async def read_rollup(request: web.Request):
        try:
            doc = await asyncio.to_thread(
                inst.rules.read_rollup, request.match_info["name"],
                request.query.get("group"),
                _page_size(request.query))
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(doc)

    async def read_rollup_history(request: web.Request):
        q = request.query
        try:
            since = int(q["sinceMs"]) if "sinceMs" in q else None
            until = int(q["untilMs"]) if "untilMs" in q else None
        except ValueError:
            return json_response({"error": "bad sinceMs/untilMs"},
                                 status=400)
        try:
            doc = await asyncio.to_thread(
                inst.rules.read_rollup_history,
                request.match_info["name"], q.get("group"),
                since, until, _page_size(q))
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(doc)

    async def spill_rollups(request: web.Request):
        return json_response(
            await asyncio.to_thread(inst.rules.spill_rollups))

    r.add_get("/api/rules", get_rules)
    r.add_post("/api/rules", _admin(put_rules))
    r.add_delete("/api/rules", _admin(delete_rules))
    r.add_post("/api/rules/poll", _admin(poll_rules))
    r.add_get("/api/rules/rollups", list_rollups)
    r.add_post("/api/rules/rollups/spill", _admin(spill_rollups))
    r.add_get("/api/rules/rollups/{name}", read_rollup)
    r.add_get("/api/rules/rollups/{name}/history", read_rollup_history)

    # --- fleet-scale historical analytics: archive->device
    # batched scoring jobs ------------------------------------------------
    _SPEC_KEYS = {
        "tenant": "tenant", "sinceMs": "since_ms", "untilMs": "until_ms",
        "batchDevices": "batch_devices", "window": "window",
        "minFill": "min_fill", "threshold": "threshold", "emit": "emit",
        "roundCostBytes": "round_cost_bytes", "maxRounds": "max_rounds",
        "maxBatches": "max_batches", "duty": "duty", "name": "name",
    }

    async def start_score_job(request: web.Request):
        body = (await request.json()
                if request.content_length else {})
        if not isinstance(body, dict):
            return json_response({"error": "JSON object body required"},
                                 status=400)
        unknown = set(body) - set(_SPEC_KEYS)
        if unknown:
            return json_response(
                {"error": f"unknown fields: {sorted(unknown)}"},
                status=400)
        spec = {snake: body[camel]
                for camel, snake in _SPEC_KEYS.items() if camel in body}
        wait = request.query.get("wait") in ("1", "true")
        fn = (inst.analytics_jobs.run_job if wait
              else inst.analytics_jobs.start_job)
        try:
            return json_response(
                await asyncio.to_thread(fn, spec), status=202)
        except TypeError as e:
            return json_response({"error": str(e)}, status=400)

    async def list_score_jobs(request: web.Request):
        return json_response(
            await asyncio.to_thread(inst.analytics_jobs.status))

    async def get_score_job(request: web.Request):
        try:
            doc = await asyncio.to_thread(
                inst.analytics_jobs.status, request.match_info["jobId"])
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(doc)

    async def cancel_score_job(request: web.Request):
        ok = await asyncio.to_thread(
            inst.analytics_jobs.cancel, request.match_info["jobId"])
        return json_response({"cancelled": bool(ok)},
                             status=200 if ok else 409)

    r.add_post("/api/analytics/score", _admin(start_score_job))
    r.add_get("/api/analytics/jobs", list_score_jobs)
    r.add_get("/api/analytics/jobs/{jobId}", get_score_job)
    r.add_post("/api/analytics/jobs/{jobId}/cancel",
               _admin(cancel_score_job))

    # --- devices ----------------------------------------------------------
    async def create_device(request: web.Request):
        body = await request.json()
        summary = inst.device_management.create_device(
            body["token"], body.get("deviceTypeToken", "default"),
            tenant=body.get("tenant", request.get("tenant", "default")),
            area=body.get("areaToken"), customer=body.get("customerToken"),
            metadata=body.get("metadata"),
        )
        return json_response(dataclasses.asdict(summary), status=201)

    async def list_devices(request: web.Request):
        q = request.query
        res = inst.device_management.list_devices(
            page=int(q.get("page", 1)), page_size=_page_size(q),
            device_type=q.get("deviceType"), tenant=q.get("tenant"),
        )
        return json_response({
            "numResults": res.total, "page": res.page, "pageSize": res.page_size,
            "results": [dataclasses.asdict(s) for s in res.results],
        })

    async def get_device(request: web.Request):
        summary = inst.device_management.get_device_summary(
            request.match_info["token"])
        return json_response(dataclasses.asdict(summary))

    async def delete_device(request: web.Request):
        ok = inst.device_management.delete_device(request.match_info["token"])
        if not ok:
            raise EntityNotFound(request.match_info["token"])
        return json_response({"deleted": True})

    r.add_post("/api/devices", create_device)
    r.add_get("/api/devices", list_devices)
    # literal /summaries must precede the dynamic /{token} route; compute
    # only pageSize summaries, not one per registered device
    import itertools as _it

    r.add_get("/api/devices/summaries", _sync(lambda req: json_response(
        [dataclasses.asdict(
            inst.device_management.get_device_summary(i.token))
         for i in _it.islice(inst.engine.devices.values(),
                             _page_size(req.query))])))
    r.add_get("/api/devices/{token}", get_device)
    r.add_delete("/api/devices/{token}", delete_device)

    # --- device events (ingest via REST + query) -------------------------
    async def post_device_event(request: web.Request):
        from sitewhere_tpu_torch.utils.qos import admit_or_raise

        body = await request.json()
        body.setdefault("deviceToken", request.match_info["token"])
        req = request_from_envelope(body)
        req.tenant = request.get("tenant", req.tenant)
        # ingest edge: per-tenant admission. A shed raises
        # ShedError, which the error middleware answers as 429 +
        # Retry-After — explicit backpressure, never a silent drop.
        # On a cluster facade admission is per OWNER: this edge admits
        # only locally-owned devices (a remote owner's handler sheds
        # with a code=429 RpcError the middleware translates the same
        # way) — charging the edge rank's bucket for remote-owned
        # traffic would double-charge the tenant and cap cluster-wide
        # throughput at one rank's rate. Admission stays at the edge,
        # never inside process(): internal emitters (zone/anomaly
        # alerts, scheduler fires) must not shed derived events.
        eng = inst.engine
        if not hasattr(eng, "cluster_config"):
            admit_or_raise(eng, req.tenant, 1)
        elif eng.owner(req.device_token) == eng.rank:
            admit_or_raise(eng.local, req.tenant, 1)
        inst.engine.process(req)
        inst.engine.flush()
        return json_response({"accepted": True}, status=201)

    # event queries run OFF the gateway loop (asyncio.to_thread): the
    # engine's shared-scan batcher coalesces whatever queries overlap in
    # flight into one device program, which only helps if concurrent REST
    # reads actually reach it concurrently
    async def get_device_events(request: web.Request):
        q = request.query
        et = EventType[q["type"].upper()] if "type" in q else None
        res = await asyncio.to_thread(
            inst.engine.query_events,
            device_token=request.match_info.get("token"),
            etype=et,
            since_ms=int(q["sinceMs"]) if "sinceMs" in q else None,
            until_ms=int(q["untilMs"]) if "untilMs" in q else None,
            limit=_page_size(q),
        )
        return json_response(res)

    async def query_all_events(request: web.Request):
        q = request.query
        et = EventType[q["type"].upper()] if "type" in q else None
        res = await asyncio.to_thread(
            inst.engine.query_events,
            device_token=q.get("deviceToken"), etype=et,
            tenant=request.get("tenant"),
            since_ms=int(q["sinceMs"]) if "sinceMs" in q else None,
            until_ms=int(q["untilMs"]) if "untilMs" in q else None,
            limit=_page_size(q),
        )
        return json_response(res)

    r.add_post("/api/devices/{token}/events", post_device_event)
    r.add_get("/api/devices/{token}/events", get_device_events)
    r.add_get("/api/events", query_all_events)

    # --- device state -----------------------------------------------------
    async def get_device_state(request: web.Request):
        state = inst.engine.get_device_state(request.match_info["token"])
        if state is None:
            raise EntityNotFound(request.match_info["token"])
        return json_response(state)

    async def presence_sweep(request: web.Request):
        # off the loop: on a ClusterEngine this fans out over peer RPC
        # and must not stall the gateway
        missing = await asyncio.to_thread(inst.engine.presence_sweep)
        return json_response({"newlyMissing": missing})

    r.add_get("/api/devices/{token}/state", get_device_state)
    r.add_post("/api/devicestates/presence/sweep", presence_sweep)

    # --- device types / statuses / alarms --------------------------------
    async def create_device_type(request: web.Request):
        body = await request.json()
        dt = inst.device_management.create_device_type(
            body["token"], body["name"], description=body.get("description", ""),
            container_policy=body.get("containerPolicy", "Standalone"),
        )
        return json_response(_entity(dt), status=201)

    r.add_post("/api/devicetypes", create_device_type)
    r.add_get("/api/devicetypes", _sync(lambda req: json_response(
        _paged(inst.device_management.device_types.list()))))
    r.add_get("/api/devicetypes/{token}", _sync(lambda req: json_response(
        _entity(inst.device_management.device_types.get(req.match_info["token"])))))

    async def create_status(request: web.Request):
        body = await request.json()
        st = inst.device_management.create_device_status(
            body["token"], request.match_info["token"], body["code"], body["name"],
        )
        return json_response(_entity(st), status=201)

    r.add_post("/api/devicetypes/{token}/statuses", create_status)
    r.add_get("/api/devicetypes/{token}/statuses", _sync(lambda req: json_response(
        [_entity(s) for s in
         inst.device_management.statuses_for_type(req.match_info["token"])])))

    async def create_command(request: web.Request):
        body = await request.json()
        cmd = command_from_json(
            body["token"], request.match_info["token"], body["name"],
            namespace=body.get("namespace", "http://sitewhere/tpu"),
            description=body.get("description", ""),
            parameters=body.get("parameters"),
        )
        inst.command_registry.create(cmd)
        return json_response(dataclasses.asdict(cmd), status=201)

    r.add_post("/api/devicetypes/{token}/commands", create_command)
    r.add_get("/api/devicetypes/{token}/commands", _sync(lambda req: json_response(
        [dataclasses.asdict(c) for c in
         inst.command_registry.list_for_type(req.match_info["token"])])))

    async def create_alarm(request: web.Request):
        body = await request.json()
        alarm = inst.device_management.create_alarm(
            body["token"], request.match_info["token"], body["message"],
        )
        return json_response(_entity(alarm, state=alarm.state.value), status=201)

    async def alarm_transition(request: web.Request):
        action = request.match_info["action"]
        token = request.match_info["token"]
        if action == "acknowledge":
            alarm = inst.device_management.acknowledge_alarm(token)
        elif action == "resolve":
            alarm = inst.device_management.resolve_alarm(token)
        else:
            raise ValueError(f"unknown alarm action {action!r}")
        return json_response(_entity(alarm, state=alarm.state.value))

    r.add_post("/api/devices/{token}/alarms", create_alarm)
    r.add_get("/api/devices/{token}/alarms", _sync(lambda req: json_response(
        [_entity(a, state=a.state.value) for a in
         inst.device_management.alarms_for_device(req.match_info["token"])])))
    r.add_post("/api/alarms/{token}/{action}", alarm_transition)

    # --- command invocation ----------------------------------------------
    async def invoke_command(request: web.Request):
        body = await request.json()
        inv = inst.commands.invoke(
            request.match_info["token"], body["commandToken"],
            body.get("parameterValues", {}),
            tenant=request.get("tenant", "default"),
            initiator="REST", initiator_id=request.get("user", ""),
        )
        await inst.commands.pump()
        return json_response({
            "invocationId": inv.invocation_id,
            "commandToken": inv.command_token,
            "deviceToken": inv.device_token,
        }, status=201)

    r.add_post("/api/devices/{token}/invocations", invoke_command)
    r.add_get("/api/commands/undelivered", _sync(lambda req: json_response(
        [{"invocationId": u.invocation.invocation_id,
          "destination": u.destination_id, "error": u.error}
         for u in inst.commands.undelivered])))

    async def retry_undelivered(request: web.Request):
        return json_response(await inst.commands.retry_undelivered())

    r.add_post("/api/commands/undelivered/retry", retry_undelivered)

    async def get_invocation(request: web.Request):
        inv = inst.commands.get_invocation(int(request.match_info["id"]))
        if inv is None:
            raise EntityNotFound("invocation")
        return json_response({
            "invocationId": inv.invocation_id, "commandToken": inv.command_token,
            "deviceToken": inv.device_token, "tenant": inv.tenant,
            "parameterValues": inv.parameter_values, "initiator": inv.initiator,
            "initiatorId": inv.initiator_id, "eventDateMs": inv.ts_ms,
        })

    r.add_get("/api/invocations/{id}", get_invocation)
    r.add_get("/api/invocations/{id}/responses", _sync(lambda req: json_response(
        inst.commands.responses_for(int(req.match_info["id"])))))

    # --- assignments ------------------------------------------------------
    def _assignment_json(a) -> dict:
        return {
            "token": a.token, "id": a.id, "deviceToken": a.device_token,
            "tenant": a.tenant, "status": a.status, "assetToken": a.asset,
            "areaToken": a.area, "customerToken": a.customer,
            "metadata": a.metadata, "createdDateMs": a.created_ms,
            "releasedDateMs": a.released_ms,
        }

    async def create_assignment(request: web.Request):
        body = await request.json()
        if inst.engine.get_device(body["deviceToken"]) is None:
            raise EntityNotFound(f"device {body['deviceToken']!r} not found")
        a = inst.engine.create_assignment(
            body["deviceToken"], token=body.get("token"),
            asset=body.get("assetToken"), area=body.get("areaToken"),
            customer=body.get("customerToken"), metadata=body.get("metadata"),
        )
        return json_response(_assignment_json(a), status=201)

    async def get_assignment(request: web.Request):
        a = inst.engine.get_assignment(request.match_info["token"])
        if a is None:
            raise EntityNotFound("assignment")
        return json_response(_assignment_json(a))

    async def assignment_transition(request: web.Request):
        token = request.match_info["token"]
        action = request.match_info["action"]
        if inst.engine.get_assignment(token) is None:
            raise EntityNotFound("assignment")
        if action == "end":
            a = inst.engine.release_assignment(token)
        elif action == "missing":
            a = inst.engine.mark_assignment_missing(token)
        else:
            raise ValueError(f"unknown assignment action {action!r}")
        return json_response(_assignment_json(a))

    async def assignment_events(request: web.Request):
        a = inst.engine.get_assignment(request.match_info["token"])
        if a is None:
            raise EntityNotFound("assignment")
        q = request.query
        et = EventType[q["type"].upper()] if "type" in q else None
        res = await asyncio.to_thread(
            inst.engine.query_events,
            device_token=a.device_token, etype=et, assignment_id=a.id,
            limit=_page_size(q),
        )
        return json_response(res)

    async def update_assignment(request: web.Request):
        """Update assignment associations/metadata (reference:
        Assignments.java:144 PUT /assignments/{token})."""
        body = await request.json()
        try:
            a = inst.engine.update_assignment(
                request.match_info["token"],
                asset=body.get("assetToken"), area=body.get("areaToken"),
                customer=body.get("customerToken"),
                metadata=body.get("metadata"),
            )
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response(_assignment_json(a))

    async def delete_assignment(request: web.Request):
        """Delete an assignment (reference: Assignments.java:262 DELETE)."""
        if not inst.engine.delete_assignment(request.match_info["token"]):
            raise EntityNotFound("assignment")
        return json_response({"deleted": True})

    r.add_post("/api/assignments", create_assignment)
    r.add_get("/api/assignments", _sync(lambda req: json_response(
        [_assignment_json(a) for a in inst.engine.list_assignments(
            device_token=req.query.get("deviceToken"),
            status=req.query.get("status"),
            area=req.query.get("areaToken"),
            asset=req.query.get("assetToken"),
            customer=req.query.get("customerToken"))])))
    r.add_get("/api/assignments/{token}", get_assignment)
    r.add_put("/api/assignments/{token}", update_assignment)
    r.add_delete("/api/assignments/{token}", delete_assignment)
    r.add_post("/api/assignments/{token}/{action}", assignment_transition)
    r.add_get("/api/assignments/{token}/events", assignment_events)
    r.add_get("/api/devices/{token}/assignments", _sync(lambda req: json_response(
        [_assignment_json(a) for a in inst.engine.list_assignments(
            device_token=req.match_info["token"])])))

    # --- areas / customers / zones / groups -------------------------------
    async def create_area_type(request: web.Request):
        body = await request.json()
        at = inst.device_management.create_area_type(
            body["token"], body["name"],
            contained_area_types=body.get("containedAreaTypes", []),
        )
        return json_response(_entity(at), status=201)

    async def create_area(request: web.Request):
        body = await request.json()
        area = inst.device_management.create_area(
            body["token"], body["areaTypeToken"], body["name"],
            parent_token=body.get("parentToken"),
            description=body.get("description", ""),
        )
        return json_response(_entity(area), status=201)

    def _tree_json(nodes):
        return [
            {"entity": _entity(n.entity), "children": _tree_json(n.children)}
            for n in nodes
        ]

    r.add_post("/api/areatypes", create_area_type)
    r.add_get("/api/areatypes", _sync(lambda req: json_response(
        _paged(inst.device_management.area_types.list()))))
    r.add_post("/api/areas", create_area)
    r.add_get("/api/areas", _sync(lambda req: json_response(
        _paged(inst.device_management.areas.list()))))
    r.add_get("/api/areas/tree", _sync(lambda req: json_response(
        _tree_json(inst.device_management.area_tree()))))
    r.add_get("/api/areas/{token}", _sync(lambda req: json_response(
        _entity(inst.device_management.areas.get(req.match_info["token"])))))

    async def create_zone(request: web.Request):
        body = await request.json()
        zone = inst.device_management.create_zone(
            body["token"], body["areaToken"], body["name"],
            bounds=[(p["latitude"], p["longitude"]) for p in body["bounds"]],
        )
        return json_response(_entity(zone), status=201)

    r.add_post("/api/zones", create_zone)
    r.add_get("/api/zones", _sync(lambda req: json_response(
        _paged(inst.device_management.zones.list()))))
    r.add_get("/api/areas/{token}/zones", _sync(lambda req: json_response(
        [_entity(z) for z in
         inst.device_management.zones_for_area(req.match_info["token"])])))

    async def zone_contains(request: web.Request):
        """On-device point-in-polygon test for one zone."""
        import torch

        from sitewhere_tpu_torch.ops.geofence import pack_zones, points_in_zones

        zone = inst.device_management.zones.get(request.match_info["token"])
        lat = float(request.query["latitude"])
        lon = float(request.query["longitude"])
        verts, valid = pack_zones([list(zone.bounds)])
        dev = inst.engine.device
        inside = points_in_zones(
            torch.tensor([[lat, lon]], dtype=torch.float32, device=dev),
            torch.from_numpy(verts).to(dev), torch.from_numpy(valid).to(dev))
        return json_response({"zone": zone.meta.token,
                              "contains": bool(inside[0, 0].item())})

    r.add_get("/api/zones/{token}/contains", zone_contains)

    async def create_customer_type(request: web.Request):
        body = await request.json()
        ct = inst.device_management.create_customer_type(body["token"], body["name"])
        return json_response(_entity(ct), status=201)

    async def create_customer(request: web.Request):
        body = await request.json()
        c = inst.device_management.create_customer(
            body["token"], body["customerTypeToken"], body["name"],
            parent_token=body.get("parentToken"),
        )
        return json_response(_entity(c), status=201)

    r.add_post("/api/customertypes", create_customer_type)
    r.add_post("/api/customers", create_customer)
    r.add_get("/api/customers", _sync(lambda req: json_response(
        _paged(inst.device_management.customers.list()))))
    r.add_get("/api/customers/tree", _sync(lambda req: json_response(
        _tree_json(inst.device_management.customer_tree()))))

    async def create_group(request: web.Request):
        body = await request.json()
        g = inst.device_management.create_group(
            body["token"], body["name"], roles=body.get("roles", []),
        )
        return json_response(_entity(g), status=201)

    async def add_group_elements(request: web.Request):
        body = await request.json()
        els = inst.device_management.add_group_elements(
            request.match_info["token"], body["elements"],
        )
        return json_response([dataclasses.asdict(e) for e in els], status=201)

    r.add_post("/api/devicegroups", create_group)
    r.add_get("/api/devicegroups", _sync(lambda req: json_response(
        _paged(inst.device_management.groups.list()))))
    r.add_post("/api/devicegroups/{token}/elements", add_group_elements)
    r.add_get("/api/devicegroups/{token}/elements", _sync(lambda req: json_response(
        [dataclasses.asdict(e) for e in
         inst.device_management.group_elements(req.match_info["token"])])))
    r.add_get("/api/devicegroups/{token}/devices", _sync(lambda req: json_response(
        inst.device_management.expand_group_devices(
            req.match_info["token"],
            roles=req.query.getall("role", None)))))

    # --- assets -----------------------------------------------------------
    async def create_asset_type(request: web.Request):
        body = await request.json()
        at = inst.assets.create_asset_type(body["token"], body["name"])
        return json_response(_entity(at), status=201)

    async def create_asset(request: web.Request):
        body = await request.json()
        a = inst.assets.create_asset(body["token"], body["assetTypeToken"],
                                     body["name"])
        return json_response(_entity(a), status=201)

    r.add_post("/api/assettypes", create_asset_type)
    r.add_post("/api/assets", create_asset)
    r.add_get("/api/assets", _sync(lambda req: json_response(
        _paged(inst.assets.list_assets(
            asset_type=req.query.get("assetType"))))))

    # --- batch ------------------------------------------------------------
    async def create_batch(request: web.Request):
        body = await request.json()
        devices = body.get("deviceTokens")
        if not devices and body.get("groupToken"):
            devices = inst.device_management.expand_group_devices(
                body["groupToken"], roles=body.get("roles"))
        op = inst.batch.create_operation(
            body["token"], body.get("operationType", "InvokeCommand"), devices,
            {"commandToken": body["commandToken"],
             "parameterValues": body.get("parameterValues", {})},
        )
        op = await inst.batch.process_operation(op.meta.token)
        return json_response(
            {"token": op.meta.token, "status": op.status, "counts": op.counts()},
            status=201,
        )

    async def list_batch_elements(request: web.Request):
        """Paged element listing for one batch operation (reference:
        BatchOperations.java:139 GET /batch/{operationToken}/elements)."""
        op = inst.batch.operations.get(request.match_info["token"])
        q = request.query
        els = op.elements
        if "status" in q:
            els = [e for e in els if e.status.name == q["status"].upper()]
        page = max(1, int(q.get("page", 1)))
        size = _page_size(q)
        lo = (page - 1) * size
        return json_response({
            "numResults": len(els), "page": page, "pageSize": size,
            "results": [dataclasses.asdict(e) | {"status": e.status.name}
                        for e in els[lo:lo + size]],
        })

    async def _run_batch_for(devices: list[str], body: dict) -> web.Response:
        import uuid

        if not devices:
            raise ValueError("criteria matched no devices")
        token = body.get("token") or f"batch-{uuid.uuid4().hex[:12]}"
        inst.batch.create_operation(
            token, "InvokeCommand", devices,
            {"commandToken": body["commandToken"],
             "parameterValues": body.get("parameterValues", {})},
        )
        op = await inst.batch.process_operation(token)
        return json_response(
            {"token": op.meta.token, "status": op.status,
             "counts": op.counts()}, status=201)

    async def batch_command_by_device_criteria(request: web.Request):
        """Invoke a command on every device matching criteria (reference:
        BatchOperations.java:188 POST /batch/command/criteria/device)."""
        body = await request.json()
        devices = [s.token for s in inst.device_management.list_devices(
            page_size=1_000_000,
            device_type=body.get("deviceTypeToken"),
            tenant=body.get("tenant"),
        ).results]
        return await _run_batch_for(devices, body)

    async def batch_command_by_assignment_criteria(request: web.Request):
        """Invoke a command per assignment matching criteria (reference:
        BatchOperations.java:224 POST /batch/command/criteria/assignment)."""
        body = await request.json()
        assignments = inst.engine.list_assignments(
            status=body.get("status", "ACTIVE"),
            area=body.get("areaToken"), asset=body.get("assetToken"),
            customer=body.get("customerToken"))
        # one element per assignment's device, deduped in arrival order
        devices = list(dict.fromkeys(a.device_token for a in assignments))
        return await _run_batch_for(devices, body)

    r.add_post("/api/batch/command", create_batch)
    r.add_post("/api/batch/command/criteria/device",
               batch_command_by_device_criteria)
    r.add_post("/api/batch/command/criteria/assignment",
               batch_command_by_assignment_criteria)
    r.add_get("/api/batch", _sync(lambda req: json_response(_paged(
        inst.batch.operations.list(
            page=int(req.query.get("page", 1)),
            page_size=_page_size(req.query))))))
    r.add_get("/api/batch/{token}", _sync(lambda req: json_response((lambda op: {
        "token": op.meta.token, "status": op.status,
        "operationType": op.operation_type, "counts": op.counts(),
        "elements": [dataclasses.asdict(e) | {"status": e.status.name}
                     for e in op.elements],
    })(inst.batch.operations.get(req.match_info["token"])))))
    r.add_get("/api/batch/{token}/elements", list_batch_elements)

    # --- schedules --------------------------------------------------------
    async def create_schedule(request: web.Request):
        body = await request.json()
        s = inst.scheduler.create_schedule(
            body["token"], body["name"], body["triggerType"],
            cron=body.get("cron"), interval_s=body.get("intervalS"),
            repeat_count=body.get("repeatCount", -1),
        )
        return json_response(_entity(s), status=201)

    async def create_job(request: web.Request):
        body = await request.json()
        j = inst.scheduler.create_job(
            body["token"], body["scheduleToken"], body["jobType"],
            body.get("configuration", {}),
        )
        return json_response(_entity(j), status=201)

    r.add_post("/api/schedules", create_schedule)
    r.add_get("/api/schedules", _sync(lambda req: json_response(
        _paged(inst.scheduler.schedules.list()))))
    r.add_post("/api/jobs", create_job)
    r.add_get("/api/jobs", _sync(lambda req: json_response(
        _paged(inst.scheduler.jobs.list()))))

    # --- labels -----------------------------------------------------------
    async def get_label(request: web.Request):
        kind = request.match_info["kind"]
        token = request.match_info["token"]
        gen = inst.labels.get(request.query.get("generator", "qrcode"))
        fn = {
            "device": gen.device_label, "asset": gen.asset_label,
            "area": gen.area_label, "customer": gen.customer_label,
            "devicegroup": gen.device_group_label,
        }.get(kind)
        if fn is None:
            raise ValueError(f"unknown label kind {kind!r}")
        return web.Response(body=fn(token), content_type="image/png")

    r.add_get("/api/labels/{kind}/{token}", get_label)

    # --- search -----------------------------------------------------------
    async def search_events(request: web.Request):
        provider = inst.search.get(request.query.get("provider", "embedded"))
        if provider is None:
            raise EntityNotFound("search provider")
        # off-loop: a cluster-backed provider blocks on peer RPC (the
        # index itself is lock-protected for cross-thread search)
        docs = await asyncio.to_thread(
            provider.search, request.query.get("q", "*:*"),
            _page_size(request.query))
        return json_response({"numResults": len(docs), "results": docs})

    r.add_get("/api/search/events", search_events)
    async def list_search_providers(request: web.Request):
        # provider info fans out to peers on a cluster instance — keep
        # the (blocking) peer RPC off the gateway loop
        infos = await asyncio.to_thread(inst.search.list_providers)
        return json_response([dataclasses.asdict(p) for p in infos])

    r.add_get("/api/search/providers", list_search_providers)

    # --- streams ----------------------------------------------------------
    async def create_stream(request: web.Request):
        body = await request.json()
        s = inst.streams.create_stream(
            body["token"], request.match_info["token"],
            content_type=body.get("contentType", "application/octet-stream"),
        )
        return json_response(_entity(s), status=201)

    async def append_stream_chunk(request: web.Request):
        data = await request.read()
        seq = int(request.query.get("sequence", 0))
        inst.streams.append_chunk(request.match_info["stream"], seq, data)
        return json_response({"appended": len(data)}, status=201)

    async def read_stream(request: web.Request):
        stream = inst.streams.streams.get(request.match_info["stream"])
        return web.Response(body=inst.streams.read_all(stream.meta.token),
                            content_type=stream.content_type)

    r.add_post("/api/devices/{token}/streams", create_stream)
    r.add_post("/api/streams/{stream}/chunks", append_stream_chunk)
    r.add_get("/api/streams/{stream}/content", read_stream)

    # --- tenants ----------------------------------------------------------
    async def create_tenant(request: web.Request):
        if AUTH_ADMIN not in request.get("authorities", []):
            return json_response({"error": "admin required"}, status=403)
        body = await request.json()
        t = inst.tenants.create_tenant(
            body["token"], body["name"],
            authorized_users=body.get("authorizedUserIds", []),
            dataset_template=body.get("datasetTemplate", "empty"),
        )
        return json_response(_entity(t), status=201)

    r.add_post("/api/tenants", create_tenant)
    r.add_get("/api/tenants", _sync(lambda req: json_response(
        _paged(inst.tenants.tenants.list()))))

    # templates for creating tenants (reference: Tenants.java
    # /templates/configuration + /templates/dataset, backed there by k8s
    # TenantConfiguration/DatasetTemplate CRDs). Registered BEFORE the
    # /{token} route so "templates" never resolves as a tenant token.
    async def list_tenant_configuration_templates(request: web.Request):
        from sitewhere_tpu_torch.instance.tenants import CONFIG_TEMPLATES

        return json_response(CONFIG_TEMPLATES)

    async def list_tenant_dataset_templates(request: web.Request):
        return json_response([
            {"id": key, "name": key.title(),
             "description": (fn.__doc__ or "").strip().split("\n")[0]}
            for key, fn in inst.tenants.datasets.items()
        ])

    r.add_get("/api/tenants/templates/configuration",
              list_tenant_configuration_templates)
    r.add_get("/api/tenants/templates/dataset",
              list_tenant_dataset_templates)
    r.add_get("/api/tenants/{token}", _sync(lambda req: json_response(
        _entity(inst.tenants.tenants.get(req.match_info["token"])))))

    # --- users ------------------------------------------------------------
    async def create_user(request: web.Request):
        if AUTH_ADMIN not in request.get("authorities", []):
            return json_response({"error": "admin required"}, status=403)
        body = await request.json()
        u = inst.users.create_user(
            body["username"], body["password"], roles=body.get("roles"),
            first_name=body.get("firstName", ""), last_name=body.get("lastName", ""),
            email=body.get("email", ""),
        )
        return json_response(
            {"username": u.username, "roles": u.roles}, status=201)

    def _self_or_admin(request: web.Request) -> bool:
        """User reads are self-or-admin: every read path that exposes a
        user's roles/authorities shares one gate (listing is admin-only)."""
        return (request.match_info.get("username") == request.get("user")
                or AUTH_ADMIN in request.get("authorities", []))

    async def list_users(request: web.Request):
        return json_response(
            [{"username": u.username, "roles": u.roles, "enabled": u.enabled}
             for u in inst.users.users.values()])

    async def get_user_authorities(request: web.Request):
        if not _self_or_admin(request):
            return json_response({"error": "admin required"}, status=403)
        u = inst.users.users.get(request.match_info["username"])
        if u is None:
            raise EntityNotFound("user")
        return json_response(inst.users.authorities_for(u))

    r.add_post("/api/users", create_user)
    r.add_get("/api/users", _admin(list_users))
    r.add_get("/api/users/{username}/authorities", get_user_authorities)

    def _user_json(u) -> dict:
        return {"username": u.username, "roles": u.roles, "enabled": u.enabled,
                "firstName": u.first_name, "lastName": u.last_name,
                "email": u.email}

    async def get_user(request: web.Request):
        if not _self_or_admin(request):
            return json_response({"error": "admin required"}, status=403)
        u = inst.users.users.get(request.match_info["username"])
        if u is None:
            raise EntityNotFound("user")
        return json_response(_user_json(u))

    async def update_user(request: web.Request):
        if AUTH_ADMIN not in request.get("authorities", []):
            return json_response({"error": "admin required"}, status=403)
        body = await request.json()
        u = inst.users.update_user(
            request.match_info["username"], password=body.get("password"),
            roles=body.get("roles"), enabled=body.get("enabled"),
        )
        return json_response(_user_json(u))

    async def delete_user(request: web.Request):
        if AUTH_ADMIN not in request.get("authorities", []):
            return json_response({"error": "admin required"}, status=403)
        if not inst.users.delete_user(request.match_info["username"]):
            raise EntityNotFound("user")
        return json_response({"deleted": True})

    r.add_get("/api/users/{username}", get_user)
    r.add_put("/api/users/{username}", update_user)
    r.add_delete("/api/users/{username}", delete_user)

    # role mutation (reference: Users.java @GET/@PUT/@DELETE
    # /{username}/roles -> add/removeRoles; empty role list is an error)
    async def get_user_roles(request: web.Request):
        if not _self_or_admin(request):
            return json_response({"error": "admin required"}, status=403)
        u = inst.users.users.get(request.match_info["username"])
        if u is None:
            raise EntityNotFound("user")
        return json_response({"numResults": len(u.roles), "results": u.roles})

    async def add_user_roles(request: web.Request):
        roles = await request.json()
        if not isinstance(roles, list) or not roles:
            return json_response({"error": "non-empty role list required"},
                                 status=400)
        try:
            u = inst.users.add_roles(request.match_info["username"], roles)
        except KeyError:
            raise EntityNotFound("user") from None
        return json_response(_user_json(u))

    async def remove_user_roles(request: web.Request):
        roles = await request.json()
        if not isinstance(roles, list) or not roles:
            return json_response({"error": "non-empty role list required"},
                                 status=400)
        try:
            u = inst.users.remove_roles(request.match_info["username"], roles)
        except KeyError:
            raise EntityNotFound("user") from None
        return json_response(_user_json(u))

    r.add_get("/api/users/{username}/roles", get_user_roles)
    r.add_put("/api/users/{username}/roles", _admin(add_user_roles))
    r.add_delete("/api/users/{username}/roles", _admin(remove_user_roles))

    # --- roles / authorities (reference: Roles.java + Authorities.java) ---
    async def create_role(request: web.Request):
        if AUTH_ADMIN not in request.get("authorities", []):
            return json_response({"error": "admin required"}, status=403)
        body = await request.json()
        inst.users.create_role(body["role"], body.get("authorities", []))
        return json_response({"role": body["role"]}, status=201)

    r.add_get("/api/roles", _sync(lambda req: json_response(
        [{"role": name, "authorities": auths}
         for name, auths in inst.users.roles.items()])))
    r.add_post("/api/roles", create_role)
    r.add_get("/api/authorities", _sync(lambda req: json_response(
        sorted({a for auths in inst.users.roles.values() for a in auths}))))

    # --- analytics (service-tpu-analytics surface) ------------------------
    def _analytics():
        if inst.analytics is None:
            raise EntityNotFound(
                "analytics disabled (EngineConfig.analytics_devices == 0)")
        return inst.analytics

    async def analytics_scores(request: web.Request):
        import asyncio

        # JAX compute off the event loop: compilation/scoring must not
        # stall other requests or the outbound pump
        res = await asyncio.to_thread(
            _analytics().score_all, update_stats=False)   # read-only poll
        from sitewhere_tpu_torch.engine import local_device_info

        out = []
        for did in np.nonzero(res["valid"])[0]:
            # analytics tables hold THIS rank's local device ids
            info = local_device_info(inst.engine, int(did))
            if info is None:
                continue
            out.append({"device": info.token,
                        "score": float(res["scores"][did]),
                        "zscore": float(res["zscores"][did])})
        return json_response({"numResults": len(out), "results": out,
                              "anomalousTokens": res["anomalous_tokens"]})

    async def analytics_train(request: web.Request):
        import asyncio
        import math

        body = await request.json() if request.can_read_body else {}
        loss = await asyncio.to_thread(
            _analytics().train_on_live,
            batch_size=int(body.get("batchSize", 256)),
            steps=int(body.get("steps", 1)))
        return json_response(
            {"loss": None if math.isnan(loss) else loss})

    async def analytics_detect(request: web.Request):
        import asyncio

        n = await asyncio.to_thread(_analytics().emit_anomaly_alerts)
        return json_response({"alertsEmitted": n})

    r.add_get("/api/analytics/scores", analytics_scores)
    r.add_post("/api/analytics/train", analytics_train)
    r.add_post("/api/analytics/detect", analytics_detect)

    # --- batch event ingest (wire-level bulk path) ------------------------
    async def post_event_batch(request: web.Request):
        """Accept a JSON array of DeviceRequest envelopes in one call — the
        bulk ingest surface the per-device POST cannot batch. Rows decode
        through the native batch path when available. Admission
        is all-or-nothing at this edge; on a cluster facade the facade
        itself admits per owning rank (local sub-batch + owner-side
        handlers), so the edge does not double-charge the local bucket —
        a fully shed facade batch still answers 429 + Retry-After."""
        from sitewhere_tpu_torch.ingest.decoders import split_json_array
        from sitewhere_tpu_torch.utils.qos import admit_or_raise

        body = await request.read()
        rows = split_json_array(body)   # raw slices; decoded once, natively
        tenant = request.get("tenant", "default")
        if not hasattr(inst.engine, "cluster_config"):
            admit_or_raise(inst.engine, tenant, len(rows))
        # a fully-shed facade sub-batch raises its own typed ShedError
        # inside ingest_json_batch (all-or-nothing), which the error
        # middleware maps to 429 + Retry-After like the edge check above
        res = inst.engine.ingest_json_batch(rows, tenant=tenant)
        inst.engine.flush()
        return json_response(res, status=201)

    r.add_post("/api/events/batch", post_event_batch)

    # --- openapi (reference: OpenAPI annotations on every controller) -----
    async def openapi_spec(request: web.Request):
        """Minimal OpenAPI 3 document generated from the live route table."""
        paths: dict[str, dict] = {}
        for route in r.routes():
            info = route.resource.get_info() if route.resource else {}
            path = info.get("path") or info.get("formatter")
            if not path or route.method == "OPTIONS":
                continue
            ops = paths.setdefault(path, {})
            ops[route.method.lower()] = {
                "summary": (route.handler.__doc__ or "").strip().split("\n")[0],
                "responses": {"200": {"description": "OK"}},
            }
        import sitewhere_tpu_torch

        return json_response({
            "openapi": "3.0.0",
            "info": {"title": "SiteWhere-TPU REST API",
                     "version": sitewhere_tpu_torch.__version__},
            "paths": dict(sorted(paths.items())),
        })

    r.add_get("/api/openapi.json", openapi_spec)

    # --- system (reference: System.java version endpoint) -----------------
    async def system_version(request: web.Request):
        import torch

        import sitewhere_tpu_torch

        # the engine's device names the backend; the count is the GPUs
        # visible to the process on a card instance, 1 on a CPU instance
        on_gpu = torch.device(inst.engine.device).type == "cuda"
        return json_response({
            "edition": "SiteWhere-TPU", "version": sitewhere_tpu_torch.__version__,
            "backend": "gpu" if on_gpu else "cpu",
            "deviceCount": torch.cuda.device_count() if on_gpu else 1,
        })

    r.add_get("/api/system/version", system_version)

    # --- device-state search (reference: DeviceStates.java POST search) ---
    async def device_state_search(request: web.Request):
        body = await request.json() if request.can_read_body else {}
        states = await asyncio.to_thread(
            inst.engine.search_device_states,
            last_interaction_before_ms=body.get("lastInteractionDateBeforeMs"),
            presence=body.get("presence"),
            device_tokens=body.get("deviceTokens"),
            area=body.get("areaToken"),
            device_type=body.get("deviceTypeToken"),
            limit=_page_size(body),
        )
        return json_response({"numResults": len(states), "results": states})

    r.add_post("/api/devicestates/search", device_state_search)

    # --- update/delete surface (reference: each controller's PUT/DELETE) --
    async def update_device(request: web.Request):
        body = await request.json()
        s = inst.device_management.update_device(
            request.match_info["token"],
            device_type=body.get("deviceTypeToken"),
            area=body.get("areaToken"), customer=body.get("customerToken"),
            metadata=body.get("metadata"),
        )
        return json_response(dataclasses.asdict(s))

    r.add_put("/api/devices/{token}", update_device)

    async def map_device(request: web.Request):
        """Map this device under a gateway/composite parent (reference:
        Devices controller device-mapping path + MapDevice requests)."""
        body = await request.json()
        parent = body.get("parentToken")
        if not parent:
            raise ValueError("parentToken is required")
        try:
            info = inst.engine.map_device(request.match_info["token"], parent)
        except KeyError as e:
            raise EntityNotFound(str(e)) from None
        return json_response({"token": info.token,
                              "parentToken": info.metadata.get("parentToken")},
                             status=201)

    r.add_post("/api/devices/{token}/parent", map_device)

    def _store_update(store, fields: dict[str, str]):
        """PUT handler over an EntityStore: body camelCase key -> attr."""
        async def handler(request: web.Request):
            body = await request.json()

            def apply(e):
                for key, attr in fields.items():
                    if key in body:
                        setattr(e, attr, body[key])
                if "metadata" in body:
                    e.meta.metadata = body["metadata"]

            e = store.update(request.match_info["token"], apply)
            return json_response(_entity(e))

        return handler

    def _store_delete(store):
        async def handler(request: web.Request):
            store.delete(request.match_info["token"])
            return json_response({"deleted": True})

        return handler

    def _store_get(store):
        async def handler(request: web.Request):
            return json_response(_entity(store.get(request.match_info["token"])))

        return handler

    dm = inst.device_management
    named = {"name": "name", "description": "description"}
    for path, store, fields in [
        ("/api/devicetypes/{token}", dm.device_types, named),
        ("/api/areatypes/{token}", dm.area_types, named),
        ("/api/areas/{token}", dm.areas, named),
        ("/api/customertypes/{token}", dm.customer_types, named),
        ("/api/customers/{token}", dm.customers, named),
        ("/api/zones/{token}", dm.zones, named),
        ("/api/devicegroups/{token}", dm.groups,
         {"name": "name", "description": "description", "roles": "roles"}),
        ("/api/assettypes/{token}", inst.assets.asset_types, named),
        ("/api/assets/{token}", inst.assets.assets, named),
        ("/api/schedules/{token}", inst.scheduler.schedules, {"name": "name"}),
        ("/api/jobs/{token}", inst.scheduler.jobs, {}),
        ("/api/tenants/{token}", inst.tenants.tenants,
         {"name": "name", "authorizedUserIds": "authorized_users"}),
    ]:
        r.add_put(path, _store_update(store, fields))
        r.add_delete(path, _store_delete(store))
    # ---- per-command / per-status CRUD (reference: DeviceTypes.java
    # /{token}/commands/{commandToken} and /{token}/statuses/{statusToken})
    def _find_status(request):
        st = inst.device_management.statuses.get(
            request.match_info["statusToken"])
        if st.device_type != request.match_info["token"]:
            raise EntityNotFound(
                f"status {st.token!r} not in type "
                f"{request.match_info['token']!r}")
        return st

    async def get_type_command(request: web.Request):
        cmd = inst.command_registry.get(request.match_info["commandToken"])
        if cmd is None or cmd.device_type != request.match_info["token"]:
            raise EntityNotFound("unknown command")
        return json_response(dataclasses.asdict(cmd))

    async def update_type_command(request: web.Request):
        body = await request.json()
        # 404 on wrong device type BEFORE mutating (a rejected update must
        # not change state)
        existing = inst.command_registry.get(request.match_info["commandToken"])
        if existing is None or existing.device_type != request.match_info["token"]:
            raise EntityNotFound("unknown command")

        def apply(c):
            for key in ("name", "namespace", "description"):
                if key in body:
                    setattr(c, key, body[key])
            if "parameters" in body:
                c.parameters = tuple(
                    CommandParameter(p["name"],
                                     ParameterType(p.get("type", "String")),
                                     p.get("required", False))
                    for p in body["parameters"])

        cmd = inst.command_registry.update(
            request.match_info["commandToken"], apply)
        return json_response(dataclasses.asdict(cmd))

    async def delete_type_command(request: web.Request):
        cmd = inst.command_registry.get(request.match_info["commandToken"])
        if cmd is None or cmd.device_type != request.match_info["token"]:
            raise EntityNotFound("unknown command")
        inst.command_registry.delete(cmd.token)
        return json_response({"deleted": True})

    async def get_type_status(request: web.Request):
        return json_response(_entity(_find_status(request)))

    async def update_type_status(request: web.Request):
        body = await request.json()
        _find_status(request)   # 404 on wrong type BEFORE mutating

        def apply(s):
            for key in ("name", "code", "backgroundColor", "foregroundColor",
                        "borderColor", "icon"):
                attr = {"backgroundColor": "background_color",
                        "foregroundColor": "foreground_color",
                        "borderColor": "border_color"}.get(key, key)
                if key in body and hasattr(s, attr):
                    setattr(s, attr, body[key])

        st = inst.device_management.statuses.update(
            request.match_info["statusToken"], apply)
        return json_response(_entity(st))

    async def delete_type_status(request: web.Request):
        _find_status(request)
        inst.device_management.statuses.delete(
            request.match_info["statusToken"])
        return json_response({"deleted": True})

    r.add_get("/api/devicetypes/{token}/commands/{commandToken}",
              get_type_command)
    r.add_put("/api/devicetypes/{token}/commands/{commandToken}",
              update_type_command)
    r.add_delete("/api/devicetypes/{token}/commands/{commandToken}",
                 delete_type_command)
    r.add_get("/api/devicetypes/{token}/statuses/{statusToken}",
              get_type_status)
    r.add_put("/api/devicetypes/{token}/statuses/{statusToken}",
              update_type_status)
    r.add_delete("/api/devicetypes/{token}/statuses/{statusToken}",
                 delete_type_status)

    # ---- device-group element removal (reference: DeviceGroups.java
    # DELETE /{groupToken}/elements/{elementId} and /elements)
    async def delete_group_element(request: web.Request):
        ok = inst.device_management.remove_group_element(
            request.match_info["token"],
            int(request.match_info["elementId"]))
        if not ok:
            raise EntityNotFound("unknown group element")
        return json_response({"deleted": True})

    async def delete_group_elements(request: web.Request):
        body = await request.json()
        removed = sum(
            inst.device_management.remove_group_element(
                request.match_info["token"], int(eid))
            for eid in body)
        return json_response({"deleted": removed})

    r.add_delete("/api/devicegroups/{token}/elements/{elementId}",
                 delete_group_element)
    r.add_delete("/api/devicegroups/{token}/elements", delete_group_elements)

    # ---- event lookups by id / alternate id (reference: DeviceEvents.java)
    def _event_lookup_tenant(request: web.Request) -> str | None:
        """Ids are enumerable ring positions: a non-admin caller must be
        tenant-bound (X-SiteWhere-Tenant-Id) so other tenants' rows read
        as absent; admins get the instance-wide view."""
        tenant = request.get("tenant")
        if tenant is None and AUTH_ADMIN not in request.get(
                "authorities", []):
            raise web.HTTPForbidden(
                text='{"error": "tenant header required"}',
                content_type=JSON)
        return tenant

    async def get_event_by_id(request: web.Request):
        ev = inst.engine.get_event(int(request.match_info["eventId"]),
                                   tenant=_event_lookup_tenant(request))
        if ev is None:
            raise EntityNotFound("unknown or expired event id")
        return json_response(ev)

    async def get_event_by_alternate(request: web.Request):
        res = await asyncio.to_thread(
            inst.engine.query_events,
            alternate_id=request.match_info["alternateId"], limit=1,
            tenant=_event_lookup_tenant(request))
        if not res["events"]:
            raise EntityNotFound("no event with that alternate id")
        return json_response(res["events"][0])

    r.add_get("/api/events/id/{eventId}", get_event_by_id)
    r.add_get("/api/events/alternate/{alternateId}", get_event_by_alternate)

    # ---- per-area / per-customer event rollups + assignment listings
    # (reference: Areas.java /{token}/measurements..., Customers.java ditto)
    _ROLLUPS = {
        "measurements": EventType.MEASUREMENT,
        "locations": EventType.LOCATION,
        "alerts": EventType.ALERT,
        "invocations": EventType.COMMAND_INVOCATION,
        "responses": EventType.COMMAND_RESPONSE,
        "statechanges": EventType.STATE_CHANGE,
    }

    def _rollup(kind: str):
        async def handler(request: web.Request):
            et = _ROLLUPS.get(request.match_info["etype"])
            if et is None:
                raise EntityNotFound("unknown event rollup")
            res = await asyncio.to_thread(
                functools.partial(
                    inst.engine.query_events,
                    **{kind: request.match_info["token"]}, etype=et,
                    limit=_page_size(request.query)))
            return json_response({"numResults": res["total"],
                                  "results": res["events"]})

        return handler

    # literal /assignments must register BEFORE the {etype} wildcard (one
    # path prefix resolves in registration order)
    r.add_get("/api/areas/{token}/assignments", _sync(lambda req: json_response(
        [dataclasses.asdict(a) for a in
         inst.engine.list_assignments(area=req.match_info["token"])])))
    r.add_get("/api/customers/{token}/assignments", _sync(lambda req: json_response(
        [dataclasses.asdict(a) for a in
         inst.engine.list_assignments(customer=req.match_info["token"])])))
    r.add_get("/api/areas/{token}/{etype}", _rollup("area"))
    r.add_get("/api/customers/{token}/{etype}", _rollup("customer"))

    # ---- device group/role listings + parent mappings (reference:
    # Devices.java /group/{token}, /grouprole/{role}, /{deviceToken}/mappings;
    # /summaries registers early, before the /{token} dynamic route)
    r.add_get("/api/devices/group/{token}", _sync(lambda req: json_response(
        dm.expand_group_devices(req.match_info["token"]))))
    r.add_get("/api/devices/grouprole/{role}", _sync(lambda req: json_response(
        sorted({tok for g in dm.groups.all()
                if req.match_info["role"] in (g.roles or [])
                for tok in dm.expand_group_devices(g.meta.token)}))))

    async def get_device_mappings(request: web.Request):
        info = inst.engine.get_device(request.match_info["token"])
        if info is None:
            raise EntityNotFound("unknown device")
        parent = info.metadata.get("parentToken")
        return json_response({"parentToken": parent} if parent else {})

    async def delete_device_mapping(request: web.Request):
        info = inst.engine.update_device(
            request.match_info["token"], metadata={"parentToken": None})
        return json_response({"parentToken": None,
                              "deviceToken": info.token})

    r.add_get("/api/devices/{token}/mappings", get_device_mappings)
    r.add_delete("/api/devices/{token}/mappings", delete_device_mapping)

    # ---- invocation summary (reference: CommandInvocations.java
    # /id/{id}/summary — invocation + its responses in one view)
    async def get_invocation_summary(request: web.Request):
        inv_id = int(request.match_info["id"])
        # through get_invocation, not raw history: on a cluster it
        # resolves ids this rank never saw at their owning rank
        inv = inst.commands.get_invocation(inv_id)
        if inv is None:
            raise EntityNotFound("unknown invocation")
        # responses store aux0 = interner id of the originatingEventId
        # string, NOT the raw invocation counter — responses_for owns that
        # mapping (same path as /api/invocations/{id}/responses)
        return json_response({
            "invocation": dataclasses.asdict(inv),
            "responses": inst.commands.responses_for(inv_id),
        })

    r.add_get("/api/invocations/{id}/summary", get_invocation_summary)

    # GET-by-token for families that lacked it
    r.add_get("/api/areatypes/{token}", _store_get(dm.area_types))
    r.add_get("/api/customertypes", _sync(lambda req: json_response(
        _paged(dm.customer_types.list()))))
    r.add_get("/api/customertypes/{token}", _store_get(dm.customer_types))
    r.add_get("/api/customers/{token}", _store_get(dm.customers))
    r.add_get("/api/zones/{token}", _store_get(dm.zones))
    r.add_get("/api/devicegroups/{token}", _store_get(dm.groups))
    r.add_get("/api/assettypes", _sync(lambda req: json_response(
        _paged(inst.assets.asset_types.list()))))
    r.add_get("/api/assettypes/{token}", _store_get(inst.assets.asset_types))
    r.add_get("/api/assets/{token}", _store_get(inst.assets.assets))
    r.add_get("/api/schedules/{token}", _store_get(inst.scheduler.schedules))
    r.add_get("/api/jobs/{token}", _store_get(inst.scheduler.jobs))

    return app


class ServerHandle:
    """Running REST server + background pumps (outbound, analytics)."""

    def __init__(self, runner: web.Server, port: int, tasks,
                 auditor=None, instance=None):
        self.runner = runner
        self.port = port
        self._tasks = list(tasks)
        self._auditor = auditor
        self._instance = instance

    async def cleanup(self) -> None:
        import asyncio

        if self._auditor is not None:
            # the conservation auditor belongs to the INSTANCE whenever
            # its lifecycle is running — tearing down just the web tier
            # must not kill always-on auditing for a STARTED instance
            # (on_stop stops it); only an instance that never ran its
            # lifecycle leaves the thread ours to reap
            from sitewhere_tpu_torch.utils.lifecycle import LifecycleStatus

            status = getattr(self._instance, "status", None)
            if status is not LifecycleStatus.STARTED:
                self._auditor.stop()
        for task in self._tasks:
            task.cancel()
        for task in self._tasks:
            try:
                await task
            except (asyncio.CancelledError, Exception):
                pass
        await self.runner.close()


async def start_server(instance: SiteWhereTpuInstance, host: str = "127.0.0.1",
                       port: int = 0,
                       analytics_interval_s: float = 5.0,
                       presence_interval_s: float = 600.0) -> ServerHandle:
    """Start the REST gateway + background pumps (outbound pump, periodic
    presence sweep, and analytics when the engine carries telemetry
    windows)."""
    import asyncio

    app = make_app(instance)

    async def pump_loop():
        while True:
            try:
                await instance.pump_outbound()
            except asyncio.CancelledError:
                raise
            except Exception:
                import logging

                logging.getLogger(__name__).exception("outbound pump error")
            await asyncio.sleep(0.05)

    runner = await web.serve(app, host, port)
    async def presence_loop():
        # background presence scan (DevicePresenceManager.java:45-160 runs
        # a periodic check-loop; default interval there is 10 minutes)
        while True:
            await asyncio.sleep(presence_interval_s)
            try:
                # rank-LOCAL sweep: every rank runs this loop for its own
                # partition (the reference's per-engine presence manager);
                # the cluster-wide fan-out is only for the admin endpoint
                missing = await asyncio.to_thread(
                    instance.engine.presence_sweep_local)
                if missing:
                    import logging

                    logging.getLogger(__name__).info(
                        "presence sweep: %d newly missing", len(missing))
            except asyncio.CancelledError:
                raise
            except Exception:
                import logging

                logging.getLogger(__name__).exception("presence sweep error")

    tasks = [asyncio.create_task(pump_loop()),
             asyncio.create_task(presence_loop())]
    if instance.analytics is not None:
        # always-on analytics: train on live windows, score, inject alerts
        tasks.append(asyncio.create_task(
            instance.analytics.run(interval_s=analytics_interval_s)))
    bound = runner.port
    # conservation audit plane: always-on invariant checking
    # while the server is up — started here so embedded instances that
    # never run the async lifecycle still get the background auditor.
    # Ownership: cleanup stops the thread only if THIS call started it;
    # an auditor the instance lifecycle already runs stays the
    # instance's to stop (a server rebind must not kill its auditing).
    auditor = getattr(instance, "conservation_auditor", None)
    started_here = None
    if (auditor is not None
            and getattr(instance.config, "conservation_audit_s", 0)
            and not auditor.running):
        auditor.start()
        started_here = auditor
    return ServerHandle(runner, bound, tasks, auditor=started_here,
                        instance=instance)
