"""Control-plane RPC server: method registry + tenant dispatch + auth.

Mirrors the reference's per-service gRPC servers and routers: each
data-owning service hosts a ``*GrpcServer`` whose ``*Router`` resolves the
tenant from call metadata and executes inside that tenant's engine
(DeviceStateRouter.java:62-72 ``GrpcTenantEngineProvider
.executeInTenantEngine``). Here one server hosts the
method families of EVERY reference gRPC surface — device-management,
event-management, device-state, asset-management, batch-operations,
schedule-management, label-generation, tenant-management, user-management
(DeviceManagementImpl.java:75-90; service-asset-management/.../asset/grpc/;
service-instance-management/.../instance/grpc/{tenant,user}/) — over the
instance, with tenant checks on every call.

Authentication mirrors the reference's system-user security context:
cross-service calls run wrapped in JWT token management
(SystemUserRunnable / ITokenManagement). A connection
must open with ``Auth.handshake`` carrying a JWT minted by the instance's
JwtService; every later frame executes under that connection's granted
authorities, and admin-family methods check them.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import logging
from typing import Any, Awaitable, Callable

from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.rpc.protocol import RpcError, encode_frame, read_frame
from sitewhere_tpu_torch.utils.qos import ShedError, admit_or_raise

logger = logging.getLogger(__name__)

Handler = Callable[..., Any]


class RpcServer:
    """Asyncio TCP server with a method registry; calls multiplex by id.

    ``authenticator`` (token -> claims dict, raising on a bad token) turns
    on per-connection authentication; methods registered with
    ``authority=`` additionally require that granted authority. Without an
    authenticator the server is an unauthenticated embedded substrate
    (in-process tests, single-trust-domain wiring)."""

    def __init__(self, tenant_validator: Callable[[str], bool] | None = None,
                 authenticator: Callable[[str], dict] | None = None,
                 tenant_authorizer: Callable[[str, str, list], bool]
                 | None = None,
                 unbound_authority: str | None = None):
        self.methods: dict[str, Handler] = {}
        self._tenant_scoped: dict[str, bool] = {}
        self._wants_attachment: dict[str, bool] = {}
        self._authority: dict[str, str | None] = {}
        self._tenant_validator = tenant_validator
        self._authenticator = authenticator
        self._tenant_authorizer = tenant_authorizer
        # authority required to call WITHOUT a tenant binding: tenant-less
        # calls see instance-wide data, so they are admin-plane
        self._unbound_authority = unbound_authority
        self._server: asyncio.AbstractServer | None = None
        self._conns: set = set()
        self.port: int | None = None

    def register(self, name: str, fn: Handler,
                 authority: str | None = None) -> None:
        import inspect

        self.methods[name] = fn
        self._authority[name] = authority
        sig = inspect.signature(fn).parameters
        self._tenant_scoped[name] = "tenant" in sig
        self._wants_attachment[name] = "_attachment" in sig

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> int:
        self._server = await asyncio.start_server(self._serve, host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # sever live connections: wait_closed() (3.12+) waits for
            # every handler, and an idle client would hold its handler in
            # read_frame forever
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    async def _serve(self, reader, writer) -> None:
        lock = asyncio.Lock()
        tasks: set[asyncio.Task] = set()
        # per-connection security context (the reference's UserContext)
        conn = {"authed": self._authenticator is None,
                "user": None, "authorities": [], "jwt_tenant": None}
        self._conns.add(writer)
        try:
            while True:
                frame = await read_frame(reader)
                if frame is None:
                    break
                task = asyncio.ensure_future(
                    self._dispatch(frame, writer, lock, conn))
                tasks.add(task)                 # keep a strong reference
                task.add_done_callback(tasks.discard)
        except Exception:
            logger.exception("rpc connection error")
        finally:
            if tasks:                           # let in-flight calls respond
                await asyncio.gather(*tasks, return_exceptions=True)
            writer.close()
            self._conns.discard(writer)

    def _handshake(self, conn: dict, params: dict) -> dict:
        try:
            claims = self._authenticator(params.get("token", ""))
        except Exception as e:
            raise RpcError(f"authentication failed: {e}", 401) from None
        conn["authed"] = True
        conn["user"] = claims.get("sub")
        conn["authorities"] = claims.get("auth", [])
        # a tenant-scoped JWT binds the whole connection to its tenant
        conn["jwt_tenant"] = claims.get("tenant")
        return {"user": conn["user"], "authorities": conn["authorities"]}

    async def _dispatch(self, frame: dict, writer, lock, conn: dict) -> None:
        rid = frame.get("id")
        try:
            method = frame.get("method", "")
            params = frame.get("params") or {}
            # spoof-proofing: only a REAL wire attachment (bytes, set by
            # read_frame) may appear under the reserved key — a json
            # string impostor inside params is discarded. Injected only
            # for handlers that declare it; stray attachments drop.
            params.pop("_attachment", None)
            if (isinstance(frame.get("_attachment"), (bytes, bytearray))
                    and self._wants_attachment.get(method)):
                params["_attachment"] = frame["_attachment"]
            if method == "Auth.handshake":
                if self._authenticator is None:
                    resp = {"id": rid, "result": {"user": None,
                                                  "authorities": []}}
                else:
                    resp = {"id": rid, "result": self._handshake(conn, params)}
                raise _Respond(resp)
            if not conn["authed"]:
                raise RpcError("authentication required", 401)
            fn = self.methods.get(method)
            if fn is None:
                raise RpcError(f"unknown method {method!r}", 404)
            need = self._authority.get(method)
            if (need is not None and self._authenticator is not None
                    and need not in conn["authorities"]):
                raise RpcError(f"authority {need!r} required", 403)
            tenant = frame.get("tenant")
            if conn.get("jwt_tenant") is not None:
                # a tenant claim in the JWT overrides any client-asserted
                # binding — the caller cannot escape its token's tenant
                if tenant is not None and tenant != conn["jwt_tenant"]:
                    raise RpcError("connection bound to another tenant", 403)
                tenant = conn["jwt_tenant"]

            def authorize(t: str) -> None:
                # identity alone is not tenant access: check the caller
                # against tenant authorization the way the REST tier does
                # (TenantManagement.user_can_access)
                if (self._authenticator is not None
                        and self._tenant_authorizer is not None
                        and not self._tenant_authorizer(
                            t, conn["user"], conn["authorities"])):
                    raise RpcError(
                        f"user not authorized for tenant {t!r}", 403)

            if tenant is not None and self._tenant_validator is not None \
                    and not self._tenant_validator(tenant):
                # the router's unknown-tenant rejection
                raise RpcError(f"unknown tenant {tenant!r}", 404)
            if tenant is not None:
                authorize(tenant)
            elif (params.get("tenant") is None
                  and self._authenticator is not None
                  and self._unbound_authority is not None
                  and self._unbound_authority not in conn["authorities"]):
                # no tenant named anywhere: the call reads/writes
                # instance-wide (event ids are enumerable ring positions)
                # — admin-plane only, mirroring the REST tier's gate
                raise RpcError(
                    "tenant binding required (or authority "
                    f"{self._unbound_authority!r})", 403)
            if tenant is not None and self._tenant_scoped.get(method):
                # executeInTenantEngine semantics: a tenant-bound connection
                # operates in ITS tenant — callers cannot address another
                params["tenant"] = tenant
            elif params.get("tenant") is not None:
                if (self._tenant_validator is not None
                        and not self._tenant_validator(params["tenant"])):
                    # unbound connections still cannot name unknown tenants
                    raise RpcError(
                        f"unknown tenant {params['tenant']!r}", 404)
                authorize(params["tenant"])
            # bind the frame's traceparent (contextvar: per-task, so
            # multiplexed calls cannot cross-talk) around the handler —
            # the owner-side ingest joins the sender's trace through it
            from sitewhere_tpu_torch.utils.tracing import bind_traceparent

            with bind_traceparent(frame.get("tp")):
                result = fn(**params)
                if isinstance(result, Awaitable):
                    result = await result
            resp = {"id": rid, "result": result}
        except _Respond as r:
            resp = r.resp
        except RpcError as e:
            resp = {"id": rid, "error": str(e), "code": e.code}
            if getattr(e, "retry_after_s", None) is not None:
                resp["retryAfterS"] = e.retry_after_s
            if getattr(e, "data", None) is not None:
                resp["data"] = e.data
        except ShedError as e:
            # typed load shed from an admission edge or an arena-stall
            # translation: the RPC form of REST's 429 + Retry-After —
            # an app-level reject the forward retry machinery can
            # classify (never a transport failure)
            resp = {"id": rid, "error": str(e), "code": 429,
                    "retryAfterS": e.retry_after_s}
        except (KeyError, ValueError, TypeError) as e:
            resp = {"id": rid, "error": str(e), "code": 400}
        except Exception as e:
            logger.exception("rpc handler failure")
            resp = {"id": rid, "error": str(e), "code": 500}
        try:
            wire = encode_frame(resp)
        except RpcError as e:      # oversized result: still answer the call
            wire = encode_frame({"id": rid, "error": str(e), "code": e.code})
        except TypeError as e:     # unserializable handler result: loud 500
            logger.exception("rpc result not serializable: %s", method)
            wire = encode_frame({"id": rid, "error": str(e), "code": 500})
        async with lock:   # frames must not interleave on the socket
            if writer.is_closing():
                return
            try:
                writer.write(wire)
                await writer.drain()
            except (ConnectionError, OSError):
                pass       # client went away mid-response


class _Respond(Exception):
    """Internal: short-circuit _dispatch with a ready response."""

    def __init__(self, resp: dict):
        self.resp = resp


def system_jwt(instance) -> str:
    """Mint the system-user token cross-service callers authenticate with
    (reference: SystemUserRunnable's system security context)."""
    from sitewhere_tpu_torch.instance.auth import DEFAULT_ROLES

    return instance.jwt.generate("system", DEFAULT_ROLES["admin"])


def build_instance_rpc(instance, require_auth: bool = True) -> RpcServer:
    """Register the reference's cross-service API families over one
    instance — the full method surface the gRPC ``*ApiChannel`` clients
    consume. ``require_auth=True`` (the default) rejects
    any call before a valid ``Auth.handshake``."""
    from sitewhere_tpu_torch.instance.auth import (AUTH_ADMIN,
                                             AUTH_ADMINISTER_TENANTS,
                                             AUTH_ADMINISTER_USERS)
    from sitewhere_tpu_torch.management.entities import entity_json, paged_json

    inst = instance
    srv = RpcServer(
        tenant_validator=lambda t: inst.tenants.tenants.try_get(t) is not None,
        authenticator=inst.jwt.validate if require_auth else None,
        tenant_authorizer=lambda t, user, auths: inst.tenants.user_can_access(
            t, user, AUTH_ADMIN in auths),
        unbound_authority=AUTH_ADMIN)

    # --- device-management (DeviceManagementImpl.java:75-90 analog) -------
    def get_device_by_token(token: str):
        info = inst.engine.get_device(token)
        if info is None:
            return None
        return dataclasses.asdict(info)

    def create_device(token: str, deviceType: str = "default",
                      tenant: str = "default", area: str = None,
                      customer: str = None, metadata: dict = None):
        s = inst.device_management.create_device(
            token, deviceType, tenant=tenant, area=area, customer=customer,
            metadata=metadata)
        return dataclasses.asdict(s)

    def update_device(token: str, deviceType: str = None, area: str = None,
                      customer: str = None, metadata: dict = None):
        s = inst.device_management.update_device(
            token, device_type=deviceType, area=area, customer=customer,
            metadata=metadata)
        return dataclasses.asdict(s)

    def delete_device(token: str):
        return {"deleted": inst.device_management.delete_device(token)}

    def list_devices(page: int = 1, pageSize: int = 100,
                     deviceType: str = None, tenant: str = None):
        res = inst.device_management.list_devices(
            page=page, page_size=pageSize, device_type=deviceType,
            tenant=tenant)
        return {"numResults": res.total,
                "results": [dataclasses.asdict(s) for s in res.results]}

    def get_device_summary(token: str):
        return dataclasses.asdict(
            inst.device_management.get_device_summary(token))

    def get_active_assignments(token: str):
        return [dataclasses.asdict(a)
                for a in inst.engine.list_assignments(token)
                if a.status != "RELEASED"]

    def create_device_type(token: str, name: str, **kw):
        return entity_json(inst.device_management.create_device_type(
            token, name, **kw))

    def list_device_types(page: int = 1, pageSize: int = 100):
        return paged_json(inst.device_management.device_types.list(
            page=page, page_size=pageSize))

    def create_device_status(token: str, deviceType: str, code: str,
                             name: str):
        return entity_json(inst.device_management.create_device_status(
            token, deviceType, code, name))

    def list_device_statuses(deviceType: str):
        return [entity_json(s) for s in
                inst.device_management.statuses_for_type(deviceType)]

    def create_device_command(token: str, deviceType: str, name: str,
                              namespace: str = "http://sitewhere/tpu",
                              description: str = "", parameters: list = None):
        from sitewhere_tpu_torch.commands.model import command_from_json

        cmd = command_from_json(token, deviceType, name, namespace=namespace,
                                description=description,
                                parameters=parameters)
        inst.command_registry.create(cmd)
        return dataclasses.asdict(cmd)

    def list_device_commands(deviceType: str):
        return [dataclasses.asdict(c)
                for c in inst.command_registry.list_for_type(deviceType)]

    def create_alarm(token: str, deviceToken: str, message: str, **kw):
        return entity_json(inst.device_management.create_alarm(
            token, deviceToken, message, **kw))

    def acknowledge_alarm(token: str):
        return entity_json(inst.device_management.acknowledge_alarm(token))

    def resolve_alarm(token: str):
        return entity_json(inst.device_management.resolve_alarm(token))

    def list_alarms(deviceToken: str):
        return [entity_json(a) for a in
                inst.device_management.alarms_for_device(deviceToken)]

    def create_customer_type(token: str, name: str, **kw):
        return entity_json(inst.device_management.create_customer_type(
            token, name, **kw))

    def create_customer(token: str, customerType: str, name: str, **kw):
        return entity_json(inst.device_management.create_customer(
            token, customerType, name, **kw))

    def customer_tree():
        return _tree_json(inst.device_management.customer_tree())

    def create_area_type(token: str, name: str, **kw):
        return entity_json(inst.device_management.create_area_type(
            token, name, **kw))

    def create_area(token: str, areaType: str, name: str, **kw):
        return entity_json(inst.device_management.create_area(
            token, areaType, name, **kw))

    def area_tree():
        return _tree_json(inst.device_management.area_tree())

    def _tree_json(nodes):
        return [{"entity": entity_json(n.entity),
                 "children": _tree_json(n.children)} for n in nodes]

    def create_zone(token: str, areaToken: str, name: str, **kw):
        return entity_json(inst.device_management.create_zone(
            token, areaToken, name, **kw))

    def list_zones(areaToken: str):
        return [entity_json(z) for z in
                inst.device_management.zones_for_area(areaToken)]

    def create_device_group(token: str, name: str, roles: list = None,
                            description: str = ""):
        return entity_json(inst.device_management.create_group(
            token, name, roles=roles, description=description))

    def add_device_group_elements(groupToken: str, elements: list):
        return [dataclasses.asdict(e) for e in
                inst.device_management.add_group_elements(
                    groupToken, elements)]

    def list_device_group_elements(groupToken: str):
        return [dataclasses.asdict(e) for e in
                inst.device_management.group_elements(groupToken)]

    # --- event-management (EventManagementImpl analog) --------------------
    def list_device_events(token: str = None, type: str = None,
                           sinceMs: int = None, untilMs: int = None,
                           pageSize: int = 100, tenant: str = None):
        from sitewhere_tpu_torch.ops.query import clamp_page_size

        et = EventType[type.upper()] if type else None
        # same clamp as the REST gateway: a peer-sent pageSize feeds the
        # limit-bucketed query compile cache
        return inst.engine.query_events(
            device_token=token, etype=et, tenant=tenant,
            since_ms=sinceMs, until_ms=untilMs,
            limit=clamp_page_size(pageSize))

    def add_device_event(envelope: dict, tenant: str = "default"):
        from sitewhere_tpu_torch.ingest.decoders import request_from_envelope

        req = request_from_envelope(envelope)
        req.tenant = tenant
        # ingest edge: per-tenant admission — a shed surfaces
        # as a typed 429 app-reject, never a silent drop. On a cluster
        # facade admission is per OWNER: this edge admits only
        # locally-owned devices (a remote owner's handler sheds with
        # its own 429) — charging the edge rank's bucket for
        # remote-owned traffic would double-charge the tenant.
        eng = inst.engine
        if not hasattr(eng, "cluster_config"):
            admit_or_raise(eng, tenant, 1)
        elif eng.owner(req.device_token) == eng.rank:
            admit_or_raise(eng.local, tenant, 1)
        inst.engine.process(req)
        inst.engine.flush()
        return {"accepted": True}

    def get_event_by_id(eventId: int, tenant: str = None):
        return inst.engine.get_event(eventId, tenant=tenant)

    # --- device-state (DeviceStateImpl analog, incl. search) --------------
    def get_device_state(token: str):
        return inst.engine.get_device_state(token)

    def search_device_states(lastInteractionBeforeMs: int = None,
                             presence: str = None, deviceTokens: list = None,
                             pageSize: int = 100):
        return inst.engine.search_device_states(
            last_interaction_before_ms=lastInteractionBeforeMs,
            presence=presence, device_tokens=deviceTokens, limit=pageSize)

    # --- asset-management (asset/grpc/AssetManagementImpl analog) ---------
    def create_asset_type(token: str, name: str, **kw):
        return entity_json(inst.assets.create_asset_type(token, name, **kw))

    def create_asset(token: str, assetType: str, name: str, **kw):
        return entity_json(inst.assets.create_asset(
            token, assetType, name, **kw))

    def get_asset_by_token(token: str):
        a = inst.assets.assets.try_get(token)
        return entity_json(a) if a is not None else None

    def list_assets(page: int = 1, pageSize: int = 100,
                    assetType: str = None):
        return paged_json(inst.assets.list_assets(
            page=page, page_size=pageSize, asset_type=assetType))

    # --- batch-operations (batch/grpc analog) -----------------------------
    async def create_batch_command_invocation(token: str, deviceTokens: list,
                                              commandToken: str,
                                              parameterValues: dict = None):
        op = inst.batch.create_operation(
            token, "InvokeCommand", deviceTokens,
            parameters={"commandToken": commandToken,
                        "parameterValues": parameterValues or {}})
        await inst.batch.process_operation(token)
        return _batch_json(op)

    def _batch_json(op):
        return entity_json(op) | {
            "counts": op.counts(),
            "elements": [dataclasses.asdict(e) | {"status": e.status.name}
                         for e in op.elements]}

    def get_batch_operation(token: str):
        op = inst.batch.operations.try_get(token)
        return _batch_json(op) if op is not None else None

    def list_batch_operations(page: int = 1, pageSize: int = 100):
        res = inst.batch.operations.list(page=page, page_size=pageSize)
        return {"numResults": res.total,
                "results": [_batch_json(o) for o in res.results]}

    def list_batch_elements(token: str):
        op = inst.batch.operations.get(token)
        return [dataclasses.asdict(e) | {"status": e.status.name}
                for e in op.elements]

    # --- schedule-management (schedule/grpc analog) -----------------------
    def create_schedule(token: str, name: str, triggerType: str,
                        cron: str = None, intervalS: float = None,
                        repeatCount: int = -1):
        return entity_json(inst.scheduler.create_schedule(
            token, name, triggerType, cron=cron, interval_s=intervalS,
            repeat_count=repeatCount))

    def list_schedules(page: int = 1, pageSize: int = 100):
        return paged_json(inst.scheduler.schedules.list(
            page=page, page_size=pageSize))

    def create_scheduled_job(token: str, scheduleToken: str, jobType: str,
                             configuration: dict):
        return entity_json(inst.scheduler.create_job(
            token, scheduleToken, jobType, configuration))

    def list_scheduled_jobs(page: int = 1, pageSize: int = 100):
        return paged_json(inst.scheduler.jobs.list(
            page=page, page_size=pageSize))

    # --- label-generation (labels/grpc analog; PNG as base64) -------------
    def get_label(entityType: str, token: str, generatorId: str = "qrcode"):
        gen = inst.labels.get(generatorId)
        fn = {"device": gen.device_label, "asset": gen.asset_label,
              "area": gen.area_label, "customer": gen.customer_label,
              "devicegroup": gen.device_group_label}.get(entityType)
        if fn is None:
            raise ValueError(f"unknown label entity type {entityType!r}")
        return {"contentType": "image/png",
                "image": base64.b64encode(fn(token)).decode()}

    def list_label_generators():
        return inst.labels.list_generators()

    # --- tenant-management (instance/grpc/tenant analog) ------------------
    def create_tenant(token: str, name: str, datasetTemplate: str = "empty",
                      authorizedUsers: list = None):
        return entity_json(inst.tenants.create_tenant(
            token, name, dataset_template=datasetTemplate,
            authorized_users=authorizedUsers))

    def get_tenant_by_token(token: str):
        t = inst.tenants.tenants.try_get(token)
        return entity_json(t) if t is not None else None

    def list_tenants(page: int = 1, pageSize: int = 100):
        return paged_json(inst.tenants.tenants.list(
            page=page, page_size=pageSize))

    def authorize_tenant_user(token: str, username: str):
        return entity_json(inst.tenants.authorize_user(token, username))

    # --- user-management (instance/grpc/user analog) ----------------------
    def _user_json(u):
        return {"username": u.username, "roles": u.roles,
                "enabled": u.enabled, "firstName": u.first_name,
                "lastName": u.last_name, "email": u.email}

    def create_user(username: str, password: str, roles: list = None,
                    firstName: str = "", lastName: str = "",
                    email: str = ""):
        return _user_json(inst.users.create_user(
            username, password, roles=roles, first_name=firstName,
            last_name=lastName, email=email))

    def get_user_by_username(username: str):
        u = inst.users.users.get(username)
        return _user_json(u) if u is not None else None

    def list_users():
        return [_user_json(u) for u in inst.users.users.values()]

    def update_user(username: str, password: str = None, roles: list = None,
                    enabled: bool = None):
        return _user_json(inst.users.update_user(
            username, password=password, roles=roles, enabled=enabled))

    def delete_user(username: str):
        return {"deleted": inst.users.delete_user(username)}

    def add_user_roles(username: str, roles: list):
        return _user_json(inst.users.add_roles(username, roles))

    def remove_user_roles(username: str, roles: list):
        return _user_json(inst.users.remove_roles(username, roles))

    def get_authorities_for_user(username: str):
        u = inst.users.users.get(username)
        return inst.users.authorities_for(u) if u is not None else None

    # --- cluster health/replication posture (rank-local, no fan-out) ------
    def cluster_health():
        from sitewhere_tpu_torch.parallel.replication import (
            cluster_health_payload)

        return cluster_health_payload(inst.engine)

    async def cluster_metrics():
        """The federated exposition over the instance control plane —
        the same rank-labeled payload REST serves at
        /api/instance/cluster/metrics. OFF-LOOP: on a clustered engine
        this fans out over blocking peer RPC, and run_rank serves the
        instance RPC on the SAME loop as the rank's cluster RPC server
        — a synchronous handler here would block that loop exactly like
        deployment rule 1 (parallel/cluster.py) warns, deadlocking two
        ranks that scrape each other."""
        from sitewhere_tpu_torch.utils.metrics import federated_exposition

        return await asyncio.to_thread(federated_exposition, inst.engine)

    async def device_memory():
        """Device-plane memory ledger + compile posture —
        the RPC twin of GET /api/instance/device/memory. Off-loop: the
        ledger walks live arrays and archive caches."""
        from sitewhere_tpu_torch.utils.devicewatch import device_memory_payload

        return await asyncio.to_thread(device_memory_payload, inst.engine)

    async def conservation():
        """Conservation ledger + audit verdict — the RPC
        twin of GET /api/instance/conservation. Off-loop: the ledger
        reads device counters (and a cluster facade fans out)."""
        from sitewhere_tpu_torch.utils.conservation import conservation_payload

        fn = getattr(inst.engine, "conservation", None)
        if callable(fn):
            return await asyncio.to_thread(fn)
        return await asyncio.to_thread(conservation_payload, inst.engine,
                                       inst.rules)

    async def spmd_heat():
        """Shard heat & skew posture — the RPC twin of GET
        /api/instance/spmd/heat. Off-loop: the harvest reads the device
        counter grid (and a cluster facade fans out)."""
        from sitewhere_tpu_torch.utils.shardobs import spmd_heat_payload

        fn = getattr(inst.engine, "spmd_heat", None)
        if callable(fn):
            return await asyncio.to_thread(fn)
        return await asyncio.to_thread(spmd_heat_payload, inst.engine)

    async def placement():
        """Elastic-placement posture — the RPC twin of GET
        /api/instance/placement. Off-loop: the payload takes the
        manager lock."""
        pm = getattr(inst.engine, "placement", None)
        if pm is None:
            return {"clustered": False}
        return await asyncio.to_thread(pm.payload)

    # --- streaming rules & rollups (RPC twins of /api/rules) ------------
    async def rules_status():
        return await asyncio.to_thread(inst.rules.status)

    async def rules_set(ruleSet: dict):
        # validate+lower+AOT-compile off-loop; RuleSetError propagates as
        # a typed RPC error with the active set untouched
        return await asyncio.to_thread(inst.rules.load, ruleSet)

    async def rules_poll(flush: bool = True):
        return await asyncio.to_thread(inst.rules.poll, bool(flush))

    async def rules_rollup(name: str, group: str = None,
                           pageSize: int = 100):
        from sitewhere_tpu_torch.ops.query import clamp_page_size

        return await asyncio.to_thread(inst.rules.read_rollup, name,
                                       group, clamp_page_size(pageSize))

    async def analytics(action: str = "status", jobId: str = None,
                        spec: dict = None, wait: bool = False):
        """Historical scoring jobs — the RPC twin of the
        /api/analytics family. ``action``: "status" (all jobs, or one
        when ``jobId`` is given), "score" (start a job from ``spec`` —
        AnalyticsJobSpec field names; ``wait`` runs it to completion),
        or "cancel". Off-loop: a waited job streams the archive."""
        aj = inst.analytics_jobs
        if action == "status":
            return await asyncio.to_thread(aj.status, jobId)
        if action == "score":
            fn = aj.run_job if wait else aj.start_job
            return await asyncio.to_thread(fn, dict(spec or {}))
        if action == "cancel":
            if not jobId:
                raise ValueError("cancel requires jobId")
            return {"cancelled": bool(
                await asyncio.to_thread(aj.cancel, jobId))}
        raise ValueError(f"unknown analytics action {action!r}")

    families: dict[str, Handler] = {
        "DeviceManagement.getDeviceByToken": get_device_by_token,
        "DeviceManagement.createDevice": create_device,
        "DeviceManagement.updateDevice": update_device,
        "DeviceManagement.deleteDevice": delete_device,
        "DeviceManagement.listDevices": list_devices,
        "DeviceManagement.getDeviceSummary": get_device_summary,
        "DeviceManagement.getActiveAssignments": get_active_assignments,
        "DeviceManagement.createDeviceType": create_device_type,
        "DeviceManagement.listDeviceTypes": list_device_types,
        "DeviceManagement.createDeviceStatus": create_device_status,
        "DeviceManagement.listDeviceStatuses": list_device_statuses,
        "DeviceManagement.createDeviceCommand": create_device_command,
        "DeviceManagement.listDeviceCommands": list_device_commands,
        "DeviceManagement.createDeviceAlarm": create_alarm,
        "DeviceManagement.acknowledgeDeviceAlarm": acknowledge_alarm,
        "DeviceManagement.resolveDeviceAlarm": resolve_alarm,
        "DeviceManagement.listDeviceAlarms": list_alarms,
        "DeviceManagement.createCustomerType": create_customer_type,
        "DeviceManagement.createCustomer": create_customer,
        "DeviceManagement.getCustomerTree": customer_tree,
        "DeviceManagement.createAreaType": create_area_type,
        "DeviceManagement.createArea": create_area,
        "DeviceManagement.getAreaTree": area_tree,
        "DeviceManagement.createZone": create_zone,
        "DeviceManagement.listZones": list_zones,
        "DeviceManagement.createDeviceGroup": create_device_group,
        "DeviceManagement.addDeviceGroupElements": add_device_group_elements,
        "DeviceManagement.listDeviceGroupElements":
            list_device_group_elements,
        "DeviceEventManagement.listDeviceEvents": list_device_events,
        "DeviceEventManagement.addDeviceEvent": add_device_event,
        "DeviceEventManagement.getDeviceEventById": get_event_by_id,
        "DeviceState.getDeviceState": get_device_state,
        "DeviceState.searchDeviceStates": search_device_states,
        "AssetManagement.createAssetType": create_asset_type,
        "AssetManagement.createAsset": create_asset,
        "AssetManagement.getAssetByToken": get_asset_by_token,
        "AssetManagement.listAssets": list_assets,
        "BatchManagement.createBatchCommandInvocation":
            create_batch_command_invocation,
        "BatchManagement.getBatchOperation": get_batch_operation,
        "BatchManagement.listBatchOperations": list_batch_operations,
        "BatchManagement.listBatchElements": list_batch_elements,
        "ScheduleManagement.createSchedule": create_schedule,
        "ScheduleManagement.listSchedules": list_schedules,
        "ScheduleManagement.createScheduledJob": create_scheduled_job,
        "ScheduleManagement.listScheduledJobs": list_scheduled_jobs,
        "LabelGeneration.getLabel": get_label,
        "LabelGeneration.listGenerators": list_label_generators,
        "Instance.clusterHealth": cluster_health,
        "Instance.clusterMetrics": cluster_metrics,
        "Instance.deviceMemory": device_memory,
        "Instance.conservation": conservation,
        "Instance.spmdHeat": spmd_heat,
        "Instance.placement": placement,
        "Instance.analytics": analytics,
        "Rules.getStatus": rules_status,
        "Rules.setRuleSet": rules_set,
        "Rules.poll": rules_poll,
        "Rules.readRollup": rules_rollup,
    }
    tenant_admin: dict[str, Handler] = {
        "TenantManagement.createTenant": create_tenant,
        "TenantManagement.getTenantByToken": get_tenant_by_token,
        "TenantManagement.listTenants": list_tenants,
        "TenantManagement.authorizeUser": authorize_tenant_user,
    }
    user_admin: dict[str, Handler] = {
        "UserManagement.createUser": create_user,
        "UserManagement.getUserByUsername": get_user_by_username,
        "UserManagement.listUsers": list_users,
        "UserManagement.updateUser": update_user,
        "UserManagement.deleteUser": delete_user,
        "UserManagement.addRoles": add_user_roles,
        "UserManagement.removeRoles": remove_user_roles,
        "UserManagement.getAuthoritiesForUser": get_authorities_for_user,
    }
    for name, fn in families.items():
        srv.register(name, fn)
    for name, fn in tenant_admin.items():
        srv.register(name, fn, authority=AUTH_ADMINISTER_TENANTS)
    for name, fn in user_admin.items():
        srv.register(name, fn, authority=AUTH_ADMINISTER_USERS)
    return srv
