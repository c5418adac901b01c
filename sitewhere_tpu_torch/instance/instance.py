"""SiteWhereTpuInstance: the composition root (port of
``sitewhere_tpu/instance/instance.py``) — one object wiring every service
the reference deploys as separate microservices: engine (ingest pipeline +
device state + event store), device/asset management, command delivery,
outbound connectors, batch operations, scheduling, labels, streams, event
search, users/tenants/JWT, and the REST gateway (web/rest.py). One engine
on the card, plus host services sharing it.

The engine is the port's ``Engine`` on ``device`` (the card unless the
caller asks for the CPU); a pre-built engine brings its own device.
"""

from __future__ import annotations

import dataclasses

from sitewhere_tpu_torch.compat import DEFAULT_DEVICE
from sitewhere_tpu_torch.commands.routing import CommandRegistry, SingleChoiceCommandRouter
from sitewhere_tpu_torch.commands.service import CommandDeliveryService
from sitewhere_tpu_torch.connectors.base import ConnectorHost, OutboundConnector
from sitewhere_tpu_torch.connectors.impl import SearchIndexConnector
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.sources import EventSourcesManager, InboundEventSource
from sitewhere_tpu_torch.ingest.wire_edge import WireEdge, WireEdgeConfig
from sitewhere_tpu_torch.instance.auth import JwtService, UserManagement
from sitewhere_tpu_torch.instance.tenants import TenantManagement
from sitewhere_tpu_torch.labels.manager import LabelGeneratorManager
from sitewhere_tpu_torch.management.assets import AssetManagement
from sitewhere_tpu_torch.management.batch import (
    BatchCommandInvocationHandler,
    BatchOperationManager,
)
from sitewhere_tpu_torch.management.device_management import DeviceManagement
from sitewhere_tpu_torch.management.schedule import (
    ScheduleManager,
    batch_command_by_criteria_executor,
    command_invocation_executor,
)
from sitewhere_tpu_torch.management.streams import DeviceStreamManager
from sitewhere_tpu_torch.search.index import EventSearchIndex, SearchProviderManager
from sitewhere_tpu_torch.utils.lifecycle import LifecycleComponent


@dataclasses.dataclass
class InstanceConfig:
    instance_id: str = "sitewhere-tpu"
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    jwt_expiration_s: int = 60 * 60 * 24
    admin_username: str = "admin"
    admin_password: str = "password"
    index_events: bool = True
    script_root: str | None = None   # versioned tenant-script store dir;
                                     # None -> per-instance temp dir
    conservation_audit_s: float = 5.0  # background conservation-audit
                                       # cadence; the thread
                                       # runs only between start() and
                                       # stop(). 0 disables the thread —
                                       # GET /api/instance/conservation
                                       # still audits on demand
    wire_edge: "WireEdgeConfig | None" = None
                                       # persistent-connection listeners:
                                       # MQTT/SWP/websocket
                                       # sockets feeding staging arenas.
                                       # None = request-response only


class SiteWhereTpuInstance(LifecycleComponent):
    def __init__(self, config: InstanceConfig | None = None, engine=None,
                 device=DEFAULT_DEVICE):
        """``engine`` may be a pre-built engine — in particular a
        DistributedEngine, so the whole product surface (REST, outbound
        feeds, command delivery, management) serves from the sharded mesh
        state instead of the single-node engine. Without one, the engine
        is built on ``device``; with no GPU, pass ``device="cpu"``."""
        super().__init__("sitewhere-tpu-instance")
        self.config = config or InstanceConfig()
        self.engine = (engine if engine is not None
                       else Engine(self.config.engine, device=device))

        # ingest edge: device-initiated stream commands peel off to the
        # stream service (reference routes them through the device command
        # path, DeviceStreamManager.java:36-80); everything else hits the
        # engine's staging path
        self.event_sources = EventSourcesManager(
            on_event_request=self._route_device_request,
            on_registration_request=self.engine.process,
        )
        self.add_child(self.event_sources)

        # persistent-connection wire edge: socket listeners
        # feeding staging arenas. The event-sources manager inherits the
        # edge's first batcher, so CoAP/socket/polling receivers with a
        # batchable decoder ride the SAME arrival windows as the live
        # MQTT/SWP connections. Note batched sources bypass the stream-
        # command peel-off (_route_device_request) — sources that need it
        # must keep a host-side deduplicator or a non-batchable decoder.
        self.wire_edge: WireEdge | None = None
        if self.config.wire_edge is not None:
            self.wire_edge = WireEdge(self.engine, self.config.wire_edge)
            self.event_sources.batcher = self.wire_edge.batchers[0]

        # management services
        self.device_management = DeviceManagement(self.engine)
        self.assets = AssetManagement()
        self.streams = DeviceStreamManager()
        self.labels = LabelGeneratorManager()

        # downlink
        self.command_registry = CommandRegistry()
        self.commands = CommandDeliveryService(
            self.engine, SingleChoiceCommandRouter("default"),
            self.command_registry,
        )
        self.add_child(self.commands)
        # cluster-backed engines route invocations to the owning rank's
        # service (see ClusterEngine.route_invocation); the hook gives
        # the rank's RPC server a path to OUR pending set
        attach_cmd = getattr(self.engine, "attach_command_service", None)
        if attach_cmd is not None:
            attach_cmd(self.commands)

        # batch + scheduling
        self.batch = BatchOperationManager()
        self.batch.register_handler(BatchCommandInvocationHandler(self.commands))
        self.scheduler = ScheduleManager()
        # schedule fires record spans on the engine's tracer
        self.scheduler.tracer = getattr(self.engine, "tracer", None)
        self.scheduler.register_executor(
            "CommandInvocation", command_invocation_executor(self.commands)
        )
        self.scheduler.register_executor(
            "BatchCommandByCriteria",
            batch_command_by_criteria_executor(self.device_management, self.batch),
        )

        # search
        self.search = SearchProviderManager()
        self.search_index = EventSearchIndex()
        self.search.add_provider("embedded", self.search_index)
        # a cluster-backed engine fans search out over every rank's index
        # (all replicas feeding one Solr, reference-style): the cluster
        # provider REPLACES "embedded" so REST stays a pure provider
        # lookup; plain engines keep the single-index provider
        attach = getattr(self.engine, "attach_search_index", None)
        if attach is not None:
            from sitewhere_tpu_torch.parallel.cluster import ClusterSearchProvider

            attach(self.search_index)
            self.search.add_provider(
                "embedded", ClusterSearchProvider(self.engine,
                                                  self.search_index))
        self.connector_hosts: list[ConnectorHost] = []
        if self.config.index_events:
            self.add_connector(SearchIndexConnector("search-index", self.search_index))

        # geofencing: zone entry/exit alerts over the location feed
        from sitewhere_tpu_torch.outbound.zones import ZoneMonitor

        self.zone_monitor = ZoneMonitor(self.engine, self.device_management)
        self.add_child(self.zone_monitor)

        # streaming rules / continuous rollups: inert until a rule set is
        # installed via REST/RPC, the tenant config's "streamingRules"
        # section, or a watched file
        from sitewhere_tpu_torch.rules import RulesManager

        self.rules = RulesManager(self.engine)

        # event conservation audit plane: always-on invariant
        # checking while the instance runs. Constructed here (so REST
        # and the debug bundle can serve its posture immediately) but
        # the thread only spins between start() and stop().
        from sitewhere_tpu_torch.utils.conservation import ConservationAuditor

        self.conservation_auditor = ConservationAuditor(
            self.engine, rules_manager=self.rules,
            interval_s=self.config.conservation_audit_s or 5.0)

        # device-initiated stream commands -> stream store + downlink acks
        from sitewhere_tpu_torch.management.streams import DeviceStreamService

        self.stream_service = DeviceStreamService(self.streams, self.commands)

        # analytics (service-tpu-analytics analog) — live when the engine
        # carries telemetry windows on its device
        self.analytics = None
        if self.config.engine.analytics_devices > 0:
            from sitewhere_tpu_torch.models.service import AnalyticsService

            self.analytics = AnalyticsService(self.engine)

        # fleet-scale historical analytics: archive->device
        # batched scoring jobs. Host-side manager is always constructed
        # (jobs fail fast without an archive) so the
        # REST/RPC job surface, the swtpu_analytics_* scrape series, and
        # the analytics-windows conservation stage exist on every
        # instance; it reuses the live service's model when one is up.
        from sitewhere_tpu_torch.models.analytics import AnalyticsManager

        self.analytics_jobs = AnalyticsManager(self.engine,
                                               service=self.analytics)

        # versioned tenant scripts (Instance.java scripting REST family);
        # activation rewrites active.py, which scripted components bind
        # through the hot-reloading ScriptManager
        import tempfile

        from sitewhere_tpu_torch.utils.scripting import (
            DEFAULT_MANAGER,
            ScriptManagement,
        )

        self._scripts_tmpdir = None
        if self.config.script_root is None:
            # ephemeral store for embedded instances — removed on stop(),
            # and by GC/interpreter-exit for instances that never run the
            # lifecycle (tests, short-lived embedding)
            import shutil
            import weakref

            self._scripts_tmpdir = tempfile.mkdtemp(prefix="swtpu-scripts-")
            self._scripts_finalizer = weakref.finalize(
                self, shutil.rmtree, self._scripts_tmpdir,
                ignore_errors=True)
        self.scripts = ScriptManagement(
            self.config.script_root or self._scripts_tmpdir,
            manager=DEFAULT_MANAGER)

        # auth + tenants
        self.users = UserManagement()
        self.users.create_user(self.config.admin_username,
                               self.config.admin_password, roles=["admin"])
        self.jwt = JwtService(expiration_s=self.config.jwt_expiration_s,
                              issuer=self.config.instance_id)
        self.tenants = TenantManagement(self.engine, self.device_management)
        self.tenants.create_tenant("default", "Default Tenant")

        # per-tenant applied component graphs (config.py hot-reload state):
        # tenant -> {"config": dict, "summary": dict}
        self.tenant_configs: dict[str, dict] = {}

        # extra readiness fields served on the public health route
        # (run_rank fills in rank/peers/ports once the rank can serve)
        self.health_extra: dict = {}

    async def on_start(self) -> None:
        if self.config.conservation_audit_s:
            self.conservation_auditor.start()
        if self.wire_edge is not None:
            await self.wire_edge.start()

    async def on_stop(self) -> None:
        # children (event sources) have already stopped; draining the
        # edge last flushes the shared arrival windows they fed
        if self.wire_edge is not None:
            await self.wire_edge.stop()
        self.conservation_auditor.stop()
        if self._scripts_tmpdir is not None:
            import shutil

            shutil.rmtree(self._scripts_tmpdir, ignore_errors=True)
            self._scripts_tmpdir = None

    # --- wiring helpers ---------------------------------------------------
    def add_source(self, source: InboundEventSource) -> InboundEventSource:
        return self.event_sources.add_source(source)

    def _route_device_request(self, req) -> None:
        """Ingest dispatch: stream commands to the stream service,
        everything else to the engine."""
        if self.stream_service.handles(req):
            self.stream_service.handle_request(req)
        else:
            self.engine.process(req)

    def add_connector(self, connector: OutboundConnector,
                      start_from_latest: bool = False) -> ConnectorHost:
        host = ConnectorHost(self.engine, connector,
                             start_from_latest=start_from_latest)
        self.connector_hosts.append(host)
        self.add_child(host)
        return host

    async def pump_outbound(self) -> int:
        """Drive command delivery + all connector hosts once (embedded mode;
        under the REST server these run as background tasks)."""
        n = await self.commands.pump()
        n += await self.zone_monitor.pump()
        for host in self.connector_hosts:
            n += await host.pump()
        return n

    def info(self) -> dict:
        return {
            "instanceId": self.config.instance_id,
            "version": __import__("sitewhere_tpu_torch").__version__,
            "devices": len(self.engine.devices),
            "tenants": len(self.tenants.tenants),
            "metrics": self.engine.metrics(),
            "components": self.describe(),
        }
