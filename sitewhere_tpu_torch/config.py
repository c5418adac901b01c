"""Configuration system: JSON tenant config -> component graphs.

The reference parses per-tenant JSON into component graphs with hand-written
parsers over generic ``{type, id, configuration}`` wrappers
(EventSourcesParser.java:50-126, CommandDestinationsParser,
OutboundConnectorsParser). Same model here: declarative JSON
describing event sources (receiver + decoder + deduplicator), outbound
connectors (type + filters), and command destinations/routers, materialized
by registered factory functions. The config plane is plain JSON files/dicts
instead of ZooKeeper/k8s CRDs.

Example::

    {
      "eventSources": [
        {"id": "mqtt-in", "type": "mqtt",
         "decoder": {"type": "json"},
         "deduplicator": {"type": "alternate-id"},
         "configuration": {"host": "127.0.0.1", "port": 1883,
                            "topic": "sitewhere/input/#"}}
      ],
      "outboundConnectors": [
        {"id": "audit", "type": "inmemory",
         "filters": [{"type": "device-type", "operation": "include",
                       "deviceTypes": ["thermostat"]}]}
      ],
      "commandRouting": {
        "router": {"type": "single-choice", "destination": "default-mqtt"},
        "destinations": [
          {"id": "default-mqtt", "type": "mqtt",
           "encoder": {"type": "json"},
           "configuration": {"host": "127.0.0.1", "port": 1883}}
        ]
      }
    }
"""

from __future__ import annotations

import json
import pathlib
from typing import Any, Callable

from sitewhere_tpu_torch.commands.destinations import (
    CommandDestination,
    CoapDeliveryProvider,
    LocalDeliveryProvider,
    MqttDeliveryProvider,
    SmsDeliveryProvider,
    coap_metadata_extractor,
    mqtt_topic_extractor,
    sms_phone_extractor,
)
from sitewhere_tpu_torch.commands.encoders import (
    BinaryCommandExecutionEncoder,
    JsonCommandExecutionEncoder,
    JsonStringCommandExecutionEncoder,
)
from sitewhere_tpu_torch.commands.routing import (
    DeviceTypeMappingCommandRouter,
    NoOpCommandRouter,
    SingleChoiceCommandRouter,
)
from sitewhere_tpu_torch.connectors.base import AreaFilter, DeviceTypeFilter
from sitewhere_tpu_torch.connectors.impl import (
    HttpConnector,
    InMemoryConnector,
    LogConnector,
    MqttConnector,
)
from sitewhere_tpu_torch.ingest.decoders import (
    BinaryEventDecoder,
    EchoStringDecoder,
    JsonBatchEventDecoder,
    JsonDeviceRequestDecoder,
)
from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator
from sitewhere_tpu_torch.ingest.sources import (
    InboundEventSource,
    InMemoryEventReceiver,
    PollingRestReceiver,
    SocketEventReceiver,
    WebSocketEventReceiver,
)


class ConfigError(ValueError):
    pass


def _scripted_decoder(cfg: dict):
    from sitewhere_tpu_torch.ingest.decoders import ScriptedDecoder
    from sitewhere_tpu_torch.utils.scripting import script_handle

    return ScriptedDecoder(script_handle(cfg, "decode"))


def _scripted_deduplicator(cfg: dict):
    from sitewhere_tpu_torch.ingest.dedup import ScriptedDeduplicator
    from sitewhere_tpu_torch.utils.scripting import script_handle

    return ScriptedDeduplicator(script_handle(cfg, "is_duplicate"))


DECODERS: dict[str, Callable[[dict], Any]] = {
    "json": lambda cfg: JsonDeviceRequestDecoder(),
    "json-batch": lambda cfg: JsonBatchEventDecoder(),
    "binary": lambda cfg: BinaryEventDecoder(),
    "protobuf": lambda cfg: BinaryEventDecoder(),  # flat-binary replaces GPB
    "echo": lambda cfg: EchoStringDecoder(),
    "scripted": _scripted_decoder,
}

DEDUPLICATORS: dict[str, Callable[[dict], Any]] = {
    "alternate-id": lambda cfg: AlternateIdDeduplicator(
        capacity=cfg.get("capacity", 1 << 16)),
    "scripted": _scripted_deduplicator,
}

RECEIVERS: dict[str, Callable[[dict], Any]] = {
    "inmemory": lambda cfg: InMemoryEventReceiver(cfg.get("name", "inmemory")),
    "socket": lambda cfg: SocketEventReceiver(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 0),
        framing=cfg.get("framing", "read_all")),
    "websocket": lambda cfg: WebSocketEventReceiver(
        host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 0)),
    "rest-poll": lambda cfg: PollingRestReceiver(
        cfg["url"], interval_s=cfg.get("intervalS", 10.0),
        headers=cfg.get("headers")),
}


def _mqtt_receiver(cfg: dict):
    from sitewhere_tpu_torch.ingest.mqtt import MqttEventReceiver

    return MqttEventReceiver(
        cfg.get("host", "127.0.0.1"), cfg["port"],
        topic=cfg.get("topic", "sitewhere/input/#"), qos=cfg.get("qos", 0),
        username=cfg.get("username"), password=cfg.get("password"),
    )


def _coap_receiver(cfg: dict):
    from sitewhere_tpu_torch.ingest.coap import CoapServerEventReceiver

    return CoapServerEventReceiver(cfg.get("host", "127.0.0.1"),
                                   cfg.get("port", 0))


RECEIVERS["mqtt"] = _mqtt_receiver
RECEIVERS["coap"] = _coap_receiver


def build_event_source(spec: dict) -> InboundEventSource:
    """One {id, type, decoder, deduplicator, configuration} wrapper ->
    InboundEventSource (EventSourcesParser analog)."""
    sid = spec.get("id")
    if not sid:
        raise ConfigError("event source requires an id")
    rtype = spec.get("type")
    if rtype not in RECEIVERS:
        raise ConfigError(f"unknown event source type {rtype!r} "
                          f"(known: {sorted(RECEIVERS)})")
    receiver = RECEIVERS[rtype](spec.get("configuration", {}))
    dspec = spec.get("decoder", {"type": "json"})
    if dspec.get("type") not in DECODERS:
        raise ConfigError(f"unknown decoder type {dspec.get('type')!r}")
    decoder = DECODERS[dspec["type"]](dspec)
    dedup = None
    ddspec = spec.get("deduplicator")
    if ddspec is not None:
        if ddspec.get("type") not in DEDUPLICATORS:
            raise ConfigError(f"unknown deduplicator type {ddspec.get('type')!r}")
        dedup = DEDUPLICATORS[ddspec["type"]](ddspec)
    return InboundEventSource(sid, decoder, [receiver], dedup,
                              tenant=spec.get("tenant", "default"))


def build_filters(specs: list[dict], engine) -> list:
    out = []
    for f in specs or []:
        ftype = f.get("type")
        if ftype == "area":
            out.append(AreaFilter(f.get("areaIds", []),
                                  f.get("operation", "include")))
        elif ftype == "device-type":
            out.append(DeviceTypeFilter(engine, f.get("deviceTypes", []),
                                        f.get("operation", "include")))
        elif ftype == "scripted":
            from sitewhere_tpu_torch.connectors.base import ScriptedFilter
            from sitewhere_tpu_torch.utils.scripting import script_handle

            out.append(ScriptedFilter(script_handle(f, "is_excluded")))
        else:
            raise ConfigError(f"unknown filter type {ftype!r}")
    return out


def build_connector(spec: dict, engine):
    """{id, type, filters, configuration} -> OutboundConnector
    (OutboundConnectorsParser analog)."""
    cid = spec.get("id")
    ctype = spec.get("type")
    cfg = spec.get("configuration", {})
    filters = build_filters(spec.get("filters"), engine)
    if ctype == "log":
        return LogConnector(cid, filters)
    if ctype == "inmemory":
        return InMemoryConnector(cid, filters)
    if ctype == "mqtt":
        return MqttConnector(cid, cfg.get("host", "127.0.0.1"), cfg["port"],
                             topic_pattern=cfg.get(
                                 "topic", "sitewhere/outbound/{token}"),
                             qos=cfg.get("qos", 0), filters=filters)
    if ctype == "http":
        uri = cfg["uri"]
        payload_builder = None
        if isinstance(uri, dict):       # scripted uri-builder template
            from sitewhere_tpu_torch.utils.scripting import script_handle

            uri = script_handle(uri, "uri")
        if "payloadBuilder" in cfg:     # scripted payload-builder template
            from sitewhere_tpu_torch.utils.scripting import script_handle

            payload_builder = script_handle(cfg["payloadBuilder"], "payload")
        return HttpConnector(cid, uri, payload_builder=payload_builder,
                             headers=cfg.get("headers"),
                             method=cfg.get("method", "POST"), filters=filters)
    if ctype == "scripted":
        from sitewhere_tpu_torch.connectors.impl import ScriptedConnector
        from sitewhere_tpu_torch.utils.scripting import script_handle

        return ScriptedConnector(cid, script_handle(cfg, "process_event"),
                                 filters=filters)
    raise ConfigError(f"unknown connector type {ctype!r}")


def _scripted_encoder(cfg: dict):
    from sitewhere_tpu_torch.commands.encoders import ScriptedCommandExecutionEncoder
    from sitewhere_tpu_torch.utils.scripting import script_handle

    return ScriptedCommandExecutionEncoder(script_handle(cfg, "encode"))


ENCODERS = {
    "json": lambda cfg: JsonCommandExecutionEncoder(),
    "json-string": lambda cfg: JsonStringCommandExecutionEncoder(),
    "binary": lambda cfg: BinaryCommandExecutionEncoder(),
    "protobuf": lambda cfg: BinaryCommandExecutionEncoder(),
    "scripted": _scripted_encoder,
}


def build_destination(spec: dict) -> CommandDestination:
    """{id, type, encoder, configuration} -> CommandDestination
    (CommandDestinationsParser analog)."""
    did = spec.get("id")
    dtype = spec.get("type")
    cfg = spec.get("configuration", {})
    espec = spec.get("encoder", {"type": "json"})
    if espec.get("type") not in ENCODERS:
        raise ConfigError(f"unknown encoder type {espec.get('type')!r}")
    encoder = ENCODERS[espec["type"]](espec)
    if dtype == "mqtt":
        provider = MqttDeliveryProvider(cfg.get("host", "127.0.0.1"),
                                        cfg["port"], qos=cfg.get("qos", 1))
        extractor = mqtt_topic_extractor(
            cfg.get("commandTopic", "sitewhere/commands/{token}"),
            cfg.get("systemTopic", "sitewhere/system/{token}"))
    elif dtype == "coap":
        provider = CoapDeliveryProvider()
        extractor = coap_metadata_extractor(cfg.get("defaultPort", 5683))
    elif dtype == "sms":
        provider = SmsDeliveryProvider(
            gateway_url=cfg.get("gatewayUrl"), account=cfg.get("account", ""),
            auth_token=cfg.get("authToken", ""),
            from_number=cfg.get("fromNumber", ""))
        extractor = sms_phone_extractor()
    elif dtype == "local":
        provider = LocalDeliveryProvider()
        extractor = mqtt_topic_extractor()
    else:
        raise ConfigError(f"unknown destination type {dtype!r}")
    return CommandDestination(did, extractor, encoder, provider)


def build_router(spec: dict):
    rtype = spec.get("type", "single-choice")
    if rtype == "single-choice":
        return SingleChoiceCommandRouter(spec["destination"])
    if rtype == "device-type-mapping":
        return DeviceTypeMappingCommandRouter(spec.get("mappings", {}),
                                              spec.get("default"))
    if rtype == "noop":
        return NoOpCommandRouter()
    if rtype == "scripted":
        from sitewhere_tpu_torch.commands.routing import ScriptedCommandRouter
        from sitewhere_tpu_torch.utils.scripting import script_handle

        return ScriptedCommandRouter(script_handle(spec, "destinations_for"))
    raise ConfigError(f"unknown router type {rtype!r}")


def apply_tenant_config(instance, config: dict | str | pathlib.Path,
                        tenant: str = "default") -> dict:
    """Materialize a tenant configuration onto a running instance; returns a
    summary of built components. The applied graph is recorded on the
    instance so :func:`reload_tenant_config` can later hot-swap it."""
    if isinstance(config, (str, pathlib.Path)):
        config = json.loads(pathlib.Path(config).read_text())
    summary = {"eventSources": [], "connectors": [], "destinations": []}
    for spec in config.get("eventSources", []):
        source = build_event_source(spec)
        instance.add_source(source)
        summary["eventSources"].append(source.source_id)
    for spec in config.get("outboundConnectors", []):
        connector = build_connector(spec, instance.engine)
        instance.add_connector(connector)
        summary["connectors"].append(connector.connector_id)
    routing = config.get("commandRouting")
    if routing:
        for spec in routing.get("destinations", []):
            dest = build_destination(spec)
            instance.commands.add_destination(dest)
            summary["destinations"].append(dest.destination_id)
        if "router" in routing:
            instance.commands.router = build_router(routing["router"])
    # streaming rules: a "streamingRules" section installs a
    # rule set through the manager's compile-before-swap path, so the
    # tenant-config hot-reload plumbing (file watcher / REST POST) swaps
    # rules with the same discipline as event sources. The rule set is
    # INSTANCE-wide (one manager per engine) — only the "default"
    # tenant's config may carry it, so one tenant's apply can never
    # silently replace another's standing rules
    rules_doc = config.get("streamingRules")
    if rules_doc and hasattr(instance, "rules"):
        if tenant != "default":
            raise ConfigError(
                "streamingRules is instance-wide: configure it on the "
                "'default' tenant (per-tenant scoping goes in each "
                "rule's 'tenant' filter)")
        summary["streamingRules"] = instance.rules.load(rules_doc)
    if hasattr(instance, "tenant_configs"):
        instance.tenant_configs[tenant] = {
            "config": config, "summary": summary,
            # identity of the router THIS config installed (if any), so a
            # later reload can tell whether the live router is ours to
            # retire — never serialized to REST (only config/summary are)
            "router_obj": (instance.commands.router
                           if routing and "router" in routing else None),
        }
    return summary


# --------------------------------------------------------------------------
# Tenant config hot-reload (reference: ZooKeeper/k8s CRD watches rebuild a
# tenant's component graph live — README "Centralized Configuration
# Management"; parsers EventSourcesParser.java:50-126). Here a POST to the
# configuration endpoint (web/rest.py) or a file watcher swaps the graph:
# old sources/connectors/destinations stop and detach, the new config
# materializes through the same factories, and — when the instance is
# already running — the new components initialize+start immediately, so the
# very next ingest uses the new decoders with no restart.
# --------------------------------------------------------------------------


async def _stop_quietly(component) -> None:
    """Stop a component being retired; a failing stop (e.g. unreachable
    broker) must never abort the swap — the component is going away
    regardless."""
    import logging

    try:
        await component.stop()
    except Exception:
        logging.getLogger(__name__).exception(
            "stop of retired component %s failed (continuing teardown)",
            getattr(component, "name", component))


async def teardown_tenant_components(instance, entry: dict) -> None:
    """Stop + detach the components a previous apply built. ``entry`` is a
    tenant_configs record ({summary, router_obj, ...}); a bare summary dict
    also works (no router handling)."""
    summary = entry.get("summary", entry)
    mgr = instance.event_sources
    for sid in summary.get("eventSources", []):
        src = mgr.sources.pop(sid, None)
        if src is None:
            continue
        if src in mgr.children:
            mgr.children.remove(src)
        await _stop_quietly(src)
    for cid in summary.get("connectors", []):
        host = next((h for h in instance.connector_hosts
                     if h.connector.connector_id == cid), None)
        if host is None:
            continue
        instance.connector_hosts.remove(host)
        if host in instance.children:
            instance.children.remove(host)
        await _stop_quietly(host)
    for did in summary.get("destinations", []):
        dest = instance.commands.destinations.pop(did, None)
        if dest is None:
            continue
        if dest in instance.commands.children:
            instance.commands.children.remove(dest)
        await _stop_quietly(dest)
    # if the live router is the one THIS config installed and the
    # replacement config doesn't bring its own, retire it too — a stale
    # router would route every invocation at the just-removed destinations
    router_obj = entry.get("router_obj")
    if router_obj is not None and instance.commands.router is router_obj:
        instance.commands.router = NoOpCommandRouter()


async def reload_tenant_config(instance, config: dict | str | pathlib.Path,
                               tenant: str = "default") -> dict:
    """Hot-swap one tenant's component graph on a RUNNING instance.

    The previous graph for ``tenant`` (if any) stops and detaches first;
    the new one builds through the normal factories and, if the instance
    is live, starts before this returns. A config error raises BEFORE the
    old graph is torn down (validate-then-swap), so a bad push never
    leaves the tenant without components."""
    from sitewhere_tpu_torch.utils.lifecycle import LifecycleStatus

    if isinstance(config, (str, pathlib.Path)):
        config = json.loads(pathlib.Path(config).read_text())

    # validate: build everything BEFORE touching the live graph (bad specs
    # raise here). Sources get materialized twice (cheap, host-side only)
    # because ids must be free at add time.
    for spec in config.get("eventSources", []):
        build_event_source(spec)
    for spec in config.get("outboundConnectors", []):
        build_connector(spec, instance.engine)
    routing = config.get("commandRouting") or {}
    for spec in routing.get("destinations", []):
        build_destination(spec)
    if "router" in routing:
        build_router(routing["router"])
    if config.get("streamingRules"):
        from sitewhere_tpu_torch.rules import RuleSet, RuleSetError

        if tenant != "default":
            raise ConfigError(
                "streamingRules is instance-wide: configure it on the "
                "'default' tenant")
        try:
            RuleSet.parse(config["streamingRules"])
        except RuleSetError as e:
            raise ConfigError(f"streamingRules: {e}") from e

    # id collisions would raise MID-apply (after teardown) — reject them
    # while the old graph is still whole. An id is free if it is unused or
    # belongs to THIS tenant's outgoing graph.
    prev = instance.tenant_configs.get(tenant)
    prev_sum = prev["summary"] if prev else {}

    def _check_ids(kind: str, new_ids: list[str], live: set[str]) -> None:
        dup = {i for i in new_ids if new_ids.count(i) > 1}
        if dup:
            raise ConfigError(f"duplicate {kind} ids {sorted(dup)}")
        clash = (set(new_ids) & live) - set(prev_sum.get(kind, []))
        if clash:
            raise ConfigError(
                f"{kind} ids {sorted(clash)} already in use by another tenant")

    _check_ids("eventSources",
               [s.get("id") for s in config.get("eventSources", [])],
               set(instance.event_sources.sources))
    _check_ids("connectors",
               [c.get("id") for c in config.get("outboundConnectors", [])],
               {h.connector.connector_id for h in instance.connector_hosts})
    _check_ids("destinations",
               [d.get("id") for d in routing.get("destinations", [])],
               set(instance.commands.destinations))

    if prev is not None:
        await teardown_tenant_components(instance, prev)
    summary = apply_tenant_config(instance, config, tenant=tenant)

    if instance.status is LifecycleStatus.STARTED:
        for sid in summary["eventSources"]:
            src = instance.event_sources.sources[sid]
            await src.initialize()
            await src.start()
        for cid in summary["connectors"]:
            host = next(h for h in instance.connector_hosts
                        if h.connector.connector_id == cid)
            await host.initialize()
            await host.start()
    return summary


class TenantConfigWatcher:
    """Polls a config file's mtime and hot-reloads on change — the plain-
    file analog of the reference's ZooKeeper config watch. Drive it with
    ``await check()`` (embedded/test mode) or ``start_background(loop)``."""

    def __init__(self, instance, path: str | pathlib.Path,
                 tenant: str = "default", interval_s: float = 1.0):
        self.instance = instance
        self.path = pathlib.Path(path)
        self.tenant = tenant
        self.interval_s = interval_s
        self._mtime: float | None = None
        self._task = None

    async def check(self) -> bool:
        """Reload if the file changed; returns True when a reload ran."""
        try:
            mtime = self.path.stat().st_mtime
        except OSError:
            return False
        if self._mtime is not None and mtime == self._mtime:
            return False
        if self._mtime is None and self.tenant in self.instance.tenant_configs:
            self._mtime = mtime
            return False   # adopt the startup config's file silently
        # record the mtime only AFTER a successful reload — a torn/bad read
        # must stay retryable on the next tick even if the writer's final
        # flush lands within the same coarse mtime granularity
        await reload_tenant_config(self.instance, self.path, self.tenant)
        self._mtime = mtime
        return True

    def start_background(self, loop=None) -> None:
        import asyncio

        async def run():
            while True:
                try:
                    await self.check()
                except Exception:
                    import logging

                    logging.getLogger(__name__).exception(
                        "tenant config reload failed (keeping old graph)")
                await asyncio.sleep(self.interval_s)

        self._task = (loop or asyncio.get_running_loop()).create_task(run())

    def stop_background(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None
