"""Device management: the registry CRUD surface (port of
``sitewhere_tpu/management/device_management.py``).

Device types, statuses, devices, alarms, customer types and customers,
area types and areas, zones, device groups and their elements, trees. The
hot columns (token -> device row, assignment slots, tenant) live in the
engine's device state: every device write goes to the port's ``Engine``
(``register_device``, ``update_device``, ``delete_device``), and a summary
reads ``get_device_state``, a readback of the card's state on a card
engine. This module owns the rest.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any

from sitewhere_tpu_torch.engine import Engine
from sitewhere_tpu_torch.management.entities import (
    EntityMeta,
    EntityNotFound,
    EntityStore,
    SearchResults,
    TreeNode,
    build_tree,
)


# --- entity dataclasses ------------------------------------------------------


@dataclasses.dataclass
class DeviceType:
    meta: EntityMeta
    name: str
    description: str = ""
    image_url: str = ""
    container_policy: str = "Standalone"  # or "Composite" (nested devices)


@dataclasses.dataclass
class DeviceStatus:
    meta: EntityMeta
    device_type: str
    code: str
    name: str
    background_color: str = "#ffffff"
    foreground_color: str = "#000000"
    border_color: str = "#000000"
    icon: str = ""


class AlarmState(enum.Enum):
    TRIGGERED = "Triggered"
    ACKNOWLEDGED = "Acknowledged"
    RESOLVED = "Resolved"


@dataclasses.dataclass
class DeviceAlarm:
    meta: EntityMeta
    device_token: str
    alarm_message: str
    state: AlarmState = AlarmState.TRIGGERED
    triggered_ms: float = 0.0
    acknowledged_ms: float | None = None
    resolved_ms: float | None = None
    triggering_event_id: int | None = None


@dataclasses.dataclass
class CustomerType:
    meta: EntityMeta
    name: str
    description: str = ""
    icon: str = ""


@dataclasses.dataclass
class Customer:
    meta: EntityMeta
    customer_type: str
    name: str
    parent_token: str | None = None
    description: str = ""
    image_url: str = ""


@dataclasses.dataclass
class AreaType:
    meta: EntityMeta
    name: str
    description: str = ""
    contained_area_types: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Area:
    meta: EntityMeta
    area_type: str
    name: str
    parent_token: str | None = None
    description: str = ""
    address: str = ""
    # zone-style boundary for the area itself
    bounds: list[tuple[float, float]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Zone:
    meta: EntityMeta
    area_token: str
    name: str
    bounds: list[tuple[float, float]]  # lat/lon polygon
    border_color: str = "#ff0000"
    fill_color: str = "#ff0000"
    opacity: float = 0.3


@dataclasses.dataclass
class DeviceGroup:
    meta: EntityMeta
    name: str
    description: str = ""
    roles: list[str] = dataclasses.field(default_factory=list)
    image_url: str = ""


@dataclasses.dataclass
class DeviceGroupElement:
    """Member of a group: a device or a nested group with roles."""

    element_id: int
    group_token: str
    device_token: str | None = None
    nested_group_token: str | None = None
    roles: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DeviceSummary:
    """Device + live status rollup (reference: device summaries list API)."""

    token: str
    device_type: str
    tenant: str
    area: str | None
    customer: str | None
    active_assignments: int
    presence: str | None
    last_interaction_ms: int | None


class DeviceManagement:
    """CRUD facade over the entity stores + the Engine's hot tables."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.device_types: EntityStore[DeviceType] = EntityStore("device-type")
        self.statuses: EntityStore[DeviceStatus] = EntityStore("device-status")
        self.alarms: EntityStore[DeviceAlarm] = EntityStore("device-alarm")
        self.customer_types: EntityStore[CustomerType] = EntityStore("customer-type")
        self.customers: EntityStore[Customer] = EntityStore("customer")
        self.area_types: EntityStore[AreaType] = EntityStore("area-type")
        self.areas: EntityStore[Area] = EntityStore("area")
        self.zones: EntityStore[Zone] = EntityStore("zone")
        self.groups: EntityStore[DeviceGroup] = EntityStore("device-group")
        self._group_elements: dict[str, list[DeviceGroupElement]] = {}
        self._next_element_id = 1
        # fires (group_token, elements) after every membership change —
        # the cluster replicator ships the group's whole element list
        # (group membership is one replicated value, like the reference's
        # group-elements table rows for a group)
        self.on_elements_change = None
        # default type exists from the engine config
        self.create_device_type(engine.config.default_device_type, "Default type")

    # --- device types -----------------------------------------------------
    def create_device_type(self, token: str, name: str, **kw) -> DeviceType:
        return self.device_types.create(
            token, lambda m: DeviceType(meta=m, name=name, **kw)
        )

    # --- devices (delegate hot columns to engine) -------------------------
    def create_device(self, token: str, device_type: str, tenant: str = "default",
                      area: str | None = None, customer: str | None = None,
                      metadata: dict | None = None) -> DeviceSummary:
        if device_type not in self.device_types:
            raise EntityNotFound(f"device-type {device_type!r} not found")
        if area is not None and area not in self.areas:
            raise EntityNotFound(f"area {area!r} not found")
        if customer is not None and customer not in self.customers:
            raise EntityNotFound(f"customer {customer!r} not found")
        self.engine.register_device(token, device_type, tenant, area, customer,
                                    metadata)
        return self.get_device_summary(token)

    def get_device_summary(self, token: str) -> DeviceSummary:
        info = self.engine.get_device(token)
        if info is None:
            raise EntityNotFound(f"device {token!r} not found")
        state = self.engine.get_device_state(token)
        n_active = len([a for a in self.engine.list_assignments(token)
                        if a.status != "RELEASED"]) or 1
        return DeviceSummary(
            token=info.token,
            device_type=info.device_type,
            tenant=info.tenant,
            area=info.area,
            customer=info.customer,
            active_assignments=n_active,
            presence=state["presence"] if state else None,
            last_interaction_ms=state["last_interaction_ms"] if state else None,
        )

    def list_devices(self, page: int = 1, page_size: int = 100,
                     device_type: str | None = None,
                     tenant: str | None = None) -> SearchResults[DeviceSummary]:
        infos = [
            i for i in self.engine.devices.values()
            if (device_type is None or i.device_type == device_type)
            and (tenant is None or i.tenant == tenant)
        ]
        total = len(infos)
        lo = (page - 1) * page_size
        page_infos = infos[lo: lo + page_size]
        out = []
        for i in page_infos:
            try:
                out.append(self.get_device_summary(i.token))
            except EntityNotFound:
                pass
        return SearchResults(out, total, page, page_size)

    def delete_device(self, token: str) -> bool:
        return self.engine.delete_device(token)

    def update_device(self, token: str, device_type: str | None = None,
                      area: str | None = None, customer: str | None = None,
                      metadata: dict | None = None) -> DeviceSummary:
        if device_type is not None and device_type not in self.device_types:
            raise EntityNotFound(f"device-type {device_type!r} not found")
        if area is not None and area not in self.areas:
            raise EntityNotFound(f"area {area!r} not found")
        if customer is not None and customer not in self.customers:
            raise EntityNotFound(f"customer {customer!r} not found")
        try:
            self.engine.update_device(token, device_type, area, customer, metadata)
        except KeyError:
            raise EntityNotFound(f"device {token!r} not found") from None
        return self.get_device_summary(token)

    # --- statuses ---------------------------------------------------------
    def create_device_status(self, token: str, device_type: str, code: str,
                             name: str, **kw) -> DeviceStatus:
        if device_type not in self.device_types:
            raise EntityNotFound(f"device-type {device_type!r} not found")
        return self.statuses.create(
            token, lambda m: DeviceStatus(meta=m, device_type=device_type,
                                          code=code, name=name, **kw)
        )

    def statuses_for_type(self, device_type: str) -> list[DeviceStatus]:
        return self.statuses.list(where=lambda s: s.device_type == device_type).results

    # --- alarms -----------------------------------------------------------
    def create_alarm(self, token: str, device_token: str, message: str,
                     triggering_event_id: int | None = None) -> DeviceAlarm:
        if self.engine.get_device(device_token) is None:
            raise EntityNotFound(f"device {device_token!r} not found")
        return self.alarms.create(
            token,
            lambda m: DeviceAlarm(meta=m, device_token=device_token,
                                  alarm_message=message, triggered_ms=m.created_ms,
                                  triggering_event_id=triggering_event_id),
        )

    def acknowledge_alarm(self, token: str) -> DeviceAlarm:
        import time as _t

        def apply(a: DeviceAlarm) -> None:
            a.state = AlarmState.ACKNOWLEDGED
            a.acknowledged_ms = _t.time() * 1000

        return self.alarms.update(token, apply)

    def resolve_alarm(self, token: str) -> DeviceAlarm:
        import time as _t

        def apply(a: DeviceAlarm) -> None:
            a.state = AlarmState.RESOLVED
            a.resolved_ms = _t.time() * 1000

        return self.alarms.update(token, apply)

    def alarms_for_device(self, device_token: str) -> list[DeviceAlarm]:
        return self.alarms.list(where=lambda a: a.device_token == device_token).results

    # --- customers / areas / zones ---------------------------------------
    def create_customer_type(self, token: str, name: str, **kw) -> CustomerType:
        return self.customer_types.create(
            token, lambda m: CustomerType(meta=m, name=name, **kw)
        )

    def create_customer(self, token: str, customer_type: str, name: str,
                        parent_token: str | None = None, **kw) -> Customer:
        if customer_type not in self.customer_types:
            raise EntityNotFound(f"customer-type {customer_type!r} not found")
        if parent_token is not None and parent_token not in self.customers:
            raise EntityNotFound(f"parent customer {parent_token!r} not found")
        return self.customers.create(
            token, lambda m: Customer(meta=m, customer_type=customer_type,
                                      name=name, parent_token=parent_token, **kw)
        )

    def customer_tree(self) -> list[TreeNode[Customer]]:
        return build_tree(self.customers.all(), lambda c: c.parent_token)

    def create_area_type(self, token: str, name: str, **kw) -> AreaType:
        return self.area_types.create(
            token, lambda m: AreaType(meta=m, name=name, **kw)
        )

    def create_area(self, token: str, area_type: str, name: str,
                    parent_token: str | None = None, **kw) -> Area:
        if area_type not in self.area_types:
            raise EntityNotFound(f"area-type {area_type!r} not found")
        if parent_token is not None and parent_token not in self.areas:
            raise EntityNotFound(f"parent area {parent_token!r} not found")
        at = self.area_types.get(area_type)
        if parent_token is not None:
            parent = self.areas.get(parent_token)
            parent_at = self.area_types.get(parent.area_type)
            if parent_at.contained_area_types and area_type not in parent_at.contained_area_types:
                raise ValueError(
                    f"area-type {parent.area_type!r} cannot contain {area_type!r}"
                )
        return self.areas.create(
            token, lambda m: Area(meta=m, area_type=area_type, name=name,
                                  parent_token=parent_token, **kw)
        )

    def area_tree(self) -> list[TreeNode[Area]]:
        return build_tree(self.areas.all(), lambda a: a.parent_token)

    def create_zone(self, token: str, area_token: str, name: str,
                    bounds: list[tuple[float, float]], **kw) -> Zone:
        if area_token not in self.areas:
            raise EntityNotFound(f"area {area_token!r} not found")
        if len(bounds) < 3:
            raise ValueError("zone bounds require at least 3 vertices")
        if len(bounds) > 16:   # geofence kernel vertex capacity
            raise ValueError("zone bounds exceed 16 vertices")
        return self.zones.create(
            token, lambda m: Zone(meta=m, area_token=area_token, name=name,
                                  bounds=bounds, **kw)
        )

    def zones_for_area(self, area_token: str) -> list[Zone]:
        return self.zones.list(where=lambda z: z.area_token == area_token).results

    # --- device groups ----------------------------------------------------
    def create_group(self, token: str, name: str, roles: list[str] | None = None,
                     **kw) -> DeviceGroup:
        group = self.groups.create(
            token, lambda m: DeviceGroup(meta=m, name=name, roles=roles or [], **kw)
        )
        self._group_elements[token] = []
        return group

    def add_group_elements(self, group_token: str,
                           elements: list[dict[str, Any]]) -> list[DeviceGroupElement]:
        if group_token not in self.groups:
            raise EntityNotFound(f"device-group {group_token!r} not found")
        out = []
        for spec in elements:
            device = spec.get("device")
            nested = spec.get("group")
            if bool(device) == bool(nested):
                raise ValueError("element must reference exactly one of device/group")
            if device is not None and self.engine.get_device(device) is None:
                raise EntityNotFound(f"device {device!r} not found")
            if nested is not None and nested not in self.groups:
                raise EntityNotFound(f"device-group {nested!r} not found")
            el = DeviceGroupElement(
                element_id=self._next_element_id,
                group_token=group_token,
                device_token=device,
                nested_group_token=nested,
                roles=list(spec.get("roles", [])),
            )
            self._next_element_id += 1
            # setdefault: a group replicated from a peer arrives without
            # a membership slot (create_group ran at the origin only)
            self._group_elements.setdefault(group_token, []).append(el)
            out.append(el)
        self._notify_elements(group_token)
        return out

    def _notify_elements(self, group_token: str) -> None:
        cb = self.on_elements_change
        if cb is not None:
            cb(group_token, list(self._group_elements.get(group_token, [])))

    def apply_replicated_elements(
            self, group_token: str,
            elements: list[DeviceGroupElement]) -> None:
        """Peer-shipped membership; no hook (must not re-broadcast)."""
        self._group_elements[group_token] = list(elements)
        if elements:
            self._next_element_id = max(
                self._next_element_id,
                max(e.element_id for e in elements) + 1)

    def group_elements(self, group_token: str) -> list[DeviceGroupElement]:
        return list(self._group_elements.get(group_token, []))

    def remove_group_element(self, group_token: str, element_id: int) -> bool:
        elements = self._group_elements.get(group_token, [])
        for i, el in enumerate(elements):
            if el.element_id == element_id:
                del elements[i]
                self._notify_elements(group_token)
                return True
        return False

    def expand_group_devices(self, group_token: str,
                             roles: list[str] | None = None) -> list[str]:
        """Flatten a group (recursively through nested groups) into device
        tokens — the fan-out used by batch command-by-group operations."""
        seen_groups: set[str] = set()
        out: list[str] = []

        def walk(token: str) -> None:
            if token in seen_groups:
                return
            seen_groups.add(token)
            for el in self._group_elements.get(token, []):
                if roles and not set(roles) & set(el.roles):
                    continue
                if el.device_token is not None:
                    if el.device_token not in out:
                        out.append(el.device_token)
                elif el.nested_group_token is not None:
                    walk(el.nested_group_token)

        walk(group_token)
        return out
