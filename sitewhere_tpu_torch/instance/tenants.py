"""Tenant management + dataset bootstrap.

The reference's instance-management bootstraps from k8s CRDs: it reads a
``SiteWhereInstance`` + ``InstanceDatasetTemplate`` and runs Groovy dataset
initializers with bootstrap-state tracking in the CRD status
(InstanceBootstrapper.java:79-175); tenants are CRDs spawning per-service
tenant engines. Here tenants are rows in the (natively multi-tenant) engine:
the tenant lane isolates pipelines/state, and dataset templates are Python
callables seeding a tenant with types/areas/users — same capability, flags/
JSON config plane instead of ZooKeeper/CRDs.
"""

from __future__ import annotations

import dataclasses
import secrets
import time
from typing import Callable

from sitewhere_tpu_torch.management.entities import EntityMeta, EntityStore


@dataclasses.dataclass
class Tenant:
    meta: EntityMeta
    name: str
    auth_token: str
    authorized_users: list[str]
    dataset_template: str = "empty"
    bootstrap_state: str = "NotBootstrapped"  # -> Bootstrapping -> Bootstrapped/Failed
    logo_url: str = ""


DatasetTemplate = Callable[["TenantManagement", Tenant], None]


def empty_dataset(tm: "TenantManagement", tenant: Tenant) -> None:
    """No seed data (reference: the 'empty' InstanceDatasetTemplate)."""


def construction_dataset(tm: "TenantManagement", tenant: Tenant) -> None:
    """Seed dataset modeled on the reference's 'construction' demo template:
    device types, an area hierarchy, and a customer."""
    dm = tm.device_management
    if dm is None:
        return
    t = tenant.meta.token
    for token, name in ((f"{t}-excavator", "Excavator"),
                        (f"{t}-crane", "Tower Crane"),
                        (f"{t}-tracker", "Asset Tracker")):
        if token not in dm.device_types:
            dm.create_device_type(token, name)
    if f"{t}-region" not in dm.area_types:
        dm.create_area_type(f"{t}-region", "Region",
                            contained_area_types=[f"{t}-site"])
        dm.create_area_type(f"{t}-site", "Construction Site")
        dm.create_area(f"{t}-southeast", f"{t}-region", "Southeast")
        dm.create_area(f"{t}-peachtree", f"{t}-site", "Peachtree site",
                       parent_token=f"{t}-southeast")
    if f"{t}-org" not in dm.customer_types:
        dm.create_customer_type(f"{t}-org", "Organization")
        dm.create_customer(f"{t}-acme", f"{t}-org", "ACME Construction")


BUILTIN_DATASETS: dict[str, DatasetTemplate] = {
    "empty": empty_dataset,
    "construction": construction_dataset,
}

# tenant configuration templates (reference: Tenants.java
# /templates/configuration backed by TenantConfigurationTemplate CRDs) —
# canned component-graph configs a new tenant can start from, in the
# config.py apply_tenant_config schema
CONFIG_TEMPLATES: list[dict] = [
    {
        "id": "default",
        "name": "Default configuration",
        "description": "In-memory event source with JSON decoder and "
                       "local command delivery.",
        "configuration": {
            "eventSources": [
                {"id": "default-in", "type": "inmemory",
                 "decoder": {"type": "json"},
                 "deduplicator": {"type": "alternate-id"}},
            ],
            "commandRouting": {
                "router": {"type": "single-choice",
                           "destination": "default-local"},
                "destinations": [
                    {"id": "default-local", "type": "local",
                     "encoder": {"type": "json"}},
                ],
            },
        },
    },
    {
        "id": "mqtt",
        "name": "MQTT configuration",
        "description": "MQTT event source (JSON decoder) with MQTT "
                       "command delivery.",
        "configuration": {
            "eventSources": [
                {"id": "mqtt-in", "type": "mqtt",
                 "decoder": {"type": "json"},
                 "configuration": {"host": "127.0.0.1", "port": 1883,
                                   "topic": "sitewhere/input/#"}},
            ],
            "commandRouting": {
                "router": {"type": "single-choice",
                           "destination": "mqtt-out"},
                "destinations": [
                    {"id": "mqtt-out", "type": "mqtt",
                     "encoder": {"type": "json"},
                     "configuration": {"host": "127.0.0.1", "port": 1883}},
                ],
            },
        },
    },
]


class TenantManagement:
    """Tenant CRUD + bootstrap orchestration."""

    def __init__(self, engine, device_management=None):
        self.engine = engine
        self.device_management = device_management
        self.tenants: EntityStore[Tenant] = EntityStore("tenant")
        self.datasets = dict(BUILTIN_DATASETS)

    def create_tenant(self, token: str, name: str,
                      authorized_users: list[str] | None = None,
                      dataset_template: str = "empty",
                      auth_token: str | None = None) -> Tenant:
        if dataset_template not in self.datasets:
            raise ValueError(f"unknown dataset template {dataset_template!r}")
        tenant = self.tenants.create(
            token,
            lambda m: Tenant(
                meta=m, name=name,
                auth_token=auth_token or secrets.token_urlsafe(16),
                authorized_users=authorized_users or [],
                dataset_template=dataset_template,
            ),
        )
        # register the tenant lane in the engine interner
        self.engine.tenants.intern(token)
        self.bootstrap(tenant)
        return tenant

    def bootstrap(self, tenant: Tenant) -> None:
        """Run the dataset initializer with bootstrap-state tracking
        (InstanceBootstrapper.java:87-104 semantics)."""
        tenant.bootstrap_state = "Bootstrapping"
        try:
            self.datasets[tenant.dataset_template](self, tenant)
            tenant.bootstrap_state = "Bootstrapped"
        except Exception:
            tenant.bootstrap_state = "Failed"
            raise
        finally:
            # the state above mutated the entity directly; a no-op store
            # update stamps updated_ms and fires on_change so replicas
            # see the FINAL bootstrap state, not the created default
            self.tenants.update(tenant.meta.token, lambda t: None)

    def authorize_user(self, tenant_token: str, username: str) -> Tenant:
        def apply(t: Tenant) -> None:
            if username not in t.authorized_users:
                t.authorized_users.append(username)

        return self.tenants.update(tenant_token, apply)

    def user_can_access(self, tenant_token: str, username: str,
                        is_admin: bool) -> bool:
        tenant = self.tenants.try_get(tenant_token)
        if tenant is None:
            return False
        return is_admin or not tenant.authorized_users or (
            username in tenant.authorized_users
        )
