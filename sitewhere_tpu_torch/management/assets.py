"""Asset management (port of ``sitewhere_tpu/management/assets.py``, host
only): asset types and assets. Assets attach to device assignments so
events can be correlated to the physical thing being monitored.
"""

from __future__ import annotations

import dataclasses

from sitewhere_tpu_torch.management.entities import EntityMeta, EntityNotFound, EntityStore, SearchResults


@dataclasses.dataclass
class AssetType:
    meta: EntityMeta
    name: str
    description: str = ""
    image_url: str = ""
    asset_category: str = "Device"  # Device | Person | Hardware


@dataclasses.dataclass
class Asset:
    meta: EntityMeta
    asset_type: str
    name: str
    image_url: str = ""
    description: str = ""


class AssetManagement:
    def __init__(self):
        self.asset_types: EntityStore[AssetType] = EntityStore("asset-type")
        self.assets: EntityStore[Asset] = EntityStore("asset")

    def create_asset_type(self, token: str, name: str, **kw) -> AssetType:
        return self.asset_types.create(
            token, lambda m: AssetType(meta=m, name=name, **kw)
        )

    def create_asset(self, token: str, asset_type: str, name: str, **kw) -> Asset:
        if asset_type not in self.asset_types:
            raise EntityNotFound(f"asset-type {asset_type!r} not found")
        return self.assets.create(
            token, lambda m: Asset(meta=m, asset_type=asset_type, name=name, **kw)
        )

    def list_assets(self, page: int = 1, page_size: int = 100,
                    asset_type: str | None = None) -> SearchResults[Asset]:
        return self.assets.list(
            page, page_size,
            where=(lambda a: a.asset_type == asset_type) if asset_type else None,
        )
