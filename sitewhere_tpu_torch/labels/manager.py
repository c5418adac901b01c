"""Label generation service (port of ``sitewhere_tpu/labels/manager.py``,
host only): QR labels from canonical entity URIs for devices, assets,
areas, customers and device groups.
"""

from __future__ import annotations

from typing import Callable

from sitewhere_tpu_torch.labels.qrcode import qr_png


class EntityUriProvider:
    """Canonical sitewhere entity URIs (DefaultEntityUriProvider analog)."""

    def __init__(self, instance: str = "sitewhere-tpu"):
        self.instance = instance

    def _uri(self, kind: str, token: str) -> str:
        return f"sitewhere://{self.instance}/{kind}/{token}"

    def device_uri(self, token: str) -> str:
        return self._uri("device", token)

    def assignment_uri(self, aid: int) -> str:
        return self._uri("assignment", str(aid))

    def asset_uri(self, token: str) -> str:
        return self._uri("asset", token)

    def area_uri(self, token: str) -> str:
        return self._uri("area", token)

    def customer_uri(self, token: str) -> str:
        return self._uri("customer", token)

    def device_group_uri(self, token: str) -> str:
        return self._uri("devicegroup", token)


class QrCodeGenerator:
    """One label generator (reference: labels/qrcode/QrCodeGenerator.java)."""

    generator_id = "qrcode"
    name = "QR Code Generator"

    def __init__(self, uris: EntityUriProvider | None = None, scale: int = 8):
        self.uris = uris or EntityUriProvider()
        self.scale = scale

    def _png(self, uri: str) -> bytes:
        return qr_png(uri, scale=self.scale)

    def device_label(self, token: str) -> bytes:
        return self._png(self.uris.device_uri(token))

    def asset_label(self, token: str) -> bytes:
        return self._png(self.uris.asset_uri(token))

    def area_label(self, token: str) -> bytes:
        return self._png(self.uris.area_uri(token))

    def customer_label(self, token: str) -> bytes:
        return self._png(self.uris.customer_uri(token))

    def device_group_label(self, token: str) -> bytes:
        return self._png(self.uris.device_group_uri(token))


class LabelGeneratorManager:
    """Registry of named generators (LabelGeneratorManager analog)."""

    def __init__(self):
        self.generators: dict[str, QrCodeGenerator] = {}
        self.register(QrCodeGenerator())

    def register(self, generator) -> None:
        self.generators[generator.generator_id] = generator

    def get(self, generator_id: str):
        gen = self.generators.get(generator_id)
        if gen is None:
            raise KeyError(f"label generator {generator_id!r} not found")
        return gen

    def list_generators(self) -> list[dict]:
        return [
            {"id": g.generator_id, "name": g.name}
            for g in self.generators.values()
        ]
