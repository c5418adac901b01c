"""Multicast and route-builder interfaces (port of
``sitewhere_tpu/connectors/multicast.py``).

A multicaster expands one outbound event into several delivery routes (e.g.
one MQTT topic per subscribed consumer group); a route builder derives the
route string per (event, route key).
"""

from __future__ import annotations

from typing import Callable, Generic, Protocol, TypeVar

from sitewhere_tpu_torch.outbound.feed import OutboundEvent

R = TypeVar("R")


class RouteBuilder(Protocol[R]):
    def build(self, event: OutboundEvent, key: str) -> R: ...


class ScriptedRouteBuilder(Generic[R]):
    """User callable (event, key) -> route (Groovy ScriptedRouteBuilder)."""

    def __init__(self, fn: Callable[[OutboundEvent, str], R]):
        self.fn = fn

    def build(self, event: OutboundEvent, key: str) -> R:
        return self.fn(event, key)


class DeviceEventMulticaster(Generic[R]):
    """Expand an event to routes via registered keys + a route builder."""

    def __init__(self, route_builder: RouteBuilder[R],
                 keys_for: Callable[[OutboundEvent], list[str]] | None = None):
        self.route_builder = route_builder
        self.keys_for = keys_for or (lambda ev: [ev.device_token])

    def routes_for(self, event: OutboundEvent) -> list[R]:
        return [self.route_builder.build(event, k) for k in self.keys_for(event)]
