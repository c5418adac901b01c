"""Command delivery service: the downlink pipeline (port of
``sitewhere_tpu/commands/service.py``).

An invocation is persisted as a COMMAND_INVOCATION event through the
engine's fused step (its id in ``aux0``), the outbound feed exposes it, and
this service consumes the feed: processing strategy -> router ->
destination(s), with failures parked in the undelivered dead letter. On a
card engine the feed is a readback of the card's ring.
"""

from __future__ import annotations

import dataclasses
import logging
import threading

from sitewhere_tpu_torch.commands.destinations import CommandDestination, DeliveryError
from sitewhere_tpu_torch.commands.model import (
    CommandInvocation,
    SystemCommand,
    next_invocation_id,
)
from sitewhere_tpu_torch.commands.routing import (
    CommandProcessingStrategy,
    CommandRegistry,
    CommandRouter,
    NestedDeviceSupport,
)
from sitewhere_tpu_torch.core.types import EventType
from sitewhere_tpu_torch.outbound.feed import FeedConsumer, OutboundEvent
from sitewhere_tpu_torch.utils.lifecycle import LifecycleComponent

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class UndeliveredCommand:
    """Dead-letter record (undelivered-command-invocations topic analog)."""

    invocation: CommandInvocation
    destination_id: str
    error: str


def local_command_responses(engine, invocation_id: str,
                            limit: int = 100) -> list[dict]:
    """ONE engine's command responses for an invocation id string,
    resolved against that engine's OWN interner (the string -> aux0
    mapping must never cross cluster ranks). Shared by the single-engine
    responses_for fallback and the cluster fan-out legs."""
    from sitewhere_tpu_torch.core.types import NULL_ID

    oid = engine.event_ids.lookup(invocation_id)
    if oid == NULL_ID:
        return []
    return engine.query_events(etype=EventType.COMMAND_RESPONSE,
                               aux0=oid, limit=limit)["events"]


class CommandDeliveryService(LifecycleComponent):
    """Owns registry, strategy, router, destinations, and the feed consumer."""

    HISTORY_LIMIT = 10_000

    def __init__(self, engine, router: CommandRouter,
                 registry: CommandRegistry | None = None):
        super().__init__("command-delivery")
        self.engine = engine
        self.registry = registry or CommandRegistry()
        self.strategy = CommandProcessingStrategy(self.registry)
        self.router = router
        self.nested = NestedDeviceSupport(engine)
        self.destinations: dict[str, CommandDestination] = {}
        self.undelivered: list[UndeliveredCommand] = []
        # pending invocations keyed by the engine event id lane (aux0).
        # _book guards _pending/history: the cluster RPC server thread
        # calls accept_remote() concurrently with the REST loop's
        # invoke()/pump()
        self._book = threading.Lock()
        self._pending: dict[int, CommandInvocation] = {}
        # retained history for the CommandInvocations controller queries,
        # bounded FIFO so long-running instances don't grow without bound
        self.history: dict[int, CommandInvocation] = {}
        self.consumer = engine.make_feed_consumer("command-delivery",
                                                  start_from_latest=True)
        self.delivered_count = 0

    def add_destination(self, dest: CommandDestination) -> CommandDestination:
        self.destinations[dest.destination_id] = dest
        self.add_child(dest)
        return dest

    # ------------------------------------------------------------- invocation
    def invoke(self, device_token: str, command_token: str,
               parameters: dict | None = None, tenant: str = "default",
               initiator: str = "REST", initiator_id: str = "") -> CommandInvocation:
        """Create + persist a command invocation event (the REST-path entry:
        Assignments controller -> addDeviceCommandInvocations analog).
        Delivery happens when the persisted event surfaces on the feed."""
        inv = CommandInvocation(
            invocation_id=self._new_invocation_id(),
            command_token=command_token,
            device_token=device_token,
            tenant=tenant,
            parameter_values=parameters or {},
            initiator=initiator,
            initiator_id=initiator_id,
            ts_ms=self.engine.epoch.now_ms(),
        )
        # validate early so bad invocations fail at the API surface
        self.strategy.build_execution(inv)
        # cluster deployments route the whole invocation to the device's
        # owning rank (event persists there; THAT rank's delivery pump
        # sees it on its feed) — the Kafka-topic hop of the reference's
        # command chain. Plain engines have no hook and stage locally.
        route = getattr(self.engine, "route_invocation", None)
        if route is not None:
            routed_id = route(inv)
            if routed_id is not None:
                inv.invocation_id = routed_id   # owner-assigned id space
                with self._book:
                    self._record_history(inv)
                return inv
        with self._book:
            self._pending[inv.invocation_id] = inv
            self._record_history(inv)
        self._stage_invocation(inv)
        return inv

    def _new_invocation_id(self) -> int:
        """Next invocation id in this deployment's id space: cluster
        engines rank-tag it (local * n_ranks + rank) so ids from
        different ranks can never collide in histories, pending sets, or
        device acks; plain engines use the raw counter."""
        iid = next_invocation_id()
        tag = getattr(self.engine, "tag_invocation_id", None)
        return tag(iid) if tag is not None else iid

    def _record_history(self, inv: CommandInvocation) -> None:
        self.history[inv.invocation_id] = inv
        while len(self.history) > self.HISTORY_LIMIT:
            self.history.pop(next(iter(self.history)))

    def _stage_invocation(self, inv: CommandInvocation) -> None:
        """Persist through the pipeline; aux0 carries the invocation id."""
        from sitewhere_tpu_torch.core.types import NULL_ID

        with self.engine.lock:
            token_id = self.engine.tokens.intern(inv.device_token)
            tenant_id = self.engine.tenants.intern(inv.tenant)
            now = self.engine.epoch.now_ms()
            self.engine._stage_row(
                int(EventType.COMMAND_INVOCATION), token_id, tenant_id,
                inv.ts_ms, now, None, None, inv.invocation_id, NULL_ID,
            )

    def accept_remote(self, inv: CommandInvocation) -> int:
        """Adopt an invocation routed here from another cluster rank (we
        own the target device): re-key into THIS rank's id space
        (process-global counters collide across ranks), register it
        pending, and persist its event locally so the delivery pump picks
        it off this rank's feed. Returns the adopted id."""
        inv.invocation_id = self._new_invocation_id()
        self.strategy.build_execution(inv)   # validate against OUR registry
        with self._book:
            self._pending[inv.invocation_id] = inv
            self._record_history(inv)
        self._stage_invocation(inv)
        return inv.invocation_id

    # ---------------------------------------------------------------- pumping
    async def pump(self) -> int:
        """Consume newly persisted invocation events and deliver them.
        Returns the number of invocations processed."""
        if self.engine.staged_count:
            self.engine.flush()
        events = self.consumer.poll()
        n = 0
        for ev in events:
            if ev.etype is EventType.COMMAND_INVOCATION:
                with self._book:
                    inv = self._pending.pop(ev.aux0, None)
                if inv is not None:
                    await self._route_and_deliver(inv)
                    n += 1
        self.consumer.commit(events)
        return n

    def _resolve_target(self, inv: CommandInvocation) -> tuple[str, dict]:
        target_token = self.nested.resolve_target_token(inv.device_token)
        info = self.engine.get_device(target_token)
        return target_token, (info.metadata if info else {})

    async def _route_and_deliver(self, inv: CommandInvocation) -> None:
        execution = self.strategy.build_execution(inv)
        target_token, metadata = self._resolve_target(inv)
        for dest_id in self.router.destinations_for(execution):
            await self._deliver_to(inv, execution, dest_id,
                                   target_token, metadata)

    async def _deliver_to(self, inv: CommandInvocation, execution,
                          dest_id: str, target_token: str,
                          metadata: dict) -> None:
        """Deliver one execution to one destination; failures dead-letter."""
        dest = self.destinations.get(dest_id)
        if dest is None:
            self.undelivered.append(
                UndeliveredCommand(inv, dest_id, "unknown destination")
            )
            return
        try:
            await dest.deliver(execution, target_token, metadata)
            self.delivered_count += 1
        except DeliveryError as e:
            logger.warning("delivery to %s failed: %s", dest_id, e)
            self.undelivered.append(UndeliveredCommand(inv, dest_id, str(e)))

    async def retry_undelivered(self) -> dict:
        """Re-route every dead-lettered invocation (the reference parks
        failures on the undelivered-command-invocations topic for later
        redelivery; CommandRoutingLogic.java:55-63). Invocations that fail
        again return to the dead-letter list."""
        parked, self.undelivered = self.undelivered, []
        for i, u in enumerate(parked):
            try:
                execution = self.strategy.build_execution(u.invocation)
                target_token, metadata = self._resolve_target(u.invocation)
                await self._deliver_to(u.invocation, execution,
                                       u.destination_id, target_token,
                                       metadata)
            except Exception as e:
                # unexpected failure (e.g. command since deleted, transport
                # error outside DeliveryError): nothing may be lost — re-park
                # this entry and every not-yet-retried one, then surface
                logger.exception("retry of %s failed", u.destination_id)
                self.undelivered.append(dataclasses.replace(u, error=str(e)))
                self.undelivered.extend(parked[i + 1:])
                raise
        return {"retried": len(parked),
                "stillUndelivered": len(self.undelivered)}

    def get_invocation(self, invocation_id: int) -> CommandInvocation | None:
        """Lookup a retained invocation (CommandInvocations controller
        GET /invocations/{id}). On a cluster, an id this rank never saw
        resolves at its OWNING rank (the id encodes it), so the endpoint
        answers identically from every rank, not just originator/owner."""
        inv = self.history.get(invocation_id)
        if inv is not None:
            return inv
        fetch = getattr(self.engine, "fetch_invocation", None)
        return fetch(invocation_id) if fetch is not None else None

    def responses_for(self, invocation_id: int, limit: int = 100) -> list[dict]:
        """Command responses whose originatingEventId names this invocation
        (CommandInvocations controller listCommandInvocationResponses).
        Devices post COMMAND_RESPONSE events with originatingEventId set to
        the string invocation id they received."""
        # interner ids for the originating-id string diverge across
        # cluster ranks: the fan-out resolves the STRING per rank
        fan = getattr(self.engine, "command_responses", None)
        if fan is not None:
            return fan(str(invocation_id), limit)
        return local_command_responses(self.engine, str(invocation_id),
                                       limit)

    async def send_system_command(self, device_token: str, command: SystemCommand) -> None:
        """Deliver a system command (e.g. RegistrationAck) immediately."""
        info = self.engine.get_device(device_token)
        metadata = info.metadata if info else {}
        dtype = info.device_type if info else None
        for dest_id in self.router.destinations_for_system(command, dtype):
            dest = self.destinations.get(dest_id)
            if dest is None:
                continue
            try:
                await dest.deliver_system(command, device_token, metadata)
            except DeliveryError as e:
                logger.warning("system command to %s failed: %s", device_token, e)
