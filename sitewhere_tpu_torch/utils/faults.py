"""Deterministic fault injection for partition/failover chaos testing
(port of ``sitewhere_tpu/utils/faults.py``, a copy: plain Python).

The cluster is plain TCP between ranks, so the chaos lever is a seam
INSIDE the peer-call path: a process-global ``FaultInjector`` that every
peer call consults before touching the wire. Tests and the chaos
harness install a plan; production runs never pay more than one
module-attribute read per call.

Faults are keyed by (src_rank, dst_rank, method) and are DETERMINISTIC:
a plan carries a seed, and probabilistic rules draw from one
``random.Random(seed)`` stream, so a failing chaos run replays exactly
with the same seed.

Supported rules:

  * ``kill(rank)`` — every call TO that rank raises ``ConnectionError``
    immediately (the network view of a SIGKILL'd process: connect
    refused, no timeout burned);
  * ``drop(src, dst, prob, method_prefix)`` — the call raises
    ``ConnectionError`` with probability ``prob`` (lossy partition);
  * ``delay(src, dst, delay_s, prob, method_prefix)`` — the call sleeps
    before proceeding (congested link / slow peer);
  * ``partition(a, b, prob, method_prefix)`` — SYMMETRIC drop between a
    rank pair: calls in EITHER direction raise ``ConnectionError`` (the
    network-partition view, vs ``drop``'s one-directional loss);
  * ``delay_jitter(src, dst, base_s, jitter_s, prob, method_prefix)`` —
    sleeps ``base_s`` plus a seeded draw in ``[0, jitter_s)`` (jittery
    congested link). The jitter draws from the SAME seeded stream as
    the probabilistic rules, so a chaos run replays exactly.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

_ANY = -1


@dataclasses.dataclass
class _Rule:
    kind: str          # "drop" | "delay" | "partition" | "delay_jitter"
    src: int = _ANY
    dst: int = _ANY
    prob: float = 1.0
    delay_s: float = 0.0
    jitter_s: float = 0.0
    method_prefix: str = ""

    def matches(self, src: int, dst: int, method: str) -> bool:
        if not method.startswith(self.method_prefix):
            return False
        if self.kind == "partition":
            # symmetric: the (a, b) pair matches either direction
            fwd = ((self.src == _ANY or self.src == src)
                   and (self.dst == _ANY or self.dst == dst))
            rev = ((self.src == _ANY or self.src == dst)
                   and (self.dst == _ANY or self.dst == src))
            return fwd or rev
        return ((self.src == _ANY or self.src == src)
                and (self.dst == _ANY or self.dst == dst))


class FaultPlan:
    """A seeded, ordered set of fault rules (first match wins)."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self.rules: list[_Rule] = []
        self.killed: set[int] = set()

    def kill(self, rank: int) -> "FaultPlan":
        self.killed.add(rank)
        return self

    def revive(self, rank: int) -> "FaultPlan":
        self.killed.discard(rank)
        return self

    def drop(self, src: int = _ANY, dst: int = _ANY, prob: float = 1.0,
             method_prefix: str = "") -> "FaultPlan":
        self.rules.append(_Rule("drop", src, dst, prob,
                                method_prefix=method_prefix))
        return self

    def delay(self, src: int = _ANY, dst: int = _ANY, delay_s: float = 0.05,
              prob: float = 1.0, method_prefix: str = "") -> "FaultPlan":
        self.rules.append(_Rule("delay", src, dst, prob, delay_s,
                                method_prefix=method_prefix))
        return self

    def partition(self, a: int, b: int, prob: float = 1.0,
                  method_prefix: str = "") -> "FaultPlan":
        """Symmetric drop between ranks ``a`` and ``b``: every call in
        either direction fails like a severed link (``drop`` stays
        one-directional)."""
        self.rules.append(_Rule("partition", a, b, prob,
                                method_prefix=method_prefix))
        return self

    def delay_jitter(self, src: int = _ANY, dst: int = _ANY,
                     base_s: float = 0.02, jitter_s: float = 0.05,
                     prob: float = 1.0,
                     method_prefix: str = "") -> "FaultPlan":
        """Seeded jittery delay: ``base_s`` plus a deterministic draw
        in ``[0, jitter_s)`` from the plan's RNG stream — same seed,
        same sleep sequence."""
        self.rules.append(_Rule("delay_jitter", src, dst, prob, base_s,
                                jitter_s, method_prefix=method_prefix))
        return self


class FaultInjector:
    """Evaluates a plan on the peer-call path. Thread-safe: the RNG draw
    is the only shared mutation and sits under a lock (call volume on
    the chaos paths is nowhere near lock-contention scale)."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._rng = random.Random(plan.seed)
        self._lock = threading.Lock()
        self.counters = {"dropped": 0, "delayed": 0, "killed_refused": 0,
                         "partitioned": 0, "jitter_delayed": 0}

    def _draw(self) -> float:
        with self._lock:
            return self._rng.random()

    def before_call(self, src: int, dst: int, method: str) -> None:
        """Raise/delay per the plan; called before the frame is sent."""
        if dst in self.plan.killed:
            self.counters["killed_refused"] += 1
            raise ConnectionError(
                f"fault injection: rank {dst} is killed (from rank {src})")
        for rule in self.plan.rules:
            if not rule.matches(src, dst, method):
                continue
            if rule.prob < 1.0 and self._draw() >= rule.prob:
                continue
            if rule.kind == "drop":
                self.counters["dropped"] += 1
                raise ConnectionError(
                    f"fault injection: dropped {method} "
                    f"rank {src}->{dst}")
            if rule.kind == "partition":
                self.counters["partitioned"] += 1
                raise ConnectionError(
                    f"fault injection: partition {rule.src}<->{rule.dst} "
                    f"severed {method} rank {src}->{dst}")
            if rule.kind == "delay":
                self.counters["delayed"] += 1
                time.sleep(rule.delay_s)
            if rule.kind == "delay_jitter":
                self.counters["jitter_delayed"] += 1
                time.sleep(rule.delay_s + self._draw() * rule.jitter_s)
            return   # first match wins


# process-global seam; None = zero-overhead fast path
_INJECTOR: FaultInjector | None = None


def install(plan: FaultPlan) -> FaultInjector:
    global _INJECTOR
    _INJECTOR = FaultInjector(plan)
    return _INJECTOR


def clear() -> None:
    global _INJECTOR
    _INJECTOR = None


def check(src: int, dst: int, method: str) -> None:
    """The one call sites make: no-op unless a plan is installed."""
    inj = _INJECTOR
    if inj is not None:
        inj.before_call(src, dst, method)
