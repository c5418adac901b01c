"""Which CUDA streams a thread runs an engine's work on.

An engine on the card is entered from threads that did not build it: the
wire edge's flusher, a cluster rank's RPC loop, the forward pump, the
replica applier, off-loop handoff work. Each such call runs under the
streams that were current on the thread that built the engine
(``card_streams``, read there), so its copies, kernels and dispatch fence
land on the stream that thread's reads and fences wait on
(``on_streams``). An engine on the CPU needs neither.
"""

from __future__ import annotations

import contextlib

import torch


def card_streams(engine) -> list:
    """The streams current, on the calling thread, on every CUDA device
    ``engine`` dispatches to (its shards' ``mesh``, else its ``device``);
    the engine's own device first. Empty for an engine off the card or a
    facade with no device."""
    devs = list(getattr(engine, "mesh", None) or [])
    dev = getattr(engine, "device", None)
    if dev is not None:
        devs.insert(0, dev)
    cards = []
    for d in devs:
        if getattr(d, "type", None) == "cuda" and d not in cards:
            cards.append(d)
    return [torch.cuda.current_stream(d) for d in cards]


def on_streams(streams: list) -> contextlib.AbstractContextManager:
    """Make ``streams`` (``card_streams`` of an engine) current on this
    thread, and the first one's device the current device, for the length
    of the ``with`` block."""
    if not streams:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    for s in reversed(streams):
        stack.enter_context(torch.cuda.stream(s))
    return stack
