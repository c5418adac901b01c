#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sitewhere_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--out PATH] [--profile]

Phases, each printed as one JSON line:

1. build   — compiles every CUDA kernel of the port from ``csrc/`` with
             nvcc (all sources at once) and loads it.
2. kernel  — one record per kernel (window_features; flash_attention;
             flash_attention_backward; flash_attention_c6, the attention
             at the head dims and the type of fault C6: D = 8, 48, 100
             zero-padded, D = 128, float16 at D = 8, 32, 48, 128, and
             past 128: D = 256 and 192 (padded to it) in all three types,
             the forward, its lse and the backward row by row against the
             plain versions (cases up to S = 1000 against float64, each
             element and row within its type's limit or 1.5 times
             float32's first-order error bound there, which frees rows of
             saturated softmax only), then both timed against
             SDPA at [8, 16384, 2, 128] bf16 and float16 (the wgmma/TMA
             kernels), at [8, 16384, 8, 32] float16, at [8, 16384, 1, 256]
             in both 16-bit types and, in bf16, at [8, 16384, 16, 16] and
             [8, 16384, 4, 64], with their floors and ptxas's registers
             and spills;
             flash_attention_backward's record also checks the
             forward's log-sum-exp and that two calls give the same bits,
             and gives ptxas's registers and spills, the kernel's time over
             the library call's, TFLOP/s and the bound's share of its
             time): holds it against its plain PyTorch
             version on the card at its main path's shapes and edge
             shapes, and times kernel, plain version, the one PyTorch call
             that computes the same function where there is one
             (``library_ms``; a yardstick only, the port never calls it)
             and the least time the card could take (``bound_ms``, from
             the H100 SXM's published peaks).
3. entry   — the Quickstart surface: ``Engine(..., device="cuda")`` with
             geofence zones and a rule set (every rule kind) installed,
             ``register_device``, ``process()`` of measurement, location
             and alert requests, ``flush()``, ``get_device_state``,
             ``ingest_json_batch`` (the native decoder into a staging
             arena), ``RulesManager.poll``, ``query_events``,
             ``get_event``, ``presence_sweep`` and the counters; the same
             stream through a CPU engine and through a card engine on the
             Python decode path (``use_native=False``), whose state and
             answers must be identical, and scores within float32
             tolerance; then the registry admin API (``update_device``,
             ``create_assignment`` with assets, ``update_assignment``,
             ``mark_assignment_missing``, ``release_assignment``,
             ``delete_assignment``, ``delete_device``, with
             ``assignment_triggers``) on the card and the CPU engine, whose
             answers, state and mirrors must be identical.
4. slice   — the main path at full width: the headline engine sizes, 80
             batches of 16384 events (10,000 auto-registered tokens, 8192
             analytics devices with 128-step windows of 100 channels)
             through ``Engine.ingest_event_batch`` -> ``pipeline_step``, then
             ``AnalyticsService.score_all`` over all 8192 windows
             (window_features kernel -> normalization -> AnomalyModel, bf16).
             Kernel launch counts are reset just before and read just after.
5. train   — analytics training on the slice engine's 8192 windows after
             its 80 batches, with the service's default model (hidden 256,
             LSTM 256, latent 32, bf16) at batch 256: (a) 16
             ``train_on_live`` calls of one step and one of 8 steps
             (window_features launch count reset just before and read just
             after: one a call), every loss finite and the last below the
             first; (b) a float32 model from the same seeded weights on the
             card and on the CPU (a CPU copy of the windows): the gradients
             of one loss within 1e-5 of each tensor's largest, then 3
             ``train_on_live`` calls at batch 64 (at 256 the CPU leg took
             ~22 s): the same batches, losses within ``rtol=1e-4,
             atol=1e-6``, parameters within that plus what the gradient
             tolerance becomes through each AdamW step, ``2 * lr * dg /
             (sqrt(v) + eps)`` capped at the most one update can move a
             parameter (a gradient below eps moves its parameter by
             ``lr * g / eps``, so summation order alone moves such
             elements by ~1e-5; the capped elements are counted);
             (c) ``save_model`` then
             ``restore_model`` into a fresh card service scores byte for
             byte alike and takes an identical next step, and a CPU service
             restored from the card's checkpoint scores 256 windows within
             the tests' bf16 tolerance; (d) one iteration of ``run()``
             injects exactly ``emit_anomaly_alerts``' tokens, each found by
             ``query_events``; (e) the rules host runtime at the read
             phase's width (the slice config with the bench's rules sizes,
             zones and CEP rule set, 9 batches of the read phase's
             stream), each leg on the card against a CPU engine fed the
             same batches, answers and state byte for byte: on an
             archive-backed engine, ``watch_file``, a reload of a
             threshold tweak that changes only its parameter column and
             fires below the old threshold, a rejected document that
             keeps the set serving, then ``spill_rollups`` twice (the
             history equals the closed ring windows; a respill and a
             fresh manager spill nothing, the fresh one reads the same
             history); ``RuleSetWatcher`` picks up a tweak and stops; an
             owner and a passive standby whose pre- and post-promotion
             alerts are disjoint and equal a single CPU engine's two
             polls, the standby's state equal to that engine's. Prints ms
             per call and per step and peak memory.
6. transformer — the long-window scorer at the repo's full width
             (``TransformerConfig()``: 100 sensors, d_model 256, 8 heads,
             4 layers, mlp 1024, bf16): ``forecast_scores`` on 8 windows of
             16384 timesteps, seeded weights and data; every layer's
             attention is the flash_attention kernel (launch count reset
             just before the timed calls, read just after: layers x calls).
             The first window's score is checked against the same model
             with the plain attention on the card.
7. transformer_train — training that model at the same width on the
             same 8 x 16384 shape, AdamW (optax's decay) at lr 1e-3: (a) one
             warm-up and 5 timed ``make_train_step`` steps on one seeded
             batch, the forward and backward attention launch counts reset
             just before and read just after (layers x steps each), losses
             finite and falling, every parameter's gradient finite and
             non-zero, ms a step, peak memory and the busy share of one
             profiled step; (b) one step's gradients through the kernels
             against the plain attention's autograd on 2 x 4096, each within
             2e-2 of its largest element; (c) a float32 model from the same
             seed on the card (float32 kernels) and the CPU on 2 x 1024, one
             Adam step: loss, gradients within 1e-4 of each one's largest,
             parameters within ``rtol=1e-4, atol=1e-6`` plus the gradient
             tolerance through Adam, capped at one update (as the train
             phase); (d) ``forecast_scores_sp`` and
             ``ring_attention_sharded`` in a one-rank NCCL group against the
             single-device path (one card cannot show the ring across
             ranks; 4 gloo ranks in the CPU tests do).
7b. transformer_c6 — the C6 configurations
             (``TransformerConfig(d_model=256, heads=2)``, ``heads=32``,
             ``d_model=384, heads=8``, ``heads=4``, ``dtype=torch.float16``
             and ``heads=4`` and ``d_model=256, heads=2`` in float16: head
             dims 128, 8, 48, 64, and 32, 64 and 128 in float16) and those
             past head dim 128 (``d_model=256, heads=1`` in bf16 and
             float16, ``d_model=384, heads=2``: D = 256, and 192 padded to
             it) on [2, 4096] windows:
             ``forecast_scores`` and one ``make_train_step`` step each,
             every layer's attention and its gradient through the kernels
             (launch counts reset just before and read just after), the
             first window within TF_SCORE_RTOL of the plain attention; the
             float16 ones profiled once more, the attention kernels by
             name (the one-pass wgmma/TMA backward, at D = 64, 128 and 256
             the wgmma/TMA forward, no mma.sync backward). Then
             the head-dim-128, 64 and 256 models at full width (8 windows of 16384
             steps): one timed ``forecast_scores`` call and one timed train
             step (launch counts reset before the one and read after the
             other), and one profiled call of each: the busy share and the
             attention kernels that ran, which must be the wgmma/TMA
             forward and one-pass backward and none of the mma.sync
             kernels.
8. read    — the read side and the whole fused step at the slice's width:
             64 geofence zones of 16 vertices and the bench's CEP rule set
             installed, 24 slice batches (channel 0 rewritten by the bench's
             rules formula; one device falls silent halfway) through
             ``ingest_event_batch``; the bench's 16-query mix at limit 64 as
             one ``query_store_batch`` and as 16 ``query_store`` calls
             (identical), ``query_events``, ``get_event``,
             ``presence_sweep``, ``RulesManager.poll``; every page, the
             harvest and the sweep rerun on a CPU copy of the state, and a
             CPU engine fed the first 4 batches, byte for byte.
9. wire    — wire ingest and durability at bench.py's headline sizes
             (16384-event batches, ``dispatch_depth=2``, 10,000 devices):
             (a) ``run_engine_load``'s JSON stream, 4 + 40 batches,
             through the native decoder and pinned staging arenas; (b) the
             first 12 batches through the arena scan step
             (``scan_chunk=4``), the copy path, binary frames, one decode
             thread and a CPU engine, each byte for byte against a
             headline engine; (c) the headline load with a group-commit
             WAL, and calls of 256 payloads sharing its fsyncs; (d) a
             snapshot after 4 batches, 8 more, a crash, and
             ``recover_engine`` on the card and on the CPU against the
             engine that never crashed; (e) the conservation ledger of
             every engine. Prints events/s, latency, host ms per batch,
             recovery seconds and peak memory on one ``wire:`` line.
9b. sharded — the multi-shard engine (``SpmdEngine``) with 1, 2 and 4
             shards, every one on this card, each at the per-shard
             headline sizes (``HEADLINE_CFG``: 2^15 devices, 2^16 tokens,
             a 2^18-row ring, 16384-event batches, 8 channels),
             ``scan_chunk=2``, ``dispatch_depth=2``, the bench's rule set,
             a group-commit WAL: 2 + 38 batches of the wire stream over
             10,000 devices (each event with its own ``eventDate``)
             through the native decoder into the stacked staging arena.
             Checks (a) every shard's store byte for byte against a
             single-card engine fed that shard's substream, (b) query
             pages over the recent stream against a single-card engine
             fed the whole stream, (c) the conservation ledger, (d)
             ``ShardedEngine(exchange=True)`` against the CPU's and the
             routed run, its overflow count against the CPU's, (e) a
             reduced leg: the card engine's state, pages, counters and rule
             fires against a CPU ``SpmdEngine``'s. Prints events/s by shard
             count (shards sharing one card: no scaling figure), host
             medians and means a call and CUDA kernels a dispatch.
9c. distributed — the mesh product engine (``DistributedEngine``) at
             ``DistributedConfig``'s default sizes a shard (2^14 devices,
             2^15 tokens and assignments, a 2^16-row ring, 2048 staged rows
             a batch, 8 channels) with a group-commit WAL, 1, 2 and 4
             shards on this card: the sharded phase's JSON stream over
             10,000 devices in calls of 8192, 10 calls a shard (every ring
             wraps once); events/s and host ms a call (decode + commit,
             dispatch, WAL gate), the counters, the newest page and (e) the
             conservation ledger of each. Then a reduced 4-shard leg: (a) its
             stacked state, summaries, counters, mirrors, query pages (a
             device, a tenant, an assignment, time windows), device states
             and tenant counts equal a CPU engine's fed the same payloads;
             (b) a snapshot after 3 calls, a crash and
             ``recover_distributed`` from the WAL tail equal the engine that
             never crashed; (c) a feed consumer polled and committed to the
             head delivers every stored event once (the overwritten ones
             counted in ``lag_lost``), ``get_event`` resolving its ids, as
             the CPU engine's; (d) ``reshard_snapshot`` 4 -> 2 of the card's
             snapshot, restored on the card, keeps every event and device
             state; (e) the ledgers. Prints one ``distributed:`` line.
10. archive — the archive tier at the slice's headline sizes (100 channels,
             4096-row segments): 40 bulk batches over 2048 devices, 2.5x the
             ring; (a) no row lost, whole segments; (b) the planner's
             pushdown equals its full scan on the bench's filter matrix; (c)
             16 ``query_events`` over evicted time ranges equal a host
             oracle of the spooled columns plus the ring; (d) ``get_event``
             of evicted ids; (e) a feed consumer from offset 0 replays every
             event once, in order, and the first 4 polls and the last again
             before their commit. One ``AnalyticsManager``
             job scores every device's newest 128-step window from the
             archive, 256 devices a batch (window_features kernel ->
             normalization -> AnomalyModel, bf16; launch count reset just
             before and read just after: one a batch), held to a host
             rebuild of the windows scored with the plain window_features;
             ``fill_windows`` on the card equals its CPU run; the
             conservation ledger balances. Then a reduced leg: a card
             engine, a CPU engine and a card engine on the copy path with a
             scan chunk, fed the same JSON for 8 rings, must agree byte for
             byte (segments, pages, feed). The job's spans are checked in the
             engine's tracer: a load span a round, a transfer and a score
             span a scoring batch. Prints spool, query, feed and job figures
             on one ``archive:`` line.
11. hostplane — the single-engine host plane at the wire phase's headline
             width: (a) the wire load with the flight recorder and span
             tracer on (the defaults) and off, in 3 interleaved pairs of 20
             batches: every summary carries a ``trace_id``, every record
             reaches ``device_ready`` and ``readback`` and its stage
             durations fit its end to end, one trace's Chrome timeline holds
             flight and span events; the on/off rate ratio is recorded, not
             gated; (b) ``DecodeWorkerPool`` (min(4, cores - 1) processes)
             fed bench.py's pool leg (48 batches of 16384 over 10,000
             tokens), whose engine equals an in-process engine byte for
             byte; (c) bench.py's fairness leg (victim 1200 events/s,
             abuser 2500 x2 in bursts capped at 250, weights 2:1, seed 90,
             4 interleaved sessions) through ``run_open_loop`` on a QoS,
             fair-tenancy engine: device-side accepted counts equal the
             admitted counts, the abuser's offered/admitted ratio is at
             least 5, and a CPU engine fed the logged admitted stream equals
             the card's; (d) the wire load with ``autotune=True`` every 16
             dispatches against a fixed-knob engine, state and pages byte
             for byte; (e) a ``ConservationAuditor`` thread on every engine
             with no violation, a scrape mid-load and at the end that parses
             and holds ``HOSTPLANE_SERIES``, the e2e histogram counting every
             harvested record; (f) the memory ledger within
             ``torch.cuda.memory_allocated`` and equal to a CPU engine's.
             Prints one ``hostplane:`` line.
12. anomaly_tp — the anomaly model's DP x TP training step at the default
             ``AnomalyConfig()`` (100 sensors, 128 steps, hidden 512, LSTM
             512, bf16), batch 64, in a one-rank NCCL group on a (1, 1)
             ``("dp", "tp")`` mesh: (a) every parameter's placements are
             JAX's predicate on its flax leaf; (b) 3 steps of
             ``make_train_step_dp_tp`` against 3 of the single-device
             ``make_train_step`` from the same seeded weights and batch,
             losses and parameters bit for bit; (c) ms a step of both and
             the ``h`` all-gather a time step. TP across ranks is held to
             JAX on 8 gloo ranks in the CPU tests only.
13. multihost — the two-process sharded job: 2 worker processes with 4
             shards each on this card, sums over a gloo group; both lines
             carry the JAX demo's totals and shard ownership, and every
             state tensor is on the card. Prints the wall time.
14. sources — an ``EventSourcesManager`` with an in-memory and a socket
             receiver (newline framing; a composite decoder over the JSON
             and JSON batch decoders), alternate-id dedup, into an engine
             on the card: 4096 seeded payloads with redeliveries, bad
             payloads and registrations; counts, dead letter, and the
             state byte for byte a CPU engine's. Prints payloads/s.
15. edge   — the persistent-connection wire edge (``ingest/wire_edge.py``)
             and the broker receivers, bench.py's wire leg on the card
             (its ``W_CFG``, pinned clocks): (a) 12 x 256 frames of
             ``WireLoadSpec(1000, 12, 200, seed=7)`` over one SWP
             connection, a flush hint and an ack barrier a group, into a
             card engine whose flusher thread makes the engine calls on
             the main thread's stream, against a second card engine and a
             CPU engine fed the same 12 ``ingest_json_batch`` calls; (b)
             1000 live MQTT connections x 12 QoS 1 frames through
             ``run_wire_load`` (3 samples; ``flush_rows=256``, 5 ms
             deadline): every frame acked, no host staging copy, the
             ledger's "wire" stage balancing; then 160 request-response
             cycles over SWP; (c) a group-commit WAL, 8 SWP connections
             pumping for 1 s, ``edge.kill()``, a fresh card engine
             replaying the WAL: every acked frame among the replayed
             payloads; (d) the MQTT receiver over ``MqttBroker``, CoAP,
             AMQP over ``AmqpBroker``, STOMP and EventHub through one
             ``EventSourcesManager`` with a shared ``WireBatcher`` into a
             card and a CPU engine (redeliveries, bad frames): counts,
             dead letter, CoAP ACKs and state equal. No error may be
             logged or raised off the main thread and no frame may stall.
             Prints events/s, publish p50/p99, connect s, KiB a
             connection, flush occupancy and the contrast on one
             ``edge:`` line.
16. services — the entity and outbound services wired by hand over an
             engine at the slice's sizes, as the JAX instance wires them:
             10,000 devices through ``DeviceManagement.create_device``
             under 16 sites, 8 customers and two device types; the read
             phase's 64 zones of 16 vertices; 4096 command invocations
             (meters to a local destination, trackers over MQTT on the
             port's broker; the local one down for the first pump, the
             undelivered retried once); a batch operation, a failing one
             and a scheduled job on an injected clock; 8 rounds of one
             location a device through the native decoder, the
             ``ZoneMonitor`` pumped until the feed drains; a
             ``ConnectorHost`` with an ``InMemoryConnector`` behind a
             device-type and an area filter and a ``SearchIndexConnector``
             over the same feed; a fixed set of searches; a QR matrix. (a)
             A CPU engine with the same services runs the stream through
             round 2 in a process of its own while the card runs: there
             alerts and their order, deliveries, connector outputs, search
             answers, batch elements, summaries, trees, every state leaf
             and the mirrors must be identical; (b) the zones and every
             pump's points on the card, one device-to-host copy a pump
             with points; (c) a 2-shard ``DistributedEngine`` on the card
             with a ``DistributedFeedConsumer`` and a
             ``CommandDeliveryService`` (2048 devices) equal to its CPU
             twin; (d) ms a ``create_device``, ms a zone pump and point x
             zones a second, invocations delivered a second, connector
             events a second, ms a search, with the card's name and power
             limit, on one ``services:`` line.
17. servers — the instance (``SiteWhereTpuInstance(..., device="cuda")``)
             at the slice engine's sizes, its REST gateway over the port's
             own HTTP layer and its RPC server on loopback, driven with the
             port's stdlib client: JWTs, a construction-dataset tenant and
             a configuration template, areas, customers, device types, 2048
             devices over ``POST /api/devices``, a tenant config with a
             socket source and an in-memory connector applied, hot-reloaded
             and a bad one refused, 8 rounds of 16384 8-channel rows over
             ``POST /api/events/batch`` (bodies under the 1 MiB limit),
             command invocations delivered by the server's pump loop,
             reads, the read phase's 64 zones and ``zone_contains``,
             search, the instance documents, an RPC mix, then
             ``run_rest_load`` at 5 x 100 and 32 x 64 (each post is one
             engine step) and the
             analytics routes (window_features at [8192, 128, 100]). (a) A CPU
             instance runs the script through batch round 2 in a process
             of its own: every status and masked body, every state leaf
             and the mirrors identical there; the REST scores within
             ``SCORE_BF16`` of the plain window_features on the same
             windows; (b) engine, state and ``zone_contains`` on the card,
             window_features by profiler name, the version saying "gpu";
             (c) an instance over a 2-shard ``DistributedEngine`` on the
             card answers as its CPU twin; (d) requests a second with p50 /
             p99, batch events a second, ms a device, RPC calls a second,
             ms a ``zone_contains`` and of the analytics routes, on one
             ``servers:`` line.
18. cluster — the cluster planes (``parallel/cluster.py``, ``forward``,
             ``replication``, ``placement``, ``entity_sync``,
             ``cluster_reshard``, ``rank_runtime``, ``cluster_demo``),
             every rank and standby on the card: (a) a 2-rank cluster
             (forwarding, RF = 2, pinned clocks) fed a seeded mixed-owner
             stream at both ranks, held to the same cluster on CPU engines
             in a process of its own (pages, states, by-id lookups from
             either rank, searches, every store and standby leaf); (b)
             ``bench.py``'s cluster leg at its hardware settings
             (``DistributedConfig()`` shards, 2 a rank, 4 channels, a
             group-commit WAL; frames of 2048, 64 calibration frames, the
             open loop, 500k events): calibration events/s, per-tenant
             p50/p99, forward hop p99, replication lag, a chaos slice
             without loss, balanced ledgers, the failover read's
             ``stale_ms`` after rank 1's server stops; (c) a move of half
             of rank 0's slots under ingest, a drain and a join, no acked
             loss, one epoch everywhere; (d) entity sync; (e) an offline
             2 -> 3 reshard; (f) ``spawn_cluster_demo`` on the card; one
             ``cluster:`` line.

``--profile`` adds torch.profiler breakdowns after the checks of the
slice, train, read, transformer, transformer_train (one step by kernel
family: attention forward and backward, GEMMs, LayerNorm / gelu,
optimizer), wire, archive and hostplane phases (a few
steps or calls each; one ``train_on_live`` call by family; one spool and
one scoring batch of the job; three dispatches with the recorder on).

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi reports them, and as the last line
``{"ok": true, "device": {...}}``. Any failed check exits non-zero without
that line; so does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import dataclasses
import functools
import hashlib
import importlib.util
import itertools
import json
import logging
import math
import os
import pathlib
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from sitewhere_tpu_torch import cuda_build
from sitewhere_tpu_torch.core.events import EpochBase, EventBatch
from sitewhere_tpu_torch.core.types import AUX_LANES, NULL_ID, EventType
from sitewhere_tpu_torch.engine import Engine, EngineConfig
from sitewhere_tpu_torch.ingest.arena import StagingArena
from sitewhere_tpu_torch.ingest.decoders import (JsonDeviceRequestDecoder,
                                                 encode_binary_request)
from sitewhere_tpu_torch.ingest.requests import DecodedRequest, RequestType
from sitewhere_tpu_torch.ingest.workers import DecodeWorkerPool
from sitewhere_tpu_torch.loadgen import (batch_maker, build_open_loop_schedule,
                                         generate_measurements_message, run_engine_load,
                                         run_open_loop)
from sitewhere_tpu_torch.models.anomaly import AnomalyConfig, loss_fn
from sitewhere_tpu_torch.models.service import AnalyticsService
from sitewhere_tpu_torch.models.transformer import (TelemetryTransformer,
                                                    TransformerConfig,
                                                    forecast_scores)
from sitewhere_tpu_torch.models.windows import snapshot_windows
from sitewhere_tpu_torch.ops import attention as fa
from sitewhere_tpu_torch.ops import window_features as wf
from sitewhere_tpu_torch.ops.query import QueryParams, query_store, query_store_batch
from sitewhere_tpu_torch.ops.readback import arena_cursor
from sitewhere_tpu_torch.ops.rules import harvest_fires
from sitewhere_tpu_torch.parallel.multihost_demo import run_two_process_demo
from sitewhere_tpu_torch.pipeline import make_presence_sweep
from sitewhere_tpu_torch.rules import RuleSetWatcher, RulesManager
from sitewhere_tpu_torch.utils.checkpoint import recover_engine, save_engine
from sitewhere_tpu_torch.utils.conservation import (ConservationAuditor, build_ledger,
                                                    check_conservation)
from sitewhere_tpu_torch.utils.devicewatch import memory_ledger
from sitewhere_tpu_torch.utils.flight import stage_durations
from sitewhere_tpu_torch.utils.metrics import REGISTRY as METRICS_REGISTRY
from sitewhere_tpu_torch.utils.metrics import export_engine_metrics


def _repo_module(name: str, rel: str):
    """A module of this checkout loaded by its path: an installed package
    named ``tests`` would shadow the repo's ``tests/``, which is no package."""
    spec = importlib.util.spec_from_file_location(name, pathlib.Path(__file__).parent / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the train phase's batch spy and one-iteration stop event, shared with the
# parity tests (numpy only)
_parity = _repo_module("torch_parity", "tests/torch_parity.py")
StopAfter, spy_batches = _parity.StopAfter, _parity.spy_batches


# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, FP32
# (non-tensor-core) and bf16 tensor-core operations/s; exponentials/s are
# 16 per SM per clock (CUDA C++ Programming Guide, arithmetic instruction
# throughput, compute capability 9.0) x 132 SMs x the 1.98 GHz boost clock
# that the FP32 peak implies (67e12 = 132 x 128 x 2 x 1.98e9)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12
PEAK_EXP_PER_S = 132 * 16 * 1.98e9
KERNEL_TOL = 1e-4          # rtol = atol, kernel vs plain version, float32
SCORE_TOL = 1e-4           # rtol, CUDA engine vs CPU engine scores, float32
# flash_attention vs its plain version: float32 computes the same float32
# math in another order; bf16 outputs may land one bf16 ulp apart (8e-3
# is one ulp at 1.0), P entering the P·V product rounded to bf16 included
# float16 rounds 8x finer than bf16: one float16 ulp at 1.0, where the
# float16 kernel's arithmetic (emulated in tests/test_torch_attention.py)
# reads <= 5.7e-4 and its bf16-rounded control fails on every causal case
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float16: 1e-3}
# the backward kernel vs its plain version, each row (one position of one
# head) of each gradient within this share of that row's largest element
# (fa.gradient_row_shares; sized by tests/test_torch_attention.py's CPU
# emulation of the bf16 kernel: <= 8.7e-3 a row up to S = 2048, one bf16
# ulp of the row's largest element and a little more), so that a wrong
# or zeroed row anywhere fails however small the causal tail's rows are;
# GRAD_ATOL comes off only on the rows whose exact gradient is 0 (S = 1,
# and dq's row 0 under a causal mask: only float32 rounding of dP - delta
# is left there); the lse against the plain log-sum-exp
# float16: the same file's emulation of the float16 kernels' arithmetic
# reads <= 1.05e-3 a row up to S = 4096 (one float16 ulp of the row's
# largest element and a little more), and >= 3.3e-3 on every gradient
# with P and dS rounded to bf16 instead (the control below must fail it);
# GRAD_STEP, float16's subnormal step, comes off every row's error, since
# a row below float16's normal range (late keys at long S) holds its
# values only to 2^-24 absolute
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2.5e-3}
GRAD_STEP = {torch.float16: 2.0 ** -24}
# a bf16 row of a true head dim of 8 holds 8 elements, whose largest lies
# nearer the rounding error of the terms summed into them than at D >= 16:
# there bf16's own arithmetic (bf16_rounded_reference on the same inputs)
# reads past GRAD_TOL at long S, and the C6 phase holds each bf16 gradient
# to GRAD_TOL or GRAD_ARITH_MARGIN times that reading, whichever is larger;
# and each output element and gradient row of its small cases to
# GRAD_ARITH_MARGIN times float32's first-order error bound there
# (``float64_reference``) where that is larger still: saturated softmax
# rows, where dP - delta cancels near float32's rounding, and the plain
# float32 version itself misses a dq row by more than the row
GRAD_ARITH_MARGIN = 1.5
GRAD_ATOL = 1e-5
LSE_TOL = 1e-4
TF_SCORE_RTOL = 1e-2       # kernel path vs plain path scores, bf16 model

# the headline engine sizes of bench.py plus BASELINE config #4's model
# width (100-sensor windows of 128 steps)
SLICE_CONFIG = dict(device_capacity=1 << 15, token_capacity=1 << 16,
                    assignment_capacity=1 << 16, store_capacity=1 << 18,
                    batch_capacity=16384, channels=100,
                    analytics_devices=8192, analytics_window=128)
SLICE_TOKENS = 10_000
SLICE_BATCHES = 80
SLICE_MODEL = AnomalyConfig(sensors=100, window=128, hidden=256, lstm_hidden=256)

# the read phase: the slice engine with the bench's CEP rule set
# (bench.py:2158-2176) at the bench's rules sizes (bench.py:2225-2232), 64
# geofence zones of 16 vertices, 24 batches of the slice stream (which
# wraps the 2^18-row ring), and the bench's 16-query mix at limit 64
# (bench.py:1835-1848)
READ_BATCHES = 24
READ_RULES_CONFIG = dict(rule_groups=256, rollup_buckets=16, presence_missing_s=4.0)
RL_RULESET = {
    "name": "bench",
    "rules": [
        {"name": "hot", "kind": "threshold", "channel": "temp",
         "op": ">", "value": 90.0, "cooldownMs": 1000},
        {"name": "burst", "kind": "window", "agg": "count",
         "channel": "temp", "op": ">=", "value": 4, "windowMs": 2000,
         "where": {"channel": "temp", "op": ">", "value": 90.0}},
        {"name": "updown", "kind": "sequence",
         "first": {"channel": "temp", "op": ">", "value": 90.0},
         "then": {"channel": "temp", "op": "<", "value": 5.0},
         "withinMs": 4000},
        {"name": "silent", "kind": "absence", "channel": "temp",
         "deadlineMs": 4000},
    ],
    "rollups": [{"name": "temp-2s", "channel": "temp",
                 "windowMs": 2000, "scope": "device"}],
}
READ_ZONES, READ_ZONE_VERTICES = 64, 16
READ_QUERIES, READ_LIMIT = 16, 64
READ_CPU_BATCHES = 4

KERNELS = [dict(name="window_features", route="cuda",
                source="sitewhere_tpu_torch/csrc/window_features.cu",
                replaces="sitewhere_tpu/ops/window_features.py:40"),
           dict(name="flash_attention", route="cuda",
                source="sitewhere_tpu_torch/csrc/flash_attention.cu",
                replaces="sitewhere_tpu/ops/attention.py:66"),
           # no Pallas kernel: the gradient jax.value_and_grad takes at
           # models/transformer.py:153 of the oracle ops/attention.py:40
           dict(name="flash_attention_backward", route="cuda",
                source="sitewhere_tpu_torch/csrc/flash_attention_bwd.cu",
                replaces="sitewhere_tpu/models/transformer.py:153",
                replaces_note="no pl.pallas_call: jax.value_and_grad of "
                              "sitewhere_tpu/ops/attention.py:40 mha_reference")]

# the transformer phase: the repo's TransformerConfig() at full width on 8
# windows of 16384 timesteps (its attention is [8, 16384, 8, 32] bf16)
TF_CONFIG = TransformerConfig()
TF_WINDOWS, TF_STEPS = 8, 16384
TF_CALLS = 3
FLASH_MID_STEPS = 4096     # where the plain version fits whole (4.3 GB scores)


class Failures(list):
    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.append(what)


def emit(record: dict, log: list) -> None:
    log.append(record)
    print(json.dumps(record), flush=True)


class PinnedEpoch(EpochBase):
    """A clock that stands still, so two engines stamp identical rows."""

    def __init__(self, base_unix_s: float | None = None, now_ms: int = 5_000):
        super().__init__(base_unix_s)
        self.now = now_ms

    def now_ms(self) -> int:
        return self.now


def untraced(summary: dict) -> dict:
    """An ingest summary without its ``trace_id`` (each engine's own), which
    must be there: the flight recorder is on by default."""
    out = dict(summary)
    tid = out.pop("trace_id", None)
    if not (isinstance(tid, str) and len(tid) == 32):
        raise AssertionError(f"ingest summary without a trace_id: {summary}")
    return out


def time_ms(fn, device: torch.device, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after ``warmup``
    runs: CUDA events around each run on the card, the host clock on the
    CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def window_features_bound_ms(m: int, w: int, c: int) -> tuple[float, str]:
    """Least time for [M, W, C] -> [M, C, 6]: each input byte read once and
    each output byte written once, against ~8 float32 operations per input
    element (Welford update, min, max) at the FP32 peak."""
    t_bytes = (m * w * c * 4 + m * c * wf.NUM_FEATURES * 4) / PEAK_BYTES_PER_S
    t_ops = 8 * m * w * c / PEAK_FP32_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def flash_floors_ms(b: int, s: int, h: int, d: int, causal: bool,
                    dtype: torch.dtype) -> dict:
    """The three floors of attention on [B, S, H, D], in ms: bytes (q, k, v
    read once, the output written once), products (4·D operations per live
    (query, key) pair at the type's peak: bf16 on the tensor cores, float32
    on the CUDA cores) and exponentials (one per live pair). The bound is
    the largest."""
    item = torch.finfo(dtype).bits // 8
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    peak = PEAK_BF16_PER_S if item == 2 else PEAK_FP32_PER_S   # bf16 = fp16 rate
    return {"bytes": 4 * b * s * h * d * item / PEAK_BYTES_PER_S * 1e3,
            "products": 4 * d * pairs / peak * 1e3,
            "exponentials": pairs / PEAK_EXP_PER_S * 1e3}


def flash_backward_floors_ms(b: int, s: int, h: int, d: int, causal: bool,
                             dtype: torch.dtype) -> dict:
    """The floors of the attention backward on [B, S, H, D], in ms: bytes
    (q, k, v, o, dO read once, dq, dk, dv written once, lse read once),
    products (five a live pair: S, dP, dV, dK, dQ, 10·D operations, 2.5x
    the forward's) and exponentials (one a live pair). The bound is the
    largest."""
    item = torch.finfo(dtype).bits // 8
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    peak = PEAK_BF16_PER_S if item == 2 else PEAK_FP32_PER_S   # bf16 = fp16 rate
    return {"bytes": (8 * b * s * h * d * item + 4 * b * h * s) / PEAK_BYTES_PER_S * 1e3,
            "products": 10 * d * pairs / peak * 1e3,
            "exponentials": pairs / PEAK_EXP_PER_S * 1e3}


def ptxas_resources(text: str, prefix: str = "flash_bwd") -> dict:
    """Registers and spill bytes of each entry function whose name starts
    with ``prefix``, from ``ptxas -v`` output (``cuda_build.build_info``):
    ``{"flash_bwd_kernel<bf16,32>": {"registers": 168, "spill_stores": 0,
    "spill_loads": 0}, ...}``; bf16 / f16 / f32 in the name where the
    kernel is templated on the type, the head dim where it is templated on
    that."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            k = re.search(r"\d+(%s\w*?_kernel)(?:I(.*?)Ev|E)" % prefix, m.group(1))
            name = None
            if k and k.group(2) is None:      # not a template: its name alone
                name = k.group(1)
                out[name] = {}
            elif k:
                d = re.search(r"Li(\d+)E", k.group(2))
                t = ("bf16" if "bfloat16" in k.group(2)
                     else "f16" if "__half" in k.group(2)
                     else "f32" if k.group(2).startswith("f") else "")
                name = f"{k.group(1)}<{','.join(x for x in (t, d and d.group(1)) if x)}>"
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def fused_qkv(b: int, s: int, h: int, d: int, dtype, device, gen):
    """q, k, v as the transformer hands them to the attention: the three
    strided views of one [B, S, 3, H, D] tensor."""
    qkv = torch.randn((b, s, 3, h, d), device=device, generator=gen).to(dtype)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


PLAIN_HEADS = 8     # heads the plain versions take at once, one window at a time


def _plain_parts(b: int, h: int):
    """(window, head slice) pairs that cover [B, ., H]: one window and at
    most PLAIN_HEADS heads a part (heads are independent), so that a part's
    [1, PLAIN_HEADS, S, S] float32 scores stay at 8.6 GB at S = 16384."""
    return [(slice(i, i + 1), slice(h0, min(h0 + PLAIN_HEADS, h)))
            for i in range(b) for h0 in range(0, h, PLAIN_HEADS)]


def plain_per_window(q, k, v, causal: bool, sm_scale: float | None = None) -> torch.Tensor:
    """The plain version one window (and up to PLAIN_HEADS heads) at a time:
    at S=16384 its whole-batch [8, 8, S, S] float32 scores would need 69 GB."""
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for w, hs in _plain_parts(q.shape[0], q.shape[2]):
        out[w, :, hs] = fa.mha_reference(q[w, :, hs], k[w, :, hs], v[w, :, hs],
                                         causal=causal, sm_scale=sm_scale)
    return out


# ------------------------------------------------------------------ phases
def phase_build(log, fails) -> None:
    t0 = time.perf_counter()
    libs = [pathlib.Path(k["source"]).stem for k in KERNELS]
    info = cuda_build.build(libs)
    for lib in libs:
        cuda_build.load(lib)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"nvcc_s": v["seconds"],
                             "ptxas": [ln.strip() for ln in v["ptxas"].splitlines()
                                       if "entry function" in ln or "registers" in ln
                                       or "spill" in ln]}
                      for name, v in info.items()}}, log)


def phase_kernel_window_features(device, log, fails, shape=(8192, 128, 100)) -> dict:
    """window_features against its plain version: the scoring path's shape,
    a ragged M, C = 8 and a large-offset ramp on the float4 path (C % 4 ==
    0); C = 30 and a pointer 4 bytes past a 16-byte boundary on the scalar
    path."""
    gen = torch.Generator(device=device).manual_seed(0)
    m, w, c = shape
    flat = torch.randn(512 * w * c + 1, device=device, generator=gen)
    cases = {
        "main": torch.randn(shape, device=device, generator=gen),
        "ragged_m": torch.randn((1237, w, c), device=device, generator=gen),
        "c8": torch.randn((max(m // 2, 1), w, 8), device=device, generator=gen),
        "offset": (1e3 * torch.arange(1, w + 1, device=device)[None, :, None]
                   + torch.randn((512, w, c), device=device, generator=gen)),
        "c30_scalar": torch.randn((max(m // 4, 1), w, 30), device=device, generator=gen),
        "misaligned_scalar": flat[1:].view(512, w, c),
    }
    errs = {}
    for name, x in cases.items():
        got = wf.window_features(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ref = wf.window_features_reference(x)
        errs[name] = (got - ref).abs().max().item()
        fails.check(torch.allclose(got, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL)
                    and bool(torch.isfinite(got).all()),
                    f"window_features disagrees with its plain version on {name} "
                    f"{tuple(x.shape)}: max abs err {errs[name]}")
    x = cases["main"]
    ms = time_ms(lambda: wf.window_features(x), device)
    plain_ms = time_ms(lambda: wf.window_features_reference(x), device)
    bound_ms, bound_by = window_features_bound_ms(*x.shape)
    rec = {"phase": "kernel", "name": "window_features", "shape": list(x.shape),
           "tol": KERNEL_TOL, "max_abs_err": errs, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    emit(rec, log)
    # no single PyTorch call computes the six features
    return dict(max_abs_err=errs["main"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_kernel_flash(device, log, fails, main=(TF_WINDOWS, TF_STEPS, 8, 32),
                       mid_steps: int = FLASH_MID_STEPS, reps: int = 10) -> dict:
    """flash_attention against mha_reference: at the transformer's shape
    (strided views of one fused qkv tensor, bf16, causal; the plain version
    one window at a time), at [8, 4096, 8, 32] causal and not (and causal
    in float32, the CUDA-core kernel), at S=1, at a
    ragged S, at the bf16 kernel's tile edges (S = 63, 64, 65, 129, causal
    and not), at D=16 and D=64 in bf16 and in float32, on contiguous
    [B, S, H, D] inputs, and with a zero and a negative ``sm_scale`` (bf16,
    ragged S, causal and not). Times kernel, plain version and SDPA (the
    library yardstick) at the main shape and at S=4096, bf16 and float32
    (SDPA in float32 with TF32 off)."""
    gen = torch.Generator(device=device).manual_seed(1)
    b, s, h, d = main
    bf16, f32 = torch.bfloat16, torch.float32
    edges = {f"s{n}_{'causal' if causal else 'full'}":
             (fused_qkv(2, n, h, d, bf16, device, gen), causal)
             for n in (63, 64, 65, 129) for causal in (True, False)}
    contiguous = {f"contiguous_{'causal' if causal else 'full'}":
                  (tuple(t.contiguous() for t in fused_qkv(2, 1000, h, d, bf16, device, gen)),
                   causal) for causal in (True, False)}
    inputs = {
        "main": (fused_qkv(b, s, h, d, bf16, device, gen), True),
        f"s{mid_steps}_causal": (fused_qkv(b, mid_steps, h, d, bf16, device, gen), True),
        f"s{mid_steps}_full": (fused_qkv(b, mid_steps, h, d, bf16, device, gen), False),
        "s1": (fused_qkv(2, 1, h, d, bf16, device, gen), True),
        "ragged_s1000": (fused_qkv(2, 1000, h, d, bf16, device, gen), True),
        "ragged_s1000_full_f32": (fused_qkv(2, 1000, h, d, f32, device, gen), False),
        "d64_f32": (fused_qkv(2, 777, 4, 64, f32, device, gen), True),
        "d16_f32": (fused_qkv(2, 300, 2, 16, f32, device, gen), False),
        "d64_bf16": (fused_qkv(2, 777, 4, 64, bf16, device, gen), True),
        "d64_bf16_full": (fused_qkv(2, 777, 4, 64, bf16, device, gen), False),
        "d16_bf16": (fused_qkv(2, 300, 2, 16, bf16, device, gen), True),
        "d16_bf16_full": (fused_qkv(2, 300, 2, 16, bf16, device, gen), False),
        **edges, **contiguous,
    }
    inputs[f"s{mid_steps}_causal_f32"] = (fused_qkv(b, mid_steps, h, d, f32, device, gen),
                                          True)
    scaled = {f"scale{scale:g}_{'causal' if causal else 'full'}":
              (fused_qkv(2, 333, h, d, bf16, device, gen), causal, scale)
              for scale in (0.0, -0.3) for causal in (True, False)}
    errs = {}
    for name, ((q, k, v), causal, scale) in ({n: (*c, None) for n, c in inputs.items()}
                                             | scaled).items():
        got = fa.flash_attention(q, k, v, causal=causal, sm_scale=scale)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ref = plain_per_window(q, k, v, causal, scale)
        errs[name] = (got.float() - ref.float()).abs().max().item()
        tol = FLASH_TOL[q.dtype]
        fails.check(got.shape == ref.shape and got.dtype == ref.dtype
                    and torch.allclose(got.float(), ref.float(), rtol=tol, atol=tol)
                    and bool(torch.isfinite(got).all()),
                    f"flash_attention disagrees with its plain version on {name} "
                    f"{tuple(q.shape)} {q.dtype} causal={causal}: max abs err {errs[name]}")
        del got, ref

    timings = {}
    for name in ("main", f"s{mid_steps}_causal", f"s{mid_steps}_causal_f32"):
        (q, k, v), causal = inputs[name]
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, S, D]
        t = {"ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                           device, reps=reps, warmup=2),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal), device, reps=reps, warmup=2)}
        if name == "main":
            t["plain_ms"] = time_ms(lambda: plain_per_window(q, k, v, causal),
                                    device, reps=3, warmup=1)
        else:
            t["plain_ms"] = time_ms(lambda: fa.mha_reference(q, k, v, causal=causal),
                                    device, reps=reps, warmup=2)
        floors = flash_floors_ms(*q.shape, causal, q.dtype)
        binding = max(floors, key=floors.get)
        t.update(shape=list(q.shape), dtype=str(q.dtype), floors_ms=floors,
                 binding_floor=binding,
                 bound_ms=floors[binding],
                 bound_by="bytes" if binding == "bytes" else "operations")
        timings[name] = t
    rec = {"phase": "kernel", "name": "flash_attention", "tol": {
               str(k): v for k, v in FLASH_TOL.items()},
           "max_abs_err": errs, "timings": timings,
           "plain_main_note": "mha_reference one window at a time"}
    emit(rec, log)
    t = timings["main"]
    return dict(max_abs_err=errs["main"], ms=t["ms"], plain_ms=t["plain_ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["library_ms"])


def plain_backward_per_window(q, k, v, o, do, lse, causal: bool,
                              sm_scale: float | None = None) -> tuple:
    """The plain backward one window (and up to PLAIN_HEADS heads) at a
    time: at S = 16384 a part's P, dP and dS are 8.6 GB each in float32."""
    grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    for w, hs in _plain_parts(q.shape[0], q.shape[2]):
        part = fa.mha_backward_reference(q[w, :, hs], k[w, :, hs], v[w, :, hs], o[w, :, hs],
                                         do[w, :, hs], lse[w, hs].contiguous(),
                                         causal=causal, sm_scale=sm_scale)
        for g, x in zip(grads, part):
            g[w, :, hs] = x
    return grads


# cases of the C6 phase up to this S (the main shapes aside) are held to
# ``float64_reference`` (a [2, 4, 1000, 1000] float64 score tensor is
# 32 MB); longer ones to the plain version
COND_MAX_S = 1000
F32_UNIT = 2.0 ** -24       # float32's unit roundoff


def float64_reference(q, k, v, o, do, lse, causal: bool,
                      sm_scale: float | None = None) -> tuple:
    """The yardstick of the C6 checks, in float64 on the same inputs: the
    exact output; (dq, dk, dv) by the plain version's formula
    (``fa.mha_backward_reference``: P from the forward's ``lse``, delta
    from its output ``o``), the exact value of what the backward kernel
    computes from them; and, for the output and each gradient, the
    first-order error of a float32 evaluation of that formula, each float32
    rounding taken as one unit (F32_UNIT) of the magnitude it rounds: P's
    exponent (the score sum's terms |q||k| times |scale|, and lse), dP and
    delta (their terms |dO||v| and |dO||o|). Returns (o, o_bound, grads,
    grad_bounds), each bound [B, S, H, D]. Where softmax rows saturate (a
    large scale at a large D), dP - delta cancels to near the rounding of
    its terms, and any float32 evaluation, plain or kernel, misses some
    rows of dq by much of the row: the bound says by how much."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    qd, kd, vd, od, dod = (t.double() for t in (q, k, v, o, do))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * scale
    if causal:
        n = s.shape[-1]
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=s.device).triu(1),
                          -math.inf)
    o64 = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), vd)
    p = s.sub_(lse.double()[..., None]).exp_()
    # P's relative error, and P times it
    pe = p * (torch.einsum("bqhd,bkhd->bhqk", qd.abs(), kd.abs()) * abs(scale)
              + lse.double().abs()[..., None]) * F32_UNIT
    dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd).sub_(
        (dod * od).sum(-1).transpose(1, 2)[..., None])
    # dS = P (dP - delta) and its error
    dse = (pe * dp.abs()).add_(p * F32_UNIT * torch.einsum(
        "bqhd,bkhd->bhqk", dod.abs(), vd.abs()).add_(
        (dod * od).abs().sum(-1).transpose(1, 2)[..., None]))
    ds = dp.mul_(p)
    grads = (torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale,
             torch.einsum("bhqk,bqhd->bkhd", ds, qd) * scale,
             torch.einsum("bhqk,bqhd->bkhd", p, dod))
    bounds = (torch.einsum("bhqk,bkhd->bqhd", dse, kd.abs()) * abs(scale),
              torch.einsum("bhqk,bqhd->bkhd", dse, qd.abs()) * abs(scale),
              torch.einsum("bhqk,bqhd->bkhd", pe, dod.abs()))
    return o64, torch.einsum("bhqk,bkhd->bqhd", pe, vd.abs()), grads, bounds


def lse_per_window(q, k, causal: bool, sm_scale: float | None = None) -> torch.Tensor:
    out = torch.empty((q.shape[0], q.shape[2], q.shape[1]), device=q.device)
    for w, hs in _plain_parts(q.shape[0], q.shape[2]):
        out[w, hs] = fa.lse_reference(q[w, :, hs], k[w, :, hs], causal=causal,
                                      sm_scale=sm_scale)
    return out


def phase_kernel_flash_backward(device, log, fails, main=(TF_WINDOWS, TF_STEPS, 8, 32),
                                mid_steps: int = FLASH_MID_STEPS, reps: int = 10) -> dict:
    """flash_attention_backward (and the forward's ``lse``) against
    mha_backward_reference (and lse_reference): at the training shape
    ([8, 16384, 8, 32] bf16 causal, strided views of one fused qkv tensor;
    the plain versions one window at a time), at [8, 4096, 8, 32] causal
    and not in bf16 and float32, at S = 1, a ragged S, the tiles' edges (S
    = 63, 64, 65, 129, causal and not), D = 16 and 64 in bf16 and float32,
    and with a zero and a negative ``sm_scale``. Each row of each gradient
    within GRAD_TOL of that row's largest element (GRAD_ATOL off on the
    rows whose exact gradient is 0), the lse within LSE_TOL; at the main
    shape a second call must give the same bits (dQ is summed across key
    blocks in a fixed order). Times the kernel (one backward call: prep
    pass, main kernel, dQ to bf16), the plain backward and the library
    yardstick: SDPA forward+backward (``torch.autograd.grad`` of its output
    for dO, so no ``.grad`` accumulates) minus SDPA's forward alone with
    grad enabled (the forward that saves the log-sum-exp), at the main
    shape and at S = 4096 in bf16 and float32; each timing also gives the
    kernel's time over SDPA's (``vs_library``), the useful product rate of
    the five products a live pair (``tflops``) and the bound's share of the
    kernel's time (``bound_share``). The record carries ptxas's registers
    and spills of every backward kernel."""
    gen = torch.Generator(device=device).manual_seed(2)
    b, s, h, d = main
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {"main": (fused_qkv(b, s, h, d, bf16, device, gen), True, None)}
    for dt in (bf16, f32):
        for causal in (True, False):
            name = f"s{mid_steps}_{'causal' if causal else 'full'}_{'bf16' if dt == bf16 else 'f32'}"
            cases[name] = (fused_qkv(b, mid_steps, h, d, dt, device, gen), causal, None)
    cases |= {
        "s1": (fused_qkv(2, 1, h, d, bf16, device, gen), True, None),
        "s1_full_f32": (fused_qkv(2, 1, h, d, f32, device, gen), False, None),
        "ragged_s1000": (fused_qkv(2, 1000, h, d, bf16, device, gen), True, None),
        "ragged_s1000_full_f32": (fused_qkv(2, 1000, h, d, f32, device, gen), False, None),
        "d64_bf16": (fused_qkv(2, 777, 4, 64, bf16, device, gen), True, None),
        "d64_bf16_full": (fused_qkv(2, 777, 4, 64, bf16, device, gen), False, None),
        "d64_f32": (fused_qkv(2, 777, 4, 64, f32, device, gen), True, None),
        "d16_bf16": (fused_qkv(2, 300, 2, 16, bf16, device, gen), True, None),
        "d16_f32": (fused_qkv(2, 300, 2, 16, f32, device, gen), False, None),
        **{f"s{n}_{'causal' if c else 'full'}": (fused_qkv(2, n, h, d, bf16, device, gen), c, None)
           for n in (63, 64, 65, 129) for c in (True, False)},
        **{f"scale{sc:g}_{'causal' if c else 'full'}_{'bf16' if dt == bf16 else 'f32'}":
           (fused_qkv(2, 333, h, d, dt, device, gen), c, sc)
           for sc in (0.0, -0.3) for c in (True, False) for dt in (bf16, f32)},
    }
    errs, lse_errs, saved = {}, {}, {}
    for name, ((q, k, v), causal, scale) in cases.items():
        do = torch.randn(q.shape, device=device, generator=gen).to(q.dtype)
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=scale)
        got = fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal, sm_scale=scale)
        if name == "main":
            again = fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal,
                                                sm_scale=scale)
            bitwise = all(torch.equal(x, y) for x, y in zip(got, again))
            fails.check(bitwise, "flash_attention_backward gives other bits on a second call "
                                 f"at the main shape {tuple(q.shape)}")
            del again
        if device.type == "cuda":
            torch.cuda.synchronize()
        ref_lse = lse_per_window(q, k, causal, scale)
        lse_errs[name] = (lse - ref_lse).abs().max().item()
        fails.check(torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL),
                    f"flash_attention lse disagrees with lse_reference on {name}: "
                    f"max abs err {lse_errs[name]}")
        del ref_lse
        ref = plain_backward_per_window(q, k, v, o, do, lse, causal, scale)
        errs[name] = {}
        for t, g, r in zip("qkv", got, ref):
            ok = (g.shape == r.shape and g.dtype == r.dtype and g.is_contiguous()
                  and bool(torch.isfinite(g.float()).all()))
            shares = fa.gradient_row_shares(g, r, f"d{t}", causal=causal, atol=GRAD_ATOL)
            worst = shares.max().item()
            errs[name][f"d{t}"] = {"abs": (g.float() - r.float()).abs().max().item(),
                                   "max_ref": r.float().abs().max().item(),
                                   "row_share": worst}
            fails.check(ok and worst <= GRAD_TOL[q.dtype],
                        f"flash_attention_backward d{t} disagrees with its plain version "
                        f"on {name} {tuple(q.shape)} {q.dtype} causal={causal}: worst row "
                        f"err {worst} of its row's max against {GRAD_TOL[q.dtype]}")
            del shares
        del got, ref
        if name in ("main", f"s{mid_steps}_causal_bf16", f"s{mid_steps}_causal_f32"):
            saved[name] = (q, k, v, o, do, lse, causal)

    timings = {}
    for name, (q, k, v, o, do, lse, causal) in saved.items():
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            torch.autograd.grad(F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal),
                                (qt, kt, vt), dot)

        def sdpa_fwd():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

        t = {"ms": time_ms(lambda: fa.flash_attention_backward(q, k, v, o, do, lse,
                                                               causal=causal),
                           device, reps=reps, warmup=2),
             "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, device, reps=reps, warmup=2),
             "sdpa_fwd_ms": time_ms(sdpa_fwd, device, reps=reps, warmup=2)}
        t["library_ms"] = t["sdpa_fwd_bwd_ms"] - t["sdpa_fwd_ms"]
        if name == "main":
            t["plain_ms"] = time_ms(lambda: plain_backward_per_window(q, k, v, o, do, lse,
                                                                      causal),
                                    device, reps=3, warmup=1)
        else:
            t["plain_ms"] = time_ms(lambda: fa.mha_backward_reference(q, k, v, o, do, lse,
                                                                      causal=causal),
                                    device, reps=reps, warmup=2)
        floors = flash_backward_floors_ms(*q.shape, causal, q.dtype)
        binding = max(floors, key=floors.get)
        bq, sq, hq, dq_ = q.shape
        pairs = bq * hq * (sq * (sq + 1) // 2 if causal else sq * sq)
        t.update(shape=list(q.shape), dtype=str(q.dtype), floors_ms=floors,
                 binding_floor=binding, bound_ms=floors[binding],
                 bound_by="bytes" if binding == "bytes" else "operations",
                 vs_library=t["ms"] / t["library_ms"],
                 tflops=10 * dq_ * pairs / (t["ms"] * 1e-3) / 1e12,
                 bound_share=floors[binding] / t["ms"])
        timings[name] = t
        del qt, kt, vt
    ptxas = ptxas_resources(cuda_build.build_info.get(fa.BWD_KERNEL, {}).get("ptxas", ""))
    rec = {"phase": "kernel", "name": "flash_attention_backward",
           "bitwise_deterministic_main": bitwise, "ptxas": ptxas,
           "tol_of_row_max": {str(k): v for k, v in GRAD_TOL.items()},
           "atol_on_exact_zero_rows": GRAD_ATOL,
           "lse_tol": LSE_TOL, "max_abs_err": errs, "lse_max_abs_err": lse_errs,
           "timings": timings,
           "plain_main_note": "mha_backward_reference one window at a time",
           "library_note": "SDPA forward+backward (torch.autograd.grad) minus SDPA "
                           "forward, both with grad enabled"}
    emit(rec, log)
    t = timings["main"]
    return dict(max_abs_err=max(e["abs"] for e in errs["main"].values()),
                max_err_of_max=max(e["abs"] / e["max_ref"] for e in errs["main"].values()),
                max_row_share=max(e["row_share"] for e in errs["main"].values()),
                ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t["library_ms"],
                vs_library=t["vs_library"], tflops=t["tflops"],
                bound_share=t["bound_share"], bitwise_deterministic=bitwise,
                ptxas={k: v for k, v in ptxas.items() if "f32" not in k})


# the head dims and the type of fault C6: D between the instantiated 16,
# 32, 64, 128 runs zero-padded, D = 128 has its own instantiations, and
# float16 its own kernels; the checked and timed shapes are the
# d_model=256, heads=2 model's ([8, 16384, 2, 128], bf16 and float16) and
# the default model's in float16 ([8, 16384, 8, 32])
C6_MAIN = (TF_WINDOWS, TF_STEPS, 2, 128)
C6_F16_MAIN = (TF_WINDOWS, TF_STEPS, 8, 32)
# checked and timed too, at the windows and steps of C6_MAIN, (heads, D,
# dtype): the default model's width (d_model 256) at D = 64 in both 16-bit
# types, the d_model=384, heads=8 model's D = 48 (padded to 64, the copy
# included) in bf16, and at D = 256 (d_model 256, heads 1) in both
C6_MAIN_HEADS = {"main_d64_bf16": (4, 64, torch.bfloat16),
                 "main_d64_f16": (4, 64, torch.float16),
                 "main_d48_bf16": (8, 48, torch.bfloat16),
                 # the d_model=256, heads=1 model's width (D = 256, 64-key
                 # tiles and blocks) in both 16-bit types
                 "main_d256_bf16": (1, 256, torch.bfloat16),
                 "main_d256_f16": (1, 256, torch.float16)}
# timed only, there: the default model's width at D = 16 in bf16
C6_TIMED_HEADS = {"d16_bf16": (16, 16, torch.bfloat16)}
# timed only, at a shape of their own: float32 at D = 256 (the CUDA-core
# kernels, off the transformer's path) on 2 windows of 4096 steps
C6_TIMED_SHAPES = {"d256_f32": ((2, 4096, 1, 256), torch.float32)}


def _c6_cases(device, gen) -> dict:
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = {}
    for dt, dims in ((bf16, (8, 48, 100, 128)), (f16, (8, 32, 48, 64, 128)), (f32, (48, 128))):
        tag = {bf16: "bf16", f16: "f16", f32: "f32"}[dt]
        for d in dims:
            h = 2 if d >= 100 else 4
            for causal in (True, False):
                cases[f"d{d}_{tag}_{'causal' if causal else 'full'}"] = (
                    fused_qkv(2, 333 if d != 100 else 65, h, d, dt, device, gen), causal, None)
    cases |= {
        "d128_bf16_s1": (fused_qkv(2, 1, 2, 128, bf16, device, gen), True, None),
        "d128_bf16_s1000": (fused_qkv(2, 1000, 2, 128, bf16, device, gen), True, None),
        "d32_f16_s1000_contiguous": (tuple(t.contiguous() for t in fused_qkv(
            2, 1000, 8, 32, f16, device, gen)), True, None),
        "d128_bf16_scale-0.3": (fused_qkv(2, 333, 2, 128, bf16, device, gen), True, -0.3),
        "d32_f16_scale-0.3": (fused_qkv(2, 333, 4, 32, f16, device, gen), True, -0.3),
        "d32_f16_scale0": (fused_qkv(2, 333, 4, 32, f16, device, gen), False, 0.0),
    }
    # the wgmma forward at D = 64 in both 16-bit types: S of one key, one
    # key past a tile, a ragged S, and both signs of scale that need care
    for dt, tag in ((bf16, "bf16"), (f16, "f16")):
        for n in (1, 65, 777, 1000):
            for causal in (True, False):
                cases[f"d64_{tag}_s{n}_{'causal' if causal else 'full'}"] = (
                    fused_qkv(2, n, 4, 64, dt, device, gen), causal, None)
        cases[f"d64_{tag}_scale-0.3"] = (fused_qkv(2, 333, 4, 64, dt, device, gen), True, -0.3)
        cases[f"d64_{tag}_scale0"] = (fused_qkv(2, 333, 4, 64, dt, device, gen), False, 0.0)
    # D = 256 (its own instantiations, 64-key tiles and blocks) and D = 192
    # (padded to 256) in all three types: S = 333 (ragged, past several
    # tiles), at D = 256 also S = 1 and 65 (one key past a tile) and, in
    # the 16-bit types, 1000; both signs of scale that need care
    for dt, tag in ((bf16, "bf16"), (f16, "f16"), (f32, "f32")):
        for d in (192, 256):
            for causal in (True, False):
                cases[f"d{d}_{tag}_{'causal' if causal else 'full'}"] = (
                    fused_qkv(2, 333, 2, d, dt, device, gen), causal, None)
            cases[f"d{d}_{tag}_scale-0.3"] = (fused_qkv(2, 333, 2, d, dt, device, gen), True, -0.3)
            cases[f"d{d}_{tag}_scale0"] = (fused_qkv(2, 333, 2, d, dt, device, gen), False, 0.0)
        for n in (1, 65) + ((1000,) if dt != f32 else ()):
            for causal in (True, False):
                cases[f"d256_{tag}_s{n}_{'causal' if causal else 'full'}"] = (
                    fused_qkv(2, n, 1 if n == 1000 else 2, 256, dt, device, gen), causal, None)
    # the padded head dims, D = 64 in both 16-bit types and D = 192 and 256
    # at the shapes transformer_c6 runs them at
    for name, cfg_name in (("d8_bf16", "d8"), ("d48_bf16", "d48"), ("d64_bf16", "d64"),
                           ("d64_f16", "f16_d64"), ("d256_bf16", "d256"), ("d192_bf16", "d192"),
                           ("d256_f16", "f16_d256")):
        cfg = TF_C6_CONFIGS[cfg_name]
        cases[f"tf_{name}"] = (fused_qkv(*TF_C6_SHAPE, cfg.heads, cfg.d_model // cfg.heads,
                                         cfg.dtype, device, gen), True, None)
    return cases


def bf16_rounded_reference(q, k, v, o, do, lse, causal: bool,
                           sm_scale: float | None = None) -> tuple:
    """The attention and its gradient with P and dS rounded to bf16 before
    their products, one window at a time in float32: the output P·V and dv
    = P^T dO with P rounded, dq = scale dS K and dk = scale dS^T Q with dS
    rounded, each returned in q's type. On bf16 inputs it is the bf16
    kernels' own arithmetic (in another order of sums), the yardstick of
    their gradient limit; on float16 inputs it is what a float16 kernel
    that rounded to bf16 (8 significant bits where float16 has 11) would
    give, the control that the float16 limits must fail."""
    scale = 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale
    parts = []
    for i in range(q.shape[0]):
        w = slice(i, i + 1)
        qf, kf, vf, dof = (t[w].float() for t in (q, k, v, do))
        p = fa._scores(q[w], k[w], causal, sm_scale).sub_(lse[w].float()[..., None]).exp_()
        delta = (dof * o[w].float()).sum(-1).transpose(1, 2)
        ds = torch.einsum("bqhd,bkhd->bhqk", dof, vf).sub_(delta[..., None]).mul_(p)
        p = p.bfloat16().float()
        out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
        dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
        del p
        ds = ds.bfloat16().float()
        dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf).mul_(scale)
        dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf).mul_(scale)
        del ds
        parts.append(tuple(t.to(q.dtype) for t in (out, dq, dk, dv)))
    return tuple(torch.cat(x) for x in zip(*parts))


def _allclose_share(got, ref) -> float:
    """The least x for which allclose(got, ref, rtol=x, atol=x) holds."""
    g, r = got.float(), ref.float()
    return ((g - r).abs() / (1 + r.abs())).max().item()


def _c6_timings(q, k, v, do, causal: bool, device, reps: int) -> dict:
    """Forward and backward of the kernels at one shape against SDPA
    (forward; forward+backward minus forward), the plain versions one
    window at a time, and the floors."""
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (qt, kt, vt), dot)

    with torch.no_grad():
        fwd = {"ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal), device,
                             reps=reps, warmup=2),
               "library_ms": time_ms(sdpa_fwd, device, reps=reps, warmup=2),
               "plain_ms": time_ms(lambda: plain_per_window(q, k, v, causal), device,
                                   reps=2, warmup=1)}
    bwd = {"ms": time_ms(lambda: fa.flash_attention_backward(q, k, v, o, do, lse,
                                                             causal=causal),
                         device, reps=reps, warmup=2),
           "sdpa_fwd_bwd_ms": time_ms(sdpa_fwd_bwd, device, reps=reps, warmup=2),
           "sdpa_fwd_ms": time_ms(sdpa_fwd, device, reps=reps, warmup=2),
           "plain_ms": time_ms(lambda: plain_backward_per_window(q, k, v, o, do, lse, causal),
                               device, reps=2, warmup=1)}
    bwd["library_ms"] = bwd["sdpa_fwd_bwd_ms"] - bwd["sdpa_fwd_ms"]
    b, s, h, d = q.shape
    pairs = b * h * (s * (s + 1) // 2 if causal else s * s)
    for t, floors, ops in ((fwd, flash_floors_ms(b, s, h, d, causal, q.dtype), 4),
                           (bwd, flash_backward_floors_ms(b, s, h, d, causal, q.dtype), 10)):
        binding = max(floors, key=floors.get)
        t.update(shape=[b, s, h, d], dtype=str(q.dtype), floors_ms=floors,
                 binding_floor=binding, bound_ms=floors[binding],
                 bound_by="bytes" if binding == "bytes" else "operations",
                 vs_library=t["ms"] / t["library_ms"],
                 tflops=ops * d * pairs / (t["ms"] * 1e-3) / 1e12,
                 bound_share=floors[binding] / t["ms"])
    return {"forward": fwd, "backward": bwd}


def phase_kernel_flash_c6(device, log, fails, main=C6_MAIN, f16_main=C6_F16_MAIN,
                          reps: int = 10) -> dict:
    """The attention at every head dim and in float16 (fault C6): the
    forward, its ``lse`` and the backward against their plain versions at
    D = 8, 48 and 100 (zero-padded to 16, 64 and 128), D = 128 (its own
    instantiations) in bf16 and float32, float16 at D = 8, 32, 48, 64 and
    128, causal and not, S = 1 and a ragged S, contiguous inputs, a negative
    and a zero scale (at D = 64 in both 16-bit types, with S = 1, 65 and
    777 and 1000), D = 256 and 192 (padded to it) in all three types with
    S = 333, both signs of scale and, at 256, S = 1, 65 and 1000, and
    D = 8, 48, 64 (both types), 192 and 256 (both) at the transformer_c6
    shapes. The yardstick is ``float64_reference`` up to COND_MAX_S (the
    main shapes aside), else the plain version: each output element within
    FLASH_TOL, each gradient row within GRAD_TOL of the row's largest
    element (bf16: or GRAD_ARITH_MARGIN times bf16's own arithmetic on the
    case, whichever is larger; float16: its subnormal step off), or, where
    that is larger, within GRAD_ARITH_MARGIN times float32's first-order
    error bound there (saturated softmax rows: the rows and elements it
    frees are counted, the kernel's, the plain float32 version's and the
    limit's readings beside); float16's bf16-rounded control, held the
    same way, must fail. Two backward calls give
    the same bits at the main shapes: the d_model=256, heads=2 model's
    shape ``main`` in bf16 and float16, the default model's shape in
    float16 (``f16_main``), and at ``main``'s windows and steps the default
    model's width with D = 64 in both types, the d48 model's full width
    and D = 256 in both types (``C6_MAIN_HEADS``). Then times the
    forward and the backward against SDPA, causal, at each main shape from
    the checked tensors, at the default model's width with D = 16
    (``C6_TIMED_HEADS``) and float32 at D = 256 on [2, 4096]
    (``C6_TIMED_SHAPES``), with the floors, and ptxas's registers and
    spills of every wgmma and float16 kernel and of each kernel at
    D = 128 and 256."""
    gen = torch.Generator(device=device).manual_seed(5)
    cases = _c6_cases(device, gen)
    cases["main_d128_bf16"] = (fused_qkv(*main, torch.bfloat16, device, gen), True, None)
    cases["main_d128_f16"] = (fused_qkv(*main, torch.float16, device, gen), True, None)
    cases["main_f16"] = (fused_qkv(*f16_main, torch.float16, device, gen), True, None)
    for name, (h, d, dt) in C6_MAIN_HEADS.items():
        cases[name] = (fused_qkv(main[0], main[1], h, d, dt, device, gen), True, None)
    errs, launches = {}, {"flash_attention": 0, "flash_attention_backward": 0}
    saved = {}
    for name, ((q, k, v), causal, scale) in cases.items():
        do = torch.randn(q.shape, device=device, generator=gen).to(q.dtype)
        f0, b0 = fa.flash_attention.launches, fa.flash_attention_backward.launches
        got = fa.flash_attention(q, k, v, causal=causal, sm_scale=scale)
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal, sm_scale=scale)
        grads = fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal,
                                            sm_scale=scale)
        _sync(device)
        launches["flash_attention"] += fa.flash_attention.launches - f0
        launches["flash_attention_backward"] += fa.flash_attention_backward.launches - b0
        fails.check((fa.flash_attention.launches - f0,
                     fa.flash_attention_backward.launches - b0) == (2, 1),
                    f"flash C6 {name}: the kernels did not launch (forward twice, "
                    "backward once)")
        ref_o = plain_per_window(q, k, v, causal, scale)
        tol = FLASH_TOL[q.dtype]
        e = {"out": (got.float() - ref_o.float()).abs().max().item()}
        # the yardstick: float64 (small cases), else the plain version. Each
        # output element within the type's tolerance (rtol = atol), or
        # GRAD_ARITH_MARGIN times float32's first-order error bound there,
        # whichever is larger
        exact = (float64_reference(q, k, v, o, do, lse, causal, scale)
                 if not name.startswith("main") and q.shape[1] <= COND_MAX_S else None)
        if exact is not None:
            o_lim = torch.maximum(tol * (1 + exact[0].abs()), GRAD_ARITH_MARGIN * exact[1])
            e["out_freed"] = int((o_lim > tol * (1 + exact[0].abs())).sum())

        def out_over(x) -> float:
            """An output's largest error as a share of its limit."""
            if exact is None:
                return _allclose_share(x, ref_o) / tol
            return ((x.double() - exact[0]).abs() / o_lim).max().item()
        e["out_over_limit"] = out_over(got)
        fails.check(got.shape == ref_o.shape and got.dtype == ref_o.dtype and got.is_contiguous()
                    and e["out_over_limit"] <= 1.0 and bool(torch.isfinite(got.float()).all()),
                    f"flash_attention disagrees on C6 {name} {tuple(q.shape)} {q.dtype}: max "
                    f"abs err {e['out']} against the plain version, {e['out_over_limit']} "
                    f"times its limit")
        del got
        ref_lse = lse_per_window(q, k, causal, scale)
        e["lse"] = (lse - ref_lse).abs().max().item()
        fails.check(torch.allclose(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL),
                    f"flash_attention lse disagrees on C6 {name}: {e['lse']}")
        del ref_lse
        ref = plain_backward_per_window(q, k, v, o, do, lse, causal, scale)
        step = GRAD_STEP.get(q.dtype, 0.0)
        limit = {t: GRAD_TOL[q.dtype] for t in "qkv"}
        if q.dtype == torch.bfloat16:
            # bf16's own arithmetic on these inputs: where it reads past
            # GRAD_TOL (a true head dim of 8 at long S), the limit is
            # GRAD_ARITH_MARGIN times its reading
            _, *a_grads = bf16_rounded_reference(q, k, v, o, do, lse, causal, scale)
            for t, g, r in zip("qkv", a_grads, ref):
                a = fa.gradient_row_shares(g, r, f"d{t}", causal=causal,
                                           atol=GRAD_ATOL).max().item()
                e[f"d{t}_bf16_arithmetic_row_share"] = a
                limit[t] = max(limit[t], GRAD_ARITH_MARGIN * a)
            del a_grads
        # the gradients against the same yardstick, row by row: a row's
        # limit, as an absolute error, is the floor above times the row's
        # largest element (plus GRAD_ATOL on the rows whose exact gradient
        # is 0), or GRAD_ARITH_MARGIN times float32's first-order error
        # bound on the row, whichever is larger
        yard = ref if exact is None else exact[2]

        def row_shares(g, x, t):
            return fa.gradient_row_shares(g, x, f"d{t}", causal=causal, atol=GRAD_ATOL,
                                          step=step)

        def over_limit(g, x, t):
            err = fa.gradient_row_errors(g, x, f"d{t}", causal=causal, step=step)[0]
            return torch.where(limits[t] > 0, err / limits[t],
                               torch.where(err > 0, math.inf, 0.0))
        limits, freed, tops = {}, {}, {}
        for i, (t, x) in enumerate(zip("qkv", yard)):
            _, tops[t], zero = fa.gradient_row_errors(x, x, f"d{t}", causal=causal)
            floor = limit[t] * tops[t] + GRAD_ATOL * zero
            bound = (GRAD_ARITH_MARGIN * exact[3][i].amax(-1).float() if exact is not None
                     else torch.zeros_like(floor))
            limits[t], freed[t] = torch.maximum(floor, bound), bound > floor
        for t, g, r, x in zip("qkv", grads, ref, yard):
            over = over_limit(g, x, t)
            got_s = row_shares(g, x, t)
            worst = int(over.argmax())
            e[f"d{t}_row_share"] = got_s.max().item()
            e[f"d{t}_over_limit"] = over.max().item()
            e[f"d{t}_freed_rows"] = int(freed[t].sum())
            if e[f"d{t}_freed_rows"]:
                # the rows float32's bound frees, the kernel's worst first:
                # its reading, the plain float32 version's and the limit's,
                # each a share of the row's largest element
                over_f = torch.where(freed[t], over, -1.0)
                plain_s, lim_s = row_shares(r, x, t), limits[t] / tops[t]
                e[f"d{t}_freed"] = [
                    {"row": [int(i) for i in np.unravel_index(int(j), over_f.shape)],
                     "kernel": got_s.flatten()[j].item(), "plain": plain_s.flatten()[j].item(),
                     "limit": lim_s.flatten()[j].item()}
                    for j in over_f.flatten().topk(min(4, e[f"d{t}_freed_rows"])).indices]
            fails.check(g.shape == r.shape and g.dtype == r.dtype and g.is_contiguous()
                        and bool(torch.isfinite(g.float()).all())
                        and e[f"d{t}_over_limit"] <= 1.0,
                        f"flash_attention_backward d{t} disagrees on C6 {name} "
                        f"{tuple(q.shape)} {q.dtype}: worst row err {got_s.flatten()[worst].item()} "
                        f"of the row, {e[f'd{t}_over_limit']} times its limit (floor {limit[t]})")
        if q.dtype == torch.float16:
            # the control: P and dS rounded to bf16, held the same way, must
            # fail the float16 limits (the output under a causal mask, every
            # gradient but at a zero scale, where dq = dk = 0 and P is one
            # value a row, and at S = 1, where P = 1 exactly and dq = dk = 0)
            c_out, *c_grads = bf16_rounded_reference(q, k, v, o, do, lse, causal, scale)
            ctl = {"out_over_limit": out_over(c_out)}
            for t, g, x in zip("qkv", c_grads, yard):
                ctl[f"d{t}_row_share"] = row_shares(g, x, t).max().item()
                ctl[f"d{t}_over_limit"] = over_limit(g, x, t).max().item()
            e["bf16_control"] = ctl
            if causal and q.shape[1] > 1:
                fails.check(ctl["out_over_limit"] > 1.0, f"the bf16-rounded control passes the "
                            f"float16 output limit on C6 {name}: {ctl['out_over_limit']}")
            if scale != 0.0 and q.shape[1] > 1:
                fails.check(all(ctl[f"d{t}_over_limit"] > 1.0 for t in "qkv"),
                            f"the bf16-rounded control passes the float16 gradient limit "
                            f"on C6 {name}: {ctl}")
            del c_out, c_grads
        if name.startswith("main"):
            again = fa.flash_attention_backward(q, k, v, o, do, lse, causal=causal)
            e["bitwise_deterministic"] = all(torch.equal(x, y) for x, y in zip(grads, again))
            fails.check(e["bitwise_deterministic"],
                        f"flash_attention_backward gives other bits on a second call at {name}")
            saved[name] = (q, k, v, do, causal)
            del again
        errs[name] = e
        del grads, ref, ref_o, o, lse, exact, yard, limits, freed, tops
    timings = {name: _c6_timings(*saved[name][:4], saved[name][4], device, reps)
               for name in ("main_d128_bf16", "main_d128_f16", "main_f16", *C6_MAIN_HEADS)}
    for name, (h, d, dt) in C6_TIMED_HEADS.items():
        q, k, v = fused_qkv(main[0], main[1], h, d, dt, device, gen)
        do = torch.randn(q.shape, device=device, generator=gen).to(q.dtype)
        timings[name] = _c6_timings(q, k, v, do, True, device, reps)
        del q, k, v, do
    for name, (shape, dt) in C6_TIMED_SHAPES.items():
        q, k, v = fused_qkv(*shape, dt, device, gen)
        do = torch.randn(q.shape, device=device, generator=gen).to(q.dtype)
        timings[name] = _c6_timings(q, k, v, do, True, device, reps)
        del q, k, v, do
    ptxas = {**ptxas_resources(cuda_build.build_info.get(fa.KERNEL, {}).get("ptxas", ""),
                               prefix="flash_attention"),
             **ptxas_resources(cuda_build.build_info.get(fa.BWD_KERNEL, {}).get("ptxas", ""))}
    ptxas = {k: v for k, v in ptxas.items() if "f16" in k.replace("bf16", "") or "128>" in k
             or "256>" in k or "wgmma" in k}
    # each type's worst output error and gradient row, and float16's control
    by_dtype = {}
    for name, e in errs.items():
        dt = str(cases[name][0][0].dtype)
        d = by_dtype.setdefault(dt, {"max_out_err": 0.0, "max_row_share": 0.0})
        d["max_out_err"] = max(d["max_out_err"], e["out"])
        d["max_out_over_limit"] = max(d.get("max_out_over_limit", 0.0), e["out_over_limit"])
        d["out_freed"] = d.get("out_freed", 0) + e.get("out_freed", 0)
        d["max_row_share"] = max(d["max_row_share"], *(e[f"d{t}_row_share"] for t in "qkv"))
        d["max_over_limit"] = max(d.get("max_over_limit", 0.0),
                                  *(e[f"d{t}_over_limit"] for t in "qkv"))
        d["freed_rows"] = d.get("freed_rows", 0) + sum(e[f"d{t}_freed_rows"] for t in "qkv")
        if "dq_bf16_arithmetic_row_share" in e:
            d["arithmetic_max_row_share"] = max(
                d.get("arithmetic_max_row_share", 0.0),
                *(e[f"d{t}_bf16_arithmetic_row_share"] for t in "qkv"))
            d["max_row_share_over_arithmetic"] = max([
                d.get("max_row_share_over_arithmetic", 0.0),
                *(e[f"d{t}_row_share"] / e[f"d{t}_bf16_arithmetic_row_share"]
                  for t in "qkv" if e[f"d{t}_bf16_arithmetic_row_share"] > 0)])
        if "bf16_control" in e and cases[name][0][0].shape[1] > 1:   # as its checks
            c = e["bf16_control"]
            if cases[name][1]:
                d["control_min_out_over_limit_causal"] = min(
                    d.get("control_min_out_over_limit_causal", math.inf), c["out_over_limit"])
            if cases[name][2] != 0.0:
                d["control_min_row_share"] = min(
                    d.get("control_min_row_share", math.inf),
                    *(c[f"d{t}_row_share"] for t in "qkv"))
                d["control_min_over_limit"] = min(
                    d.get("control_min_over_limit", math.inf),
                    *(c[f"d{t}_over_limit"] for t in "qkv"))
    emit({"phase": "kernel", "name": "flash_attention_c6",
          "tol": {str(k): v for k, v in FLASH_TOL.items()},
          "grad_tol_of_row_max": {str(k): v for k, v in GRAD_TOL.items()},
          "grad_step": {str(k): v for k, v in GRAD_STEP.items()},
          "grad_arith_margin": GRAD_ARITH_MARGIN,
          "by_dtype": by_dtype, "errors": errs, "launches": launches, "timings": timings, "ptxas": ptxas,
          "library_note": "forward: SDPA; backward: SDPA forward+backward minus SDPA "
                          "forward, both with grad enabled"}, log)
    return {"launches": launches, "timings": timings, "ptxas": ptxas,
            "by_dtype": by_dtype}


# the entry phase's rule set: every rule kind on "temp" (standard normal
# values: the kinds accumulate counts and compare, never sum floats) and a
# rollup of "load", which carries halves only, so its float sums are exact
# in any order (CUDA adds a scatter's duplicates in no fixed order)
ENTRY_RULES = {"name": "entry", "rules": [
    {"name": "hot", "kind": "threshold", "channel": "temp", "op": ">",
     "value": 1.5, "cooldownMs": 100},
    {"name": "twice", "kind": "window", "agg": "count", "channel": "temp",
     "op": ">=", "value": 2, "windowMs": 300,
     "where": {"channel": "temp", "op": ">", "value": 0.5}},
    {"name": "drop", "kind": "sequence",
     "first": {"channel": "temp", "op": ">", "value": 1.0},
     "then": {"channel": "temp", "op": "<", "value": -1.0}, "withinMs": 400},
    {"name": "gone", "kind": "absence", "channel": "temp", "deadlineMs": 300}],
    "rollups": [{"name": "load-1s", "channel": "load", "windowMs": 1000}]}
# sensor-1's location (48.85, 2.35) and a band that catches ~1/4 of the
# uniform random locations
ENTRY_ZONES = [[(48.0, 2.0), (48.0, 3.0), (49.5, 3.0), (49.5, 2.0)],
               [(-45.0, -90.0), (-45.0, 90.0), (45.0, 90.0), (45.0, -90.0)]]


def _entry_payloads() -> list[bytes]:
    """JSON payloads after the request stream: 5 devices keep reporting at
    2 s (the rest fall silent), a location, an alert with an alternate id,
    and two payloads that do not decode."""
    out = [json.dumps({"deviceToken": f"dev-{d}", "type": "DeviceMeasurements",
                       "request": {"measurements": {"temp": 0.5 * d,
                                                    "load": 0.5 * (d % 7)},
                                   "eventDate": 10**12 + 2000 + d}}).encode()
           for d in range(5)]
    out.append(json.dumps({"deviceToken": "dev-7", "type": "DeviceLocation",
                           "request": {"latitude": 10.0, "longitude": 20.0,
                                       "eventDate": 10**12 + 2001}}).encode())
    out.append(json.dumps({"deviceToken": "dev-8", "type": "DeviceAlert",
                           "request": {"type": "door", "level": "Error",
                                       "alternateId": "door-1",
                                       "eventDate": 10**12 + 2002}}).encode())
    return out + [b"{broken", b"[]"]


def _entry_requests(rng) -> list[DecodedRequest]:
    reqs = []
    names = ["temp", "humidity", "pressure"]
    for t in range(12):
        for d in range(40):
            reqs.append(DecodedRequest(
                type=RequestType.DEVICE_MEASUREMENT, device_token=f"dev-{d}",
                measurements={n: float(rng.standard_normal()) for n in names},
                # absolute unix ms; PinnedEpoch(1e9) makes them 100 t + 0..2,
                # so timestamps collide
                event_ts_ms=10**12 + 100 * t + int(rng.integers(0, 3))))
        k = int(rng.integers(0, 40))
        reqs.append(DecodedRequest(type=RequestType.DEVICE_LOCATION,
                                   device_token=f"dev-{k}",
                                   latitude=float(rng.uniform(-90, 90)),
                                   longitude=float(rng.uniform(-180, 180))))
        reqs.append(DecodedRequest(type=RequestType.DEVICE_ALERT,
                                   device_token=f"dev-{(k + 7) % 40}",
                                   alert_type=f"a{t % 3}", alert_level=t % 4))
    reqs.append(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                               device_token="dev-3", tenant="other",
                               measurements={"temp": 1.0}))   # dead letter
    return reqs


def _state_leaves(state):
    """(path, tensor) for every tensor of a state, depth first; the rule
    block's static layout (a tuple) is not a leaf."""
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for name, leaf in _state_leaves(v):
                yield f"{f.name}.{name}", leaf
        elif isinstance(v, torch.Tensor):
            yield f.name, v


def _to_device(obj, dev):
    """A copy of a state dataclass with every tensor on ``dev``."""
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _to_device(getattr(obj, f.name), dev)
                                           for f in dataclasses.fields(obj)})
    return obj


def _alert_level_lane_rows(native, python) -> int | None:
    """Store rows whose vmask differs between a native-decode engine and a
    Python-decode one, when each is an alert row's lane 0 set on the
    Python side only (None when any other vmask element differs)."""
    diff = native.vmask != python.vmask
    rows, lanes = diff.nonzero(as_tuple=True)
    alert = native.etype[rows] == int(EventType.ALERT)
    if bool((lanes == 0).all() and alert.all() and python.vmask[rows, 0].all()):
        return int(rows.numel())
    return None


def _entry_admin(e) -> dict:
    """The admin calls of the entry phase on one engine, and what they
    answer."""
    r = {"update_device": dataclasses.asdict(e.update_device(
        "dev-1", device_type="gauge", area="north", customer="acme",
        metadata={"parentToken": "sensor-1"}))}
    r["create"] = [dataclasses.asdict(e.create_assignment(
        "dev-2", token="dev-2:pump", asset="pump-7", area="east")),
        dataclasses.asdict(e.create_assignment("dev-2", token="dev-2:valve",
                                               asset="valve-3"))]
    r["update"] = dataclasses.asdict(e.update_assignment("dev-2:pump", asset="pump-8",
                                                         customer="acme"))
    r["missing"] = dataclasses.asdict(e.mark_assignment_missing("dev-2:pump"))
    r["release"] = dataclasses.asdict(e.release_assignment("dev-2:valve"))
    e.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT, device_token="dev-2",
                             measurements={"temp": 3.0}))
    r["deleted"] = [e.delete_assignment("dev-2:pump"), e.delete_device("dev-4")]
    e.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT, device_token="dev-4",
                             measurements={"temp": 4.0}))
    r["flush"] = e.flush()
    r["state_changes"] = e.query_events(etype=EventType.STATE_CHANGE, limit=20)
    r["dev2_events"] = e.query_events(device_token="dev-2", limit=5)
    r["assignments"] = [dataclasses.asdict(a) for a in e.list_assignments(device_token="dev-2")]
    r["assets"] = [e.assets.token(i) for i in range(len(e.assets))]
    r["slots"] = e.device_slots
    r["devices"] = {k: dataclasses.asdict(v) for k, v in e.devices.items()}
    r["metrics"] = e.metrics()
    return r


def phase_entry(device, log, fails) -> None:
    cfg = EngineConfig(device_capacity=1024, token_capacity=2048,
                       assignment_capacity=2048, store_capacity=1 << 14,
                       batch_capacity=256, channels=100, analytics_devices=64,
                       analytics_window=128, presence_missing_s=3.0,
                       rule_groups=64, rollup_buckets=8, assignment_triggers=True)
    engines, managers = {}, {}
    # the native decoder on the card and on the CPU, and the Python decode
    # path (asked for with use_native=False) on the card
    for label, dev, native in (("card", device, True), ("cpu", torch.device("cpu"), True),
                               ("python", device, False)):
        eng = Engine(dataclasses.replace(cfg, use_native=native), device=dev)
        eng.epoch = PinnedEpoch(1e9)
        eng.set_geofence_zones(ENTRY_ZONES)
        managers[label] = RulesManager(eng)
        managers[label].load(ENTRY_RULES)
        did = eng.register_device("sensor-1", device_type="thermostat")
        eng.process(DecodedRequest(type=RequestType.DEVICE_MEASUREMENT,
                                   device_token="sensor-1",
                                   measurements={"temp": 21.5, "rpm": 900.0}))
        eng.process(DecodedRequest(type=RequestType.DEVICE_LOCATION,
                                   device_token="sensor-1", latitude=48.85,
                                   longitude=2.35, elevation=35.0))
        eng.process(DecodedRequest(type=RequestType.DEVICE_ALERT,
                                   device_token="sensor-1", alert_type="overheat",
                                   alert_level=2))
        first = eng.flush()
        for req in _entry_requests(np.random.default_rng(1)):
            eng.process(req)
        rest = eng.flush()
        engines[label] = (eng, did, first, rest)

    eng, did, first, rest = engines["card"]
    st = eng.get_device_state("sensor-1")
    fails.check(did == 0 and first["found"] == 3 and first["persisted"] == 3,
                f"entry: first flush {first}")
    fails.check(st["measurements"].get("temp", {}).get("value") == 21.5
                and st["measurements"].get("rpm", {}).get("value") == 900.0,
                f"entry: staged measurements {st['measurements']}")
    loc = st["recent_locations"][0] if st["recent_locations"] else {}
    fails.check(abs(loc.get("latitude", 0) - 48.85) < 1e-5
                and abs(loc.get("longitude", 0) - 2.35) < 1e-5,
                f"entry: recent location {st['recent_locations']}")
    fails.check(st["recent_alerts"][:1] == [{"level": 2, "type": "overheat",
                                             "ts_ms": 5_000}],
                f"entry: recent alert {st['recent_alerts']}")
    fails.check(st["event_counts"]["MEASUREMENT"] == 1
                and st["event_counts"]["LOCATION"] == 1
                and st["event_counts"]["ALERT"] == 1,
                f"entry: event counts {st['event_counts']}")

    # the same stream on the CPU: identical state, summaries and answers
    ceng, _, cfirst, crest = engines["cpu"]
    fails.check((first, rest) == (cfirst, crest),
                f"entry: flush summaries differ from the CPU engine: {rest} vs {crest}")
    tokens = ["sensor-1"] + [f"dev-{d}" for d in range(40)]
    fails.check(all(eng.get_device_state(t) == ceng.get_device_state(t) for t in tokens),
                "entry: get_device_state differs from the CPU engine")

    # the read side and the rules tier on the same stream, card vs CPU
    peng = engines["python"][0]
    reads = {}
    for kind, e in (("card", eng), ("cpu", ceng), ("python", peng)):
        r = reads[kind] = {"json": untraced(e.ingest_json_batch(_entry_payloads()))}
        e.flush()
        r["alerts"] = managers[kind].poll(flush=True)
        head = arena_cursor(e.state.store, 0)
        r["queries"] = [e.query_events(**q) for q in (
            {}, dict(limit=7), dict(device_token="dev-3"),
            dict(etype=EventType.ALERT), dict(etype=EventType.LOCATION, limit=5),
            dict(since_ms=500, until_ms=800), dict(alternate_id="door-1"),
            dict(tenant="other"))]
        r["events"] = [e.get_event(i) for i in (-1, 0, 7, head - 2, head - 1, head)]
        r["missing"] = e.presence_sweep()
        r["rule_counters"] = e.rule_counters()
        r["tenant_counters"] = e.tenant_pipeline_counters()
        r["tenant_metrics"] = e.tenant_metrics()
        r["states"] = e.search_device_states(presence="missing", limit=1000)
    for key in reads["card"]:
        fails.check(reads["card"][key] == reads["cpu"][key],
                    f"entry: {key} differs from the CPU engine: "
                    f"{reads['card'][key]} vs {reads['cpu'][key]}")
    # the Python path's summary has no "staged" count
    reads["python"]["json"]["staged"] = reads["card"]["json"].get("staged")
    for key in reads["card"]:
        fails.check(reads["card"][key] == reads["python"][key],
                    f"entry: {key} differs from the use_native=False engine: "
                    f"{reads['card'][key]} vs {reads['python'][key]}")
    card = reads["card"]
    fails.check(card["json"] == {"decoded": 7, "failed": 2, "staged": 7},
                f"entry: json {card['json']}")
    fails.check(eng._native_decoder is not None and peng._native_decoder is None
                and eng.host_counters.get("arena_rows", 0) >= 7,
                f"entry: the batch did not take the native arena path: {eng.host_counters}")
    fired = {a["rule"] for a in card["alerts"]}
    fails.check(fired == {r["name"] for r in ENTRY_RULES["rules"]},
                f"entry: rules fired {sorted(fired)}")
    fails.check(card["tenant_counters"]["default"]["geofence_hit"] > 0
                and len(card["missing"]) > 0 and card["events"][4] is not None,
                f"entry: geofence / sweep / get_event {card['tenant_counters']} "
                f"{card['missing']} {card['events'][4]}")
    differ = [name for (name, a), (_, b) in zip(_state_leaves(eng.state),
                                                 _state_leaves(ceng.state))
              if not torch.equal(a.cpu(), b)]
    fails.check(not differ, f"entry: state differs from the CPU engine in {differ}")
    differ_py = [name for (name, a), (_, b) in zip(_state_leaves(eng.state),
                                                    _state_leaves(peng.state))
                 if not torch.equal(a, b)]
    # one difference the JAX package has too: the native decoder leaves an
    # alert row's level lane out of vmask, the Python path sets it
    alert_lane_rows = _alert_level_lane_rows(eng.state.store, peng.state.store)
    if alert_lane_rows:
        differ_py.remove("store.vmask")
    fails.check(not differ_py and alert_lane_rows is not None,
                f"entry: state differs from the use_native=False engine in {differ_py} "
                f"(alert level lanes {alert_lane_rows})")
    fails.check(eng.metrics() == ceng.metrics(),
                f"entry: metrics differ: {eng.metrics()} vs {ceng.metrics()}")

    mcfg = AnomalyConfig(sensors=100, window=128, hidden=64, lstm_hidden=64,
                         latent=16, dtype=torch.float32)
    svc = AnalyticsService(eng, mcfg, min_fill=1)
    csvc = AnalyticsService(ceng, mcfg, min_fill=1)
    csvc.model.load_state_dict({k: v.cpu() for k, v in svc.model.state_dict().items()})
    got, ref = svc.score_all(), csvc.score_all()
    score_err = float(np.max(np.abs(got["scores"] - ref["scores"])))
    fails.check(bool(np.array_equal(got["valid"], ref["valid"]))
                and bool(np.allclose(got["scores"], ref["scores"],
                                     rtol=SCORE_TOL, atol=1e-6)),
                f"entry: scores differ from the CPU engine (max abs {score_err})")

    # the registry admin API, card and CPU: identical answers, state and
    # mirrors, and the STATE_CHANGE events of assignment_triggers
    admin = {kind: _entry_admin(e) for kind, e in (("card", eng), ("cpu", ceng))}
    fails.check(admin["card"] == admin["cpu"],
                f"entry: admin answers differ from the CPU engine: {admin['card']} vs "
                f"{admin['cpu']}")
    admin_differ = [name for (name, a), (_, b) in zip(_state_leaves(eng.state),
                                                       _state_leaves(ceng.state))
                    if not torch.equal(a.cpu(), b)]
    fails.check(not admin_differ,
                f"entry: state after the admin calls differs from the CPU engine in {admin_differ}")
    changes = {e["stateChange"] for e in admin["card"]["state_changes"]["events"]}
    fails.check(changes >= {"assignment.created", "assignment.missing",
                            "assignment.released"}
                and admin["card"]["assets"] == ["pump-7", "valve-3", "pump-8"],
                f"entry: admin triggers {sorted(changes)}, assets {admin['card']['assets']}")
    emit({"phase": "entry", "admin": admin["card"],
          "admin_state_equal_cpu": not admin_differ, "device_state": st, "metrics": eng.metrics(),
          "state_leaves_equal_cpu": not differ,
          "state_leaves_equal_python_decode": not differ_py,
          "alert_rows_vmask_lane0_native_vs_python": alert_lane_rows,
          "score_max_abs_err_vs_cpu": score_err,
          "score_tol": SCORE_TOL, "reads_equal_cpu": sorted(
              k for k in card if card[k] == reads["cpu"][k]),
          "rules_fired": sorted(fired), "alerts": len(card["alerts"]),
          "missing_after_sweep": len(card["missing"]),
          "tenant_counters": card["tenant_counters"]}, log)


def slice_batches(seed: int, n_batches: int, device, cfg: dict,
                  n_tokens: int) -> tuple[list[EventBatch], int]:
    """:func:`slice_columns` copied to ``device`` as EventBatches."""
    cols, n_garbage = slice_columns(seed, n_batches, cfg, n_tokens)
    return [EventBatch.from_numpy(device, **c) for c in cols], n_garbage


def slice_columns(seed: int, n_batches: int, cfg: dict,
                  n_tokens: int) -> tuple[list[dict], int]:
    """The full-width stream as numpy columns, built on the host and
    copied to the card before the timed loop. Token ids 0..8191 appear first in batch 0,
    so they auto-register as dense ids 0..8191: the analytics devices. Each
    of them gets one measurement row per batch plus one more in 5120/8192
    of the batches (rotating), so 80 batches give each 130 samples >= W;
    no device gets more than 2 rows in one batch (<= W, no window-slot
    collision). Tokens 8192..9999 send one measurement per batch; the rest
    of each batch is locations, alerts and garbage tokens (negative or past
    the token capacity), which must dead-letter. (Counts are for the full
    width; they scale with ``cfg``.)"""
    b, c, m = cfg["batch_capacity"], cfg["channels"], cfg["analytics_devices"]
    rng = np.random.default_rng(seed)
    n_extra = m * 5 // 8
    n_other = n_tokens - m
    n_misc = b - m - n_extra - n_other
    n_loc, n_alert = n_misc * 5 // 10, n_misc * 3 // 10
    n_bad = n_misc - n_loc - n_alert
    batches, n_garbage = [], 0
    for k in range(n_batches):
        meas_tok = np.concatenate([
            rng.permutation(m), (k * n_extra + np.arange(n_extra)) % m,
            m + rng.permutation(n_other)]).astype(np.int32)
        bad = np.concatenate([-1 - rng.integers(0, 1000, n_bad // 2),
                              cfg["token_capacity"] + rng.integers(0, 1000, n_bad - n_bad // 2)])
        misc_tok = np.concatenate([rng.integers(0, n_tokens, n_loc + n_alert), bad])
        misc_type = np.repeat([int(EventType.LOCATION), int(EventType.ALERT),
                               int(EventType.MEASUREMENT)], [n_loc, n_alert, n_bad])
        order = rng.permutation(n_misc)
        token = np.concatenate([meas_tok, misc_tok[order]]).astype(np.int32)
        etype = np.concatenate([np.zeros(len(meas_tok), np.int32),
                                misc_type[order]]).astype(np.int32)
        values = rng.standard_normal((b, c), dtype=np.float32)
        vmask = np.ones((b, c), np.bool_)
        is_loc, is_alert = etype == EventType.LOCATION, etype == EventType.ALERT
        vmask[is_loc, 3:] = False
        vmask[is_alert, 1:] = False
        values[is_alert, 0] = rng.integers(0, 4, int(is_alert.sum()))
        aux = np.full((b, AUX_LANES), NULL_ID, np.int32)
        aux[is_alert, 0] = 0
        ts = (1000 * k + np.arange(b) // 64).astype(np.int32)
        batches.append(dict(
            valid=np.ones(b, np.bool_), etype=etype, token_id=token,
            tenant_id=np.zeros(b, np.int32), ts_ms=ts,
            received_ms=np.full(b, 1000 * k, np.int32), values=values,
            vmask=vmask, aux=aux, seq=np.arange(b, dtype=np.int32)))
        n_garbage += n_bad
    return batches, n_garbage


def phase_slice(device, log, fails, seed: int, n_batches: int,
                config: dict = SLICE_CONFIG, n_tokens: int = SLICE_TOKENS,
                model: AnomalyConfig = SLICE_MODEL, profile: bool = False) -> dict:
    cfg = EngineConfig(**config)
    eng = Engine(cfg, device=device)
    for t in range(n_tokens):
        eng.tokens.intern(f"dev-{t:05d}")
    eng.alert_types.intern("overheat")
    batches, n_garbage = slice_batches(seed, n_batches, device, config, n_tokens)
    svc = AnalyticsService(eng, model, min_fill=cfg.analytics_window, seed=seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    wf.window_features.launches = 0            # the main path starts here
    step_ms = []
    t_start = time.perf_counter()
    for batch in batches:
        t0 = time.perf_counter()
        eng.ingest_event_batch(batch)
        if device.type == "cuda":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    ingest_s = time.perf_counter() - t_start
    summary = eng.flush()
    score_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        result = svc.score_all()
        score_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"window_features": wf.window_features.launches}   # ... ends here

    met = eng.metrics()
    n_rows = n_batches * cfg.batch_capacity
    filled = eng.state.windows.filled.cpu().numpy()
    fails.check(met["processed"] == n_rows and
                met["processed"] == met["found"] + met["missed"],
                f"slice: processed != found + missed: {met}")
    fails.check(met["missed"] == n_garbage and met["registered"] == n_tokens,
                f"slice: expected {n_garbage} dead letters and {n_tokens} "
                f"registrations: {met}")
    # every auto-registered device holds exactly one active assignment
    fails.check(met["persisted"] == met["found"] and summary["persisted"] == met["found"],
                f"slice: persisted != found x 1 assignment: {met}")
    fails.check(int(filled.min()) >= cfg.analytics_window,
                f"slice: an analytics window has only {int(filled.min())} samples")
    scores = result["scores"]
    fails.check(scores.shape == (cfg.analytics_devices,)
                and bool(np.isfinite(scores).all()) and bool(result["valid"].all()),
                "slice: scores are not finite / not all valid")
    fails.check(launches["window_features"] > 0,
                "slice: the scoring path never launched the window_features kernel")
    rec = {"phase": "slice", "batches": n_batches, "batch_rows": cfg.batch_capacity,
           "step_ms_median": statistics.median(step_ms),
           "step_ms_first": step_ms[0],
           "events_per_s": n_rows / ingest_s,
           "score_ms_median_8192_windows": statistics.median(score_ms[1:]),
           "score_ms_first": score_ms[0],
           "score_mean": float(scores.mean()), "launches": launches,
           "metrics": met,
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                           if device.type == "cuda" else None)}
    emit(rec, log)
    if profile:       # after the counts were read: these launches don't count
        phase_profile(eng, svc, batches[:3], log)
    return launches, rec["step_ms_median"], eng


def _device_time(prof, n: int = 10) -> tuple[dict, float]:
    """Top entries by device time: ``kernels`` are the CUDA kernels
    themselves, ``ops`` the aten ops that launched them (the same time,
    attributed to its caller). Busy time sums the kernels only."""
    # a record_function range shows up on the device too (a user annotation
    # spanning its kernels): it is not a kernel, and counting it would
    # count its kernels twice
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events if e.device_type != torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)

    def top(rows):
        rows = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)
        return [{"name": e.key[:80], "calls": e.count,
                 "device_ms": e.self_device_time_total / 1e3} for e in rows[:n]]

    return {"kernels": top(kernels), "ops": top(ops)}, busy_us / 1e3


def rules_temp(i: np.ndarray) -> np.ndarray:
    """The bench's rules value for event ``i`` (bench.py:2200-2211): halves
    only, so every float sum is exact in any order; ~3 % above 90.0, 2.5
    every 149th."""
    v = np.where(i % 37 == 0, 96.5, 20.0 + (i % 80) * 0.5)
    return np.where(i % 149 == 0, 2.5, v).astype(np.float32)


def read_columns(seed: int, n_batches: int, cfg: dict,
                 n_tokens: int) -> tuple[list[dict], int]:
    """The slice stream with channel 0 ("temp") of every measurement row
    rewritten by :func:`rules_temp` of the row's stream index, and the
    rows of device 0 (the token of batch 0's first row: devices register
    in order of first appearance) moved to device 1 after half the batches,
    as the bench moves its device 0 (so it falls silent: the absence rule
    fires and the sweep finds it). Returns the columns and that token."""
    cols, _ = slice_columns(seed, n_batches, cfg, n_tokens)
    b = cfg["batch_capacity"]
    quiet, heir = (int(t) for t in cols[0]["token_id"][:2])
    for k, c in enumerate(cols):
        meas = c["etype"] == int(EventType.MEASUREMENT)
        c["values"][meas, 0] = rules_temp(k * b + np.nonzero(meas)[0])
        if k >= n_batches // 2:
            c["token_id"][c["token_id"] == quiet] = heir
    return cols, quiet


def read_zones(seed: int, n: int = READ_ZONES, v: int = READ_ZONE_VERTICES) -> list:
    """n regular v-gons (lat, lon) of radius 0.05-0.25 around seeded
    centres in [-2, 2]^2, where the stream's standard-normal location rows
    fall: a seeded share of them lands inside."""
    rng = np.random.default_rng(seed + 7)
    centres = rng.uniform(-2.0, 2.0, (n, 2))
    radii = rng.uniform(0.05, 0.25, n)
    ang = 2 * np.pi * np.arange(v) / v
    return [[(float(cy + r * np.sin(a)), float(cx + r * np.cos(a))) for a in ang]
            for (cy, cx), r in zip(centres, radii)]


def _zoned_engine(device, seed: int, n_tokens: int, config: dict, **kw) -> Engine:
    """The read phase's engine, its zones set and no rule set yet."""
    eng = Engine(EngineConfig(**config, **READ_RULES_CONFIG, **kw), device=device)
    eng.epoch = PinnedEpoch(1e9, now_ms=1000 * READ_BATCHES + 500)
    for t in range(n_tokens):
        eng.tokens.intern(f"dev-{t:05d}")
    eng.alert_types.intern("overheat")
    eng.set_geofence_zones(read_zones(seed), READ_ZONE_VERTICES)
    return eng


def _read_engine(device, seed: int, n_tokens: int, config: dict):
    eng = _zoned_engine(device, seed, n_tokens, config)
    mgr = RulesManager(eng)
    mgr.load(RL_RULESET)
    return eng, mgr


def _query_mix(eng, t_window: int) -> list[tuple]:
    """The bench's 16 predicate sets (QueryParams order): full scan, one
    device, MEASUREMENT since 0, a 5 s window from ``t_window + 50 qi``
    (the bench's windows start at 50 qi; this stream's ring holds its
    second half)."""
    imin, imax = -(2**31), 2**31 - 1
    devs = sorted(eng.token_device.values()) or [0]
    preds = []
    for qi in range(READ_QUERIES):
        p = [NULL_ID, NULL_ID, NULL_ID, imin, imax] + [NULL_ID] * 5
        if qi % 4 == 1:
            p[0] = int(devs[qi % len(devs)])
        elif qi % 4 == 2:
            p[1], p[3] = int(EventType.MEASUREMENT), 0
        elif qi % 4 == 3:
            p[3], p[4] = t_window + qi * 50, t_window + qi * 50 + 5000
        preds.append(tuple(p))
    return preds


def _seq_pages(store, preds):
    return [query_store(store, *p[:5], limit=READ_LIMIT, assignment=p[5], aux0=p[6],
                        aux1=p[7], area=p[8], customer=p[9]) for p in preds]


def _pages_equal(a, b) -> bool:
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


def phase_read(device, log, fails, seed: int, slice_step_ms: float,
               n_batches: int = READ_BATCHES, config: dict = SLICE_CONFIG,
               n_tokens: int = SLICE_TOKENS, profile: bool = False) -> None:
    """The read side and the whole fused step on the card at the slice's
    full width: geofence zones and the bench's rule set installed, the
    stream through ``ingest_event_batch``; then the query mix (batched and
    sequential), ``query_events``, ``get_event``, ``presence_sweep``,
    ``RulesManager.poll``, the counters; every page, the harvest and the
    sweep rerun on a CPU copy of the state, and a CPU engine fed the first
    batches, all byte for byte."""
    cpu = torch.device("cpu")
    on_card = device.type == "cuda"
    eng, mgr = _read_engine(device, seed, n_tokens, config)
    columns, quiet_token = read_columns(seed, n_batches, config, n_tokens)
    batches = [EventBatch.from_numpy(device, **c) for c in columns]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    wf.window_features.launches = fa.flash_attention.launches = 0   # path starts
    step_ms = []
    state_early = None
    for k, batch in enumerate(batches):
        t0 = time.perf_counter()
        eng.ingest_event_batch(batch)
        if on_card:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if k + 1 == READ_CPU_BATCHES:
            state_early = eng.state        # the step is functional: a snapshot
    eng.flush()

    # the query mix: one batched program against 16 sequential scans
    store = eng.state.store
    t_window = 1000 * (n_batches // 2)
    preds = _query_mix(eng, t_window)
    params = QueryParams(*torch.tensor(preds, dtype=torch.int32).T.to(device))
    batched = query_store_batch(store, params, limit=READ_LIMIT)
    seq = _seq_pages(store, preds)
    fails.check(all(_pages_equal([f[q] for f in batched], seq[q])
                    for q in range(READ_QUERIES)),
                "read: query_store_batch differs from sequential query_store on the card")
    batch_ms = time_ms(lambda: query_store_batch(store, params, limit=READ_LIMIT), device,
                       reps=20, warmup=3)
    seq_ms = time_ms(lambda: _seq_pages(store, preds), device, reps=10, warmup=2)

    # the engine's read calls: 8 calls of each of the mix's four shapes
    devs = sorted(eng.token_device.items(), key=lambda kv: kv[1])
    one = eng.tokens.token(devs[1][0])
    shapes = [dict(limit=READ_LIMIT), dict(device_token=one, limit=READ_LIMIT),
              dict(etype=EventType.MEASUREMENT, since_ms=0, limit=READ_LIMIT),
              dict(since_ms=t_window + 150, until_ms=t_window + 5150,
                   limit=READ_LIMIT)]
    q_ms, answers = [], []
    for shape in shapes:
        for _ in range(8):
            t0 = time.perf_counter()
            answers.append(eng.query_events(**shape))
            q_ms.append((time.perf_counter() - t0) * 1e3)
    full, by_dev = answers[0], answers[8]
    fails.check(full["total"] == int(batched.total[0])
                and by_dev["total"] == int(batched.total[1])
                and len(full["events"]) == READ_LIMIT
                and all(a["eventDateMs"] >= b["eventDateMs"]
                        for a, b in zip(full["events"], full["events"][1:])),
                f"read: query_events disagrees with the pages: {full['total']} "
                f"{by_dev['total']} vs {batched.total[:2].tolist()}")
    head = arena_cursor(store, 0)
    live, evicted = eng.get_event(head - 1), eng.get_event(head - store.capacity - 1)
    fails.check(live is not None and evicted is None
                and live["eventDateMs"] == int(store.ts_ms[(head - 1) % store.capacity]),
                f"read: get_event live {live} evicted {evicted}")

    # the same pages, harvest and sweep on a CPU copy of the card's state
    state_cpu = _to_device(eng.state, cpu)
    params_cpu = QueryParams(*(c.cpu() for c in params))
    fails.check(_pages_equal(batched, query_store_batch(state_cpu.store, params_cpu,
                                                        limit=READ_LIMIT)),
                "read: the query pages differ between the card and the CPU")
    fails.check(all(_pages_equal(a, b) for a, b in zip(seq, _seq_pages(state_cpu.store,
                                                                       preds))),
                "read: the sequential pages differ between the card and the CPU")
    harvest = harvest_fires(eng.state.rules)
    harvest_cpu = harvest_fires(state_cpu.rules)
    fails.check(all(torch.equal(a.cpu(), b) for a, b in zip(harvest[1:], harvest_cpu[1:]))
                and all(torch.equal(a.cpu(), b) for (_, a), (_, b) in zip(
                    _state_leaves(harvest[0]), _state_leaves(harvest_cpu[0]))),
                "read: the harvest differs between the card and the CPU")
    harvest_ms = time_ms(lambda: [x.cpu() for x in harvest_fires(eng.state.rules)[1:]],
                         device)
    sweep = make_presence_sweep()
    now, miss = eng.epoch.now_ms(), int(READ_RULES_CONFIG["presence_missing_s"] * 1000)
    args = [torch.tensor(x, dtype=torch.int32) for x in (now, miss)]
    swept, newly = sweep(eng.state, *(a.to(device) for a in args))
    swept_cpu, newly_cpu = sweep(state_cpu, *args)
    fails.check(torch.equal(newly.cpu(), newly_cpu) and torch.equal(
        swept.device_state.presence.cpu(), swept_cpu.device_state.presence),
                "read: the presence sweep differs between the card and the CPU")
    sweep_ms = time_ms(lambda: sweep(eng.state, *(a.to(device) for a in args)), device)
    del state_cpu, swept, swept_cpu

    # the engine's own sweep, the rules manager's poll and the counters
    t0 = time.perf_counter()
    missing = eng.presence_sweep()
    sweep_call_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    alerts = mgr.poll()
    poll_ms = (time.perf_counter() - t0) * 1e3
    eng.flush()
    fired = {}
    for a in alerts:
        fired[a["rule"]] = fired.get(a["rule"], 0) + 1
    rule_counters = eng.rule_counters()
    counters = eng.tenant_pipeline_counters()
    launches = {"window_features": wf.window_features.launches,
                "flash_attention": fa.flash_attention.launches}   # ... path ends
    peak_gb = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    quiet = f"dev-{quiet_token:05d}"
    fails.check(missing == [quiet], f"read: presence_sweep found {missing}, not [{quiet}]")
    # every rule kind of the update: threshold lowers to an extremum window,
    # then sequence and absence; the count window "burst" needs 4 rows above
    # 90 in 2 s of one device, which the bench formula never gives (one in
    # 37 of a device's rows), here as in the bench: its count accumulates
    # and is held to the CPU, and its fires are reported
    fails.check({"hot", "updown", "silent"} <= set(fired)
                and any(a["rule"] == "silent" and a["group"] == quiet for a in alerts),
                f"read: rules fired {fired}")
    fails.check(counters.get("default", {}).get("geofence_hit", 0) > 0,
                f"read: no geofence hit: {counters}")

    # a CPU engine fed the first batches: the card's state after the same
    # batches, rules, rollups, zones and tenant counters included
    ceng, _ = _read_engine(cpu, seed, n_tokens, config)
    t0 = time.perf_counter()
    for c in columns[:READ_CPU_BATCHES]:
        ceng.ingest_event_batch(EventBatch.from_numpy(cpu, **c))
    cpu_s = time.perf_counter() - t0
    differ = [name for (name, a), (_, b) in zip(_state_leaves(state_early),
                                                 _state_leaves(ceng.state))
              if not torch.equal(a.cpu(), b)]
    fails.check(not differ, f"read: state after {READ_CPU_BATCHES} batches differs from "
                f"the CPU engine in {differ}")
    rec = {"phase": "read", "batches": n_batches, "batch_rows": config["batch_capacity"],
           "zones": READ_ZONES, "zone_vertices": READ_ZONE_VERTICES,
           "rules": [r["name"] for r in RL_RULESET["rules"]],
           "step_ms_median_zones_rules": statistics.median(step_ms[1:]),
           "step_ms_first": step_ms[0], "step_ms": step_ms,
           "slice_step_ms_median_no_rules": slice_step_ms,
           "query_store_batch_ms_q16": batch_ms, "query_store_x16_ms": seq_ms,
           "query_events_ms_median": statistics.median(q_ms),
           "query_events_ms_by_shape": [statistics.median(q_ms[8 * i:8 * i + 8])
                                        for i in range(4)],
           "harvest_ms": harvest_ms, "sweep_ms": sweep_ms,
           "engine_presence_sweep_ms": sweep_call_ms, "rules_poll_ms": poll_ms,
           "alerts": len(alerts), "fired_by_rule": fired,
           "burst_count_max": int(eng.state.rules.rules.acc_cnt[1].max()),
           "rule_counters": rule_counters, "tenant_counters": counters,
           "query_totals": batched.total.tolist(), "missing": missing,
           "cpu_engine_s_first_batches": cpu_s,
           "state_equal_cpu_after_batches": (READ_CPU_BATCHES, not differ),
           "launches": launches, "peak_mem_gb": peak_gb}
    emit(rec, log)
    if profile:       # after the checks: three more steps with zones and rules
        _profile("step_zones_rules",
                 lambda: [eng.ingest_event_batch(b) for b in batches[-3:]], 3, log)


# the wire phase: bench.py's headline engine (HEADLINE_CFG, bench.py:99-103;
# channels at the default) fed run_engine_load's stream of DeviceMeasurement
# JSON over 10,000 device tokens; 40 measured batches where the bench
# measures 91, to keep the script's time
WIRE_CONFIG = dict(device_capacity=1 << 15, token_capacity=1 << 16,
                   assignment_capacity=1 << 16, store_capacity=1 << 18,
                   batch_capacity=16384, scan_chunk=1, dispatch_depth=2)
WIRE_DEVICES = 10_000
WIRE_WARMUP, WIRE_BATCHES = 4, 40
WIRE_PARITY_BATCHES = 12       # the engines held to each other byte for byte
WIRE_SNAPSHOT_AFTER = 4        # the recovery drill's snapshot
WIRE_SMALL_CALL = 256          # payloads a call in bench.py's WAL leg
WIRE_CORE_METRICS = ("processed", "found", "missed", "registered", "persisted",
                     "reg_overflow", "channel_collisions")


class HostClock:
    """Host time of each ingest call, split by wrapping the engine's own
    methods on this instance: the arena dispatch (WAL gate, the copy and
    step launches, the dispatch-depth wait), within it the WAL gate and the
    depth wait, and the wait for a free arena. Decode + commit is the rest
    of the call."""

    PARTS = ("dispatch", "wal_gate", "depth_wait", "arena_wait")
    WRAPS = (("_dispatch_arena", "dispatch"), ("_wal_gate", "wal_gate"),
             ("_enqueue_out", "depth_wait"), ("_acquire_arena", "arena_wait"))

    def __init__(self, eng):
        self.calls: list[dict] = []
        self._cur = None
        for name, part in self.WRAPS:
            self._wrap(eng, name, part)
        for name in ("ingest_json_batch", "ingest_binary_batch"):
            self._wrap_call(eng, name)

    def _wrap(self, eng, name, part):
        fn = getattr(eng, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if self._cur is not None:
                    self._cur[part] += (time.perf_counter() - t0) * 1e3
        setattr(eng, name, timed)

    def _wrap_call(self, eng, name):
        fn = getattr(eng, name)

        def timed(*a, **kw):
            self._cur = dict.fromkeys(self.PARTS, 0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._cur["total"] = (time.perf_counter() - t0) * 1e3
                self.calls.append(self._cur)
                self._cur = None
        setattr(eng, name, timed)

    def medians(self, last: int) -> dict:
        calls = self.calls[-last:]
        out = {f"{p}_ms": statistics.median(c[p] for c in calls) for p in self.PARTS}
        out["decode_commit_ms"] = statistics.median(c["total"] - c["dispatch"]
                                                    for c in calls)
        out["ingest_call_ms"] = statistics.median(c["total"] for c in calls)
        return out


def wire_payloads(seed: int, n: int, batch: int, n_devices: int) -> list[list[bytes]]:
    """The first ``n`` batches that run_engine_load sends (warm-up first)."""
    make = batch_maker(n_devices, batch, seed)
    return [make(b if b < WIRE_WARMUP else b - WIRE_WARMUP) for b in range(n)]


def wire_engine(device, config: dict, **kw) -> Engine:
    eng = Engine(EngineConfig(**{**config, **kw}), device=device)
    eng.epoch = PinnedEpoch(1e9)
    return eng


def _mirrors(eng) -> dict:
    return {"devices": {k: dataclasses.asdict(v) for k, v in eng.devices.items()},
            "token_device": eng.token_device, "dead_letters": eng.dead_letters,
            "tokens": [eng.tokens.token(i) for i in range(len(eng.tokens))],
            "names": [eng.channel_map.names.token(i) for i in range(len(eng.channel_map.names))],
            "metrics": {k: eng.metrics()[k] for k in WIRE_CORE_METRICS}}


def _engines_differ(ref, eng) -> list[str]:
    """State leaves and host mirrors where ``eng`` differs from ``ref``."""
    out = [name for (name, a), (_, b) in zip(_state_leaves(ref.state), _state_leaves(eng.state))
           if not torch.equal(a.cpu(), b.cpu())]
    ma, mb = _mirrors(ref), _mirrors(eng)
    return out + [f"mirror:{k}" for k in ma if ma[k] != mb[k]]


def _conserved(eng, label: str, fails) -> list:
    bad = [v.to_dict() for v in check_conservation(build_ledger(eng))]
    fails.check(not bad, f"conservation violated on the {label} engine: {bad}")
    return bad


def _load(eng, seed: int, n_batches: int, batch: int, n_devices: int, device):
    """run_engine_load as bench.py runs its headline (pipelined), with the
    host split per ingest call and the peak device memory."""
    clock = HostClock(eng)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    stats = run_engine_load(eng, n_batches=n_batches, batch_size=batch, n_devices=n_devices,
                            seed=seed, warmup_batches=WIRE_WARMUP, pipelined=True)
    peak = torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None
    return stats, clock, peak


def phase_wire(device, log, fails, seed: int, config: dict = WIRE_CONFIG,
               n_devices: int = WIRE_DEVICES, n_batches: int = WIRE_BATCHES,
               parity_batches: int = WIRE_PARITY_BATCHES,
               snapshot_after: int = WIRE_SNAPSHOT_AFTER, profile: bool = False) -> None:
    """Wire ingest and durability at the bench's headline sizes: (a) the
    headline load through the native decoder and the pinned staging
    arenas; (b) the first batches through the arena scan step, the copy
    path, binary frames, one decode thread and a CPU engine, each byte for
    byte against a headline engine; (c) the headline load with a
    group-commit WAL; (d) a snapshot, a crash and recovery against the
    engine that never crashed, on the card and on the CPU; (e) the
    conservation ledger of every engine."""
    cpu = torch.device("cpu")
    batch = config["batch_capacity"]
    rows = (WIRE_WARMUP + n_batches) * batch
    rec: dict = {"phase": "wire", "config": config, "devices": n_devices,
                 "warmup_batches": WIRE_WARMUP, "batches": n_batches,
                 "batches_bench": 91}

    # (a) the headline load, as bench.py runs it
    eng = wire_engine(device, config)
    stats, clock, peak = _load(eng, seed, n_batches, batch, n_devices, device)
    met = eng.metrics()
    fails.check(stats.events_decoded == n_batches * batch and stats.events_failed == 0,
                f"wire (a): decoded {stats.events_decoded} failed {stats.events_failed}")
    fails.check(met["persisted"] == rows and met.get("arena_rows") == rows
                and "staged_copy_rows" not in met,
                f"wire (a): persisted {met['persisted']}, arena_rows "
                f"{met.get('arena_rows')}, staged_copy_rows {met.get('staged_copy_rows')} "
                f"for {rows} rows")
    rec["headline"] = {**stats.to_dict(), **clock.medians(n_batches),
                       "arena_pool_waits": met["arena_pool_waits"],
                       "arena_pool_size": met["arena_pool_size"],
                       "ingest_workers": met.get("ingest_workers", 1),
                       "sharded_batches": met.get("sharded_batches", 0),
                       "peak_mem_gb": peak, "metrics": met}
    rec["conservation"] = {"headline": _conserved(eng, "headline", fails)}

    # the native decoder's rate alone, one thread and sharded, into a spare
    # arena (every token is interned already: the interners do not change)
    pay = wire_payloads(seed, 1, batch, n_devices)[0]
    spare = StagingArena(batch, eng.config.channels)
    rates = {}
    for label, dec in (("one_thread", eng._native_decoder), ("sharded", eng._sharder)):
        if dec is not None:
            ms = time_ms(lambda: dec.decode_into(pay, spare, 0), cpu, reps=7, warmup=2)
            rates[label] = batch / ms * 1e3
    rec["decode_msgs_per_s"] = rates
    if profile and device.type == "cuda":   # after the checks: three more dispatches
        more = wire_payloads(seed + 1, 3, batch, n_devices)
        _profile("wire_dispatch", lambda: ([eng.ingest_json_batch(p) for p in more],
                                           eng.barrier()), 3, log, family=_step_family)
    del eng, clock

    # (c) the same load with a group-commit write-ahead log
    with tempfile.TemporaryDirectory(prefix="wire-") as tmp:
        tmp = pathlib.Path(tmp)
        weng = wire_engine(device, config, wal_dir=str(tmp / "wal"), wal_group_commit=True)
        wstats, wclock, _ = _load(weng, seed, n_batches, batch, n_devices, device)
        wmet = weng.metrics()
        wsplit = wclock.medians(n_batches)
        fsyncs, groups = weng.wal.fsyncs, weng.wal.commit_groups
        fails.check(wstats.events_decoded == n_batches * batch and wstats.events_failed == 0
                    and wmet["persisted"] == rows,
                    f"wire (c): decoded {wstats.events_decoded} persisted {wmet['persisted']}")
        # a headline call fills one arena, so it is one append group and one
        # dispatch gate: at most one fsync a call
        calls = WIRE_WARMUP + n_batches
        fails.check(0 < fsyncs <= calls and groups == calls,
                    f"wire (c): {fsyncs} fsyncs, {groups} append groups for {calls} calls")
        # group commit amortizes once several calls share a dispatch:
        # bench.py's WAL leg sends calls of 256 payloads (bench.py:720-747)
        payloads = wire_payloads(seed, parity_batches, batch, n_devices)
        small = [p[lo:lo + WIRE_SMALL_CALL] for p in payloads[:2]
                 for lo in range(0, batch, WIRE_SMALL_CALL)]
        for part in small:
            weng.ingest_json_batch(part)
        weng.barrier()
        small_fsyncs = weng.wal.fsyncs - fsyncs
        fails.check(0 < small_fsyncs < len(small)
                    and weng.metrics()["persisted"] == rows + 2 * batch,
                    f"wire (c): {small_fsyncs} fsyncs for {len(small)} calls of "
                    f"{WIRE_SMALL_CALL} payloads")
        rec["wal"] = {**wstats.to_dict(), **wsplit,
                      "fsyncs": fsyncs, "commit_groups": groups, "calls": calls,
                      "small_calls": len(small), "small_call_payloads": WIRE_SMALL_CALL,
                      "small_calls_fsyncs": small_fsyncs,
                      "arena_pool_waits": wmet["arena_pool_waits"]}
        rec["wal_over_headline_events_per_s"] = wstats.events_per_s / stats.events_per_s
        rec["conservation"]["wal"] = _conserved(weng, "WAL", fails)
        weng.wal.close()
        del weng, wclock

        # (b) the first batches through the other paths, against a headline
        # engine; the binary engine gets the same payloads as binary frames
        decoder = JsonDeviceRequestDecoder()
        frames = [[encode_binary_request(r) for p in b for r in decoder.decode(p, {})]
                  for b in payloads]
        variants = {"headline": (device, {}, False), "scan_chunk_4": (device, {"scan_chunk": 4}, False),
                    "copy_path": (device, {"ingest_arenas": -1}, False),
                    "binary_frames": (device, {}, True),
                    "one_decode_thread": (device, {"ingest_workers": 1}, False),
                    "cpu": (cpu, {}, False)}
        parity, summaries, ref = {}, {}, None
        for label, (dev, kw, binary) in variants.items():
            e = wire_engine(dev, config, **kw)
            t0 = time.perf_counter()
            ingest = e.ingest_binary_batch if binary else e.ingest_json_batch
            summaries[label] = [untraced(ingest(p)) for p in (frames if binary else payloads)]
            summaries[label].append(e.flush())
            seconds = time.perf_counter() - t0
            rec["conservation"][label] = _conserved(e, label, fails)
            if ref is None:
                ref = e
                continue
            differ = _engines_differ(ref, e)
            fails.check(not differ and summaries[label] == summaries["headline"],
                        f"wire (b): the {label} engine differs from the headline engine "
                        f"after {parity_batches} batches in {differ[:8]}")
            parity[label] = {"equal": not differ, "seconds": seconds}
            del e
        rec["parity"] = parity

        # (d) the recovery drill: a snapshot after a few batches, the rest,
        # then the engine is dropped without a flush (its WAL closed as the
        # process would leave it)
        wal_dir, snap = tmp / "drill-wal", tmp / "drill-snap"
        deng = wire_engine(device, config, wal_dir=str(wal_dir))
        for k, p in enumerate(payloads):
            deng.ingest_json_batch(p)
            if k + 1 == snapshot_after:
                save_engine(deng, snap)
        rec["conservation"]["drill"] = _conserved(deng, "drill", fails)
        deng.wal.close()
        del deng
        t0 = time.perf_counter()
        rengine = recover_engine(snap, wal_dir, device=device, epoch_cls=PinnedEpoch)
        rengine.flush()
        if device.type == "cuda":
            torch.cuda.synchronize()
        recovery_s = time.perf_counter() - t0
        rengine.wal.close()
        differ = _engines_differ(ref, rengine)
        fails.check(not differ, f"wire (d): the recovered engine differs from the engine "
                    f"that never crashed in {differ[:8]}")
        t0 = time.perf_counter()
        crec = recover_engine(snap, wal_dir, device=cpu, epoch_cls=PinnedEpoch)
        crec.flush()
        cpu_recovery_s = time.perf_counter() - t0
        crec.wal.close()
        cdiffer = _engines_differ(rengine, crec)
        fails.check(not cdiffer, f"wire (d): the CPU recovery differs from the card's "
                    f"in {cdiffer[:8]}")
        rec["recovery"] = {"snapshot_after_batches": snapshot_after,
                           "replayed_batches": parity_batches - snapshot_after,
                           "seconds": recovery_s, "cpu_seconds": cpu_recovery_s,
                           "equal_uncrashed": not differ, "cpu_equal": not cdiffer}
        rec["conservation"]["recovered"] = _conserved(rengine, "recovered", fails)
        rec["conservation"]["cpu_recovered"] = _conserved(crec, "CPU recovered", fails)
        del rengine, crec, ref
    rec["card"] = card_line() if device.type == "cuda" else None
    emit(rec, log)
    h, w = rec["headline"], rec["wal"]
    print(f"wire: {h['events_per_s']:.0f} events/s headline, {w['events_per_s']:.0f} with "
          f"the WAL (ratio {rec['wal_over_headline_events_per_s']:.3f}); e2e p50 "
          f"{h['latency_p50_ms']:.2f} ms p99 {h['latency_p99_ms']:.2f} ms; host per batch "
          f"decode+commit {h['decode_commit_ms']:.2f} ms, dispatch {h['dispatch_ms']:.2f} ms; "
          f"arena_pool_waits {h['arena_pool_waits']}; recovery {rec['recovery']['seconds']:.2f} s; "
          f"peak device memory {h['peak_mem_gb']} GiB; {rec['card']}", flush=True)


# the archive phase: the slice phase's headline engine sizes (bench.py's
# HEADLINE_CFG) with 100 channels and an archive of 4096-row segments (the
# default) in a temporary directory, fed 40 bulk batches over 2048 devices:
# 655,360 events, 2.5x the 2^18-row ring, 320 rows a device. One analytics
# job scores every device's newest 128-step window from the archive at the
# service's default width (BASELINE config #4: 100-sensor windows), bf16,
# 256 devices a batch
# the series a scrape of the hostplane phase must hold (the CPU parity
# test, tests/test_torch_metrics.py, pins the same list)
HOSTPLANE_SERIES = (
    "swtpu_engine_processed", "swtpu_engine_persisted", "swtpu_engine_arena_rows",
    "swtpu_tenant_events", "swtpu_pipeline_accepted", "swtpu_pipeline_invalid",
    "swtpu_arena_pool_arenas", "swtpu_arena_pool_free", "swtpu_arena_pool_inflight",
    "swtpu_arena_pool_waits", "swtpu_arena_pool_occupancy_hwm",
    "swtpu_staged_backlog_hwm_rows", "swtpu_dispatch_inflight", "swtpu_flight_records",
    "swtpu_span_records", "swtpu_spans_recorded_total", "swtpu_spans_sampled_out_total",
    "swtpu_ingest_e2e_seconds", "swtpu_device_exec_seconds", "swtpu_flow_rows",
    "swtpu_conservation_audits_total", "swtpu_conservation_violations",
    "swtpu_device_mem_bytes", "swtpu_device_mem_hwm", "swtpu_qos_admitted_total",
    "swtpu_qos_shed_total", "swtpu_qos_bucket_fill", "swtpu_qos_shed_threshold",
    "swtpu_qos_wfq_vtime", "swtpu_query_latency_seconds", "swtpu_queries_total",
)


ARCHIVE_CONFIG = dict(device_capacity=1 << 15, token_capacity=1 << 16,
                      assignment_capacity=1 << 16, store_capacity=1 << 18,
                      batch_capacity=16384, channels=100, analytics_window=128)
ARCHIVE_DEVICES, ARCHIVE_BATCHES = 2048, 40
ARCHIVE_JOB_DEVICES = 256
ARCHIVE_QUERIES = 16
ARCHIVE_FEED_BATCH = 16384
# feed polls that are polled again before their commit (at-least-once):
# the first few and the last (every one doubled the feed's 42 s on an H100)
ARCHIVE_FEED_REPOLLS = 4
# tests/test_torch_anomaly.py's bf16 tolerance: job scores against the
# host rebuild scored with the plain window_features
SCORE_BF16 = dict(rtol=1e-2, atol=1e-3)
# the reduced leg: a card engine, a CPU engine and a card engine on the copy
# path with a scan chunk, fed the same JSON through the native decoder for 8
# rings' worth of events
ARCHIVE_SMALL = dict(device_capacity=1024, token_capacity=4096,
                     assignment_capacity=4096, store_capacity=1 << 14,
                     batch_capacity=2048, channels=8, archive_segment_rows=1024)
ARCHIVE_SMALL_DEVICES, ARCHIVE_SMALL_RINGS = 300, 8


def archive_columns(seed: int, n_batches: int, cfg: dict, n_devices: int) -> list[dict]:
    """The bulk stream as numpy columns: row j of every batch is a
    measurement of token ``j % n_devices`` (so batch 0 auto-registers token
    t as device t), every channel set, and event times strictly increasing
    over the stream (row j of batch k at ``k * batch + j``, its absolute ring
    position)."""
    b, c = cfg["batch_capacity"], cfg["channels"]
    rng = np.random.default_rng(seed)
    token = np.tile(np.arange(n_devices, dtype=np.int32), b // n_devices)
    out = []
    for k in range(n_batches):
        out.append(dict(
            valid=np.ones(b, np.bool_), etype=np.zeros(b, np.int32), token_id=token,
            tenant_id=np.zeros(b, np.int32),
            ts_ms=(k * b + np.arange(b)).astype(np.int32),
            received_ms=np.full(b, k, np.int32),
            values=rng.standard_normal((b, c), dtype=np.float32),
            vmask=np.ones((b, c), np.bool_),
            aux=np.full((b, AUX_LANES), NULL_ID, np.int32),
            seq=np.arange(b, dtype=np.int32)))
    return out


def archive_payloads(seed: int, n_calls: int, batch: int, n_devices: int) -> list[list[bytes]]:
    """The reduced leg's JSON: measurements of three names, a location every
    7th event and an alert with an alternate id every 11th, event times
    strictly increasing (PinnedEpoch(1e9) puts them at 0, 1, 2, ...)."""
    rng = np.random.default_rng(seed)
    out = []
    for call in range(n_calls):
        pays = []
        for i in range(batch):
            seq = call * batch + i
            tok = f"rl-{int(rng.integers(0, n_devices))}"
            ts = 10**12 + seq
            if seq % 11 == 0:
                req = {"type": "DeviceAlert", "request": {
                    "type": f"a{seq % 3}", "level": "Error", "eventDate": ts,
                    "alternateId": f"alt-{seq}"}}
            elif seq % 7 == 0:
                req = {"type": "DeviceLocation", "request": {
                    "latitude": float(rng.uniform(-80, 80)),
                    "longitude": float(rng.uniform(-170, 170)), "eventDate": ts}}
            else:
                req = {"type": "DeviceMeasurements", "request": {
                    "measurements": {"temp": 0.5 * (seq % 97), "load": 0.25 * (seq % 13),
                                     f"x{seq % 3}": 1.0}, "eventDate": ts}}
            pays.append(json.dumps({"deviceToken": tok, **req}).encode())
        out.append(pays)
    return out


def _segments_differ(a, b) -> list[str]:
    """Segments of two archives whose index entries or columns (dtype and
    bytes) differ."""
    from sitewhere_tpu_torch.utils.archive import _COLUMNS

    if [dataclasses.asdict(s) for s in a.segments] != [dataclasses.asdict(s) for s in b.segments]:
        return ["index"]
    out = []
    for sa, sb in zip(a.segments, b.segments):
        ca, cb = a._cols_or_drop(sa, _COLUMNS), b._cols_or_drop(sb, _COLUMNS)
        out += [f"{sa.path}:{c}" for c in _COLUMNS
                if ca[c].dtype != cb[c].dtype or not np.array_equal(ca[c], cb[c])]
    return out


def _archive_rows_equal(ra, rb) -> bool:
    return len(ra) == len(rb) and all(
        x.keys() == y.keys() and all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
                                     for k in x) for x, y in zip(ra, rb))


def _host_rows(eng) -> dict:
    """Every persisted row of a one-arena engine as host columns in
    absolute position order: the evicted positions from the spooled
    segments, the rest from one read of the ring."""
    from sitewhere_tpu_torch.ops.readback import read_range, slice_to_host
    from sitewhere_tpu_torch.utils.archive import _COLUMNS

    arch = eng.archive
    head = eng.ring_heads()[0]
    acap = eng.ring_arena_capacity()
    oldest = max(0, head - acap)
    parts = {c: [] for c in _COLUMNS}
    for seg in arch.segments:
        n = min(seg.count, oldest - seg.start)
        if n <= 0:
            continue
        cols = arch._cols_or_drop(seg, _COLUMNS)
        for c in _COLUMNS:
            parts[c].append(cols[c][:n])
    ring = slice_to_host(read_range(eng.state.store, oldest % acap, head - oldest))
    for c in _COLUMNS:
        parts[c].append(getattr(ring, c))
    return {c: np.concatenate(v) for c, v in parts.items()}


def _oracle_page(eng, rows: dict, lane_names: dict, *, device=None, since_ms=None,
                 until_ms=None, limit: int = 100) -> dict:
    """query_events over host rows: the filters, newest first (event times
    are unique in this stream), formatted by the engine's own formatter."""
    m = rows["valid"].copy()
    if device is not None:
        m &= rows["device"] == device
    if since_ms is not None:
        m &= rows["ts_ms"] >= since_ms
    if until_ms is not None:
        m &= rows["ts_ms"] <= until_ms
    idx = np.nonzero(m)[0]
    idx = idx[np.argsort(-rows["ts_ms"][idx], kind="stable")][:limit]
    events = [eng._format_event(int(rows["etype"][i]), int(rows["device"][i]),
                                int(rows["assignment"][i]), int(rows["ts_ms"][i]),
                                int(rows["received_ms"][i]), rows["values"][i],
                                rows["vmask"][i], rows["aux"][i], lane_names)
              for i in idx]
    return {"total": int(m.sum()), "events": events}


@torch.inference_mode()
def _plain_scores(model, data, filled, min_fill: int):
    """models/service._score_windows with the plain window_features."""
    feats = wf.window_features_reference(data)
    scores = model(wf.normalize_windows(data, feats))
    return torch.where(filled >= min_fill, scores, 0.0)


def phase_archive(device, log, fails, seed: int, config: dict = ARCHIVE_CONFIG,
                  n_devices: int = ARCHIVE_DEVICES, n_batches: int = ARCHIVE_BATCHES,
                  job_devices: int = ARCHIVE_JOB_DEVICES, small: dict = ARCHIVE_SMALL,
                  small_devices: int = ARCHIVE_SMALL_DEVICES,
                  feed_batch: int = ARCHIVE_FEED_BATCH, profile: bool = False) -> dict:
    """The archive tier at full width: the bulk stream spills 2.5 rings to
    disk; (a) no row lost, (b) the planner's pushdown query equals its full
    scan over the bench's filter matrix, (c) ``query_events`` over evicted
    time ranges equals a host oracle of the spooled columns plus the ring,
    (d) ``get_event`` of evicted ids, (e) a feed consumer from offset 0
    replays every event once; one analytics job scores every device's
    newest window from the archive through the window_features kernel,
    held to a host rebuild scored with the plain version; then the reduced
    leg, card against CPU byte for byte. Returns the kernel's launches in
    the job and its timing at the job's shape."""
    from sitewhere_tpu_torch.models.analytics import AnalyticsJobSpec, AnalyticsManager
    from sitewhere_tpu_torch.ops.window_fill import fill_windows

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    b, c, w = config["batch_capacity"], config["channels"], config["analytics_window"]
    rec: dict = {"phase": "archive", "config": config, "devices": n_devices,
                 "batches": n_batches, "events": n_batches * b}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="archive-"))
    try:
        eng = Engine(EngineConfig(**config, archive_dir=str(tmp / "headline")), device=device)
        for t in range(n_devices):
            eng.tokens.intern(f"ar-{t:05d}")
        cols = archive_columns(seed, n_batches, config, n_devices)
        batches = [EventBatch.from_numpy(device, **x) for x in cols]
        all_ts = np.concatenate([x["ts_ms"] for x in cols])
        all_vals = np.concatenate([x["values"] for x in cols])
        del cols
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for batch in batches:
            eng.ingest_event_batch(batch)
        eng.flush()
        ingest_s = time.perf_counter() - t0
        del batches
        arch, st = eng.archive, eng.spool_stats
        met = eng.metrics()
        head = eng.ring_heads()[0]
        acap = eng.ring_arena_capacity()
        seg_rows = arch.segment_rows
        spilled = arch.spilled(0)

        # (a) every evicted row is on disk, in whole segments
        fails.check(met["processed"] == head == n_batches * b and met["archive_lost_rows"] == 0
                    and met["archived_rows"] == spilled and spilled % seg_rows == 0
                    and head - acap <= spilled <= head and len(arch.segments) == spilled // seg_rows,
                    f"archive (a): head {head}, spilled {spilled}, metrics {met}")
        rec["spill"] = {"head": head, "ring_rows": acap, "evicted_rows": head - acap,
                        "archived_rows": met["archived_rows"], "segments": len(arch.segments),
                        "segment_rows": seg_rows, "lost_rows": met["archive_lost_rows"],
                        **st, "spool_ms_per_segment": st["seconds"] * 1e3 / max(1, st["segments"]),
                        "spool_host_ms_per_batch": st["seconds"] * 1e3 / n_batches,
                        "syncs_per_batch": st["syncs"] / n_batches,
                        "ingest_s": ingest_s}

        # (b) pushdown against the full scan, on the bench's filter matrix
        filters = [{"limit": 50}, {"limit": 5}, {"device": 7}, {"device": 7, "limit": 3},
                   {"since_ms": 1000, "until_ms": 1500, "limit": 100},
                   {"since_ms": spilled // 4, "limit": 64},
                   {"device": 3, "since_ms": 1200, "until_ms": 2200 + b},
                   {"etype": int(EventType.MEASUREMENT), "limit": 20},
                   {"device": 999_999_999},
                   {"max_pos": {0: spilled // 3}, "limit": 40},
                   {"max_pos": {0: spilled // 3}, "device": 1}]
        bad = [f for f in filters
               if (lambda x, y: x[0] != y[0] or not _archive_rows_equal(x[1], y[1]))(
                   arch.query(**f), arch.query_unpruned(**f))]
        fails.check(not bad, f"archive (b): pushdown differs from the full scan for {bad}")
        rec["pushdown_filters"], rec["pushdown_equal"] = len(filters), not bad

        # (c) historical query_events against the host oracle: the spooled
        # columns plus the ring, which must hold the stream as generated
        rows = _host_rows(eng)
        fails.check(len(rows["ts_ms"]) == head and np.array_equal(rows["ts_ms"], all_ts)
                    and np.array_equal(rows["values"], all_vals)
                    and np.array_equal(rows["device"], np.arange(head) % n_devices),
                    "archive (c): the spooled segments plus the ring are not the stream")
        lane_names = eng._lane_names()
        evicted = head - acap
        q_ms, q_bad = [], []
        for i in range(ARCHIVE_QUERIES):
            since = (evicted * i) // ARCHIVE_QUERIES
            q = dict(since_ms=since, until_ms=since + (b if i % 2 else 40 * b), limit=100)
            if i % 4 == 3:
                q["device"] = (97 * i) % n_devices
            kw = dict(q)
            if "device" in kw:
                kw["device_token"] = f"ar-{kw.pop('device'):05d}"
            t0 = time.perf_counter()
            page = eng.query_events(**kw)
            q_ms.append((time.perf_counter() - t0) * 1e3)
            if page != _oracle_page(eng, rows, lane_names, **q):
                q_bad.append(q)
        fails.check(not q_bad, f"archive (c): query_events differs from the host oracle for {q_bad}")
        rec["query_ms_p50"] = float(np.percentile(q_ms, 50))
        rec["query_ms_p99"] = float(np.percentile(q_ms, 99))
        rec["query_ms"] = q_ms

        # (d) get_event of evicted ids (and one id the ring holds)
        ids = [0, 1, seg_rows - 1, seg_rows, evicted // 2, evicted - 1, head - 1]
        got = [eng.get_event(i) for i in ids]
        fails.check(all(ev is not None and ev["eventId"] == i and ev["eventDateMs"] == int(all_ts[i])
                        and ev["measurements"] == {lane_names.get(ch, f"ch{ch}"): float(all_vals[i, ch])
                                                   for ch in range(c)}
                        for i, ev in zip(ids, got)) and eng.get_event(head) is None,
                    f"archive (d): get_event of ids {ids} does not give the archived rows")

        # (e) the feed replays every event once, at least once before a commit
        consumer = eng.make_feed_consumer("replay", max_batch=feed_batch)
        delivered, poll_s, feed_ok, repolls = 0, 0.0, True, 0
        while True:
            t0 = time.perf_counter()
            evs = consumer.poll()
            poll_s += time.perf_counter() - t0
            if not evs:
                break
            ids_now = [e.event_id for e in evs]
            feed_ok &= (ids_now == list(range(delivered, delivered + len(evs)))
                        and evs[-1].values == [float(v) for v in all_vals[ids_now[-1]]])
            if repolls < ARCHIVE_FEED_REPOLLS or delivered + len(evs) == head:
                again = consumer.poll()
                feed_ok &= [e.event_id for e in again] == ids_now
                repolls += 1
                del again
            consumer.commit(evs)
            delivered += len(evs)
            del evs
        fails.check(feed_ok and delivered == head and consumer.lag_lost == 0
                    and consumer.offset == head,
                    f"archive (e): the feed delivered {delivered} of {head} events "
                    f"(in order and again before a commit: {feed_ok}, lag_lost {consumer.lag_lost})")
        rec["feed"] = {"delivered": delivered, "max_batch": feed_batch, "repolls": repolls,
                       "events_per_s": delivered / poll_s, "lag_lost": consumer.lag_lost}

        # the analytics job: every device's newest window, 256 devices a
        # batch, through the window_features kernel
        mgr = AnalyticsManager(eng)
        job_scores: dict = {}
        orig_emit = mgr._emit_batch

        def spy(job, batch_devs, ends, scores, valid, *a, **kw):
            for d, s in zip(batch_devs, scores):
                job_scores[int(d)] = float(s)
            return orig_emit(job, batch_devs, ends, scores, valid, *a, **kw)

        mgr._emit_batch = spy
        model, _ = mgr._model_bundle(w, c)       # built before the count starts
        if device.type == "cuda":
            torch.cuda.synchronize()
        wf.window_features.launches = 0          # this path starts here
        job = mgr.run_job(AnalyticsJobSpec(batch_devices=job_devices, window=w,
                                           threshold=3.0, name="archive-smoke"))
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = wf.window_features.launches   # ... ends here
        n_job_batches = (n_devices + job_devices - 1) // job_devices
        fails.check(job["state"] == "done" and job["devices"] == n_devices
                    and job["scored"] == n_devices and job["batches"] == n_job_batches,
                    f"archive: job {job}")
        fails.check(launches == job["batches"],
                    f"archive: {launches} window_features launches for {job['batches']} "
                    "scoring batches")
        # the job's spans, as the JAX job emits them: a load span a round and
        # a score span a scoring batch
        job_spans: dict = {}
        for sp in eng.tracer.recent(eng.tracer.capacity):
            if sp["tags"].get("job") == "archive-smoke":
                job_spans[sp["name"]] = job_spans.get(sp["name"], 0) + 1
        fails.check(job_spans.get("analytics.load") == job["rounds"]
                    and job_spans.get("analytics.score") == job["batches"]
                    and job_spans.get("analytics.transfer") == job["batches"],
                    f"archive: the job left spans {job_spans} for {job['rounds']} rounds "
                    f"and {job['batches']} scoring batches")
        # the host rebuild: each device's newest w archived rows
        per = head // n_devices
        pos = np.arange(n_devices)[:, None] + n_devices * np.arange(per)[None, :]
        pos = np.where(pos < spilled, pos, -1)
        newest = np.sort(pos, axis=1)[:, -w:]
        host_windows = torch.from_numpy(all_vals[newest])
        filled = torch.full((n_devices,), w, dtype=torch.int32)
        plain = torch.cat([_plain_scores(model, host_windows[lo:lo + job_devices].to(device),
                                         filled[lo:lo + job_devices].to(device), w).cpu()
                           for lo in range(0, n_devices, job_devices)]).numpy()
        got_scores = np.array([job_scores.get(d, np.nan) for d in range(n_devices)])
        score_err = float(np.nanmax(np.abs(got_scores - plain)))
        fails.check(bool(np.isfinite(got_scores).all())
                    and bool(np.allclose(got_scores, plain, **SCORE_BF16)),
                    f"archive: job scores differ from the host rebuild (max abs {score_err})")
        # fill_windows of the first batch: card and CPU byte for byte, and
        # the host rebuild's windows
        sel = newest[:job_devices].reshape(-1)
        fill_in = (torch.from_numpy(np.repeat(np.arange(job_devices, dtype=np.int32), w)),
                   torch.from_numpy(all_ts[sel].astype(np.int32)),
                   torch.arange(job_devices * w, dtype=torch.int32),
                   torch.from_numpy(all_vals[sel]),
                   torch.ones((job_devices * w, c), dtype=torch.bool))
        card_fill = fill_windows(*(x.to(device) for x in fill_in), m=job_devices, w=w)
        cpu_fill = fill_windows(*fill_in, m=job_devices, w=w)
        fill_equal = (all(torch.equal(x.cpu(), y) for x, y in zip(card_fill, cpu_fill))
                      and torch.equal(cpu_fill[0], host_windows[:job_devices]))
        fails.check(fill_equal, "archive: fill_windows on the card differs from its CPU run "
                    "or from the host rebuild")
        # the kernel at the job's shape, against its plain version
        x = card_fill[0]
        kernel_ms = time_ms(lambda: wf.window_features(x), device)
        plain_ms = time_ms(lambda: wf.window_features_reference(x), device)
        bound_ms, bound_by = window_features_bound_ms(*x.shape)
        kerr = float((wf.window_features(x) - wf.window_features_reference(x)).abs().max())
        fails.check(kerr <= KERNEL_TOL * (1 + float(x.abs().max())),
                    f"archive: window_features at {tuple(x.shape)} max abs err {kerr}")
        eng.flush()
        led = build_ledger(eng, None)
        bad_led = [v.to_dict() for v in check_conservation(led)]
        fails.check(not bad_led and led["stages"]["analytics"]["planned"] == n_devices,
                    f"archive: conservation violated: {bad_led}")
        rec["job"] = {k: job[k] for k in ("rounds", "segments", "bytes", "rows", "planned",
                                          "scored", "emitted", "batches", "stream_s",
                                          "score_s", "bytes_per_s", "devices_per_s")}
        rec["job"].update(score_max_abs_err_vs_host=score_err, score_tol=SCORE_BF16,
                          window_features_launches=launches, fill_windows_equal_cpu=fill_equal,
                          spans=job_spans,
                          model=dataclasses.asdict(model.cfg) | {"dtype": str(model.cfg.dtype)})
        b1 = {"shape": list(x.shape), "ms": kernel_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": kerr}
        rec["window_features_at_job_shape"] = b1
        rec["conservation"] = {"stages": sorted(led["stages"]), "violations": bad_led}
        rec["peak_mem_gb"] = (torch.cuda.max_memory_allocated() / 2**30
                              if device.type == "cuda" else None)
        if profile and device.type == "cuda":   # after the counts were read
            more = [EventBatch.from_numpy(device, **x)
                    for x in archive_columns(seed + 1, 2, config, n_devices)]
            eng._spool_trigger = 1 << 62          # ingest without spooling ...
            for batch in more:
                eng.ingest_event_batch(batch)
            eng.barrier()
            _profile("spool", eng._spool, 1, log, family=_step_family)   # ... then one spool
            _profile("score_batch", lambda: mgr._model_bundle(w, c)[1](
                model, card_fill[0], card_fill[1], w), 1, log, family=_kernel_family)
        del eng, mgr, rows, all_vals, host_windows

        # the reduced leg: card, CPU and the card's copy path, byte for byte
        calls = ARCHIVE_SMALL_RINGS * small["store_capacity"] // small["batch_capacity"]
        payloads = archive_payloads(seed, calls, small["batch_capacity"], small_devices)
        legs = {"card": (device, {}), "cpu": (cpu, {}),
                "card_copy_scan2": (device, {"ingest_arenas": -1, "scan_chunk": 2})}
        engines, small_rec = {}, {}
        for label, (dev, kw) in legs.items():
            e = Engine(EngineConfig(**small, **kw, archive_dir=str(tmp / label)), device=dev)
            e.epoch = PinnedEpoch(1e9)
            t0 = time.perf_counter()
            for p in payloads:
                e.ingest_json_batch(p)
            e.flush()
            small_rec[label] = {"seconds": time.perf_counter() - t0,
                                "archived_rows": e.metrics()["archived_rows"],
                                "arena_rows": e.host_counters.get("arena_rows", 0),
                                "staged_copy_rows": e.host_counters.get("staged_copy_rows", 0),
                                "conservation": _conserved(e, f"archive {label}", fails)}
            engines[label] = e
        ref = engines["card"]
        fails.check(ref.metrics()["archive_lost_rows"] == 0
                    and ref.metrics()["archived_rows"] >= (ARCHIVE_SMALL_RINGS - 1)
                    * small["store_capacity"]
                    and small_rec["card"]["arena_rows"] > 0
                    and small_rec["card_copy_scan2"]["staged_copy_rows"] > 0,
                    f"archive (small): {small_rec}")
        queries = [dict(limit=50), dict(since_ms=100, until_ms=3000, limit=64),
                   dict(device_token="rl-7", limit=100),
                   dict(etype=EventType.ALERT, until_ms=20_000, limit=30),
                   dict(alternate_id="alt-121")]
        pages = {label: [e.query_events(**q) for q in queries] for label, e in engines.items()}
        feeds = {}
        for label, e in engines.items():
            fc = e.make_feed_consumer("small", max_batch=1 << 15)
            out = []
            while evs := fc.poll():
                fc.commit(evs)
                out += [dataclasses.asdict(ev) | {"etype": int(ev.etype)} for ev in evs]
            feeds[label] = out
        for label, e in engines.items():
            if e is ref:
                continue
            differ = _engines_differ(ref, e) + _segments_differ(ref.archive, e.archive)
            fails.check(not differ and pages[label] == pages["card"]
                        and feeds[label] == feeds["card"],
                        f"archive (small): the {label} engine differs from the card's in "
                        f"{differ[:8]} (pages equal {pages[label] == pages['card']}, "
                        f"feed equal {feeds[label] == feeds['card']})")
            small_rec[label]["equal_card"] = not differ
        fails.check(len(feeds["card"]) == ref.ring_heads()[0]
                    and any(p["total"] for p in pages["card"]),
                    f"archive (small): feed {len(feeds['card'])} events, head {ref.ring_heads()}")
        rec["small"] = {"config": small, "calls": calls, "events": calls * small["batch_capacity"],
                        "segments": len(ref.archive.segments), **small_rec}
        del engines, ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["card"] = card_line() if device.type == "cuda" else None
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec, log)
    s, j = rec["spill"], rec["job"]
    print(f"archive: spool {s['spool_ms_per_segment']:.3f} ms a segment "
          f"({s['spool_host_ms_per_batch']:.2f} host ms a batch, {s['syncs_per_batch']:.2f} syncs); "
          f"{s['archived_rows']} rows in {s['segments']} segments; historical query_events "
          f"p50 {rec['query_ms_p50']:.2f} ms p99 {rec['query_ms_p99']:.2f} ms; feed replay "
          f"{rec['feed']['events_per_s']:.0f} events/s; job {j['rounds']} rounds, "
          f"{j['bytes_per_s'] / 1e6:.1f} MB/s, {j['devices_per_s']:.0f} devices/s; "
          f"window_features {launches} launches, {b1['ms']:.4f} ms at {b1['shape']} "
          f"(bound {b1['bound_ms']:.4f} ms); peak device memory {rec['peak_mem_gb']} GiB; "
          f"phase {rec['seconds']:.1f} s; {rec['card']}", flush=True)
    return {"launches": launches, **b1}


# the hostplane phase: the wire phase's headline width (bench.py's
# HEADLINE_CFG: 16384-event batches, dispatch_depth=2, 10,000 devices) for
# the tracing pairs, the pool leg (bench.py:140-175: 48 batches over
# 10,000 tokens) and the tuner; bench.py's fairness leg (bench.py:1317-1400)
# at its own engine sizes
HOST_PAIRS, HOST_PAIR_BATCHES = 3, 20
HOST_POOL_BATCHES, HOST_POOL_WARMUP = 48, 4
HOST_TUNE_BATCHES = 40
HOST_AUDIT_S = 1.0
FAIR_CONFIG = dict(device_capacity=1 << 12, token_capacity=1 << 13,
                   assignment_capacity=1 << 13, store_capacity=1 << 16,
                   batch_capacity=512, channels=4, qos=True, fair_tenancy=True,
                   tenant_rates={"abuser": 250.0}, qos_burst_s=0.25,
                   tenant_weights={"victim": 2.0, "abuser": 1.0})
FAIR_SESSIONS, FAIR_DURATION_S = 4, 1.2


def _fair_spec(abuser: bool, duration_s: float):
    from sitewhere_tpu_torch.loadgen import OpenLoopSpec, TenantLoad

    tenants = [TenantLoad("victim", 1200.0, n_devices=128)]
    if abuser:
        tenants.append(TenantLoad("abuser", 2500.0, n_devices=128, abusive_mult=2.0,
                                  abusive_period_s=0.4, abusive_burst_s=0.2))
    return OpenLoopSpec(tenants=tuple(tenants), duration_s=duration_s, frame_size=128,
                        seed=90)


class _CallLog:
    """Records an engine's ``ingest_json_batch`` and ``flush`` calls in
    order, so another engine can replay the same admitted stream."""

    def __init__(self, eng):
        self.ops: list = []
        ingest, flush = eng.ingest_json_batch, eng.flush

        def logged_ingest(payloads, tenant="default", **kw):
            self.ops.append(("ingest", list(payloads), tenant))
            return ingest(payloads, tenant, **kw)

        def logged_flush():
            self.ops.append(("flush",))
            return flush()

        eng.ingest_json_batch, eng.flush = logged_ingest, logged_flush

    def replay(self, eng) -> None:
        for op in self.ops:
            if op[0] == "ingest":
                eng.ingest_json_batch(op[1], op[2])
            else:
                eng.flush()


def _audited(eng, auditors: list):
    aud = ConservationAuditor(eng, interval_s=HOST_AUDIT_S)
    aud.start()
    auditors.append(aud)
    return eng


def _stage_medians(eng) -> dict:
    durs = [stage_durations(r["stagesUs"]) for r in eng.flight.recent(
        eng.flight.capacity, kind="ingest")]
    out = {}
    for key in ("decode_ms", "wal_ms", "dispatch_wait_ms", "device_ms"):
        vals = [d[key] for d in durs if d[key] is not None]
        out[key] = statistics.median(vals) if vals else None
    return out


def _scrape(engines) -> dict:
    """One scrape: every engine's export into the process registry, then
    the registry's text parsed into {family: samples}. Raises on a sample
    line that belongs to no declared family or carries no number."""
    for e in engines:
        export_engine_metrics(e)
    families: dict = {}
    for line in METRICS_REGISTRY.expose_text().splitlines():
        if line.startswith("# TYPE "):
            families[line.split()[2]] = 0
        elif line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            float(value)
            base = name.split("{", 1)[0]
            fam = next(f for f in (base, base.rsplit("_", 1)[0]) if f in families)
            families[fam] += 1
    return families


def phase_hostplane(device, log, fails, seed: int, config: dict = WIRE_CONFIG,
                    n_devices: int = WIRE_DEVICES, pairs: int = HOST_PAIRS,
                    pair_batches: int = HOST_PAIR_BATCHES,
                    pool_batches: int = HOST_POOL_BATCHES,
                    tune_batches: int = HOST_TUNE_BATCHES, fair_config: dict = FAIR_CONFIG,
                    fair_sessions: int = FAIR_SESSIONS,
                    fair_duration_s: float = FAIR_DURATION_S,
                    profile: bool = False) -> None:
    """The single-engine host plane on the card: (a) the wire load with the
    flight recorder and span tracer on and off, in interleaved pairs; (b)
    the multiprocess decode pool against the in-process path; (c) bench.py's
    fairness leg through the open-loop generator on a QoS, fair-tenancy
    engine; (d) the autotuner against a fixed-knob engine; (e) a
    conservation auditor thread on every engine and the Prometheus scrape;
    (f) the memory ledger."""
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    batch = config["batch_capacity"]
    rec: dict = {"phase": "hostplane", "config": config, "devices": n_devices}
    auditors: list = []
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # (a) tracing on and off, interleaved pairs of the wire load
    on = _audited(wire_engine(device, config), auditors)
    off = _audited(wire_engine(device, config, flight_recorder=False, span_trace=False),
                   auditors)
    trace_ids: list = []
    ingest = on.ingest_json_batch

    def traced(payloads, tenant="default", **kw):
        res = ingest(payloads, tenant, **kw)
        trace_ids.append(res.get("trace_id"))
        return res

    on.ingest_json_batch = traced
    mid_scrape: dict = {}

    def scrape_mid_load():
        time.sleep(0.2)
        mid_scrape.update(_scrape([on]))

    rates = {"on": [], "off": []}
    for k in range(pairs):
        order = (("on", on), ("off", off)) if k % 2 == 0 else (("off", off), ("on", on))
        for label, eng in order:
            scraper = None
            if k == 0 and label == "on":
                scraper = threading.Thread(target=scrape_mid_load, name="swtpu-scrape")
                scraper.start()
            st = run_engine_load(eng, n_batches=pair_batches, batch_size=batch,
                                 n_devices=n_devices, seed=seed + k, warmup_batches=1,
                                 pipelined=True)
            if scraper is not None:
                scraper.join()
            fails.check(st.events_decoded == pair_batches * batch and st.events_failed == 0,
                        f"hostplane (a): {label} decoded {st.events_decoded}")
            rates[label].append(st.events_per_s)
    on.flush()
    off.flush()
    ratios = [a / b for a, b in zip(rates["on"], rates["off"])]
    records = on.flight.recent(on.flight.capacity, kind="ingest")
    fails.check(len(trace_ids) == pairs * (pair_batches + 1)
                and all(isinstance(t, str) and len(t) == 32 for t in trace_ids),
                f"hostplane (a): {sum(t is None for t in trace_ids)} of {len(trace_ids)} "
                "summaries without a trace_id")
    incomplete = [r["traceId"] for r in records
                  if not {"device_ready", "readback"} <= set(r["stagesUs"])]
    overlong = [r["traceId"] for r in records
                if sum(v for v in stage_durations(r["stagesUs"]).values() if v) * 1e3
                > r["stagesUs"].get("device_ready", 0.0) + 1e-3]
    fails.check(len(records) == len(trace_ids) and not incomplete and not overlong,
                f"hostplane (a): {len(records)} records for {len(trace_ids)} batches, "
                f"{len(incomplete)} without device_ready/readback, {len(overlong)} whose "
                "stages exceed their end to end")
    doc = on.get_trace_timeline(trace_ids[-1])
    cats = {e.get("cat") for e in doc["traceEvents"] if e.get("ph") == "X"}
    fails.check(cats == {"flight", "span"} or (on._sharder is None and cats == {"flight"}),
                f"hostplane (a): the timeline of one trace holds {cats}")
    fails.check(not off.recent_traces() and len(off.tracer) == 0,
                "hostplane (a): the engine with the recorder off recorded")
    medians = _stage_medians(on)
    rec["tracing"] = {"pairs": pairs, "batches_per_run": pair_batches,
                      "on_events_per_s": rates["on"], "off_events_per_s": rates["off"],
                      "on_over_off": ratios, "on_over_off_median": statistics.median(ratios),
                      "on_over_off_spread": [min(ratios), max(ratios)],
                      "records": len(records), "spans": len(on.tracer),
                      "timeline_events": len(doc["traceEvents"]),
                      "stage_medians_ms": medians, "mid_load_scrape_families": len(mid_scrape)}
    fails.check("swtpu_engine_processed" in mid_scrape and "swtpu_flight_records" in mid_scrape,
                f"hostplane (e): the mid-load scrape holds {sorted(mid_scrape)[:8]}...")
    if profile and device.type == "cuda":   # after the checks: three more dispatches
        more = wire_payloads(seed + 7, 3, batch, n_devices)
        _profile("hostplane_dispatch", lambda: ([on.ingest_json_batch(p) for p in more],
                                                on.barrier()), 3, log, family=_step_family)

    # (b) the decode pool, bench.py's pool leg, against the in-process path
    n_pool = max(1, min(4, (os.cpu_count() or 2) - 1))
    rng = np.random.default_rng(2)
    toks = [f"lg-{i}" for i in range(n_devices)]
    pool_batches_pay = []
    for b in range(pool_batches):
        picks = rng.integers(0, n_devices, batch)
        pool_batches_pay.append([generate_measurements_message(toks[d], b * batch + i)
                                 for i, d in enumerate(picks)])
    peng = _audited(wire_engine(device, config), auditors)
    ieng = _audited(wire_engine(device, config), auditors)
    timed = pool_batches_pay[HOST_POOL_WARMUP:]
    with DecodeWorkerPool(peng, n_workers=n_pool, max_msgs=batch) as pool:
        for b in pool_batches_pay[:HOST_POOL_WARMUP]:
            pool.submit(b)
        pool.flush()
        peng.barrier()
        t0 = time.perf_counter()
        for b in timed:
            pool.submit(b)
            if peng.staged_count:
                peng.flush_async()
        pool.flush()
        if peng.staged_count:
            peng.flush_async()
        peng.barrier()
        pool_s = time.perf_counter() - t0
        pool_stats = pool.stats()
    for b in pool_batches_pay[:HOST_POOL_WARMUP]:
        ieng.ingest_json_batch(b)
    ieng.barrier()
    t0 = time.perf_counter()
    for b in timed:
        ieng.ingest_json_batch(b)
        if ieng.staged_count:
            ieng.flush_async()
    ieng.barrier()
    inproc_s = time.perf_counter() - t0
    peng.flush()
    ieng.flush()
    differ = _engines_differ(ieng, peng)
    fails.check(not differ and pool_stats["fallback_batches"] == 0,
                f"hostplane (b): the pool engine differs from the in-process engine in "
                f"{differ[:8]} ({pool_stats})")
    rec["pool"] = {"workers": n_pool, "batches": pool_batches, "timed_batches": len(timed),
                   "pool_msgs_per_s": len(timed) * batch / pool_s,
                   "in_process_msgs_per_s": len(timed) * batch / inproc_s,
                   "stats": pool_stats, "equal": not differ}
    del pool_batches_pay, timed

    # (c) fairness and QoS: bench.py's leg through the port's open-loop generator
    feng = _audited(wire_engine(device, fair_config), auditors)
    calls = _CallLog(feng)
    run_engine_load(feng, n_batches=1, batch_size=fair_config["batch_capacity"],
                    n_devices=128, warmup_batches=1)
    sched_alone = build_open_loop_schedule(_fair_spec(False, fair_duration_s))
    sched_abuse = build_open_loop_schedule(_fair_spec(True, fair_duration_s))
    p99_alone, p99_abuse, results = [], [], []
    for _ in range(fair_sessions):
        ra = run_open_loop(feng, sched_alone, checkpoint_frames=4)
        rb = run_open_loop(feng, sched_abuse, checkpoint_frames=4)
        p99_alone.append(ra.per_tenant["victim"]["e2e_p99_ms"])
        p99_abuse.append(rb.per_tenant["victim"]["e2e_p99_ms"])
        results.append((ra, rb))
    feng.flush()
    admitted = {"victim": sum(ra.per_tenant["victim"]["events"]
                              + rb.per_tenant["victim"]["events"] for ra, rb in results),
                "abuser": sum(rb.per_tenant["abuser"]["events"] for _, rb in results)}
    sheds = {t: sum(r.per_tenant.get(t, {}).get("shed", 0) for pair in results for r in pair)
             for t in ("victim", "abuser")}
    ratio = (admitted["abuser"] + sheds["abuser"]) / max(1, admitted["abuser"])
    tpc = feng.tenant_pipeline_counters()
    accepted = {t: tpc.get(t, {}).get("accepted", 0) for t in admitted}
    fails.check(accepted == admitted,
                f"hostplane (c): device accepted {accepted} != admitted {admitted}")
    fails.check(ratio >= 5.0, f"hostplane (c): abuser offered/admitted {ratio:.2f} < 5")
    ceng = wire_engine(cpu, fair_config)
    calls.replay(ceng)
    ceng.flush()
    cdiffer = _engines_differ(feng, ceng)
    fails.check(not cdiffer, f"hostplane (c): the CPU engine fed the admitted stream differs "
                f"from the card's in {cdiffer[:8]}")
    rec["fairness"] = {"sessions": fair_sessions, "duration_s": fair_duration_s,
                       "victim_p99_alone_ms": p99_alone, "victim_p99_abuse_ms": p99_abuse,
                       "victim_p99_alone_min_ms": min(p99_alone),
                       "victim_p99_abuse_min_ms": min(p99_abuse),
                       "admitted": admitted, "shed": sheds, "abuser_offered_over_admitted": ratio,
                       "qos_shed_by_tenant": dict(feng.qos.shed_by_tenant),
                       "cpu_equal": not cdiffer}
    del ceng, calls

    # (d) the autotuner against a fixed-knob engine, same load
    teng = _audited(wire_engine(device, config, autotune=True, autotune_interval=16),
                    auditors)
    fixed = _audited(wire_engine(device, config), auditors)
    for eng in (teng, fixed):
        run_engine_load(eng, n_batches=tune_batches, batch_size=batch, n_devices=n_devices,
                        seed=seed + 11, warmup_batches=WIRE_WARMUP, pipelined=True)
        eng.flush()
    tdiffer = _engines_differ(fixed, teng)
    queries = [dict(limit=64), dict(device_token="lg-7", limit=16),
               dict(since_ms=0, limit=32)]
    pages_equal = all(teng.query_events(**q) == fixed.query_events(**q) for q in queries)
    tuner = teng._autotuner
    fails.check(not tdiffer and pages_equal and tuner.evaluations >= 2,
                f"hostplane (d): the tuned engine differs from the fixed one in "
                f"{tdiffer[:8]} (pages equal: {pages_equal}; {tuner.evaluations} evaluations)")
    rec["autotune"] = {"interval": 16, "evaluations": tuner.evaluations,
                       "decisions": tuner.decisions, "final": tuner.current(),
                       "state_equal": not tdiffer, "pages_equal": pages_equal}

    # (e) the auditors and the final scrape
    for aud in auditors:
        aud.stop()
        aud.audit()
    fails.check(all(a.confirmed_total == 0 and not a.last_violations for a in auditors),
                f"hostplane (e): audit violations "
                f"{[a.last_violations for a in auditors if a.last_violations]}")
    engines = [on, off, peng, ieng, feng, teng, fixed]
    families = _scrape(engines)
    missing = [n for n in HOSTPLANE_SERIES if n not in families]
    fails.check(not missing, f"hostplane (e): the scrape lacks {missing}")
    hist = METRICS_REGISTRY.histogram("swtpu_ingest_e2e_seconds")
    ring = [r for r in on.flight._ring if r is not None and r.kind == "ingest"]
    harvested = sum(r.n_payloads for r in ring if r.harvested)
    counted = hist.count(tenant="default", engine=on.metrics_label)
    fails.check(counted == harvested == sum(r.n_payloads for r in ring) > 0,
                f"hostplane (e): swtpu_ingest_e2e_seconds counts {counted}, harvested "
                f"{harvested} of {sum(r.n_payloads for r in ring)} payloads")
    rec["audit"] = {"engines": len(auditors), "audits": sum(a.audits for a in auditors),
                    "syncs": sum(a.stats["syncs"] for a in auditors),
                    "seconds": sum(a.stats["seconds"] for a in auditors)}
    rec["scrape"] = {"families": len(families), "e2e_count": counted}

    # (f) the memory ledger: the card engine against a CPU engine of its shape
    led = memory_ledger(on)
    comp_sum = sum(led["components"].values())
    allocated = torch.cuda.memory_allocated() if device.type == "cuda" else None
    cpu_led = memory_ledger(wire_engine(cpu, config))
    fails.check(led["components"] == cpu_led["components"]
                and (allocated is None or comp_sum <= allocated),
                f"hostplane (f): ledger {led['components']} vs CPU {cpu_led['components']}, "
                f"sum {comp_sum} vs allocated {allocated}")
    rec["memory"] = {"components": led["components"], "sum_bytes": comp_sum,
                     "allocated_bytes": allocated, "live": led["liveArrays"],
                     "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                                     if device.type == "cuda" else None)}
    rec["seconds"] = time.perf_counter() - t_phase
    rec["card"] = card_line() if device.type == "cuda" else None
    emit(rec, log)
    tr, po, fa_, m = rec["tracing"], rec["pool"], rec["fairness"], rec["memory"]
    print(f"hostplane: tracing on {statistics.median(tr['on_events_per_s']):.0f} / off "
          f"{statistics.median(tr['off_events_per_s']):.0f} events/s (on/off median "
          f"{tr['on_over_off_median']:.3f}, spread {tr['on_over_off_spread'][0]:.3f}-"
          f"{tr['on_over_off_spread'][1]:.3f}); stage medians ms "
          + ", ".join(f"{k[:-3]} {v:.2f}" for k, v in tr["stage_medians_ms"].items()
                      if v is not None)
          + f"; pool {po['pool_msgs_per_s']:.0f} msgs/s with {po['workers']} workers, "
          f"in-process {po['in_process_msgs_per_s']:.0f}; tuner "
          + (", ".join(f"{d['knob']} {d['from']}->{d['to']}"
                       for d in rec['autotune']['decisions']) or "no change")
          + f" in {rec['autotune']['evaluations']} evaluations; sheds {fa_['shed']}, victim "
          f"p99 alone {fa_['victim_p99_alone_min_ms']:.2f} ms, with abuser "
          f"{fa_['victim_p99_abuse_min_ms']:.2f} ms; ledger {m['sum_bytes']} bytes; peak "
          f"device memory {m['peak_mem_gb']} GiB; {rec['seconds']:.1f} s; {rec['card']}",
          flush=True)


def _step_family(name: str) -> str:
    """Kernel family of one device kernel of the fused step."""
    n = name.lower()
    if "memcpy" in n:
        return "copy"
    if "memset" in n:
        return "memset"
    if "sort" in n or "radix" in n or "cub::" in n and "scan" in n:
        return "sort_scan"
    if any(t in n for t in ("scatter", "index", "gather")):
        return "scatter_gather"
    if "reduce" in n:
        return "reduce"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def _profile(what: str, run, calls: int, log, family=None) -> None:
    """torch.profiler over ``run()`` (``calls`` calls): device time by
    kernel (and per call by ``family(kernel name)`` when given) and the
    device's busy share of the wall time (the rest is host work and launch
    gaps)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top, busy_ms = _device_time(prof)
    rec = {"phase": "profile", "what": what, "calls": calls,
           "wall_ms_per_call": wall_ms / calls, "device_ms_per_call": busy_ms / calls,
           "device_busy_share": busy_ms / wall_ms, "top": top}
    if family is not None:
        fams: dict[str, float] = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                fam = family(e.key)
                fams[fam] = fams.get(fam, 0.0) + e.self_device_time_total / 1e3 / calls
        rec["device_ms_per_call_by_family"] = fams
    emit(rec, log)


def phase_profile(eng, svc, batches, log) -> None:
    """Profiles of a few more full-width steps and one scoring call."""
    _profile("step", lambda: [eng.ingest_event_batch(b) for b in batches],
             len(batches), log)
    _profile("score", svc.score_all, 1, log)
    eng.flush()


# the train phase: the slice engine's 8192 windows after its 80 batches and
# the service's default model (hidden 256, LSTM 256, latent 32, bf16)
TRAIN_CALLS = 16
TRAIN_LONG_STEPS = 8
TRAIN_BATCH = 256
TRAIN_PARITY_CALLS = 3
TRAIN_PARITY_BATCH = 64      # the CPU leg's batch: at 256 it took ~22 s on the GPU machine
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)    # card vs CPU, float32: losses, parameters
GRAD_F32_TOL = 1e-5          # card vs CPU gradients: of each tensor's largest (the tests')
SCORE_BF16_TOL = dict(rtol=1e-2, atol=1e-3)   # card vs CPU scores, bf16 (the tests')
TRAIN_CPU_SCORED = 256       # windows the CPU scores after restoring the card's checkpoint
TRAIN_ALERT_SHARE = 0.02     # share of the windows the loop's threshold lets through
# (e): the read phase's engine (the slice config at the bench's rules sizes,
# its zones and the bench's CEP rule set) fed the read phase's stream; the
# stream's 1 s batches fill 2 s rollup windows 0..4
RT_BATCHES = 9
RT_SPILL_AFTER = 7          # the first spill: windows 0..3 live, 0..2 closed
RT_LIMIT = 1 << 16          # rollup listings: past every (group, window) of the ring
RT_TWEAKED = {**RL_RULESET, "rules": [dict(RL_RULESET["rules"][0], value=55.0),
                                      *RL_RULESET["rules"][1:]]}
RT_BAD_DOC = '{"rules": [{"name": "x", "kind": "window", "agg": "count", ' \
    '"channel": "temp", "op": "<", "value": 1, "windowMs": 1000}]}'


def _cpu_view(eng, m: int | None = None):
    """An engine stand-in for an ``AnalyticsService`` on the CPU: the
    card engine's config, devices and a CPU copy of its windows (the first
    ``m`` devices' when given)."""
    from types import SimpleNamespace

    wins = _to_device(eng.state.windows, torch.device("cpu"))
    if m is not None:
        wins = dataclasses.replace(wins, data=wins.data[:m], cursor=wins.cursor[:m],
                                   filled=wins.filled[:m])
    return SimpleNamespace(config=eng.config, device=torch.device("cpu"),
                           devices=eng.devices, state=SimpleNamespace(windows=wins))


def _timed(device, fn):
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _adam_step_bound(step: int, beta1: float, beta2: float) -> float:
    """The largest ``|m_hat| / sqrt(v_hat)`` that any gradient sequence
    gives at Adam step ``step`` (Cauchy-Schwarz over the two moving
    averages): 1.0 at step 1, 1.004 at step 3. Times ``lr`` it is the most
    one AdamW update moves a parameter, weight decay aside."""
    r = beta1 * beta1 / beta2
    return ((1 - beta1) / (1 - beta1 ** step) * sum(r ** i for i in range(step)) ** 0.5
            / ((1 - beta2) / (1 - beta2 ** step)) ** 0.5)


def _adam_slack(host, grad_tol: dict) -> dict:
    """What a gradient difference of ``grad_tol[name]`` can move each
    parameter in the AdamW step ``host`` just took: the update is
    ``lr * m / (sqrt(v) + eps)`` (bias-corrected), so to first order a
    gradient error ``dg`` moves it by at most ``2 * lr * dg / (sqrt(v) +
    eps)`` (once through ``m``, once through ``v``). Below Adam's eps that
    is ``lr * dg / eps``: summation order alone (~1e-10 at full width)
    moves such a parameter by ~1e-5 a step. The slack is capped at the
    most one update can move a parameter (:func:`_adam_step_bound`); the
    weight decay term is the same on both sides to ``rtol``. Returns
    ``{name: (slack, capped)}``, ``capped`` the elements held to the cap."""
    group = host.opt.param_groups[0]
    lr, eps, (beta1, beta2) = group["lr"], group["eps"], group["betas"]
    out = {}
    for k, b in host.model.named_parameters():
        st = host.opt.state[b]
        step = int(st["step"])
        v_hat = st["exp_avg_sq"] / (1 - beta2 ** step)
        raw = 2 * lr * grad_tol[k] / (v_hat.sqrt() + eps)
        cap = lr * _adam_step_bound(step, beta1, beta2)
        out[k] = (raw.clamp(max=cap), raw > cap)
    return out


def _params_vs_cpu(card, host, slack: dict, capped: dict) -> dict:
    """The card service's parameters against the CPU service's: each
    element within ``TRAIN_TOL`` plus its accumulated Adam slack. Returns
    how many elements needed the slack, how many of those had it capped,
    how many elements were capped at all, how many exceed their slack, and
    the largest difference."""
    out = {"slack_elements": 0, "slack_elements_capped": 0, "capped_elements": 0,
           "beyond": 0, "max_abs_diff": 0.0}
    for (k, a), b in zip(card.model.named_parameters(), host.model.parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        base = TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * b.detach().abs()
        out["slack_elements"] += int((diff > base).sum())
        out["slack_elements_capped"] += int(((diff > base) & capped[k]).sum())
        out["capped_elements"] += int(capped[k].sum())
        out["beyond"] += int((diff > base + slack[k]).sum())
        out["max_abs_diff"] = max(out["max_abs_diff"], float(diff.max()))
    return out


def phase_train(device, log, fails, seed: int, eng, calls: int = TRAIN_CALLS,
                long_steps: int = TRAIN_LONG_STEPS, batch: int = TRAIN_BATCH,
                parity_batch: int = TRAIN_PARITY_BATCH,
                cpu_scored: int = TRAIN_CPU_SCORED, rules_config: dict = SLICE_CONFIG,
                rules_tokens: int = SLICE_TOKENS, profile: bool = False) -> dict:
    """Analytics training on the slice engine's windows: (a) ``calls``
    ``train_on_live`` calls of one step and one of ``long_steps`` at the
    service's default width, one window_features launch a call; (b) a
    float32 model trained on the card and on the CPU from the same seeded
    weights and windows, picks, losses and parameters held together; (c)
    the checkpoint round trip on the card and onto the CPU; (d) one
    iteration of the background loop, its alerts found by ``query_events``;
    (e) the rules host runtime on the card at the read phase's width
    against CPU engines fed the same batches. Returns the kernel's
    launches on the training path."""
    t_phase = time.perf_counter()
    threads = sorted(t.name for t in threading.enumerate())   # left by earlier phases
    cpu = torch.device("cpu")
    svc = AnalyticsService(eng, seed=seed)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    # (a) training on the card
    wf.window_features.launches = 0                # the training path starts here
    losses, call_ms = [], []
    for _ in range(calls):
        loss, ms = _timed(device, lambda: svc.train_on_live(batch_size=batch, steps=1))
        losses.append(loss)
        call_ms.append(ms)
    long_loss, long_ms = _timed(device, lambda: svc.train_on_live(batch_size=batch,
                                                                  steps=long_steps))
    launches = {"window_features": wf.window_features.launches}    # ... ends here
    losses.append(long_loss)
    peak_gb = (torch.cuda.max_memory_allocated() / 2**30
               if device.type == "cuda" else None)
    fails.check(launches["window_features"] == calls + 1,
                f"train: {launches['window_features']} window_features launches in "
                f"{calls + 1} train_on_live calls")
    fails.check(all(np.isfinite(losses)) and losses[-1] < losses[0],
                f"train: losses not finite or not falling: {losses}")
    call_med = statistics.median(call_ms)
    rec = {"phase": "train", "model": dataclasses.asdict(svc.cfg) | {"dtype": str(svc.cfg.dtype)},
           "windows": int(eng.config.analytics_devices), "batch": batch,
           "calls": calls + 1, "launches": launches,
           "ms_per_call_median": call_med, "ms_first_call": call_ms[0],
           "ms_call_of_long": long_ms, "long_steps": long_steps,
           "ms_per_step": (long_ms - call_med) / (long_steps - 1),
           "losses": losses, "peak_mem_gb": peak_gb, "threads_at_start": threads}

    # (b) card against CPU, float32, the same seeded weights and windows:
    # the gradients of one loss, then training
    cfg32 = dataclasses.replace(svc.cfg, dtype=torch.float32)
    card32 = AnalyticsService(eng, cfg32, seed=seed + 1)
    cpu32 = AnalyticsService(_cpu_view(eng), cfg32, seed=seed + 1)
    data = snapshot_windows(cpu32.engine.state.windows)[:parity_batch]
    x = wf.normalize_windows(data, wf.window_features_reference(data))
    loss_fn(card32.model, x.to(device)).backward()
    loss_fn(cpu32.model, x).backward()
    grad_tol, grad_err = {}, {}
    for (k, a), b in zip(card32.model.named_parameters(), cpu32.model.parameters()):
        grad_tol[k] = GRAD_F32_TOL * float(b.grad.abs().max())
        grad_err[k] = float((a.grad.cpu() - b.grad).abs().max())
    fails.check(all(grad_err[k] <= grad_tol[k] for k in grad_tol),
                "train: card vs CPU float32 gradients beyond 1e-5 of each tensor's "
                f"largest: { {k: grad_err[k] / grad_tol[k] for k in grad_tol} }")
    for m in (card32.model, cpu32.model):
        m.zero_grad(set_to_none=True)
    seen_card, seen_cpu = spy_batches(card32), spy_batches(cpu32)
    pair_losses, cpu_ms = [], []
    slack, capped = {k: 0.0 for k in grad_tol}, {k: False for k in grad_tol}
    for _ in range(TRAIN_PARITY_CALLS):
        lc = card32.train_on_live(batch_size=parity_batch, steps=1)
        lh, ms = _timed(cpu, lambda: cpu32.train_on_live(batch_size=parity_batch, steps=1))
        pair_losses.append((lc, lh))
        cpu_ms.append(ms)
        for k, (s, c) in _adam_slack(cpu32, grad_tol).items():
            slack[k], capped[k] = slack[k] + s, capped[k] | c
    picks_equal = all(np.allclose(a, b, **TRAIN_TOL) for a, b in zip(seen_card, seen_cpu))
    fails.check(len(seen_card) == len(seen_cpu) == TRAIN_PARITY_CALLS and picks_equal,
                "train: card and CPU services trained on different batches")
    fails.check(all(np.isclose(lc, lh, **TRAIN_TOL) for lc, lh in pair_losses),
                f"train: card vs CPU float32 losses {pair_losses}")
    params = _params_vs_cpu(card32, cpu32, slack, capped)
    fails.check(params["beyond"] == 0,
                f"train: card vs CPU float32 parameters beyond rtol=1e-4, atol=1e-6 "
                f"plus Adam's gain on the gradient tolerance, capped at one update: {params}")
    rec["float32_vs_cpu"] = {"losses": pair_losses, "cpu_ms_per_call": cpu_ms,
                             "batch": parity_batch,
                             "grad_err_over_tol": max(grad_err[k] / grad_tol[k]
                                                      for k in grad_tol)} | params
    del card32, cpu32, seen_card, seen_cpu

    # (c) the checkpoint: card -> card byte for byte, card -> CPU within bf16
    with tempfile.TemporaryDirectory(prefix="train-") as tmp:
        ckpt = pathlib.Path(tmp) / "ckpt"
        svc.save_model(ckpt)
        back = AnalyticsService(eng, seed=seed + 2)
        back.restore_model(ckpt)
        s_orig = svc.score_all(update_stats=False)["scores"]
        s_back = back.score_all(update_stats=False)["scores"]
        fails.check(np.array_equal(s_orig, s_back),
                    "train: restored card service scores differ from the original")
        l_orig = svc.train_on_live(batch_size=batch, steps=1)
        l_back = back.train_on_live(batch_size=batch, steps=1)
        same = l_orig == l_back and all(
            torch.equal(a, b) for a, b in zip(svc.model.state_dict().values(),
                                              back.model.state_dict().values()))
        fails.check(same, f"train: the restored service's next step differs "
                          f"({l_orig} vs {l_back})")
        on_cpu = AnalyticsService(_cpu_view(eng, cpu_scored), seed=seed + 3)
        on_cpu.restore_model(ckpt)
        s_cpu = on_cpu.score_all(update_stats=False)["scores"]
        ref = s_back[:cpu_scored]
        fails.check(np.allclose(s_cpu, ref, **SCORE_BF16_TOL),
                    "train: the card checkpoint restored on the CPU scores beyond "
                    f"rtol=1e-2, atol=1e-3 (max rel {np.max(np.abs(s_cpu - ref) / np.abs(ref))})")
        rec["checkpoint"] = {"bytes": (ckpt / "model" / "state.pt").stat().st_size,
                             "cpu_max_rel_err": float(np.max(np.abs(s_cpu - ref) / np.abs(ref)))}
        del back, on_cpu

    # (d) one iteration of the background loop, after two scoring passes
    # have seeded the running statistics; the threshold is the z-score that
    # ~2 % of the windows crossed in the second
    svc.score_all()
    z = svc.score_all()["zscores"]
    svc.threshold = float(np.quantile(z, 1 - TRAIN_ALERT_SHARE))
    scored, inner_score = [], svc.score_all
    svc.score_all = lambda **kw: scored.append(inner_score(**kw)) or scored[-1]
    sent, inner_process = [], eng.process
    eng.process = lambda req: sent.append(req.device_token) or inner_process(req)
    try:
        asyncio.run(svc.run(interval_s=0.0, stop_event=StopAfter()))
    finally:
        del svc.score_all, eng.process
    tokens = scored[0]["anomalous_tokens"] if scored else None
    found = sum(any(r.get("alertType") == "analytics.anomaly" for r in
                    eng.query_events(device_token=tok, etype=EventType.ALERT,
                                     limit=64)["events"])
                for tok in sent)
    fails.check(tokens is not None and len(tokens) > 0 and sent == tokens
                and found == len(tokens),
                f"train: the loop injected {len(sent)} alerts for "
                f"{None if tokens is None else len(tokens)} anomalous tokens, "
                f"{found} found by query_events")
    rec["loop"] = {"alerts": len(sent), "found": found}

    # (e) the rules host runtime on the card against a CPU engine
    rec["rules_runtime"] = _train_rules_runtime(device, fails, seed, rules_config,
                                                rules_tokens)
    rec["seconds"] = time.perf_counter() - t_phase
    emit(rec, log)
    print(f"train: {call_med:.3f} ms a train_on_live call (median of {calls}, batch "
          f"{batch}), {rec['ms_per_step']:.3f} ms a step, {launches['window_features']} "
          f"window_features launches in {calls + 1} calls, loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, peak {peak_gb} GiB; float32 card/CPU: gradients at "
          f"{rec['float32_vs_cpu']['grad_err_over_tol']:.3g} of their tolerance, "
          f"{rec['float32_vs_cpu']['slack_elements']} parameters past rtol=1e-4, "
          f"atol=1e-6 within Adam's slack ({rec['float32_vs_cpu']['slack_elements_capped']} "
          f"of them at its one-update cap, {rec['float32_vs_cpu']['capped_elements']} capped "
          f"in all), max diff "
          f"{rec['float32_vs_cpu']['max_abs_diff']:.3g}; "
          f"{rec['seconds']:.1f} s", flush=True)
    if profile:       # after the counts were read: these launches don't count
        phase_profile_train(svc, batch, log)
    return launches


def _rt_touch(path: pathlib.Path, text: str) -> None:
    """Rewrite a watched file with its mtime 2 s on, so a reload sees the
    change whatever the file system's mtime resolution."""
    mtime = path.stat().st_mtime
    path.write_text(text)
    os.utime(path, (mtime + 2, mtime + 2))


def _rt_feed(eng, columns) -> None:
    for c in columns:
        eng.ingest_event_batch(EventBatch.from_numpy(eng.device, **c))
    eng.flush()


def _host_leaves(state) -> dict:
    return {k: v.cpu() for k, v in _state_leaves(state)}


def _rt_reload_spill(device, seed: int, columns: list, tmp: pathlib.Path,
                     config: dict, n_tokens: int) -> tuple[dict, dict, tuple]:
    """Hot reload and the rollup spill on one archive-backed engine:
    ``watch_file`` of the bench's rule set, 3 batches, a reload that moves
    "hot" from 90 to 55 (only its parameter column may change), 2 batches,
    a rejected document, 2 batches, a spill (windows 0..2 of 0..3 closed),
    2 batches, a spill of the window closed since, a respill, and a fresh
    manager that spills nothing and reads the same history. Returns what
    the engine answered, its state, and its manager and file for the
    watcher."""
    tmp.mkdir()
    eng = _zoned_engine(device, seed, n_tokens, config, archive_dir=str(tmp / "archive"))
    mgr = RulesManager(eng)
    path = tmp / "rules.json"
    path.write_text(json.dumps(RL_RULESET))
    out = {"preserved_at_install": mgr.watch_file(path)["preservedState"]}
    _rt_feed(eng, columns[:3])
    polls = [mgr.poll()]
    before = _host_leaves(eng.state.rules)
    _rt_touch(path, json.dumps(RT_TWEAKED))
    out["reloads"] = [mgr.check_reload(), mgr.check_reload()]
    out["changed_by_tweak"] = sorted(k for k, v in _host_leaves(eng.state.rules).items()
                                     if not torch.equal(v, before[k]))
    _rt_feed(eng, columns[3:5])
    polls.append(mgr.poll())
    _rt_touch(path, RT_BAD_DOC)
    try:
        mgr.check_reload()
        out["rejected"] = False
    except ValueError:
        out["rejected"] = True
    out["reload_errors"] = mgr.reload_errors
    out["serving"] = mgr.ruleset.doc["rules"][0]["value"]
    _rt_feed(eng, columns[5:RT_SPILL_AFTER])
    polls.append(mgr.poll())
    rollup = RL_RULESET["rollups"][0]["name"]
    out["spills"] = [mgr.spill_rollups(lag=1)]
    _rt_feed(eng, columns[RT_SPILL_AFTER:])
    polls.append(mgr.poll())
    out["live"] = mgr.read_rollup(rollup, limit=RT_LIMIT)["buckets"]
    out["spills"] += [mgr.spill_rollups(lag=1), mgr.spill_rollups(lag=1)]
    out["history"] = mgr.read_rollup_history(rollup, limit=RT_LIMIT)["buckets"]
    out["polls"] = polls
    state = _host_leaves(eng.state)
    fresh = RulesManager(eng)
    fresh.load(RT_TWEAKED)
    out["spills"].append(fresh.spill_rollups(lag=1))
    out["fresh_history"] = fresh.read_rollup_history(rollup, limit=RT_LIMIT)["buckets"]
    return out, state, (mgr, path)


def _rt_watch(mgr, path: pathlib.Path) -> dict:
    """``RuleSetWatcher`` over a serving manager: ``start()`` installs the
    file, the thread picks up a tweak, ``stop()`` joins it."""
    _rt_touch(path, json.dumps(RL_RULESET))
    swaps = mgr.swaps
    watcher = RuleSetWatcher(mgr, path, interval_s=0.05)
    watcher.start()
    thread = watcher._thread
    _rt_touch(path, json.dumps(RT_TWEAKED))
    deadline = time.monotonic() + 5.0
    while mgr.swaps < swaps + 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    swapped = mgr.swaps - swaps
    watcher.stop()
    return {"thread": thread.name, "swaps": swapped, "stopped": not thread.is_alive(),
            "serving": mgr.ruleset.doc["rules"][0]["value"]}


def _rt_standby(device, seed: int, columns: list, config: dict,
                n_tokens: int) -> tuple[list, list, list, dict]:
    """An owner and a passive standby fed the same batches, the owner's
    emitted alerts forwarded to the standby: the owner polls halfway and
    dies, the standby polls passively at the end, promotes and polls."""
    owner, standby = (_zoned_engine(device, seed, n_tokens, config) for _ in range(2))
    omgr, smgr = RulesManager(owner), RulesManager(standby, active=False)
    omgr.load(RL_RULESET)
    smgr.load(RL_RULESET)
    inner = owner.ingest_json_batch

    def forwarding(payloads, tenant="default", **kw):
        res = inner(payloads, tenant, **kw)
        standby.ingest_json_batch(list(payloads), tenant)
        return res

    owner.ingest_json_batch = forwarding
    half = len(columns) // 2
    for eng in (owner, standby):
        _rt_feed(eng, columns[:half])
    pre = omgr.poll()
    for eng in (owner, standby):
        _rt_feed(eng, columns[half:])
    passive = smgr.poll()
    smgr.promote()
    post = smgr.poll()
    standby.flush()
    return pre, post, passive, _host_leaves(standby.state)


def _rt_single(device, seed: int, columns: list, config: dict,
               n_tokens: int) -> tuple[list, list, dict]:
    """One engine on the standby pair's stream, polling where the owner
    did and where the promoted standby did."""
    eng = _zoned_engine(device, seed, n_tokens, config)
    mgr = RulesManager(eng)
    mgr.load(RL_RULESET)
    half = len(columns) // 2
    _rt_feed(eng, columns[:half])
    first = mgr.poll()
    _rt_feed(eng, columns[half:])
    last = mgr.poll()
    eng.flush()
    return first, last, _host_leaves(eng.state)


def _leaves_differ(a: dict, b: dict) -> list[str]:
    return [k for k in a if not torch.equal(a[k], b[k])]


def _bucket_rows(buckets) -> list[tuple]:
    return sorted((b["group"], b["windowStartMs"], b["count"], b["sum"], b["min"],
                   b["max"]) for b in buckets)


def _train_rules_runtime(device, fails, seed: int, config: dict = SLICE_CONFIG,
                         n_tokens: int = SLICE_TOKENS, n_batches: int = RT_BATCHES) -> dict:
    """(e) of the train phase: the rules host runtime at the read phase's
    width (the slice config, the bench's rules sizes, zones and rule set,
    the read phase's stream), each leg on the card against a CPU engine fed
    the same batches, byte for byte: hot reload and the rollup spill on an
    archive-backed engine, the watcher, and standby promotion."""
    cpu = torch.device("cpu")
    columns, _ = read_columns(seed, n_batches, config, n_tokens)
    out = {"batches": n_batches, "rule_groups": READ_RULES_CONFIG["rule_groups"],
           "rollup_buckets": READ_RULES_CONFIG["rollup_buckets"]}
    with tempfile.TemporaryDirectory(prefix="rules-") as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        card, card_state, (mgr, path) = _rt_reload_spill(device, seed, columns, tmp / "card",
                                                         config, n_tokens)
        out["card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        host, host_state, _ = _rt_reload_spill(cpu, seed, columns, tmp / "cpu", config,
                                               n_tokens)
        out["cpu_s"] = time.perf_counter() - t0
        differ = _leaves_differ(card_state, host_state)
        del card_state, host_state
        fails.check(card == host and not differ,
                    f"train: rules reload and spill on the card differ from the CPU "
                    f"engine's: state leaves {differ}, answers equal {card == host}")
        polls = card["polls"]
        hot_below = [sum(a["rule"] == "hot" and a["value"] < 90.0 for a in p) for p in polls]
        fails.check(card["preserved_at_install"] is False and card["reloads"] == [True, False]
                    and card["changed_by_tweak"] == ["rules.val_a"]
                    and hot_below[0] == 0 and hot_below[1] > 0
                    and card["rejected"] and card["reload_errors"] == 1
                    and card["serving"] == 55.0 and all(hot_below[1:]),
                    f"train: hot reload on the card: reloads {card['reloads']}, changed "
                    f"{card['changed_by_tweak']}, hot fires below 90 by poll {hot_below}, "
                    f"rejected {card['rejected']}, serving {card['serving']}")
        newest = max(b["windowStartMs"] for b in card["live"])
        window = RL_RULESET["rollups"][0]["windowMs"]
        closed = _bucket_rows(b for b in card["live"] if b["windowStartMs"] <= newest - window)
        hist = _bucket_rows(card["history"])
        spilled = [s["spilled"] for s in card["spills"]]
        fails.check(hist and hist == closed and spilled[0] > 0 and spilled[1] > 0
                    and spilled[0] + spilled[1] == len(hist) and spilled[2:] == [0, 0]
                    and card["fresh_history"] == card["history"],
                    f"train: rollup spill on the card: spilled {spilled}, history "
                    f"{len(hist)} rows against {len(closed)} closed ring windows, a fresh "
                    f"manager reads {len(card['fresh_history'])}")
        out |= {"alerts_by_poll": [len(p) for p in polls], "hot_below_90_by_poll": hot_below,
                "spilled": spilled, "history_rows": len(hist),
                "live_windows": len(card["live"])}
        del card, host
        watch = _rt_watch(mgr, path)
        fails.check(watch["thread"] == "swtpu-rules-watch" and watch["swaps"] == 2
                    and watch["stopped"] and watch["serving"] == 55.0,
                    f"train: the rules watcher on the card: {watch}")
        out["watcher"] = watch
        del mgr
    t0 = time.perf_counter()
    pre, post, passive, standby_state = _rt_standby(device, seed, columns, config,
                                                    n_tokens)
    out["standby_card_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    first, last, single_state = _rt_single(cpu, seed, columns, config, n_tokens)
    out["single_cpu_s"] = time.perf_counter() - t0
    keys = [{a["alternateId"] for a in x} for x in (pre, post, first, last)]
    differ = _leaves_differ(standby_state, single_state)
    fails.check(keys[0] and keys[1] and not keys[0] & keys[1] and passive == []
                and keys[0] | keys[1] == keys[2] | keys[3] and pre == first and post == last
                and not differ,
                f"train: standby promotion on the card: {len(keys[0])} + {len(keys[1])} "
                f"keys, {len(keys[0] & keys[1])} shared, union equal to a CPU engine's "
                f"{len(keys[2] | keys[3])}: {keys[0] | keys[1] == keys[2] | keys[3]}; "
                f"state leaves differing from it {differ}")
    out["standby_keys"] = [len(keys[0]), len(keys[1])]
    return out


def phase_profile_train(svc, batch: int, log) -> None:
    """torch.profiler over one ``train_on_live(steps=1)`` call: device time
    by family (B1, the rest of the feature pass, forward, backward,
    optimizer, other) and the device's busy share of the wall time. The
    backward runs on autograd's device thread, outside the ``record_function``
    ranges of the call, so it is read from that thread's top-level events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.train_on_live(batch_size=batch, steps=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top, busy_ms = _device_time(prof)
    families = {"features": 0.0, "forward": 0.0, "backward": 0.0, "optimizer": 0.0,
                "other": 0.0}
    ranges = {"analytics.features": "features", "anomaly.forward": "forward",
              "anomaly.backward": "backward", "anomaly.optimizer": "optimizer"}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or e.cpu_parent is not None:
            continue
        fam = ranges.get(e.name, "backward" if e.name.startswith("autograd::engine")
                         else "other")
        families[fam] += e.device_time_total / 1e3
    b1 = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "window_features" in e.key) / 1e3
    emit({"phase": "profile", "what": "train_on_live", "calls": 1, "batch": batch,
          "wall_ms_per_call": wall_ms, "device_ms_per_call": busy_ms,
          "device_busy_share": busy_ms / wall_ms, "device_ms_b1": b1,
          "device_ms_by_family": families, "top": top}, log)


def phase_transformer(device, log, fails, seed: int, cfg: TransformerConfig = TF_CONFIG,
                      windows: int = TF_WINDOWS, steps: int = TF_STEPS,
                      calls: int = TF_CALLS, profile: bool = False) -> dict:
    model = TelemetryTransformer(cfg, device=device,
                                 generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((windows, steps, cfg.sensors), device=device, generator=gen)
    forecast_scores(model, x)                      # warm-up
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    fa.flash_attention.launches = 0                # this path starts here
    call_ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        scores = forecast_scores(model, x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        call_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {"flash_attention": fa.flash_attention.launches}   # ... ends here
    peak_gb = (torch.cuda.max_memory_allocated() / 2**30
               if device.type == "cuda" else None)

    fails.check(scores.shape == (windows,) and scores.dtype == torch.float32
                and bool(torch.isfinite(scores).all()),
                f"transformer: scores not finite / of shape ({windows},): {scores}")
    fails.check(launches["flash_attention"] == cfg.layers * calls,
                f"transformer: {launches['flash_attention']} flash_attention launches "
                f"in {calls} calls of a {cfg.layers}-layer model")
    # the same model with the plain attention on the first window
    plain = forecast_scores(model, x[:1], attention_fn=functools.partial(
        fa.mha_reference, causal=True))
    rel_err = abs(scores[0].item() - plain[0].item()) / abs(plain[0].item())
    fails.check(rel_err <= TF_SCORE_RTOL,
                f"transformer: kernel path score {scores[0].item()} vs plain path "
                f"{plain[0].item()} (rel err {rel_err})")
    med = statistics.median(call_ms)
    emit({"phase": "transformer", "config": dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
          "windows": windows, "steps": steps, "calls": calls,
          "ms_per_call_median": med, "ms_per_call": call_ms,
          "windows_per_s": windows / med * 1e3, "timesteps_per_s": windows * steps / med * 1e3,
          "peak_mem_gb": peak_gb, "launches": launches,
          "score_first_window": scores[0].item(), "plain_score_first_window": plain[0].item(),
          "score_rel_err_vs_plain": rel_err, "score_rtol": TF_SCORE_RTOL,
          "score_mean": scores.mean().item()}, log)
    if profile:       # after the counts were read: these launches don't count
        phase_profile_transformer(model, x, log)
    return launches


def _kernel_family(name: str) -> str:
    n = name.lower()
    if "flash_bwd" in n:
        return "attention_backward"
    if "flash_attention" in n:
        return "attention"
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "gemm"
    if "layer_norm" in n or "gelu" in n:
        return "layernorm_gelu"
    if "multi_tensor_apply" in n or "adam" in n:
        return "optimizer"
    return "other"


def phase_profile_transformer(model, x, log) -> None:
    """torch.profiler over one forecast_scores call: device time by kernel
    family (the attention kernel, GEMMs, LayerNorm / gelu, the rest) and
    the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forecast_scores(model, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top, busy_ms = _device_time(prof)
    families: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            fam = _kernel_family(e.key)
            families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
    emit({"phase": "profile", "what": "forecast_scores", "calls": 1,
          "wall_ms_per_call": wall_ms, "device_ms_per_call": busy_ms,
          "device_busy_share": busy_ms / wall_ms, "device_ms_by_family": families,
          "top": top}, log)


# the transformer_train phase: TransformerConfig() at full width on the
# scoring phase's 8 windows of 16384 steps, AdamW (optax's, models/anomaly
# .adamw) at lr 1e-3; (b) on 2 windows of 4096 steps, where the plain
# attention's autograd keeps 4 layers x [2, 8, 4096, 4096] float32
# probabilities (4.3 GB) and peaks near 3x one layer's more in its backward;
# (c) a float32 model on 2 windows of 1024 steps on the card and the CPU;
# (d) one NCCL rank on 2 windows of 2048 steps
TT_STEPS = 5
TT_LR = 1e-3
TT_PLAIN = (2, 4096)
TT_CPU = (2, 1024)
TT_SP = (2, 2048)
TT_GRAD_TOL = 2e-2          # bf16 kernel path vs plain path, share of each gradient's max
TT_F32_GRAD_TOL = 1e-4      # card vs CPU float32 gradients, share of each one's max
TT_F32_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TT_SP_TOL = dict(rtol=1e-5, atol=1e-5)     # one NCCL rank vs the single-device path, float32


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _grads(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _grad_shares(got: dict, ref: dict) -> dict:
    """Each gradient's max |got - ref| as a share of its max |ref|."""
    out = {}
    for n, r in ref.items():
        g = got[n].to(r.device).float()
        scale = r.float().abs().max().item()
        err = (g - r.float()).abs().max().item()
        out[n] = err / scale if scale else err
    return out


def _profile_train_step(step, x, log, profile: bool) -> dict:
    """torch.profiler over one ``train_step``: the device's busy share of
    the wall time; with ``profile`` also device time by kernel family
    (attention forward, attention backward, GEMMs, LayerNorm / gelu,
    optimizer, other), emitted as a profile record."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    top, busy_ms = _device_time(prof)
    out = {"profiled_wall_ms": wall_ms, "device_ms": busy_ms,
           "device_busy_share": busy_ms / wall_ms}
    if profile:
        families: dict[str, float] = {}
        for e in prof.key_averages():
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and e.self_device_time_total > 0
                    and not getattr(e, "is_user_annotation", False)):
                fam = _kernel_family(e.key)
                families[fam] = families.get(fam, 0.0) + e.self_device_time_total / 1e3
        emit({"phase": "profile", "what": "transformer_train_step", "calls": 1,
              "wall_ms_per_call": wall_ms, "device_ms_per_call": busy_ms,
              "device_busy_share": busy_ms / wall_ms, "device_ms_by_family": families,
              "top": top}, log)
    return out


def _train_sp_one_rank(device, model, x, fails) -> dict:
    """(d): ``forecast_scores_sp`` and ``ring_attention_sharded`` in a
    one-rank NCCL group (a ``file://`` store, no port) against
    ``forecast_scores`` with the plain attention and ``mha_reference``,
    float32; the scores' gradients against the single-device path's. One
    card shows the code path (positions, the masked last position, the
    group sum, the identity hops), not the ring across ranks: that is
    held to JAX on 4 gloo ranks in tests/test_torch_ring_attention.py."""
    import torch.distributed as dist

    from sitewhere_tpu_torch.models.transformer import forecast_scores_sp, loss_fn
    from sitewhere_tpu_torch.parallel.ring_attention import ring_attention_sharded

    store = tempfile.mkdtemp(prefix="swtpu-sp-")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        plain = functools.partial(fa.mha_reference, causal=True)
        with torch.no_grad():
            sp = forecast_scores_sp(model, x)
        ref = forecast_scores(model, x, attention_fn=plain)
        gen = torch.Generator(device=device).manual_seed(5)
        q, k, v = (torch.randn((x.shape[0], x.shape[1], 8, 32), device=device,
                               generator=gen) for _ in range(3))
        ring = ring_attention_sharded(q, k, v, causal=True)
        ring_ref = fa.mha_reference(q, k, v, causal=True)
        model.zero_grad(set_to_none=True)
        forecast_scores_sp(model, x).mean().backward()
        g_sp = _grads(model)
        model.zero_grad(set_to_none=True)
        loss_fn(model, x, attention_fn=plain).backward()
        shares = _grad_shares(g_sp, _grads(model))
        model.zero_grad(set_to_none=True)
        _sync(device)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out = {"shape": list(x.shape), "world_size": 1, "backend": backend,
           "scores_max_abs_err": (sp - ref).abs().max().item(),
           "ring_max_abs_err": (ring - ring_ref).abs().max().item(),
           "grad_err_of_max": max(shares.values()),
           "note": "one rank: the hops and the gather are the identity; the "
                   "ring across ranks is held to JAX on 4 gloo ranks (CPU tests)"}
    fails.check(torch.allclose(sp, ref, **TT_SP_TOL),
                f"transformer_train (d): forecast_scores_sp {sp.tolist()} vs "
                f"forecast_scores {ref.tolist()}")
    fails.check(torch.allclose(ring, ring_ref, **TT_SP_TOL),
                f"transformer_train (d): ring_attention_sharded vs mha_reference max abs "
                f"err {out['ring_max_abs_err']}")
    fails.check(max(shares.values()) <= TT_F32_GRAD_TOL,
                f"transformer_train (d): SP gradients vs single device {shares}")
    return out


def phase_transformer_train(device, log, fails, seed: int, cfg: TransformerConfig = TF_CONFIG,
                            windows: int = TF_WINDOWS, steps: int = TF_STEPS,
                            train_steps: int = TT_STEPS, plain_shape=TT_PLAIN,
                            cpu_shape=TT_CPU, sp_shape=TT_SP, profile: bool = False) -> dict:
    """Transformer training at full width: (a) one warm-up and
    ``train_steps`` timed ``make_train_step`` steps (AdamW) on one seeded
    batch, both attention counts reset just before and read just after
    (each layers x steps), losses finite and falling, every parameter's
    gradient finite and non-zero; (b) one step's gradients through the
    kernels against the plain attention's autograd; (c) a float32 model on
    the card and the CPU, one Adam step: losses, gradients, parameters; (d)
    the sequence-parallel path on one NCCL rank."""
    from types import SimpleNamespace

    from sitewhere_tpu_torch.models.anomaly import adamw
    from sitewhere_tpu_torch.models.transformer import adam, loss_fn, make_train_step

    gen = torch.Generator(device=device).manual_seed(seed + 1)
    model = TelemetryTransformer(cfg, device=device,
                                 generator=torch.Generator().manual_seed(seed))
    x = torch.randn((windows, steps, cfg.sensors), device=device, generator=gen)
    opt = adamw(model.parameters(), TT_LR)
    step = make_train_step(model, opt)
    losses = [step(x).item()]                     # warm-up
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    fa.flash_attention.launches = 0               # this path starts here
    fa.flash_attention_backward.launches = 0
    step_ms = []
    for _ in range(train_steps):
        t0 = time.perf_counter()
        loss = step(x)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss.item())
    launches = {"flash_attention": fa.flash_attention.launches,
                "flash_attention_backward": fa.flash_attention_backward.launches}
    peak_gib = (torch.cuda.max_memory_allocated() / 2**30          # ... ends here
                if device.type == "cuda" else None)
    want = cfg.layers * train_steps
    fails.check(launches == {"flash_attention": want, "flash_attention_backward": want},
                f"transformer_train: launches {launches} in {train_steps} steps of a "
                f"{cfg.layers}-layer model (want {want} each)")
    fails.check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                f"transformer_train: losses not finite or not falling: {losses}")
    busy = _profile_train_step(step, x, log, profile) if device.type == "cuda" else {}

    loss_fn(model, x).backward()                  # every parameter reached
    no_grad = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())
               or not bool(p.grad.any())]
    fails.check(not no_grad and any(".qkv." in n for n, _ in model.named_parameters()),
                f"transformer_train: parameters without a finite non-zero gradient: {no_grad}")
    opt.zero_grad(set_to_none=True)

    # (b) kernels vs the plain attention's autograd, one step's gradients
    xb = x[:plain_shape[0], :plain_shape[1]]
    loss_fn(model, xb).backward()
    g_kernel = _grads(model)
    model.zero_grad(set_to_none=True)
    loss_fn(model, xb, attention_fn=functools.partial(fa.mha_reference, causal=True)).backward()
    g_plain = _grads(model)
    model.zero_grad(set_to_none=True)
    shares_b = _grad_shares(g_kernel, g_plain)
    fails.check(max(shares_b.values()) <= TT_GRAD_TOL,
                f"transformer_train (b): kernel vs plain gradients beyond {TT_GRAD_TOL} of "
                f"max: { {n: v for n, v in shares_b.items() if v > TT_GRAD_TOL} }")
    del g_kernel, g_plain

    # (c) float32 on the card and on the CPU, one Adam step from the same weights
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    card = TelemetryTransformer(cfg32, device=device, generator=torch.Generator().manual_seed(seed))
    host = TelemetryTransformer(cfg32, device="cpu", generator=torch.Generator().manual_seed(seed))
    xc = x[:cpu_shape[0], :cpu_shape[1]]
    card_opt, host_opt = adam(card.parameters(), TT_LR), adam(host.parameters(), TT_LR)
    f32_launches = (fa.flash_attention.launches, fa.flash_attention_backward.launches)
    card_loss = loss_fn(card, xc)
    card_loss.backward()
    t0 = time.perf_counter()
    host_loss = loss_fn(host, xc.cpu())
    host_loss.backward()
    cpu_s = time.perf_counter() - t0
    f32_launches = (fa.flash_attention.launches - f32_launches[0],
                    fa.flash_attention_backward.launches - f32_launches[1])
    shares_c = _grad_shares(_grads(card), _grads(host))
    grad_tol = {n: TT_F32_GRAD_TOL * p.grad.abs().max().item()
                for n, p in host.named_parameters()}
    card_opt.step()
    host_opt.step()
    slack = _adam_slack(SimpleNamespace(model=host, opt=host_opt), grad_tol)
    params_c = _params_vs_cpu(SimpleNamespace(model=card), SimpleNamespace(model=host),
                              {k: v[0] for k, v in slack.items()},
                              {k: v[1] for k, v in slack.items()})
    fails.check(f32_launches == (cfg.layers, cfg.layers),
                f"transformer_train (c): float32 kernel launches {f32_launches}")
    fails.check(torch.allclose(card_loss.detach().cpu(), host_loss.detach(), **TT_F32_LOSS_TOL),
                f"transformer_train (c): float32 loss card {card_loss.item()} CPU "
                f"{host_loss.item()}")
    fails.check(max(shares_c.values()) <= TT_F32_GRAD_TOL,
                f"transformer_train (c): float32 gradients card vs CPU beyond "
                f"{TT_F32_GRAD_TOL} of max: {shares_c}")
    fails.check(params_c["beyond"] == 0,
                f"transformer_train (c): parameters after one Adam step beyond tolerance "
                f"plus slack: {params_c}")

    # (d) the sequence-parallel path on one NCCL rank
    sp = _train_sp_one_rank(device, card, x[:sp_shape[0], :sp_shape[1]], fails)

    med = statistics.median(step_ms)
    emit({"phase": "transformer_train",
          "config": dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
          "windows": windows, "steps": steps, "optimizer": f"adamw lr {TT_LR}",
          "train_steps": train_steps, "ms_per_step_median": med, "ms_per_step": step_ms,
          "timesteps_per_s": windows * steps / med * 1e3, "losses": losses,
          "peak_mem_gib": peak_gib, "launches": launches, **busy,
          "b_plain": {"shape": [*plain_shape, cfg.sensors],
                      "plain_probability_bytes": cfg.layers * plain_shape[0] * cfg.heads
                      * plain_shape[1] ** 2 * 4,
                      "tol_of_max": TT_GRAD_TOL, "worst": max(shares_b.values()),
                      "worst_param": max(shares_b, key=shares_b.get)},
          "c_float32": {"shape": [*cpu_shape, cfg.sensors], "optimizer": f"adam lr {TT_LR}",
                        "loss_card": card_loss.item(), "loss_cpu": host_loss.item(),
                        "grad_tol_of_max": TT_F32_GRAD_TOL,
                        "grad_worst": max(shares_c.values()), "params": params_c,
                        "cpu_s": cpu_s, "launches": list(f32_launches)},
          "d_sp_one_rank": sp}, log)
    return launches


# the sharded phase: SpmdEngine at bench.py's per-chip headline sizes
# (HEADLINE_CFG, bench.py:99-103: 2^15 devices, 2^16 tokens, a 2^18-row
# ring, 16384-event batches, 8 channels) a shard, dispatch_depth 2 and
# scan_chunk 2 as scripts/bench_spmd.py:105 runs its engine, the bench's
# rule set at the read phase's rules sizes and a group-commit WAL; every
# shard on cuda:0 (one card: the shards share it, so events/s across shard
# counts is no scaling figure)
SHARDED_CONFIG = dict(device_capacity=1 << 15, token_capacity=1 << 16,
                      assignment_capacity=1 << 16, store_capacity=1 << 18,
                      batch_capacity=16384, channels=8, scan_chunk=2, dispatch_depth=2,
                      rule_groups=256, rollup_buckets=16)
SHARDED_SHARDS = (1, 2, 4)
SHARDED_BATCHES = 40
SHARDED_WARMUP = 2
SHARDED_DEVICES = 10_000
SHARDED_T0_MS = 10**12 + 1_000     # event dates past the pinned epoch base (1e9 s)
SHARDED_SMALL = dict(device_capacity=2048, token_capacity=4096, assignment_capacity=4096,
                     store_capacity=1 << 13, batch_capacity=1024, channels=8,
                     scan_chunk=2, dispatch_depth=2, rule_groups=256, rollup_buckets=16)
SHARDED_SMALL_BATCHES = 6
SHARDED_COUNTERS = ("processed", "found", "missed", "registered", "persisted",
                    "reg_overflow", "rule_fires", "staged", "arena_rows")
# the exchange leg: 8192 events over 4 shards' token slices, buckets of
# 4096 (room for every row) and of 1024 with every row arriving on shard 0
# (overflow); each shard's ring holds one exchanged batch
SHARDED_EXCHANGE = dict(device_capacity_per_shard=1 << 12, token_capacity_per_shard=1 << 12,
                        assignment_capacity_per_shard=1 << 12,
                        store_capacity_per_shard=1 << 17, channels=8)


def sharded_payloads(seed: int, n_batches: int, batch: int, n_devices: int):
    """The wire phase's stream (``loadgen.batch_maker``'s seeded devices,
    its canonical measurement request) with two changes: the measurement
    is the rule set's "temp" channel valued by :func:`rules_temp`, and each
    event carries its own ``eventDate`` (one ms apart), so a query page has
    no timestamp ties to order. Returns [(payloads, token indices)]."""
    rng = np.random.default_rng(seed)
    toks = [f"lg-{i}" for i in range(n_devices)]
    out = []
    for b in range(n_batches):
        picks = rng.integers(0, n_devices, batch)
        seq0 = b * batch
        vals = rules_temp(np.arange(seq0, seq0 + batch))
        out.append(([json.dumps({"deviceToken": toks[d], "type": "DeviceMeasurement",
                                 "request": {"name": "temp", "value": float(vals[i]),
                                             "eventDate": SHARDED_T0_MS + seq0 + i,
                                             "updateState": True,
                                             "metadata": {"seq": str(seq0 + i)}}}).encode()
                     for i, d in enumerate(picks)], picks))
    return out


def _spmd_engine(device, n: int, config: dict, wal_dir=None):
    from sitewhere_tpu_torch.parallel.sharded import SpmdEngine

    cfg = dict(config, wal_dir=str(wal_dir), wal_group_commit=True) if wal_dir else config
    eng = SpmdEngine(EngineConfig(**cfg), n_shards=n, device=device)
    eng.epoch = PinnedEpoch(1e9)
    mgr = RulesManager(eng)
    mgr.load(RL_RULESET)
    return eng, mgr


def _launches_a_dispatch(eng, payloads) -> float | None:
    """CUDA kernels a dispatch launches: one profiled call that fills and
    dispatches, kernels counted from the trace over the dispatches it made."""
    from torch.profiler import ProfilerActivity, profile

    before = eng._arena_dispatches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.ingest_json_batch(payloads)
        eng.flush_async()
        eng.barrier()
    n = eng._arena_dispatches - before
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.key.startswith("Memcpy") and not e.key.startswith("Memset"))
    return kernels / n if n else None


def _sharded_exchange(device, fails, seed: int, n: int = 4, n_events: int = 8192,
                      bucket: int = 4096, skew_bucket: int = 1024,
                      sizes: dict = SHARDED_EXCHANGE) -> dict:
    """ShardedEngine on the card: unrouted batches moved by the exchange
    equal the CPU's byte for byte and the host-routed run per token, and
    the overflow count of a skewed batch equals the CPU's."""
    from sitewhere_tpu_torch.parallel.router import ShardRouter, stack_host_batches
    from sitewhere_tpu_torch.parallel.sharded import ShardedEngine

    tps = sizes["token_capacity_per_shard"]
    rng = np.random.default_rng(seed + 11)
    toks = rng.integers(0, n * tps, n_events)
    ts = np.arange(toks.size)
    vals = rules_temp(ts)

    def unrouted(place):
        from sitewhere_tpu_torch.core.events import HostEventBuffer

        bufs = [HostEventBuffer(toks.size, 8) for _ in range(n)]
        for i, t in enumerate(toks):
            bufs[place(i, t)].append(int(EventType.MEASUREMENT), int(t), 0, int(ts[i]),
                                     int(ts[i]), values=[float(vals[i])])
        return stack_host_batches([b.emit_host() for b in bufs])

    router = ShardRouter(n, tps, toks.size, 8)
    for i, t in enumerate(toks):
        router.append(int(EventType.MEASUREMENT), int(t), 0, int(ts[i]), int(ts[i]),
                      values=[float(vals[i])])
    routed = ShardedEngine(n_shards=n, device=device, **sizes)
    routed.step(router.emit())
    out = {}
    for label, place, bkt in (("round_robin", lambda i, t: i % n, bucket),
                              ("skewed", lambda i, t: 0, skew_bucket)):
        batch = unrouted(place)
        card = ShardedEngine(n_shards=n, device=device, exchange=True, bucket_capacity=bkt,
                             **sizes)
        cpu = ShardedEngine(n_shards=n, device="cpu", exchange=True, bucket_capacity=bkt,
                            **sizes)
        card.step(batch)
        cpu.step(batch)
        differ = [name for (name, a), (_, b) in zip(_state_leaves(card.state),
                                                    _state_leaves(cpu.state))
                  if not torch.equal(a.cpu(), b)]
        fails.check(not differ, f"sharded exchange ({label}): the card differs from the "
                                f"CPU in {differ[:5]}")
        m, mc = card.global_metrics(), cpu.global_metrics()
        fails.check(m == mc, f"sharded exchange ({label}): counters {m} vs CPU {mc}")
        out[label] = {"missed": m["missed"], "found": m["found"], "bucket": bkt}
        if label == "round_robin":
            fails.check(m["missed"] == 0 and m["found"] == toks.size,
                        f"sharded exchange: {m} with room in every bucket")
            ra, rb = routed.state, card.state
            for f in ("meas_last", "meas_last_ms", "last_interaction_ms", "event_counts"):
                a, b = getattr(ra.device_state, f), getattr(rb.device_state, f)
                ta, tb = ra.registry.token_to_device, rb.registry.token_to_device
                ok = all(torch.equal(a[s][ta[s][ta[s] >= 0].long()],
                                     b[s][tb[s][ta[s] >= 0].long()]) for s in range(n))
                fails.check(ok, f"sharded exchange: per-token {f} differs from the routed run")
    return out


def phase_sharded(device, log, fails, seed: int, config: dict = SHARDED_CONFIG,
                  shard_counts=SHARDED_SHARDS, n_batches: int = SHARDED_BATCHES,
                  n_devices: int = SHARDED_DEVICES, small: dict = SHARDED_SMALL,
                  small_batches: int = SHARDED_SMALL_BATCHES, exchange_kw=None) -> dict:
    """The multi-shard engine on the card (``SpmdEngine``, every shard on
    this card) at the per-shard headline sizes, 1, 2 and 4 shards: the
    wire stream (:func:`sharded_payloads`) through the native decoder into
    the stacked staging arena, the WAL on, the bench's rule set; events/s
    over the timed batches, host stage medians and CUDA kernels a dispatch.
    Checks (a) each shard's store byte-identical to a single-card engine
    fed that shard's substream; (b) ``query_events`` pages over the recent
    stream equal a single-card engine's fed the whole stream; (c) the
    conservation ledger balances; (d) ``ShardedEngine(exchange=True)``
    equals the CPU's and the routed run, and its overflow count the CPU's;
    (e) a reduced leg: the card engine's stacked state, counters, pages and
    rule fires equal a CPU ``SpmdEngine``'s fed the same batches."""
    from sitewhere_tpu_torch.parallel.placement import shard_for_token

    t_phase = time.perf_counter()
    stream = sharded_payloads(seed, n_batches, config["batch_capacity"], n_devices)
    toks = [f"lg-{i}" for i in range(n_devices)]
    total = sum(len(p) for p, _ in stream)
    runs = {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        single = wire_engine(device, {k: v for k, v in config.items()})
        for p, _ in stream:
            single.ingest_json_batch(p)
        single.flush()
        for n in shard_counts:
            eng, _ = _spmd_engine(device, n, config, wal_dir=tmp / f"wal{n}")
            clock = HostClock(eng)
            for p, _ in stream[:SHARDED_WARMUP]:
                eng.ingest_json_batch(p)
            eng.barrier()
            timed = stream[SHARDED_WARMUP:]
            d0 = eng._arena_dispatches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p, _ in timed:
                eng.ingest_json_batch(p)
            eng.barrier()
            wall = time.perf_counter() - t0
            calls = clock.calls[-len(timed):]
            run = {"events_per_s": sum(len(p) for p, _ in timed) / wall, "wall_s": wall,
                   "dispatches": eng._arena_dispatches - d0,
                   "host_ms_per_call": clock.medians(len(timed)),
                   # a dispatch every few calls: the medians of its parts are 0
                   "host_ms_per_call_mean": {f"{k}_ms": statistics.fmean(c[k] for c in calls)
                                             for k in ("total", *HostClock.PARTS)},
                   "wal_fsyncs": eng.wal.fsyncs}
            eng.flush()
            m = eng.metrics()
            fails.check(m["processed"] == m["persisted"] == total
                        and eng.host_counters.get("arena_rows") == total
                        and not eng.host_counters.get("staged_copy_rows"),
                        f"sharded {n}: counters {m}, host {eng.host_counters}")
            # (a) each shard's store against a single-card engine on its substream
            if n > 1:
                shard_of = np.array([shard_for_token(t, n) for t in toks])
                differ = []
                for s in range(n):
                    ref = wire_engine(device, config)
                    for p, picks in stream:
                        mine = np.nonzero(shard_of[picks] == s)[0]
                        ref.ingest_json_batch([p[i] for i in mine])
                    ref.flush()
                    differ += [f"shard {s} {name}" for (name, a), (_, b) in zip(
                        _state_leaves(ref.state.store), _state_leaves(eng.shards[s].store))
                               if not torch.equal(a, b)]
                    del ref
                fails.check(not differ, f"sharded {n}: stores differ from the per-shard "
                                        f"single-card engines: {differ[:5]}")
                run["stores_identical_to_substreams"] = not differ
            # (b) pages over the recent stream (both rings still hold it)
            t_end = SHARDED_T0_MS - 10**12 + total
            preds = [dict(limit=64, since_ms=t_end - 100_000),
                     dict(device_token="lg-7", limit=32, since_ms=t_end - 100_000),
                     dict(device_token="lg-4242", limit=8, since_ms=t_end - 150_000,
                          until_ms=t_end - 50_000),
                     dict(limit=16, etype=EventType.MEASUREMENT, since_ms=t_end - 20_000)]
            pages_ok = True
            for kw in preds:
                a, b = single.query_events(**kw), eng.query_events(**kw)
                strip = [[{k: v for k, v in e.items() if k != "assignmentId"}
                          for e in x["events"]] for x in (a, b)]
                pages_ok &= a["total"] == b["total"] and strip[0] == strip[1]
            fails.check(pages_ok, f"sharded {n}: query pages differ from the single card's")
            run["pages_equal_single_card"] = pages_ok
            # (c) conservation
            bad = [v.to_dict() for v in check_conservation(build_ledger(eng))]
            fails.check(not bad, f"sharded {n}: conservation violated: {bad}")
            run["launches_a_dispatch"] = _launches_a_dispatch(eng, stream[-1][0])
            run["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
            runs[n] = run
            eng.wal.close()
            del eng, clock
        del single
        exchange = _sharded_exchange(device, fails, seed, **(exchange_kw or {}))
        # (e) the card engine against a CPU engine, every byte
        small_stream = sharded_payloads(seed + 3, small_batches, small["batch_capacity"], 600)
        (card, card_mgr), (cpu, cpu_mgr) = (_spmd_engine(d, 2, small)
                                            for d in (device, torch.device("cpu")))
        for p, _ in small_stream:
            for e in (card, cpu):
                e.ingest_json_batch(p)
        for e in (card, cpu):
            e.flush()
        differ = [name for (name, a), (_, b) in zip(_state_leaves(card.state),
                                                    _state_leaves(cpu.state))
                  if not torch.equal(a.cpu(), b)]
        pages = [e.query_events(limit=50, since_ms=1_000) for e in (card, cpu)]
        fires = [sorted(a["alternateId"] for a in m.poll()) for m in (card_mgr, cpu_mgr)]
        counters = [{k: e.metrics()[k] for k in SHARDED_COUNTERS} for e in (card, cpu)]
        fails.check(not differ and pages[0] == pages[1] and fires[0] == fires[1]
                    and counters[0] == counters[1],
                    f"sharded reduced leg: the card differs from the CPU: state "
                    f"{differ[:5]}, pages {pages[0] == pages[1]}, fires "
                    f"{len(fires[0])} vs {len(fires[1])}, counters {counters}")
        small_rec = {"identical": not differ and pages[0] == pages[1]
                     and fires[0] == fires[1] and counters[0] == counters[1],
                     "rule_fires": len(fires[0]), "counters": counters[0]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "sharded", "note": "every shard on one card: events/s across shard "
                                       "counts is shards sharing one card, not scaling",
           "config": config, "batches": n_batches, "warmup": SHARDED_WARMUP,
           "devices": n_devices, "events": total, "runs": runs, "exchange": exchange,
           "reduced_leg": small_rec, "seconds": time.perf_counter() - t_phase}
    emit(rec, log)
    print("sharded: " + " ".join(
        f"{n}x={r['events_per_s']:.0f}ev/s({r['launches_a_dispatch']}k/disp)"
        for n, r in runs.items()) + " (shards share one card)", flush=True)
    return rec


# the distributed phase: DistributedConfig's own defaults a shard (2^14
# devices, 2^15 tokens and assignments, a 2^16-row ring, 2048 staged rows a
# batch, 8 channels) with a group-commit WAL, every shard on this card; the
# sharded phase's stream in calls of 8192 payloads, 10 calls a shard so
# every shard's ring wraps once (each shard takes ~8192 / n rows a call)
DIST_SHARDS = (1, 2, 4)
DIST_CALL = 8192
DIST_CALLS_A_SHARD = 10
DIST_WARMUP = 2
DIST_DEVICES = 10_000
# the reduced leg: 4 shards, a 4096-row ring a shard, 10 calls of 2048 over
# 600 devices (every ring wraps); the snapshot after 3 calls, when the rings
# of a 4 -> 2 reshard still hold every event
DIST_SMALL = dict(n_shards=4, device_capacity_per_shard=1024,
                  token_capacity_per_shard=2048, assignment_capacity_per_shard=2048,
                  store_capacity_per_shard=4096, batch_capacity_per_shard=256)
DIST_SMALL_CALL = 2048
DIST_SMALL_CALLS = 10
DIST_ACME = 8               # events of the two-assignment device a call
DIST_SMALL_DEVICES = 600
DIST_SNAPSHOT_AFTER = 3
DIST_SAMPLE_TOKENS = 40


class DistClock(HostClock):
    """Host time of each ingest call of a ``DistributedEngine``: the
    dispatches it made (``flush_async``: the WAL gate, the copies and the
    step launches of every shard) and within them the WAL gate; decode +
    commit is the rest of the call."""

    PARTS = ("dispatch", "wal_gate")
    WRAPS = (("flush_async", "dispatch"), ("_wal_gate", "wal_gate"))


def _dist_engine(device, wal_dir=None, **kw):
    from sitewhere_tpu_torch.parallel.distributed import DistributedConfig, DistributedEngine

    cfg = DistributedConfig(device=str(device), **kw)
    if wal_dir is not None:
        cfg.wal_dir, cfg.wal_group_commit = str(wal_dir), True
    eng = DistributedEngine(cfg)
    eng.epoch = PinnedEpoch(1e9)
    return eng


def _dist_pages(eng, t_end: int, tokens: list[str], assignment_id: int) -> list:
    """The check's query mix: newest page, a device, a tenant, an
    assignment, a time window, and the combinations."""
    return [eng.query_events(**kw) for kw in (
        dict(limit=64), dict(device_token=tokens[0], limit=32),
        dict(tenant="acme", limit=48), dict(assignment_id=assignment_id, limit=16),
        dict(since_ms=t_end - 3_000, until_ms=t_end - 1_000, limit=100),
        dict(device_token=tokens[1], since_ms=t_end - 9_000, limit=8),
        dict(tenant="acme", since_ms=t_end - 6_000, until_ms=t_end - 2_000, limit=20),
        dict(etype=EventType.MEASUREMENT, tenant="default", limit=10))]


def _dist_feed(eng) -> tuple[list, int]:
    """Every event a consumer from offset 0 delivers, polled and committed
    to the head, and its lag_lost."""
    feed = eng.make_feed_consumer("chip", max_batch=1 << 16)
    got = []
    while True:
        evs = feed.poll()
        if not evs:
            break
        got.extend(evs)
        feed.commit(evs)
    return got, feed.lag_lost


def _dist_reduced(device, fails, seed: int, tmp: pathlib.Path) -> dict:
    """Checks (a)-(e) on a reduced 4-shard engine on the card, against a CPU
    engine fed the same payloads."""
    from sitewhere_tpu_torch.parallel.distributed import recover_distributed, restore_distributed
    from sitewhere_tpu_torch.parallel.reshard import reshard_snapshot

    stream = sharded_payloads(seed + 5, DIST_SMALL_CALLS, DIST_SMALL_CALL, DIST_SMALL_DEVICES)
    card = _dist_engine(device, wal_dir=tmp / "wal", **DIST_SMALL)
    cpu = _dist_engine(torch.device("cpu"), **DIST_SMALL)
    out: dict = {}
    for e in (card, cpu):
        e.register_device("acme-0", tenant="acme", area="plant")
        e.create_assignment("acme-0", token="acme-0:x", asset="press")
    asg = card.get_assignment("acme-0:x").id
    summaries = []
    for k, (p, _) in enumerate(stream):
        acme = [json.dumps({"deviceToken": "acme-0", "type": "DeviceMeasurement",
                            "request": {"name": "temp", "value": float(k + i),
                                        "eventDate": SHARDED_T0_MS + 10**6 + DIST_ACME * k + i}}
                           ).encode() for i in range(DIST_ACME)]
        summaries.append([(untraced(e.ingest_json_batch(p)),
                           untraced(e.ingest_json_batch(acme, tenant="acme")))
                          for e in (card, cpu)])
        if k + 1 == DIST_SNAPSHOT_AFTER:
            for e in (card, cpu):
                e.flush()
            card.save(tmp / "snap")
    outs = [e.flush() for e in (card, cpu)]
    total = sum(len(p) + DIST_ACME for p, _ in stream)
    persisted = total + DIST_ACME * len(stream)   # acme-0 has two assignments
    # (a) the card against the CPU: state, counters, pages, device states
    differ = [name for (name, a), (_, b) in zip(_state_leaves(card.state),
                                                _state_leaves(cpu.state))
              if not torch.equal(a.cpu(), b)]
    t_end = SHARDED_T0_MS - 10**12 + DIST_SMALL_CALLS * DIST_SMALL_CALL
    toks = [f"lg-{i}" for i in range(0, DIST_SMALL_DEVICES, DIST_SMALL_DEVICES // DIST_SAMPLE_TOKENS)]
    pages = [_dist_pages(e, t_end, toks, asg) for e in (card, cpu)]
    dstates = [[e.get_device_state(t) for t in toks + ["acme-0"]] for e in (card, cpu)]
    same = {"state": not differ, "summaries": all(a == b for a, b in summaries)
            and outs[0] == outs[1], "metrics": card.metrics() == cpu.metrics(),
            "shard_metrics": card.shard_metrics() == cpu.shard_metrics(),
            "pages": pages[0] == pages[1], "device_states": dstates[0] == dstates[1],
            "tenant_metrics": card.tenant_metrics() == cpu.tenant_metrics(),
            "tenant_counters": card.tenant_pipeline_counters() == cpu.tenant_pipeline_counters(),
            "mirrors": _mirrors(card) == _mirrors(cpu)}
    m = card.metrics()
    fails.check(all(same.values()) and m["processed"] == total
                and m["persisted"] == persisted
                and pages[0][3]["total"] > 0 and pages[0][2]["total"] > 0,
                f"distributed (a): the card differs from the CPU: {same}, state {differ[:5]}, "
                f"metrics {m}, total {total}")
    out["a_identical"] = same
    # (b) save after DIST_SNAPSHOT_AFTER calls, a crash, recovery from the WAL tail
    card.wal.close()
    t0 = time.perf_counter()
    rec = recover_distributed(tmp / "snap", device=device, epoch_cls=PinnedEpoch)
    recover_s = time.perf_counter() - t0
    rdiff = [name for (name, a), (_, b) in zip(_state_leaves(card.state),
                                               _state_leaves(rec.state))
             if not torch.equal(a, b)]
    rpages = _dist_pages(rec, t_end, toks, asg)
    fails.check(not rdiff and rpages == pages[0] and rec.metrics() == m,
                f"distributed (b): recovered engine differs: state {rdiff[:5]}, pages "
                f"{rpages == pages[0]}, metrics {rec.metrics()} vs {m}")
    out["b_recovered"] = {"state_identical": not rdiff, "pages_equal": rpages == pages[0],
                          "seconds": recover_s}
    # (c) the feed: every stored event once, ids resolving through get_event
    got, lost = _dist_feed(card)
    cgot, clost = _dist_feed(cpu)
    heads = card._heads()
    written = int(heads.sum())
    ids = [e.event_id for e in got]
    sample = got[:: max(1, len(got) // 64)]
    by_id = [card.get_event(e.event_id) for e in sample]
    ok_ids = all(ev is not None and ev["deviceToken"] == src.device_token
                 and ev["eventDateMs"] == src.ts_ms and ev["measurements"] == src.measurements
                 for ev, src in zip(by_id, sample))
    feed_ok = (len(ids) == len(set(ids)) and len(ids) + lost == written
               and [e.event_id for e in cgot] == ids and clost == lost
               and card.make_feed_consumer("late", start_from_latest=True).poll() == []
               and ok_ids and written == persisted and lost > 0)
    fails.check(feed_ok, f"distributed (c): feed delivered {len(ids)} ({len(set(ids))} unique) "
                         f"+ lag_lost {lost} of {written} written; CPU {len(cgot)} + {clost}; "
                         f"get_event ok {ok_ids}")
    out["c_feed"] = {"delivered": len(ids), "lag_lost": lost, "written": written,
                     "get_event_checked": len(sample)}
    # (d) reshard 4 -> 2 of the card's snapshot, restored on the card
    snap = restore_distributed(tmp / "snap", device=device, epoch_cls=PinnedEpoch)
    reshard_snapshot(tmp / "snap", tmp / "snap2", 2)
    two = restore_distributed(tmp / "snap2", device=device, epoch_cls=PinnedEpoch)

    def keys(e):
        return sorted((x["deviceToken"], x["type"], x["eventDateMs"], x["receivedDateMs"])
                      for x in e.query_events(limit=1 << 14)["events"])

    def states(e):
        return [{k: v for k, v in (e.get_device_state(t) or {}).items() if k != "shard"}
                for t in toks + ["acme-0"]]

    ks, k2 = keys(snap), keys(two)
    fails.check(two.n_shards == 2 and ks == k2 and len(ks) == snap.metrics()["persisted"]
                and states(snap) == states(two),
                f"distributed (d): 4 -> 2 reshard: {len(ks)} vs {len(k2)} event keys, "
                f"states equal {states(snap) == states(two)}")
    out["d_reshard"] = {"events": len(k2), "device_states": len(toks) + 1}
    # (e) the ledgers of every engine of the leg
    for label, e in (("reduced card", card), ("reduced CPU", cpu), ("recovered", rec)):
        _conserved(e, f"distributed {label}", fails)
    rec.wal.close()
    return out


def phase_distributed(device, log, fails, seed: int, shard_counts=DIST_SHARDS,
                      call: int = DIST_CALL, calls_a_shard: int = DIST_CALLS_A_SHARD,
                      n_devices: int = DIST_DEVICES, config: dict | None = None) -> dict:
    """The mesh product engine (``parallel/distributed.DistributedEngine``)
    on the card at ``DistributedConfig``'s default sizes a shard, with a
    group-commit WAL, 1, 2 and 4 shards on this card: the sharded phase's
    JSON stream (:func:`sharded_payloads`) through the native decoder,
    ``DIST_CALLS_A_SHARD`` calls a shard (every ring wraps once); events/s
    over the timed calls and host ms a call (decode + commit, dispatch,
    WAL gate); (e) the conservation ledger of each. Then the reduced leg
    (:func:`_dist_reduced`): (a) card against CPU, (b) snapshot + WAL
    recovery, (c) the feed, (d) a 4 -> 2 reshard, (e) the ledgers."""
    t_phase = time.perf_counter()
    config = config or {}
    stream = sharded_payloads(seed, calls_a_shard * max(shard_counts), call, n_devices)
    runs = {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_distributed_"))
    try:
        for n in shard_counts:
            calls = stream[:calls_a_shard * n]
            eng = _dist_engine(device, wal_dir=tmp / f"wal{n}", n_shards=n, **config)
            clock = DistClock(eng)
            for p, _ in calls[:DIST_WARMUP]:
                eng.ingest_json_batch(p)
            eng.barrier()
            timed = calls[DIST_WARMUP:]
            d0 = eng._dispatches
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for p, _ in timed:
                eng.ingest_json_batch(p)
            eng.barrier()
            wall = time.perf_counter() - t0
            recs = clock.calls[-len(timed):]
            run = {"events_per_s": sum(len(p) for p, _ in timed) / wall, "wall_s": wall,
                   "calls": len(timed), "payloads_a_call": call,
                   "dispatches": eng._dispatches - d0,
                   "host_ms_per_call": clock.medians(len(timed)),
                   "host_ms_per_call_mean": {f"{k}_ms": statistics.fmean(c[k] for c in recs)
                                             for k in ("total", *DistClock.PARTS)},
                   "wal_fsyncs": eng.wal.fsyncs,
                   "peak_mem_gib": (torch.cuda.max_memory_allocated() / 2**30
                                    if device.type == "cuda" else None)}
            eng.flush()
            total = sum(len(p) for p, _ in calls)
            m = eng.metrics()
            heads = eng._heads()
            acap = eng.ring_arena_capacity()
            seen = len(np.unique(np.concatenate([picks for _, picks in calls])))
            fails.check(m["processed"] == m["persisted"] == m["found"] == total
                        and m["devices"] == seen and int(heads.max()) > acap,
                        f"distributed {n}: counters {m}, ring heads {heads.tolist()} "
                        f"(capacity {acap}), total {total}, tokens {seen}")
            newest = eng.query_events(limit=4)["events"]
            fails.check([e["eventDateMs"] for e in newest]
                        == [SHARDED_T0_MS - 10**12 + total - 1 - i for i in range(4)],
                        f"distributed {n}: newest events {newest}")
            _conserved(eng, f"distributed {n}", fails)
            run["ring_wraps_max"] = int(heads.max()) // acap
            runs[n] = run
            eng.wal.close()
            del eng, clock
        reduced = _dist_reduced(device, fails, seed, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = {"phase": "distributed", "note": "every shard on one card: events/s across shard "
                                           "counts is shards sharing one card, not scaling",
           "config": "DistributedConfig() defaults a shard, wal_group_commit=True",
           "devices": n_devices, "runs": runs, "reduced_leg": reduced,
           "seconds": time.perf_counter() - t_phase}
    emit(rec, log)
    print("distributed: " + " ".join(
        f"{n}x={r['events_per_s']:.0f}ev/s(host "
        f"{r['host_ms_per_call']['decode_commit_ms']:.1f}+"
        f"{r['host_ms_per_call']['dispatch_ms']:.1f}ms/call, gate "
        f"{r['host_ms_per_call']['wal_gate_ms']:.2f})"
        for n, r in runs.items()) + " (shards share one card)", flush=True)
    return rec


# ------------------------------------------------- anomaly_tp, multihost, sources

TP_CONFIG = AnomalyConfig()     # the default model: C 100, W 128, hidden 512, LSTM 512, bf16
TP_BATCH = 64
TP_STEPS = 3
TP_LR = 1e-3
TP_TIMED = 5


def phase_anomaly_tp(device, log, fails, seed: int, cfg: AnomalyConfig = TP_CONFIG,
                     batch: int = TP_BATCH, steps: int = TP_STEPS,
                     timed: int = TP_TIMED) -> dict:
    """The anomaly model's DP x TP training step (``param_shardings``,
    ``distribute_model``, ``make_train_step_dp_tp``) in a one-rank NCCL
    group on a (1, 1) ``("dp", "tp")`` mesh (gloo on the CPU): one card
    cannot hold two NCCL ranks, so TP across ranks is held to JAX on 8
    gloo ranks in tests/test_torch_anomaly_tp.py only. Here (a) every
    parameter's placements are JAX's predicate on its flax leaf (with tp
    = 1 a sharded leaf is Shard(0) over one rank: each local shard is the
    whole tensor); (b) ``steps`` steps against the single-device
    ``make_train_step`` from the same seeded weights and batch: every
    collective of one rank is a copy and the operations run in the same
    order, so the losses and parameters must be bit for bit the same;
    (c) ms a step of both, and the LSTM's per-time-step all-gather of
    ``h`` ([batch, lstm_hidden] float32) timed alone."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from sitewhere_tpu_torch.models import anomaly as tan

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed + 16)
    ref = tan.AnomalyModel(cfg, device=device, generator=gen)
    x = torch.rand((batch, cfg.window, cfg.sensors), generator=gen).to(device)
    store = tempfile.mkdtemp(prefix="swtpu-tp-")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}/store", rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh(device.type, (1, 1), mesh_dim_names=("dp", "tp"))
        model = tan.distribute_model(ref, mesh)
        want = {leaf.param: tan.jax_shards_leaf(leaf.shape, 1)
                for leaf in tan.anomaly_flax_leaves(cfg)}
        placements = {n: [str(pl) for pl in p.placements]
                      for n, p in model.named_parameters()}
        fails.check(placements == {n: ["R", "S(0)" if s else "R"] for n, s in want.items()},
                    f"anomaly_tp (a): placements {placements} vs JAX's predicate {want}")
        fails.check(all(torch.equal(p.to_local(), ref.get_parameter(n))
                        for n, p in model.named_parameters()),
                    "anomaly_tp (a): a local shard on a (1, 1) mesh is not the whole tensor")
        step_tp = tan.make_train_step_dp_tp(model, tan.adamw(model.parameters(), TP_LR), mesh)
        step_ref = tan.make_train_step(ref, tan.adamw(ref.parameters(), TP_LR))
        losses_tp = [step_tp(x) for _ in range(steps)]
        losses_ref = [step_ref(x) for _ in range(steps)]
        full = tan.full_state_dict(model)
        loss_diff = max(abs(a.item() - b.item()) for a, b in zip(losses_tp, losses_ref))
        param_diff = max((full[n] - p.detach()).abs().max().item()
                         for n, p in ref.named_parameters())
        fails.check(all(torch.equal(a, b) for a, b in zip(losses_tp, losses_ref))
                    and all(torch.equal(full[n], p.detach())
                            for n, p in ref.named_parameters()),
                    f"anomaly_tp (b): {steps} DP x TP steps vs the single-device steps: "
                    f"loss diff {loss_diff}, parameter diff {param_diff} (must be 0)")
        fails.check(all(math.isfinite(v.item()) for v in losses_tp),
                    f"anomaly_tp (b): losses {losses_tp}")
        tp_ms = time_ms(lambda: step_tp(x), device, reps=timed, warmup=1)
        ref_ms = time_ms(lambda: step_ref(x), device, reps=timed, warmup=1)
        par = tan.TensorParallel(mesh)
        h = torch.rand((batch, cfg.lstm_hidden), device=device)

        def gathers():
            with torch.no_grad():
                for _ in range(cfg.window):
                    par.gather(h)

        gather_ms = time_ms(gathers, device, reps=timed, warmup=1)
        _sync(device)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    out = {"phase": "anomaly_tp", "config": dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
           "batch": batch, "mesh": [1, 1], "backend": backend, "steps": steps,
           "sharded_params": sorted(n for n, s in want.items() if s),
           "losses": [v.item() for v in losses_tp], "loss_max_abs_diff": loss_diff,
           "param_max_abs_diff": param_diff, "tp_step_ms": tp_ms, "single_step_ms": ref_ms,
           "gather_ms_per_time_step": gather_ms / cfg.window,
           "gathers_a_forward": cfg.window, "gather_ms_a_forward": gather_ms,
           "seconds": time.perf_counter() - t0,
           "note": "one NCCL rank: every collective is a copy; TP across ranks is held to "
                   "JAX on 8 gloo ranks (CPU tests)"}
    emit(out, log)
    print(f"anomaly_tp: {tp_ms:.2f} ms a DP x TP step vs {ref_ms:.2f} single-device "
          f"(batch {batch}, default model, (1, 1) {backend} mesh); h all-gather "
          f"{gather_ms / cfg.window * 1e3:.1f} us a time step, {gather_ms:.2f} ms a forward",
          flush=True)
    return out


MULTIHOST_SHARDS = 4


def phase_multihost(device, log, fails, shards: int = MULTIHOST_SHARDS) -> dict:
    """The two-process sharded job (``parallel/multihost_demo.py``): 2
    worker processes (``python -c``, importing only the port), each with
    ``shards`` shards on this card and the reductions over a gloo group
    (NCCL refuses two ranks on one GPU): 3 steps of 8 events a shard, the
    global metrics after every step, the global store scan and the
    presence sweep summed over the group. Both lines must carry the JAX
    demo's totals, the shard ownership [0..3] / [4..7], and every state
    tensor on the card. Prints the wall time."""
    dev = f"{device.type}:{device.index or 0}" if device.type == "cuda" else "cpu"
    res = run_two_process_demo(devices_per_proc=shards, device=dev, timeout_s=300)
    ok, placed = sorted(res["ok"]), sorted(res["placed"])
    n = 2 * shards
    for r, line in enumerate(ok):
        fails.check(f"rank={r}/2 shards={list(range(r * shards, (r + 1) * shards))}" in line
                    and f"persisted={24 * n} store_valid={24 * n}" in line
                    and f"missing={8 * n}" in line,
                    f"multihost: rank {r} line {line!r}")
        fails.check(f"device={dev} " in placed[r], f"multihost: rank {r} placed {placed[r]!r}")
    fails.check(len(ok) == 2 and ok[0].split("persisted=")[1] == ok[1].split("persisted=")[1],
                f"multihost: the ranks disagree on the global totals {ok}")
    out = {"phase": "multihost", "processes": 2, "shards_a_process": shards,
           "backend": "gloo", "device": dev, "lines": ok, "placed": placed,
           "wall_s": res["seconds"]}
    emit(out, log)
    print(f"multihost: 2 processes x {shards} shards on {dev}, {res['seconds']:.2f} s wall",
          flush=True)
    return out


SOURCES_CONFIG = dict(device_capacity=1 << 12, token_capacity=1 << 13,
                      assignment_capacity=1 << 13, store_capacity=1 << 14,
                      batch_capacity=1024, channels=8)
SOURCES_PAYLOADS = 4096
SOURCES_DEVICES = 600
SOURCES_REPS = 5        # card runs of the stream: the first checked, every one timed


def sources_stream(seed: int, n: int = SOURCES_PAYLOADS, n_devices: int = SOURCES_DEVICES):
    """Seeded payloads for the sources phase, with what they must give:
    ``memory`` (one payload a submit) and ``socket`` (newline lines, some
    of them JSON arrays of envelopes) lists of bytes, each about 2 % bad
    payloads, 5 % redeliveries of an earlier alternate id and a
    registration every 64th; ``expect`` the decoded, failed and duplicate
    counts a source must reach, the dead letter's payloads and the tokens
    registered by request. Values are multiples of 0.5."""
    rng = np.random.default_rng(seed + 17)
    t0 = int(1e9 * 1000) + 10_000
    out = {"memory": [], "socket": []}
    expect = {k: {"decoded": 0, "failed": 0, "duplicate": 0, "bad": [], "registered": []}
              for k in out}
    seen: dict[str, list] = {k: [] for k in out}
    for i in range(n):
        kind = "memory" if i % 2 == 0 else "socket"
        tok = f"src-{int(rng.integers(n_devices))}"
        r = rng.random()
        if r < 0.02:
            p = [b"{not json", b"[1, 2]", b'{"deviceToken": "x", "type": "Nope"}'][i % 3]
            if kind == "socket" and p == b"[1, 2]":
                p = b'["no envelope"]'
            out[kind].append(p)
            expect[kind]["failed"] += 1
            expect[kind]["bad"].append(p)
            continue
        if r < 0.07 and seen[kind]:
            env = seen[kind][int(rng.integers(len(seen[kind])))]
            expect[kind]["duplicate"] += 1
        elif i % 64 == 0:
            env = {"deviceToken": f"reg-{i}", "type": "RegisterDevice",
                   "request": {"deviceTypeToken": "gateway", "areaToken": "north"}}
            expect[kind]["decoded"] += 1
            expect[kind]["registered"].append(env["deviceToken"])
        else:
            env = {"deviceToken": tok, "type": "DeviceMeasurement",
                   "request": {"measurements": {f"c{j}": float(rng.integers(-64, 64)) / 2
                                                for j in range(3)},
                               "eventDate": t0 + i, "alternateId": f"a-{i}"}}
            if i % 5 == 0:
                env = {"deviceToken": tok, "type": "DeviceLocation",
                       "request": {"latitude": 48.5, "longitude": 2.5, "eventDate": t0 + i,
                                   "alternateId": f"a-{i}"}}
            seen[kind].append(env)
            expect[kind]["decoded"] += 1
        body = json.dumps(env).encode()
        if kind == "socket" and i % 3 == 0:
            body = b"[" + body + b"]"        # a batch of one, through the batch decoder
        out[kind].append(body)
    return out, expect


def _sources_engine(device, config: dict):
    from sitewhere_tpu_torch.ingest.decoders import (CompositeDecoder,
                                                     JsonBatchEventDecoder)
    from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator
    from sitewhere_tpu_torch.ingest.sources import (EventSourcesManager, InboundEventSource,
                                                    InMemoryEventReceiver,
                                                    SocketEventReceiver)

    eng = Engine(EngineConfig(**config), device=device)
    eng.epoch = PinnedEpoch(1e9)
    mgr = EventSourcesManager(on_event_request=eng.process,
                              on_registration_request=eng.process)
    mem, sock = InMemoryEventReceiver(), SocketEventReceiver(framing="newline")
    json_dec = JsonDeviceRequestDecoder()
    mgr.add_source(InboundEventSource("memory", json_dec, [mem], AlternateIdDeduplicator()))
    mgr.add_source(InboundEventSource("socket", CompositeDecoder(
        lambda p, m: ("batch" if p[:1] == b"[" else "one", p),
        {"batch": JsonBatchEventDecoder(), "one": json_dec}), [sock],
        AlternateIdDeduplicator()))
    return eng, mgr, mem, sock


def _feed_sources(eng, mgr, mem, sock, stream) -> float:
    """Every payload through its receiver (the in-memory ones first, each
    processed as it is submitted); returns the socket path's wall seconds
    from the connection until the last payload is counted, the engine's
    partial batch is committed (``flush``) and the device is idle."""
    for p in stream["memory"]:
        mem.submit(p)
    src = mgr.sources["socket"]
    n = len(stream["socket"])

    async def run() -> float:
        await mgr.initialize()
        await mgr.start()
        try:
            t0 = time.perf_counter()
            _, w = await asyncio.open_connection("127.0.0.1", sock.bound_port)
            w.write(b"".join(p + b"\n" for p in stream["socket"]))
            await w.drain()
            w.close()
            await w.wait_closed()
            while src.decoded_count + src.failed_count + src.duplicate_count < n:
                if time.perf_counter() - t0 > 120:
                    break
                await asyncio.sleep(0.001)
            eng.flush()
            _sync(eng.device)
            return time.perf_counter() - t0
        finally:
            await mgr.stop()

    return asyncio.run(run())


def phase_sources(device, log, fails, seed: int, config: dict = SOURCES_CONFIG,
                  n: int = SOURCES_PAYLOADS, reps: int = SOURCES_REPS) -> dict:
    """Inbound event sources into an engine on the card: an
    ``EventSourcesManager`` with an ``InMemoryEventReceiver`` source
    (``JsonDeviceRequestDecoder``) and a ``SocketEventReceiver`` source
    (newline framing, stdlib asyncio; a ``CompositeDecoder`` that sends
    JSON arrays to ``JsonBatchEventDecoder``), each with an
    ``AlternateIdDeduplicator``, forwarding to ``Engine.process``:
    ``n`` seeded payloads with redeliveries, bad payloads and
    registrations. Each source's decoded, failed and duplicate counts and
    the dead letter must be what the stream says, and the card engine's
    state leaves, metrics and registrations byte for byte a CPU engine's
    fed the same payloads the same way. The stream then runs ``reps - 1``
    more times, each into a fresh card engine that must end with the same
    metrics. Prints the median payloads/s of the socket path over the
    ``reps`` card runs, each timed from the connection to the card engine
    idle with every payload committed."""
    stream, expect = sources_stream(seed, n)
    # each bad payload logs a warning as it reaches the dead letter
    logging.getLogger("sitewhere_tpu_torch.ingest.sources").setLevel(logging.ERROR)
    runs = {}
    for where in (device, torch.device("cpu")):
        eng, mgr, mem, sock = _sources_engine(where, config)
        seconds = _feed_sources(eng, mgr, mem, sock, stream)
        runs[where.type] = (eng, mgr, seconds)
    eng, mgr, seconds = runs[device.type]
    samples = [seconds]
    for _ in range(reps - 1):
        again, *feed = _sources_engine(device, config)
        samples.append(_feed_sources(again, *feed, stream))
        fails.check(again.metrics() == eng.metrics(),
                    f"sources: a repeated run's metrics {again.metrics()} vs {eng.metrics()}")
    counts = {k: {"decoded": s.decoded_count, "failed": s.failed_count,
                  "duplicate": s.duplicate_count} for k, s in mgr.sources.items()}
    for k, s in counts.items():
        want = {c: expect[k][c] for c in ("decoded", "failed", "duplicate")}
        fails.check(s == want, f"sources: {k} counts {s} vs the stream's {want}")
    dead = [p for _, p, _ in mgr.failed_decodes]
    fails.check(sorted(dead) == sorted(expect["memory"]["bad"] + expect["socket"]["bad"]),
                f"sources: dead letter of {len(dead)} payloads vs "
                f"{len(expect['memory']['bad']) + len(expect['socket']['bad'])} bad ones")
    host = runs["cpu"][0]
    differ = [k for (k, a), (_, b) in zip(_state_leaves(eng.state), _state_leaves(host.state))
              if not torch.equal(a.cpu(), b)]
    fails.check(not differ, f"sources: card vs CPU state leaves differ: {differ[:8]}")
    fails.check(eng.metrics() == host.metrics(),
                f"sources: metrics {eng.metrics()} vs CPU {host.metrics()}")
    regs = expect["memory"]["registered"] + expect["socket"]["registered"]
    infos = [eng.get_device(t) for t in regs]
    fails.check(bool(regs) and all(i is not None and i.device_type == "gateway"
                                   and not i.auto_registered for i in infos),
                f"sources: registrations {list(zip(regs, infos))[:4]}")
    m = eng.metrics()
    n_sock = len(stream["socket"])
    rates = [n_sock / s for s in samples]
    rate = statistics.median(rates)
    out = {"phase": "sources", "payloads": n, "memory": len(stream["memory"]),
           "socket": n_sock, "counts": counts, "dead_letter": len(dead),
           "registered_by_request": len(regs), "processed": m["processed"],
           "persisted": m["persisted"], "socket_seconds": samples,
           "socket_payloads_per_s": rate, "socket_payloads_per_s_runs": rates,
           "cpu_socket_payloads_per_s": n_sock / runs["cpu"][2],
           "config": config}
    emit(out, log)
    print(f"sources: {rate:.0f} payloads/s through the socket receiver into the card "
          f"engine, committed (median of {reps} runs of {n_sock} payloads: "
          f"{min(rates):.0f}..{max(rates):.0f}); card state equal to the CPU engine's",
          flush=True)
    return out


# bench.py's wire leg (W_CFG and its load) on the card
EDGE_CONFIG = dict(device_capacity=1 << 12, token_capacity=1 << 13,
                   assignment_capacity=1 << 13, store_capacity=1 << 15, batch_capacity=1024)
EDGE_SPEC = dict(n_connections=1000, frames_per_conn=12, n_devices=200, seed=7)
EDGE_GROUP = 256            # parity frames a group: a flush hint and an ack barrier each
EDGE_GROUPS = 12
EDGE_LOAD_RUNS = 3          # samples of the 12,000-frame load
EDGE_RR = 160               # connect, frame, ack, close cycles of the contrast
EDGE_KILL_S = 1.0
EDGE_KILL_CONNS = 8
EDGE_RECV_N = 96            # payloads a broker receiver in (d)
EDGE_RECV_GROUP = 16        # batched payloads a flush in (d)
# how often the host waited for a free staging arena: a timing count, the
# only metric the edge-fed and the directly fed engine may differ in
EDGE_TIMING_METRICS = ("arena_pool_waits",)
EDGE_LOGGERS = ("sitewhere_tpu_torch.ingest.wire_edge", "sitewhere_tpu_torch.ingest.sources")


class _ThreadErrors(logging.Handler):
    """Every ERROR record of the wire edge's and the sources' loggers, and
    every exception that ends a thread, while installed: the flusher
    thread logs a failed engine call and carries on, so a CUDA error
    raised off the main thread shows only here."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.seen: list[str] = []
        self._hook = None

    def emit(self, record):
        self.seen.append(f"{record.name}: {record.getMessage()} {record.exc_text or ''}")

    def __enter__(self):
        for name in EDGE_LOGGERS:
            logging.getLogger(name).addHandler(self)
        self._hook = threading.excepthook
        threading.excepthook = lambda a: self.seen.append(
            f"thread {a.thread.name if a.thread else '?'}: {a.exc_type.__name__}: {a.exc_value}")
        return self

    def __exit__(self, *exc):
        for name in EDGE_LOGGERS:
            logging.getLogger(name).removeHandler(self)
        threading.excepthook = self._hook


def _edge_engine(device, config: dict, warm: list[bytes], **kw) -> Engine:
    eng = Engine(EngineConfig(**config, **kw), device=device)
    eng.epoch = PinnedEpoch(1.7e9, now_ms=77_777)
    eng.ingest_json_batch(warm)
    eng.flush()
    return eng


def _untimed_metrics(eng) -> dict:
    return {k: v for k, v in eng.metrics().items() if k not in EDGE_TIMING_METRICS}


async def _swp_groups(eng, payloads: list[bytes], group: int) -> dict:
    """``payloads`` over one SWP connection in groups of ``group``, each with
    a flush hint and an ack barrier, into an edge whose size threshold is
    the group: the edge makes one engine call a group. Returns the edge's
    snapshot."""
    from sitewhere_tpu_torch.ingest.wire_edge import (SWP_ACK, SWP_MAGIC, WireEdge,
                                                      WireEdgeConfig)

    edge = WireEdge(eng, WireEdgeConfig(mqtt_port=None, tcp_port=0, flush_rows=group,
                                        flush_interval_s=5.0))
    await edge.start()
    try:
        r, w = await asyncio.open_connection("127.0.0.1", edge.tcp_port)
        w.write(SWP_MAGIC + b" default json\n")
        sent = acked = 0
        for lo in range(0, len(payloads), group):
            chunk = payloads[lo:lo + group]
            w.write(b"".join(struct.pack("!I", len(p)) + p for p in chunk)
                    + struct.pack("!I", 0))
            sent += len(chunk)
            await w.drain()
            while acked < sent:
                code, val = struct.unpack("!BI", await asyncio.wait_for(r.readexactly(5), 60))
                if code != SWP_ACK:
                    raise RuntimeError(f"edge: SWP record {code:#x} {val} in the parity leg")
                acked = val
        w.close()
        return edge.snapshot()
    finally:
        await edge.stop()


async def _swp_one(port: int, payload: bytes) -> None:
    """One request-response cycle: connect, handshake, one frame, a flush
    hint, its durable ack, close."""
    from sitewhere_tpu_torch.ingest.wire_edge import SWP_ACK, SWP_MAGIC

    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(SWP_MAGIC + b" default json\n" + struct.pack("!I", len(payload)) + payload
            + struct.pack("!I", 0))
    await w.drain()
    while (await asyncio.wait_for(r.readexactly(5), 60))[0] != SWP_ACK:
        pass
    w.close()


async def _edge_load(eng, device, schedule, warm_schedule, runs: int, rr: list[bytes]) -> dict:
    """(b): ``runs`` samples of ``run_wire_load`` (every connection live for
    the whole run, QoS 1) through one MQTT + SWP edge; each sample's
    committed time adds the ``flush()`` and device sync after its last
    ack. Then the request-response contrast and, with the edge attached,
    the conservation ledger."""
    from sitewhere_tpu_torch.ingest.wire_edge import WireEdge, WireEdgeConfig
    from sitewhere_tpu_torch.loadgen import run_wire_load

    edge = WireEdge(eng, WireEdgeConfig(mqtt_port=0, tcp_port=0, flush_rows=256,
                                        flush_interval_s=0.005))
    await edge.start()
    try:
        await run_wire_load("127.0.0.1", edge.mqtt_port, warm_schedule, client_id_prefix="ww")
        eng.flush()
        _sync(device)
        copies0 = eng.host_counters.get("staged_copy_rows", 0)
        samples = []
        for k in range(runs):
            res = await run_wire_load("127.0.0.1", edge.mqtt_port, schedule,
                                      client_id_prefix=f"wl{k}")
            t0 = time.perf_counter()
            eng.flush()
            _sync(device)
            samples.append((res, res.wall_s + time.perf_counter() - t0))
        t1 = time.perf_counter()
        for p in rr:
            await _swp_one(edge.tcp_port, p)
        rr_eps = len(rr) / (time.perf_counter() - t1)
        eng.flush()
        _sync(device)
        ledger = build_ledger(eng)
        return {"samples": samples, "rr_eps": rr_eps,
                "copies": eng.host_counters.get("staged_copy_rows", 0) - copies0,
                "wire_stage": ledger["stages"].get("wire"),
                "violations": [v.to_dict() for v in check_conservation(ledger)],
                "snapshot": edge.snapshot()}
    finally:
        await edge.stop()


def _kill_frame(i: int, k: int) -> bytes:
    return generate_measurements_message(f"wl-dev-{k % 200}", 5_000_000 + i * 10_000 + k)


async def _edge_kill(eng, conns: int, seconds: float):
    """(c): ``conns`` SWP connections pump frames for ``seconds``, then
    ``edge.kill()`` (sockets closed, no batcher drain). Returns each
    connection's last cumulative durable ack and the edge."""
    from sitewhere_tpu_torch.ingest.wire_edge import (SWP_ACK, SWP_MAGIC, WireEdge,
                                                      WireEdgeConfig)

    edge = WireEdge(eng, WireEdgeConfig(mqtt_port=None, tcp_port=0, flush_rows=64,
                                        flush_interval_s=0.002))
    await edge.start()
    acked = [0] * conns
    links = []
    for _ in range(conns):
        r, w = await asyncio.open_connection("127.0.0.1", edge.tcp_port)
        w.write(SWP_MAGIC + b" default json\n")
        links.append((r, w))

    async def pump(i):
        # bursts of 32 frames a millisecond a connection: a flood without
        # pauses starves the flusher thread of the interpreter, and a drill
        # that acks nothing proves nothing
        w = links[i][1]
        try:
            for k in range(20_000):
                p = _kill_frame(i, k)
                w.write(struct.pack("!I", len(p)) + p)
                if k % 32 == 31:
                    await w.drain()
                    await asyncio.sleep(0.001)
        except (ConnectionError, asyncio.CancelledError):
            pass

    async def reap(i):
        r = links[i][0]
        try:
            while True:
                hdr = await r.readexactly(5)
                if hdr[0] == SWP_ACK:
                    acked[i] = struct.unpack("!I", hdr[1:])[0]
        except (asyncio.IncompleteReadError, ConnectionError, asyncio.CancelledError):
            pass

    tasks = [asyncio.ensure_future(f(i)) for f in (pump, reap) for i in range(conns)]
    await asyncio.sleep(seconds)
    edge.kill()
    for t in tasks:
        t.cancel()
    await asyncio.gather(*tasks, return_exceptions=True)
    return list(acked), edge


def edge_receiver_stream(seed: int, n: int = EDGE_RECV_N, n_devices: int = 300) -> tuple:
    """Seeded payloads for each broker receiver of (d): measurements and
    locations with alternate ids (values multiples of 0.5), about 5 %
    redeliveries of an earlier payload of the same source and 2 % bad
    frames. Returns the lists and what a source with a deduplicator must
    count (``decoded``, ``failed``, ``duplicate``, the dead letter)."""
    rng = np.random.default_rng(seed + 29)
    t0 = int(1.7e12) + 1_000
    out, expect = {}, {}
    for s, name in enumerate(("mqtt", "coap", "amqp", "stomp", "hub")):
        seen, pays = [], []
        exp = {"decoded": 0, "failed": 0, "duplicate": 0, "bad": []}
        for i in range(n):
            r = rng.random()
            if r < 0.02:
                p = [b"{not json", b'{"deviceToken": "x", "type": "Nope"}'][i % 2]
                exp["failed"] += 1
                exp["bad"].append(p)
            elif r < 0.07 and seen:
                p = seen[int(rng.integers(len(seen)))]
                exp["duplicate"] += 1
            else:
                tok = f"rx-{int(rng.integers(n_devices))}"
                req = {"eventDate": t0 + s * 10_000 + i, "alternateId": f"{name}-{i}"}
                if i % 5 == 0:
                    env = {"deviceToken": tok, "type": "DeviceLocation",
                           "request": {"latitude": 48.5, "longitude": 2.5, **req}}
                else:
                    env = {"deviceToken": tok, "type": "DeviceMeasurement",
                           "request": {"name": f"c{i % 3}",
                                       "value": float(rng.integers(-64, 64)) / 2, **req}}
                p = json.dumps(env).encode()
                seen.append(p)
                exp["decoded"] += 1
            pays.append(p)
        out[name], expect[name] = pays, exp
    return out, expect


async def _until(pred, what: str, limit_s: float = 30.0) -> None:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > limit_s:
            raise RuntimeError(f"edge: timed out waiting for {what}")
        await asyncio.sleep(0.001)


def _counted(src) -> int:
    return src.decoded_count + src.failed_count + src.duplicate_count + src.batched_count


async def _feed_receivers(eng, device, stream) -> dict:
    """(d): the MQTT receiver over ``MqttBroker``, CoAP, AMQP over
    ``AmqpBroker``, STOMP (an embedded broker, two competing consumers)
    and EventHub, as five sources of one ``EventSourcesManager`` that
    carries a shared ``WireBatcher``. MQTT, AMQP and EventHub have an
    alternate-id deduplicator (the per-payload path, a dead letter); CoAP
    and STOMP take the batcher. Each payload is counted before the next
    is sent and the batcher flushes every ``EDGE_RECV_GROUP`` payloads, so
    the engine sees the same calls on every device."""
    from sitewhere_tpu_torch.ingest.amqp import (AmqpBroker, AmqpClient,
                                                 RabbitMqEventReceiver)
    from sitewhere_tpu_torch.ingest.coap import CREATED, POST, CoapClient, CoapServerEventReceiver
    from sitewhere_tpu_torch.ingest.dedup import AlternateIdDeduplicator
    from sitewhere_tpu_torch.ingest.eventhub import EventHub, EventHubEventReceiver
    from sitewhere_tpu_torch.ingest.mqtt import MqttBroker, MqttClient, MqttEventReceiver
    from sitewhere_tpu_torch.ingest.sources import EventSourcesManager, InboundEventSource
    from sitewhere_tpu_torch.ingest.stomp import ActiveMqBrokerEventReceiver, StompClient
    from sitewhere_tpu_torch.ingest.wire_edge import WireBatcher

    batcher = WireBatcher(eng, flush_rows=1 << 20, auto=False)
    mgr = EventSourcesManager(eng.process, eng.process, batcher=batcher)
    mqtt_broker, amqp_broker = MqttBroker(), AmqpBroker()
    await mqtt_broker.start()
    await amqp_broker.start()
    hub = EventHub("edge", partition_count=4)
    dec = JsonDeviceRequestDecoder()
    recv = {"mqtt": MqttEventReceiver("127.0.0.1", mqtt_broker.bound_port, topic="sw/in/#",
                                      qos=1),
            "coap": CoapServerEventReceiver(),
            "amqp": RabbitMqEventReceiver("127.0.0.1", amqp_broker.bound_port, queue="sw.in"),
            "stomp": ActiveMqBrokerEventReceiver("edge", "SW.IN", num_consumers=2),
            "hub": EventHubEventReceiver(hub)}
    deduped = ("mqtt", "amqp", "hub")
    srcs = {k: mgr.add_source(InboundEventSource(
        k, dec, [r], AlternateIdDeduplicator() if k in deduped else None))
        for k, r in recv.items()}
    await mgr.initialize()
    await mgr.start()
    coap_codes = []
    try:
        pub = MqttClient("127.0.0.1", mqtt_broker.bound_port, "edge-pub")
        await pub.connect()
        for i, p in enumerate(stream["mqtt"]):
            await pub.publish(f"sw/in/{i}", p, qos=1)
            await _until(lambda: _counted(srcs["mqtt"]) == i + 1, "an mqtt payload")
        await pub.disconnect()
        client = CoapClient("127.0.0.1", recv["coap"].bound_port, timeout=60)
        for lo in range(0, len(stream["coap"]), EDGE_RECV_GROUP):
            replies = []
            for i, p in enumerate(stream["coap"][lo:lo + EDGE_RECV_GROUP], start=lo):
                replies.append(asyncio.ensure_future(client.request(POST, ["events"], p)))
                await _until(lambda: _counted(srcs["coap"]) == i + 1, "a coap payload")
            batcher.flush()                # the confirmable ACKs wait for this
            coap_codes += [(await f)["code"] for f in replies]
        amqp_pub = AmqpClient("127.0.0.1", amqp_broker.bound_port)
        await amqp_pub.connect()
        for i, p in enumerate(stream["amqp"]):
            await amqp_pub.publish("", "sw.in", p)
            await _until(lambda: _counted(srcs["amqp"]) == i + 1, "an amqp payload")
        await amqp_pub.close()
        stomp_pub = StompClient("127.0.0.1", recv["stomp"].bound_port)
        await stomp_pub.connect()
        for i, p in enumerate(stream["stomp"]):
            await stomp_pub.send("/queue/SW.IN", p)
            await _until(lambda: _counted(srcs["stomp"]) == i + 1, "a stomp payload")
            if (i + 1) % EDGE_RECV_GROUP == 0:
                batcher.flush()
        batcher.flush()
        await stomp_pub.disconnect()
        for p in stream["hub"]:
            hub.send(p, partition_key="edge")      # one partition: one order
        await _until(lambda: _counted(srcs["hub"]) == len(stream["hub"]), "the hub payloads")
    finally:
        await mgr.stop()
        await mqtt_broker.stop()
        await amqp_broker.stop()
        batcher.close()
    eng.flush()
    _sync(device)
    return {"counts": {k: {"decoded": s.decoded_count, "failed": s.failed_count,
                           "duplicate": s.duplicate_count, "batched": s.batched_count}
                       for k, s in srcs.items()},
            "dead": [(s, p) for s, p, _ in mgr.failed_decodes],
            "coap_created": sum(c == CREATED for c in coap_codes),
            "batcher": batcher.counters(), "reconnects": recv["mqtt"].reconnects}


def _raise_fd_limit(need: int) -> None:
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE, (min(hard, max(need, 4096)), hard))


def phase_edge(device, log, fails, seed: int, config: dict = EDGE_CONFIG,
               spec: dict = EDGE_SPEC, group: int = EDGE_GROUP, groups: int = EDGE_GROUPS,
               load_runs: int = EDGE_LOAD_RUNS, rr: int = EDGE_RR,
               kill_s: float = EDGE_KILL_S, recv_n: int = EDGE_RECV_N) -> dict:
    """The persistent-connection wire edge and the broker receivers into
    engines on the card (bench.py's wire leg): (a) ``groups`` x ``group``
    frames of the load's schedule over one SWP connection, a flush hint and
    an ack barrier a group, into a card engine, against a second card
    engine and a CPU engine fed the same ``ingest_json_batch`` calls: state
    leaves, host mirrors and ``metrics()`` equal; (b) ``spec``'s load
    (1000 live MQTT connections x 12 QoS 1 frames) through ``run_wire_load``
    into that engine's edge (``flush_rows=256``, 5 ms deadline),
    ``load_runs`` samples: every frame acked, no host staging copy, the
    ledger's "wire" stage present and balancing; then ``rr``
    request-response cycles over SWP; (c) a card engine with a group-commit
    WAL: 8 SWP connections pump for ``kill_s``, ``edge.kill()``, a fresh
    card engine replays the WAL and every frame a client saw acked is among
    the replayed payloads; (d) the five broker receivers
    (``_feed_receivers``) into a card and a CPU engine: counts, the dead
    letter, the CoAP ACKs and the state equal. Every flusher thread runs on
    the card: no error may be logged or raised off the main thread, and no
    frame may stall."""
    from sitewhere_tpu_torch.loadgen import (WireLoadSpec, build_wire_schedule,
                                             wire_schedule_fingerprint)
    from sitewhere_tpu_torch.utils.checkpoint import replay_wal_into

    _raise_fd_limit(4 * spec["n_connections"] + 256)
    logging.getLogger("sitewhere_tpu_torch.ingest.sources").setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    warm = [generate_measurements_message(f"wl-dev-{i % 200}", i) for i in range(1024)]
    sched = build_wire_schedule(WireLoadSpec(**spec))
    events = sum(len(f) for f in sched)
    parity = [p for f in sched for p in f][:groups * group]
    stalled = 0
    with _ThreadErrors() as errs:
        # (a) parity; the stream each engine call of the edge ran on
        e_wa = _edge_engine(device, config, warm)
        main_stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        streams = []
        edge_call = e_wa.ingest_json_batch

        def on_stream(payloads, tenant="default", **kw):
            streams.append((threading.current_thread().name,
                            torch.cuda.current_stream(device) if main_stream else None))
            return edge_call(payloads, tenant=tenant, **kw)

        e_wa.ingest_json_batch = on_stream
        snap_a = asyncio.run(_swp_groups(e_wa, parity, group))
        e_wa.ingest_json_batch = edge_call
        stalled += snap_a["frames_stalled"]
        fails.check(bool(streams) and all(s == main_stream and t != "MainThread"
                                          for t, s in streams),
                    f"edge: (a) the edge's engine calls ran on {streams[:4]}, not off the "
                    f"main thread on its stream {main_stream}")
        oracles = {}
        for where in (device, torch.device("cpu")):
            o = _edge_engine(where, config, warm)
            for lo in range(0, len(parity), group):
                o.ingest_json_batch(parity[lo:lo + group])
            o.flush()
            oracles[where.type] = o
        e_wa.flush()
        _sync(device)
        for name, o in oracles.items():
            differ = _engines_differ(o, e_wa)
            fails.check(not differ, f"edge: (a) the edge-fed card engine vs the {name} "
                                    f"oracle differs: {differ[:8]}")
            fails.check(_untimed_metrics(o) == _untimed_metrics(e_wa),
                        f"edge: (a) metrics {_untimed_metrics(e_wa)} vs the {name} "
                        f"oracle's {_untimed_metrics(o)}")
        fails.check(snap_a["rows_submitted"] == len(parity) and snap_a["flushes"] == groups,
                    f"edge: (a) {snap_a['rows_submitted']} rows in {snap_a['flushes']} "
                    f"flushes, want {len(parity)} in {groups}")
        del oracles
        # (b) load
        warm_sched = build_wire_schedule(WireLoadSpec(n_connections=4, frames_per_conn=16,
                                                      n_devices=200, seed=11))
        load = asyncio.run(_edge_load(e_wa, device, sched, warm_sched, load_runs, parity[:rr]))
        stalled += load["snapshot"]["frames_stalled"]
        for res, _ in load["samples"]:
            fails.check(res.acked == events == res.events and res.connections == len(sched),
                        f"edge: (b) {res.acked} of {events} frames acked over "
                        f"{res.connections} connections")
        fails.check(load["copies"] == 0, f"edge: (b) {load['copies']} host staging copies")
        fails.check(load["wire_stage"] is not None and not load["violations"],
                    f"edge: (b) wire stage {load['wire_stage']}, violations "
                    f"{load['violations']}")
        # (c) kill drill
        with tempfile.TemporaryDirectory(prefix="edge-wal-") as wal_dir:
            e_wk = _edge_engine(device, config, warm, wal_dir=wal_dir, wal_group_commit=True)
            acked, kedge = asyncio.run(_edge_kill(e_wk, EDGE_KILL_CONNS, kill_s))
            for b in kedge.batchers:
                b.close()
            stalled += kedge.snapshot()["frames_stalled"]
            e_wk.flush()
            _sync(device)
            e_wk.wal.close()
            e_wr = Engine(EngineConfig(**config), device=device)
            replayed = set()
            replay_call = e_wr.ingest_json_batch

            def spy(payloads, tenant="default", **kw):
                replayed.update(payloads)
                return replay_call(payloads, tenant=tenant, **kw)

            e_wr.ingest_json_batch = spy
            replay_wal_into(e_wr, -1, wal_dir)
            _sync(device)
        lost = [(i, k) for i, n in enumerate(acked) for k in range(n)
                if _kill_frame(i, k) not in replayed]
        recovered = e_wr.metrics()["persisted"]
        fails.check(sum(acked) > 0 and not lost and recovered >= sum(acked) + len(warm),
                    f"edge: (c) {sum(acked)} frames acked before the kill, {len(lost)} of "
                    f"them not replayed ({lost[:4]}), {recovered} rows recovered")
        # (d) broker receivers
        stream, expect = edge_receiver_stream(seed, recv_n)
        recv = {}
        for where in (device, torch.device("cpu")):
            eng = Engine(EngineConfig(**SOURCES_CONFIG), device=where)
            eng.epoch = PinnedEpoch(1.7e9, now_ms=77_777)
            recv[where.type] = (eng, asyncio.run(_feed_receivers(eng, where, stream)))
        (card, got), (host, host_got) = recv[device.type], recv["cpu"]
        stalled += got["batcher"]["frames_stalled"]
        for k, c in got["counts"].items():
            if k in ("coap", "stomp"):
                want = {"decoded": 0, "failed": 0, "duplicate": 0, "batched": recv_n}
            else:
                want = {**{c2: expect[k][c2] for c2 in ("decoded", "failed", "duplicate")},
                        "batched": 0}
            fails.check(c == want, f"edge: (d) {k} counts {c} vs the stream's {want}")
        want_dead = sorted((k, p) for k in ("mqtt", "amqp", "hub") for p in expect[k]["bad"])
        fails.check(sorted(got["dead"]) == want_dead,
                    f"edge: (d) dead letter of {len(got['dead'])} vs {len(want_dead)} bad")
        fails.check(got["coap_created"] == recv_n,
                    f"edge: (d) {got['coap_created']} of {recv_n} CoAP ACKs CREATED")
        fails.check({k: v for k, v in got.items() if k != "batcher"}
                    == {k: v for k, v in host_got.items() if k != "batcher"},
                    "edge: (d) the card run's counts differ from the CPU run's")
        differ = _engines_differ(host, card)
        fails.check(not differ, f"edge: (d) card vs CPU engine differ: {differ[:8]}")
        fails.check(_untimed_metrics(card) == _untimed_metrics(host),
                    f"edge: (d) metrics {_untimed_metrics(card)} vs CPU "
                    f"{_untimed_metrics(host)}")
    fails.check(not errs.seen, f"edge: errors off the main thread: {errs.seen[:4]}")
    fails.check(stalled == 0, f"edge: {stalled} frames stalled")
    eps = [res.events_per_s for res, _ in load["samples"]]
    committed = [events / s for _, s in load["samples"]]
    first = load["samples"][0][0]
    snap = load["snapshot"]
    out = {"phase": "edge", "schedule_fingerprint": wire_schedule_fingerprint(sched),
           "parity": {"frames": len(parity), "groups": groups,
                      "card_and_cpu_oracles_equal": True},
           "connections": first.connections, "events": events,
           "events_per_s_runs": eps, "events_per_s": statistics.median(eps),
           "committed_events_per_s_runs": committed,
           "committed_events_per_s": statistics.median(committed),
           "publish_p50_ms_runs": [r.publish_p50_ms for r, _ in load["samples"]],
           "publish_p99_ms_runs": [r.publish_p99_ms for r, _ in load["samples"]],
           "connect_s_runs": [r.connect_s for r, _ in load["samples"]],
           "kib_per_connection": first.per_connection_bytes / 1024,
           "flush_occupancy_pct": snap["flush_occupancy_pct"], "flushes": snap["flushes"],
           "request_response_events_per_s": load["rr_eps"], "request_response_cycles": rr,
           "staged_copy_rows": load["copies"], "wire_stage": load["wire_stage"],
           "kill": {"acked": sum(acked), "acked_by_connection": acked,
                    "replayed_payloads": len(replayed), "recovered_rows": recovered,
                    "warm_rows": len(warm)},
           "receivers": got["counts"], "dead_letter": len(got["dead"]),
           "frames_stalled": stalled, "thread_errors": len(errs.seen),
           "seconds": time.perf_counter() - t_phase, "config": config}
    emit(out, log)
    print(f"edge: {out['events_per_s']:.0f} events/s acked ({out['committed_events_per_s']:.0f} "
          f"committed) over {first.connections} live MQTT connections, QoS 1 "
          f"(median of {len(eps)}: {min(eps):.0f}..{max(eps):.0f}), publish p50 "
          f"{first.publish_p50_ms} ms p99 {first.publish_p99_ms} ms, connect "
          f"{first.connect_s} s, {out['kib_per_connection']:.1f} KiB a connection, flush "
          f"occupancy {snap['flush_occupancy_pct']} %; request-response "
          f"{load['rr_eps']:.0f} events/s; kill drill {sum(acked)} acked, all replayed; "
          f"5 broker receivers card = CPU; {out['seconds']:.1f} s", flush=True)
    return out


# the services phase: the entity and outbound services wired by hand over
# the slice engine's sizes (bench.py's headline engine), 10,000 devices
# under areas, customers and two device types, the read phase's 64 zones,
# 8 rounds of one location a device, 4096 command invocations and the
# connectors over one feed; the CPU leg runs rounds 1..2 in a process of
# its own while the card runs, and both are compared there
SERVICES_CONFIG = dict(device_capacity=1 << 15, token_capacity=1 << 16,
                       assignment_capacity=1 << 16, store_capacity=1 << 18,
                       batch_capacity=16384)
SERVICES_SPEC = dict(devices=10_000, rounds=8, checkpoint=2, invocations=4096,
                     batch_devices=16, walk=0.08)
# the mesh leg: tests/test_distributed.py:294 at 2048 devices over 2 shards
SERVICES_MESH = dict(n_shards=2, device_capacity_per_shard=2048,
                     token_capacity_per_shard=4096, assignment_capacity_per_shard=4096,
                     store_capacity_per_shard=8192, batch_capacity_per_shard=1024)
SERVICES_MESH_DEVICES = 2048
SERVICES_MESH_INVOCATIONS = 256
SERVICES_QUERIES = ("*:*", "type:ALERT", "type:LOCATION", "type:COMMAND_INVOCATION",
                    "deviceToken:dev-00042", "type:ALERT deviceToken:dev-00007",
                    "tenant:default type:LOCATION", "type:ALERT eventDateMs:[0 TO *]")
SERVICES_FROZEN_S = 1_750_000_000.0     # the entity and batch stamps, pinned
SERVICES_NOW_MS = 60_000                # the engines' pinned clock
SERVICES_TIMEOUT_S = 600.0              # the CPU leg's process


class PinnedServices:
    """While inside, the entity and batch stamps read one instant and the
    process-global invocation counter starts at 1: two runs of one stream
    stamp and number alike."""

    def __init__(self, P):
        self.P = P
        self.saved: list = []

    def __enter__(self):
        frozen = types.SimpleNamespace(time=lambda: SERVICES_FROZEN_S)
        for name, attr, value in (("management.entities", "time", frozen),
                                  ("management.batch", "time", frozen),
                                  ("commands.model", "_invocation_ids", itertools.count(1))):
            mod = self.P.mod(name)
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
        return self

    def __exit__(self, *exc) -> None:
        for mod, attr, value in reversed(self.saved):
            setattr(mod, attr, value)


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


def _leaf_digests(state) -> dict:
    """sha256 of every state leaf's bytes, with its dtype and shape."""
    return {name: f"{leaf.dtype}{tuple(leaf.shape)}:" + hashlib.sha256(
        leaf.detach().cpu().contiguous().numpy().tobytes()).hexdigest()
        for name, leaf in _state_leaves(state)}


def _service_mirrors(eng) -> dict:
    m = eng.metrics()
    return {"devices": {k: dataclasses.asdict(v) for k, v in eng.devices.items()},
            "assignments": {k: dataclasses.asdict(v) for k, v in eng.assignments.items()},
            "token_device": eng.token_device, "dead_letters": eng.dead_letters,
            "tokens": [eng.tokens.token(i) for i in range(len(eng.tokens))],
            "metrics": {k: m[k] for k in WIRE_CORE_METRICS if k in m}}


def services_positions(seed: int, n: int, rounds: int, walk: float) -> np.ndarray:
    """[rounds, n, 2] (lat, lon): a standard-normal start, where the read
    phase's zones lie, then a seeded random walk of step ``walk``."""
    rng = np.random.default_rng(seed + 31)
    start = rng.standard_normal((n, 2))
    walk = rng.normal(0.0, walk, (rounds, n, 2))
    return start[None] + np.cumsum(walk, axis=0)


def _location_json(token: str, lat: float, lon: float, ts_ms: int) -> bytes:
    return json.dumps({"deviceToken": token, "type": "DeviceLocation",
                       "request": {"latitude": lat, "longitude": lon, "elevation": 0.0,
                                   "eventDate": ts_ms}}).encode()


async def _drained(consumer, pump) -> list:
    """``pump()`` until a call leaves the consumer's offsets where they
    were: the feed is drained. Returns each call's result."""
    def offsets() -> list[int]:
        return [int(x) for x in np.ravel(consumer.offsets)]

    out = []
    while True:
        before = offsets()
        out.append(await pump())
        if offsets() == before:
            return out


class _PointSpy:
    """Wraps the zone monitor's ``points_in_zones``: where each call's
    points and zones lie, and how many points it took."""

    def __init__(self, zones_mod):
        self.mod, self.fn, self.calls = zones_mod, zones_mod.points_in_zones, []

    def __enter__(self):
        def spy(points, verts, valid):
            self.calls.append((str(points.device), str(verts.device), str(valid.device),
                               int(points.shape[0])))
            return self.fn(points, verts, valid)

        self.mod.points_in_zones = spy
        return self

    def __exit__(self, *exc) -> None:
        self.mod.points_in_zones = self.fn


async def _services_leg(device, seed: int, config: dict, spec: dict, rounds: int) -> dict:
    """One run of the services stream on ``device`` through round
    ``rounds``: the answers at round ``spec["checkpoint"]`` and the run's
    timings and counters."""
    P = _parity.service_namespace("sitewhere_tpu_torch")
    n = spec["devices"]
    tokens = [f"dev-{i:05d}" for i in range(n)]
    sites = [f"site-{r}-{k}" for r in range(4) for k in range(4)]
    t = {}
    with PinnedServices(P):
        eng = Engine(EngineConfig(**config), device=device)
        eng.epoch = PinnedEpoch(1e9, now_ms=SERVICES_NOW_MS)
        s = _parity.wire_services(P, eng, index_events=False)
        dm, zm = s.device_management, s.zone_monitor
        dm.create_area_type("region", "Region", contained_area_types=["site"])
        dm.create_area_type("site", "Site")
        dm.create_customer_type("org", "Organization")
        for r in range(4):
            dm.create_area(f"region-{r}", "region", f"Region {r}")
            for k in range(4):
                dm.create_area(f"site-{r}-{k}", "site", f"Site {r}.{k}",
                               parent_token=f"region-{r}")
        for c in range(8):
            dm.create_customer(f"cust-{c}", "org", f"Customer {c}",
                               parent_token=None if c < 2 else f"cust-{c % 2}")
        dm.create_device_type("meter", "Meter")
        dm.create_device_type("tracker", "Tracker")
        for i, bounds in enumerate(read_zones(seed)):
            dm.create_zone(f"zone-{i:02d}", sites[i % 16], f"Zone {i}", bounds=bounds)
        t0 = time.perf_counter()
        for i, tok in enumerate(tokens):
            dm.create_device(tok, "meter" if i % 2 else "tracker", area=sites[i % 16],
                             customer=f"cust-{i % 8}")
        _sync(device)
        t["create_s"] = time.perf_counter() - t0

        # the connectors read the feed from its start
        sink = P.InMemoryConnector("sink", filters=[
            P.DeviceTypeFilter(eng, ["meter"], "include"),
            P.AreaFilter([eng.areas.lookup(a) for a in sites[:4]], "include")])
        hosts = [P.ConnectorHost(eng, sink),
                 P.ConnectorHost(eng, P.SearchIndexConnector("search", s.search_index))]
        t["connector_s"], t["connector_events"] = 0.0, 0

        async def pump_connectors() -> None:
            t0 = time.perf_counter()
            for h in hosts:
                before = int(np.sum(h.consumer.offsets))
                await _drained(h.consumer, h.pump)
                t["connector_events"] += int(np.sum(h.consumer.offsets)) - before
            t["connector_s"] += time.perf_counter() - t0

        # commands: meters through the local destination, trackers over MQTT
        local = P.LocalDeliveryProvider()
        broker = P.MqttBroker()
        await broker.start()
        got_mqtt: list = []
        sub = P.MqttClient("127.0.0.1", broker.bound_port, "services-devices")
        await sub.connect()
        sub.on_message = lambda topic, payload: got_mqtt.append((topic, payload))
        await sub.subscribe("sitewhere/commands/#", 1)
        cmd = s.commands
        cmd.add_destination(P.CommandDestination(
            "local", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(), local))
        cmd.add_destination(P.CommandDestination(
            "mqtt", P.mqtt_topic_extractor(), P.BinaryCommandExecutionEncoder(),
            P.MqttDeliveryProvider("127.0.0.1", broker.bound_port)))
        cmd.router = P.DeviceTypeMappingCommandRouter({"meter": "local", "tracker": "mqtt"})
        cmd.registry.create(P.DeviceCommand(
            token="reboot", device_type="meter", name="reboot",
            parameters=(P.CommandParameter("delay", P.ParameterType.INT64, required=True),)))
        cmd.registry.create(P.DeviceCommand(token="locate", device_type="tracker",
                                            name="locate"))
        t0 = time.perf_counter()
        invs = [cmd.invoke(tokens[k % n], "reboot", {"delay": k % 60}) if k % 2
                else cmd.invoke(tokens[k % n], "locate") for k in range(spec["invocations"])]
        local.fail = True                  # the first pump finds the local sink down
        pumped = [await cmd.pump()]
        local.fail = False
        undelivered = len(cmd.undelivered)
        pumped += await _drained(cmd.consumer, cmd.pump)
        retry = await cmd.retry_undelivered()
        want_mqtt = sum(1 for k in range(spec["invocations"]) if k % 2 == 0)
        for _ in range(1000):
            if len(got_mqtt) >= want_mqtt:
                break
            await asyncio.sleep(0.005)
        t["command_s"] = time.perf_counter() - t0
        t["delivered"] = cmd.delivered_count

        # batch operations and one scheduled job on an injected clock
        meters = tokens[1:2 * spec["batch_devices"]:2]
        s.batch.create_operation("op-reboot", "InvokeCommand", meters,
                                 {"commandToken": "reboot", "parameterValues": {"delay": 5}})
        op = await s.batch.process_operation("op-reboot")
        s.batch.create_operation("op-bad", "InvokeCommand", meters[:4],
                                 {"commandToken": "nope"})
        bad = await s.batch.process_operation("op-bad")
        s.scheduler.create_schedule("every-10s", "Every 10 s", "Simple", interval_s=10.0,
                                    repeat_count=1)
        s.scheduler.create_job("job-locate", "every-10s", "CommandInvocation",
                               {"deviceToken": tokens[0], "commandToken": "locate"})
        at = SERVICES_FROZEN_S * 1000
        fired = [await s.scheduler.fire_due(at + dt) for dt in (0, 5_000, 10_000, 20_000)]
        want_mqtt += sum(fired)
        await pump_connectors()

        # rounds of one location a device, the zone monitor pumped to the end
        alerts: list = []
        raise_alert = zm._alert

        def _alert(token, kind, zone):
            alerts.append((token, kind, zone))
            raise_alert(token, kind, zone)

        zm._alert = _alert
        positions = services_positions(seed, n, spec["rounds"], spec["walk"])
        base_ms = int(1e12)
        t["zone_s"], raised, checkpoint = 0.0, [], None
        for r in range(rounds):
            eng.ingest_json_batch([_location_json(tok, float(positions[r, i, 0]),
                                                  float(positions[r, i, 1]),
                                                  base_ms + 1_000 * (r + 1))
                                   for i, tok in enumerate(tokens)])
            eng.flush()
            t0 = time.perf_counter()
            raised.append(await _drained(zm.consumer, zm.pump))
            _sync(device)
            t["zone_s"] += time.perf_counter() - t0
            await pump_connectors()
            if r + 1 == spec["checkpoint"]:
                for _ in range(1000):
                    if len(got_mqtt) >= want_mqtt:
                        break
                    await asyncio.sleep(0.005)
                eng.flush()
                checkpoint = {
                    "alerts": list(alerts), "raised": [list(x) for x in raised],
                    "membership": {d: sorted(z) for d, z in zm.membership.items()},
                    "local": list(local.delivered), "mqtt": sorted(got_mqtt),
                    "first_pump_undelivered": undelivered, "retry": retry,
                    "pumped": pumped, "invocations": _parity.plain(invs[:64]),
                    "undelivered": _parity.plain(cmd.undelivered),
                    "batch": _parity.plain([op, bad, s.batch.failed_elements]),
                    "fired": fired, "job": _parity.plain(s.scheduler.jobs.get("job-locate")),
                    "sink": _parity.plain(sink.events),
                    "search": {q: [s.search_index.search(q, 100),
                                   s.search_index.search(q, 50, order="id")]
                               for q in SERVICES_QUERIES},
                    "summaries": _parity.plain([dm.get_device_summary(tok)
                                                for tok in tokens[::97]]),
                    "listing": _parity.plain(dm.list_devices(page=3, page_size=50,
                                                             device_type="meter")),
                    "trees": _parity.plain([dm.area_tree(), dm.customer_tree()]),
                    # labels: the QR matrix only (the card machine has no PIL)
                    "qr": P.qr_matrix(f"sitewhere://sitewhere-tpu/device/{tokens[0]}"),
                    "state": _leaf_digests(eng.state),
                    "mirrors": _digest(_service_mirrors(eng))}
        t0 = time.perf_counter()
        search_ms = {}
        for q in SERVICES_QUERIES:
            t1 = time.perf_counter()
            s.search_index.search(q, 100)
            search_ms[q] = (time.perf_counter() - t1) * 1e3
        t["search_s"] = time.perf_counter() - t0
        eng.flush()
        _sync(device)
        stored_alerts = eng.query_events(etype=EventType.ALERT, limit=1)["total"]
        await sub.disconnect()
        for dest in cmd.destinations.values():
            await dest.stop()
        await broker.stop()
    return {"checkpoint": checkpoint, "timings": t, "search_ms": search_ms,
            "raised": raised, "alerts": len(alerts), "stored_alerts": stored_alerts,
            "zone_stats": dict(zm.stats), "verts": str(zm._verts.device),
            "valid": str(zm._valid.device), "mqtt": len(got_mqtt), "want_mqtt": want_mqtt,
            "local": len(local.delivered), "undelivered_first_pump": undelivered,
            "retry": retry, "sink_events": len(sink.events),
            "index_docs": len(s.search_index.docs), "batch_counts": op.counts(),
            "fired": fired, "events": eng.metrics()["persisted"]}


def services_leg(device, seed: int, config: dict = SERVICES_CONFIG,
                 spec: dict = SERVICES_SPEC, rounds: int | None = None) -> dict:
    """The services stream on ``device`` (see ``phase_services``)."""
    return asyncio.run(_services_leg(torch.device(device), seed, config, spec,
                                     spec["rounds"] if rounds is None else rounds))


async def _mesh_leg(device, seed: int, config: dict, n_devices: int, n_inv: int) -> dict:
    from sitewhere_tpu_torch.parallel.distributed import DistributedFeedConsumer

    P = _parity.service_namespace("sitewhere_tpu_torch")
    with PinnedServices(P):
        eng = _dist_engine(device, **config)
        rng = np.random.default_rng(seed + 37)
        temps = rng.normal(20.0, 5.0, n_devices)
        for lo in range(0, n_devices, 1024):
            eng.ingest_json_batch([json.dumps({
                "deviceToken": f"mesh-{i:05d}", "type": "DeviceMeasurements",
                "request": {"measurements": {"temp.celsius": float(temps[i])}}}).encode()
                for i in range(lo, min(lo + 1024, n_devices))])
        eng.flush()
        feed = DistributedFeedConsumer(eng, "grp", max_batch=1 << 16)
        evs = feed.poll()
        feed.commit(evs)
        again = feed.poll()
        svc = P.CommandDeliveryService(eng, P.SingleChoiceCommandRouter("local"))
        svc.registry.create(P.DeviceCommand(token="ping", device_type="default",
                                            name="ping"))
        local = P.LocalDeliveryProvider()
        svc.add_destination(P.CommandDestination(
            "local", P.mqtt_topic_extractor(), P.JsonCommandExecutionEncoder(), local))
        t0 = time.perf_counter()
        invs = [svc.invoke(f"mesh-{i:05d}", "ping")
                for i in range(0, n_devices, max(1, n_devices // n_inv))]
        eng.flush()
        pumped = await _drained(svc.consumer, svc.pump)
        seconds = time.perf_counter() - t0
        return {"answers": {"events": _parity.plain(evs), "again": len(again),
                            "invocations": _parity.plain(invs), "pumped": pumped,
                            "delivered": list(local.delivered),
                            "state": _leaf_digests(eng.state),
                            "mirrors": _digest(_service_mirrors(eng))},
                "seconds": seconds, "delivered": svc.delivered_count,
                "devices": [str(st.device_state.presence.device) for st in eng.shards]}


def services_mesh_leg(device, seed: int, config: dict = SERVICES_MESH,
                      n_devices: int = SERVICES_MESH_DEVICES,
                      n_inv: int = SERVICES_MESH_INVOCATIONS) -> dict:
    return asyncio.run(_mesh_leg(torch.device(device), seed, config, n_devices, n_inv))


def services_cpu_legs(seed: int, config: dict, spec: dict, mesh: dict, mesh_devices: int,
                      mesh_invocations: int) -> dict:
    """The CPU legs, in a process of their own: the main stream through
    round ``spec["checkpoint"]`` and the mesh leg."""
    torch.set_num_threads(4)
    logging.getLogger("sitewhere_tpu_torch.commands.service").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    main = services_leg("cpu", seed, config, spec, rounds=spec["checkpoint"])
    t1 = time.perf_counter()
    mesh_out = services_mesh_leg("cpu", seed, mesh, mesh_devices, mesh_invocations)
    return {"checkpoint": main["checkpoint"], "mesh": mesh_out["answers"],
            "main_s": t1 - t0, "mesh_s": time.perf_counter() - t1}


def _differing(a: dict, b: dict) -> list[str]:
    """Keys of two answer dicts whose values differ (state leaves by name)."""
    out = []
    for k in sorted(set(a) | set(b)):
        if k == "state" and isinstance(a.get(k), dict) and isinstance(b.get(k), dict):
            out += [f"state.{n}" for n in sorted(set(a[k]) | set(b[k]))
                    if a[k].get(n) != b[k].get(n)]
        elif a.get(k) != b.get(k):
            out.append(k)
    return out


def phase_services(device, log, fails, seed: int, config: dict = SERVICES_CONFIG,
                   spec: dict = SERVICES_SPEC, mesh: dict = SERVICES_MESH,
                   mesh_devices: int = SERVICES_MESH_DEVICES,
                   mesh_invocations: int = SERVICES_MESH_INVOCATIONS) -> dict:
    """The entity and outbound services over the card engine, wired by hand
    as the JAX instance wires them: ``spec["devices"]`` devices created
    through ``DeviceManagement.create_device`` under 16 sites of 4 regions,
    8 customers in trees and two device types; the read phase's 64 zones;
    ``spec["invocations"]`` command invocations (meters to a local
    destination, trackers over MQTT on the port's broker; the local sink
    down for the first pump, the undelivered retried once); a batch
    operation, a failing one and a scheduled job fired on an injected
    clock; ``spec["rounds"]`` rounds of one location a device through the
    native decoder, the ``ZoneMonitor`` pumped until the feed drains; a
    ``ConnectorHost`` with an ``InMemoryConnector`` behind a device-type
    and an area filter and a ``SearchIndexConnector`` over the same feed,
    and a fixed set of searches. (a) A CPU engine with the same services
    runs the stream through round ``spec["checkpoint"]`` in a process of
    its own while the card runs; at that round alerts and their order,
    deliveries (payload bytes), connector outputs, search answers, batch
    elements, summaries, trees, every state leaf and the mirrors must be
    identical. (b) The zones and every pump's points lie on the card and a
    pump with points makes one device-to-host copy. (c) The mesh engine:
    a 2-shard ``DistributedEngine`` on the card with a
    ``DistributedFeedConsumer`` and a ``CommandDeliveryService`` against
    the same on the CPU. (d) ms a ``create_device``, ms a zone pump and
    points x zones a second, invocations delivered a second, connector
    events a second, ms a search."""
    import concurrent.futures
    import multiprocessing

    from sitewhere_tpu_torch.outbound import zones as zones_mod

    # the first pump's parked deliveries each log a warning
    logging.getLogger("sitewhere_tpu_torch.commands.service").setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    threads = sorted(t.name for t in threading.enumerate())   # left by earlier phases
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        host = pool.submit(services_cpu_legs, seed, config, spec, mesh, mesh_devices,
                           mesh_invocations)
        t0 = time.perf_counter()
        with _PointSpy(zones_mod) as spy:
            card = services_leg(str(device), seed, config, spec)
        card_s = time.perf_counter() - t0
        card_mesh = services_mesh_leg(str(device), seed, mesh, mesh_devices,
                                      mesh_invocations)
        cpu = host.result(timeout=SERVICES_TIMEOUT_S)
    wait_s = time.perf_counter() - t0 - card_s - card_mesh["seconds"]
    dev = str(device)
    # (a) the card against the CPU at the checkpoint round
    differ = _differing(cpu["checkpoint"], card["checkpoint"])
    fails.check(not differ, f"services: (a) the card leg differs from the CPU leg at round "
                            f"{spec['checkpoint']}: {differ[:12]}")
    mesh_differ = _differing(cpu["mesh"], card_mesh["answers"])
    fails.check(not mesh_differ, f"services: (c) the mesh engine on the card differs from "
                                 f"the CPU's: {mesh_differ[:12]}")
    # the run's own checks
    fails.check(card["alerts"] > 0 and sum(map(sum, card["raised"])) == card["alerts"]
                == card["stored_alerts"],
                f"services: alerts raised {card['alerts']}, counted a pump "
                f"{sum(map(sum, card['raised']))}, stored {card['stored_alerts']}")
    fails.check(card["mqtt"] == card["want_mqtt"] and card["retry"]["stillUndelivered"] == 0
                and card["undelivered_first_pump"] > 0,
                f"services: MQTT deliveries {card['mqtt']} of {card['want_mqtt']}, first pump "
                f"parked {card['undelivered_first_pump']}, retry {card['retry']}")
    fails.check(card["batch_counts"].get("SUCCEEDED") == spec["batch_devices"]
                and card["fired"] == [1, 0, 1, 0],
                f"services: batch {card['batch_counts']}, schedule fires {card['fired']}")
    # the filtered sink took meters (odd devices) of region 0's sites only
    sink_idx = [int(e["device_token"][4:]) for e in card["checkpoint"]["sink"]]
    fails.check(bool(sink_idx) and all(i % 2 == 1 and i % 16 < 4 for i in sink_idx),
                f"services: the filtered connector took {len(sink_idx)} events, not only "
                f"meters of region 0")
    # (b) placement: every pump's points and the zones on the card, one copy a pump
    stats = card["zone_stats"]
    on_card = all(p == v == z == dev for p, v, z, _ in spy.calls)
    fails.check(on_card and card["verts"] == card["valid"] == dev,
                f"services: (b) zone arrays on {card['verts']}/{card['valid']}, points "
                f"{sorted(set(c[:3] for c in spy.calls))[:4]}, not {dev}")
    fails.check(stats["syncs"] == len(spy.calls) and stats["points"]
                == sum(c[3] for c in spy.calls) > 0,
                f"services: (b) {stats['syncs']} device-to-host copies for {len(spy.calls)} "
                f"evaluations ({stats})")
    fails.check(all(d == dev for d in card_mesh["devices"]),
                f"services: (c) mesh shards on {card_mesh['devices']}, not {dev}")
    t = card["timings"]
    zone_pumps = sum(len(x) for x in card["raised"])
    out = {"phase": "services", "config": config, "spec": spec,
           "cpu_cut": f"the CPU leg ran rounds 1..{spec['checkpoint']} of {spec['rounds']} "
                      f"(every step before the rounds whole); card and CPU compared there",
           "identical_at_checkpoint": not differ, "mesh_identical": not mesh_differ,
           "create_device_ms": t["create_s"] * 1e3 / spec["devices"],
           "zone_pump_ms": t["zone_s"] * 1e3 / zone_pumps, "zone_pumps": zone_pumps,
           "point_zones_per_s": stats["point_zones"] / t["zone_s"],
           "points": stats["points"], "zone_syncs": stats["syncs"],
           "alerts": card["alerts"],
           "invocations_per_s": t["delivered"] / t["command_s"],
           "invocations_delivered": t["delivered"], "mqtt_deliveries": card["mqtt"],
           "local_deliveries": card["local"], "retry": card["retry"],
           "connector_events_per_s": t["connector_events"] / t["connector_s"],
           "connector_events": t["connector_events"], "sink_events": card["sink_events"],
           "index_docs": card["index_docs"], "search_ms": card["search_ms"],
           "search_ms_median": statistics.median(card["search_ms"].values()),
           "events": card["events"],
           "mesh": {"shards": mesh["n_shards"], "devices": mesh_devices,
                    "invocations_per_s": card_mesh["delivered"] / card_mesh["seconds"],
                    "delivered": card_mesh["delivered"]},
           "card_leg_s": card_s, "mesh_leg_s": card_mesh["seconds"],
           "cpu_leg_s": cpu["main_s"] + cpu["mesh_s"], "cpu_wait_s": max(0.0, wait_s),
           "seconds": time.perf_counter() - t_phase}
    if device.type == "cuda":
        out["card"] = card_line()
    emit(out, log)
    print(f"services: {out['create_device_ms']:.3f} ms a create_device, zone pump "
          f"{out['zone_pump_ms']:.2f} ms ({out['point_zones_per_s']:.3g} point-zones/s, "
          f"{out['alerts']} alerts), {out['invocations_per_s']:.0f} invocations/s, "
          f"{out['connector_events_per_s']:.0f} connector events/s, search "
          f"{out['search_ms_median']:.2f} ms; card = CPU at round {spec['checkpoint']}; "
          f"mesh card = CPU; {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ servers
# the instance at the slice engine's sizes (bench.py:100-104), its analytics
# table at the slice phase's 8192 devices x 128 steps x 100 channels
SERVERS_CONFIG = dict(SLICE_CONFIG)
SERVERS_SPEC = dict(devices=2048, batch_rounds=8, batch_rows=16384, batch_names=8,
                    batch_devices=1024, checkpoint=2, invocations=32, states=64,
                    zone_points=2, rpc_devices=64, rpc_events=128,
                    # the second load cut from 32 x 200 to 32 x 64 so the
                    # script stays inside its time limit beside the D = 256
                    # attention checks (on one H100 machine the phase took
                    # 334 s at 32 x 200, on another 119 s at 32 x 64)
                    loads=((5, 100), (32, 64)), train_batch=256,
                    # before the checkpoint (the CPU leg runs these too: a
                    # single-event flush of this engine takes ~0.35 s there)
                    cpu_invocations=16, cpu_rpc_devices=16, cpu_rpc_events=32)
SERVERS_BODY_LIMIT = 1 << 20    # aiohttp's client_max_size, which the gateway keeps
SERVERS_MASK = frozenset({"trace_id", "traceId", "authToken", "auth_token",
                          "port", "backend", "deviceCount"})
SERVERS_TIMEOUT_S = 600.0       # the CPU leg's process
SERVERS_DEFAULT_CFG = {
    "eventSources": [{"id": "sock", "type": "socket", "port": 0,
                      "decoder": {"type": "json"}}],
    "outboundConnectors": [{"id": "sink", "type": "inmemory"}],
    "commandRouting": {"router": {"type": "single-choice", "destination": "local-dest"},
                       "destinations": [{"id": "local-dest", "type": "local",
                                         "encoder": {"type": "json"}}]}}
# the hot reload: the source takes alternate-id dedup, the sink a filter
SERVERS_RELOADED_CFG = {
    **SERVERS_DEFAULT_CFG,
    "eventSources": [dict(SERVERS_DEFAULT_CFG["eventSources"][0],
                          deduplicator={"type": "alternate-id"})],
    "outboundConnectors": [{"id": "sink", "type": "inmemory",
                            "filters": [{"type": "device-type", "deviceTypes": ["meter"],
                                         "operation": "include"}]}]}
_JWT_RE = re.compile(r"^eyJ[\w-]+\.[\w-]+\.[\w-]+$")


class PinnedServers(PinnedServices):
    """``PinnedServices``, and the pins of ``tests/torch_parity.server_pins``
    (the schedule, auth, tenant and script clocks at one instant, fixed JWT
    secret, salts and tenant tokens, ``uuid.uuid4`` counting from 1): two
    runs of one request script answer alike."""

    def __enter__(self):
        super().__enter__()
        ids = itertools.count(1)
        for mod, attr, value in _parity.server_pins(self.P, SERVICES_FROZEN_S,
                                                    lambda: next(ids)):
            self.saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, value)
        return self


def servers_mask(x):
    """``x`` with the named fields (``SERVERS_MASK``: JWTs and tenant auth
    tokens, trace ids, ports, the backend and the device count) and any
    JWT string replaced by ``"<masked>"``."""
    if isinstance(x, dict):
        return {k: "<masked>" if k in SERVERS_MASK else servers_mask(v)
                for k, v in x.items()}
    if isinstance(x, list):
        return [servers_mask(v) for v in x]
    if isinstance(x, str) and _JWT_RE.match(x):
        return "<masked>"
    return x


def servers_rows(rnd: int, spec: dict) -> list[dict]:
    """Round ``rnd`` of the batch ingest: ``batch_rows`` DeviceMeasurements
    envelopes of ``batch_names`` channels over the first ``batch_devices``
    devices, seeded by the round, binary halves only (sums are exact)."""
    rng = np.random.default_rng(1000 + rnd)
    n, k = spec["batch_rows"], spec["batch_names"]
    vals = np.round(rng.normal(20.0, 5.0, (n, k)) * 2) / 2
    devs = np.arange(n) % spec["batch_devices"]
    return [{"deviceToken": f"srv-{int(d):05d}", "type": "DeviceMeasurements",
             "request": {"measurements": {f"m{j}": float(v[j]) for j in range(k)},
                         "eventDate": 1_000_000_000_000 + rnd * 1000 + i // 1024}}
            for i, (d, v) in enumerate(zip(devs, vals))]


def _body_chunks(rows: list[dict], limit: int = SERVERS_BODY_LIMIT) -> list[bytes]:
    """``rows`` as JSON array bodies, each under the gateway's body limit."""
    out, cur, size = [], [], 2
    for r in rows:
        b = json.dumps(r).encode()
        if cur and size + len(b) + 1 > limit:
            out.append(b"[" + b",".join(cur) + b"]")
            cur, size = [], 2
        cur.append(b)
        size += len(b) + 1
    out.append(b"[" + b",".join(cur) + b"]")
    return out


def _feed_heads(eng) -> int:
    eng.flush()
    store = eng.state.store
    return sum(arena_cursor(store, a) for a in range(store.arenas))


async def _pumped(inst, timeout_s: float = 120.0) -> None:
    """Wait until the server's pump loop has taken every persisted event
    through command delivery, the zone monitor and every connector host."""
    consumers = [inst.commands.consumer, inst.zone_monitor.consumer] + [
        h.consumer for h in inst.connector_hosts]
    t0 = time.perf_counter()
    while True:
        head = _feed_heads(inst.engine)
        if all(c.offset >= head for c in consumers):
            return
        if time.perf_counter() - t0 > timeout_s:
            raise TimeoutError(f"pumps stuck at {[c.offset for c in consumers]} of {head}")
        await asyncio.sleep(0.02)


class _Gateway:
    """One leg's view of its gateway: every call's (step, method, path,
    status, masked body) in ``log``; ``problems`` collects failed checks."""

    def __init__(self, base: str, session, log: list, problems: list):
        self.base, self.session, self.log, self.problems = base, session, log, problems
        self.jwt = None

    async def call(self, step: str, method: str, path: str, body=None, *, keep=None,
                   expect: int | None = 200, headers=None, params=None, data=None,
                   record: bool = True):
        h = {"Authorization": f"Bearer {self.jwt}"} if self.jwt else {}
        h.update(headers or {})
        r = await self.session.request(method, self.base + path, json=body, data=data,
                                       headers=h, params=params)
        ct = r.headers.get("Content-Type", "")
        doc = json.loads(r.body) if ct.startswith("application/json") else r.body
        if record:
            seen = keep(doc) if keep is not None else doc
            self.log.append((step, method, path, r.status, ct,
                             servers_mask(_parity.plain(seen))
                             if not isinstance(seen, bytes) else seen.decode()))
        if expect is not None and r.status != expect:
            self.problems.append(f"{step}: {method} {path} answered {r.status}, not "
                                 f"{expect}: {r.body[:200]!r}")
        return r.status, doc


def _families(text: bytes) -> list[str]:
    return sorted(set(re.findall(r"^# TYPE (\S+)", text.decode(), re.M)))


async def _servers_leg(device, seed: int, config: dict, spec: dict, full: bool) -> dict:
    from sitewhere_tpu_torch.instance.instance import InstanceConfig, SiteWhereTpuInstance
    from sitewhere_tpu_torch.loadgen import run_rest_load
    from sitewhere_tpu_torch.rpc.server import build_instance_rpc
    from sitewhere_tpu_torch.web import http
    from sitewhere_tpu_torch.web.rest import start_server

    P = _parity.service_namespace("sitewhere_tpu_torch")
    log, problems, t, out = [], [], {}, {}
    n = spec["devices"]
    tokens = [f"srv-{i:05d}" for i in range(n)]
    zones = read_zones(seed)
    with PinnedServers(P):
        inst = SiteWhereTpuInstance(InstanceConfig(engine=EngineConfig(**config),
                                                   conservation_audit_s=0), device=device)
        inst.engine.epoch = PinnedEpoch(1e9, now_ms=SERVICES_NOW_MS)
        # the background analytics loop stays off (it would train and raise
        # alerts at times of its own); the routes drive the service
        service, inst.analytics = inst.analytics, None
        server = await start_server(inst)
        inst.analytics = service
        rpc = build_instance_rpc(inst)
        rpc_port = await rpc.start()
        session = http.ClientSession()
        gw = _Gateway(f"http://127.0.0.1:{server.port}", session, log, problems)
        gw.rpc_port = rpc_port
        zone_calls = []
        try:
            # --- auth and admin
            basic = base64.b64encode(b"admin:password").decode()
            _, body = await gw.call("auth", "GET", "/api/authapi/jwt",
                                    headers={"Authorization": f"Basic {basic}"})
            gw.jwt = body["token"]
            bad = base64.b64encode(b"admin:wrong").decode()
            await gw.call("auth", "GET", "/api/authapi/jwt", expect=401,
                          headers={"Authorization": f"Basic {bad}"})
            await gw.call("auth", "GET", "/api/devices", expect=401,
                          headers={"Authorization": "Bearer x.y.z"})
            _, templates = await gw.call("admin", "GET", "/api/tenants/templates/configuration")
            await gw.call("admin", "GET", "/api/tenants/templates/dataset")
            await gw.call("admin", "POST", "/api/tenants", expect=201, body={
                "token": "acme", "name": "ACME", "datasetTemplate": "construction"})
            tpl = next(x for x in templates if x["id"] == "default")
            await gw.call("admin", "POST",
                          "/api/microservices/event-sources/tenants/acme/configuration",
                          {"configuration": tpl["configuration"]})
            await gw.call("admin", "POST", "/api/areatypes", {"token": "region", "name": "R"},
                          expect=201)
            for a in range(4):
                await gw.call("admin", "POST", "/api/areas", expect=201, body={
                    "token": f"region-{a}", "areaTypeToken": "region", "name": f"R{a}"})
            await gw.call("admin", "POST", "/api/customertypes", expect=201,
                          body={"token": "fleet", "name": "Fleet"})
            for c in range(8):
                await gw.call("admin", "POST", "/api/customers", expect=201, body={
                    "token": f"cust-{c}", "customerTypeToken": "fleet", "name": f"C{c}"})
            for dt in ("meter", "tracker"):
                await gw.call("admin", "POST", "/api/devicetypes", expect=201,
                              body={"token": dt, "name": dt.title()})
            await gw.call("admin", "POST", "/api/devicetypes/meter/commands", expect=201,
                          body={"token": "ping", "name": "ping"})
            t0 = time.perf_counter()
            for i, tok in enumerate(tokens):
                await gw.call("admin", "POST", "/api/devices", expect=201, body={
                    "token": tok, "deviceTypeToken": "meter" if i % 2 else "tracker",
                    "areaToken": f"region-{i % 4}", "customerToken": f"cust-{i % 8}"},
                    record=i < 64)
            t["create_s"] = time.perf_counter() - t0
            cfg_url = "/api/microservices/event-sources/tenants/default/configuration"
            await gw.call("config", "POST", cfg_url, {"configuration": SERVERS_DEFAULT_CFG})
            await gw.call("config", "POST", cfg_url, {"configuration": SERVERS_RELOADED_CFG})
            await gw.call("config", "POST", cfg_url, expect=400, body={
                "configuration": {"eventSources": [{"id": "sock", "type": "bogus"}]}})
            await gw.call("config", "GET", cfg_url)
            # --- ingest: the batch rounds through the checkpoint
            rounds = spec["batch_rounds"] if full else spec["checkpoint"]
            t["batch_s"], t["batch_rows"] = 0.0, 0
            for rnd in range(rounds):
                if rnd == spec["checkpoint"]:
                    out["checkpoint"] = await _servers_checkpoint(inst, gw, spec, zones,
                                                                  zone_calls, t)
                    await _servers_timed(inst, gw, spec, t)
                chunks = _body_chunks(servers_rows(rnd, spec))
                t0 = time.perf_counter()
                for chunk in chunks:
                    await gw.call(f"batch{rnd}", "POST", "/api/events/batch", data=chunk,
                                  expect=201, headers={"Content-Type": "application/json"},
                                  keep=lambda b: {k: v for k, v in b.items()
                                                  if k != "trace_id"})
                t["batch_s"] += time.perf_counter() - t0
                t["batch_rows"] += spec["batch_rows"]
                t["batch_posts"] = len(chunks)
            if "checkpoint" not in out:
                out["checkpoint"] = await _servers_checkpoint(inst, gw, spec, zones,
                                                              zone_calls, t)
            if full:
                # --- the REST load and the analytics routes, once the
                # pumps have indexed the batch rounds
                await _pumped(inst)
                loads = []
                for workers, msgs in spec["loads"]:
                    stats = await run_rest_load(gw.base, gw.jwt, n_workers=workers,
                                                msgs_per_worker=msgs,
                                                device_prefix=f"rest-{workers}")
                    loads.append(dict(stats.to_dict(), workers=workers, msgs=msgs))
                    if stats.events_failed:
                        problems.append(f"rest load {workers}x{msgs}: "
                                        f"{stats.events_failed} failed posts")
                out["loads"] = loads
                out["analytics"] = await _servers_analytics(inst, gw, spec, t)
            out["state"] = _leaf_digests(inst.engine.state)
            out["mirrors"] = _digest(_service_mirrors(inst.engine))
            out["placement"] = {"engine": str(inst.engine.device),
                                "state": sorted({str(x.device) for _, x in
                                                 _state_leaves(inst.engine.state)})}
        finally:
            await session.close()
            await rpc.stop()
            await server.cleanup()
    out.update(problems=problems, timings=t, zone_calls=zone_calls,
               sink=len(inst.connector_hosts[-1].connector.events)
               if inst.connector_hosts else 0)
    return out


async def _servers_checkpoint(inst, gw, spec, zones, zone_calls: list, t: dict) -> dict:
    """The rest of the script up to the checkpoint: commands, reads, zones,
    search, the instance documents and the RPC mix. Returns the log so far,
    the state digests and the mirrors."""
    from sitewhere_tpu_torch.ops import geofence

    n = spec["devices"]
    # --- commands: invocations over REST, delivered by the server's pump loop
    await _servers_commands(inst, gw, 0, spec["cpu_invocations"])
    await gw.call("commands", "GET", "/api/invocations/1")
    # --- reads
    await gw.call("reads", "GET", "/api/events", params={"pageSize": "100"})
    for i in range(0, n, n // spec["states"]):
        await gw.call("reads", "GET", f"/api/devices/srv-{i:05d}/state",
                      expect=None)
        await gw.call("reads", "GET", f"/api/devices/srv-{i:05d}/events",
                      params={"pageSize": "16"})
    await gw.call("reads", "POST", "/api/devicestates/search",
                  {"deviceTokens": [f"srv-{i:05d}" for i in range(0, 64)]})
    await gw.call("reads", "GET", "/api/devices", params={"pageSize": "50"})
    await gw.call("reads", "GET", "/api/areas/tree")
    # --- zones: the read phase's 64, each asked for its centre and a far point
    for z, poly in enumerate(zones):
        await gw.call("zones", "POST", "/api/zones", expect=201, body={
            "token": f"zone-{z}", "areaToken": f"region-{z % 4}", "name": f"Z{z}",
            "bounds": [{"latitude": la, "longitude": lo} for la, lo in poly]})
    real = geofence.points_in_zones

    def spy(points, verts, valid):
        zone_calls.append((str(points.device), str(verts.device), str(valid.device)))
        return real(points, verts, valid)

    geofence.points_in_zones = spy
    t0 = time.perf_counter()
    try:
        for z, poly in enumerate(zones):
            lat = sum(p[0] for p in poly) / len(poly)
            lon = sum(p[1] for p in poly) / len(poly)
            for la, lo in ((lat, lon), (lat + 10.0, lon))[:spec["zone_points"]]:
                await gw.call("zones", "GET", f"/api/zones/zone-{z}/contains",
                              params={"latitude": repr(la), "longitude": repr(lo)})
    finally:
        geofence.points_in_zones = real
    t["zone_s"] = time.perf_counter() - t0
    t["zone_calls"] = len(zones) * spec["zone_points"]
    # --- search, after the index connector has taken every event
    await _pumped(inst)
    t0 = time.perf_counter()
    for q in ("*:*", "type:COMMAND_INVOCATION", "deviceToken:srv-00042"):
        await gw.call("search", "GET", "/api/search/events", params={"q": q})
    t["search_s"] = (time.perf_counter() - t0) / 3
    # --- the instance documents
    _, t["version"] = await gw.call("instance", "GET", "/api/system/version")
    await gw.call("instance", "GET", "/api/instance/metrics/prometheus",
                  keep=lambda b: [f for f in _families(b)
                                  if f.startswith("swtpu_engine_")])
    await gw.call("instance", "GET", "/api/instance/device/memory",
                  keep=lambda b: sorted(b["components"]))
    await gw.call("instance", "GET", "/api/instance/conservation",
                  keep=lambda b: [b["balanced"], b["ledger"]["stages"]])
    await gw.call("instance", "GET", "/api/instance/debug/bundle", keep=sorted)
    # --- the RPC mix
    answers, _, _ = await _servers_rpc(inst, gw, "rpc", spec["cpu_rpc_devices"],
                                       spec["cpu_rpc_events"])
    gw.log.append(("rpc", answers))
    inst.engine.flush()
    return {"log": list(gw.log), "state": _leaf_digests(inst.engine.state),
            "mirrors": _digest(_service_mirrors(inst.engine)),
            "delivered": inst.commands.delivered_count}


async def _servers_timed(inst, gw, spec: dict, t: dict) -> None:
    """Past the checkpoint, on the card only: invocations delivered by the
    pump loop and the RPC mix, timed."""
    first = spec["cpu_invocations"]
    t["command_s"] = await _servers_commands(inst, gw, first, spec["invocations"])
    t["delivered"] = inst.commands.delivered_count - first
    _, t["rpc_calls"], t["rpc_s"] = await _servers_rpc(
        inst, gw, "rpt", spec["rpc_devices"], spec["rpc_events"])


async def _servers_commands(inst, gw, first: int, n: int) -> float:
    """``n`` ping invocations over REST to the meters from the ``first``-th
    on, delivered by the server's pump loop; returns the seconds until the
    last one was delivered."""
    t0 = time.perf_counter()
    for i in range(first, first + n):
        await gw.call("commands", "POST", f"/api/devices/srv-{2 * i + 1:05d}/invocations",
                      {"commandToken": "ping"}, expect=201, record=i < 16)
    await _pumped(inst)
    return time.perf_counter() - t0


async def _servers_rpc(inst, gw, prefix: str, n_dev: int, n_ev: int) -> tuple[list, int, float]:
    """The RPC mix through ``RpcClient`` under the system JWT: ``n_dev``
    devices created, ``n_ev`` events, state and event reads, a state search
    and a device listing. Returns the masked answers, the calls and the
    seconds."""
    from sitewhere_tpu_torch.rpc.client import RpcClient
    from sitewhere_tpu_torch.rpc.server import system_jwt

    cli = await RpcClient(port=gw.rpc_port, tenant="default",
                          auth_token=system_jwt(inst)).connect()
    answers = []
    t0 = time.perf_counter()
    try:
        async def rcall(method, **params):
            res = await cli.call(method, **params)
            answers.append((method, servers_mask(_parity.plain(res))))

        for i in range(n_dev):
            await rcall("DeviceManagement.createDevice", token=f"{prefix}-{i:04d}",
                        deviceType="meter")
        for i in range(n_ev):
            await rcall("DeviceEventManagement.addDeviceEvent", envelope={
                "deviceToken": f"{prefix}-{i % n_dev:04d}", "type": "DeviceMeasurement",
                "request": {"name": "m0", "value": float(i % 7) / 2}})
        for i in range(0, n_dev, max(1, n_dev // 16)):
            await rcall("DeviceState.getDeviceState", token=f"{prefix}-{i:04d}")
            await rcall("DeviceEventManagement.listDeviceEvents", token=f"{prefix}-{i:04d}")
        await rcall("DeviceState.searchDeviceStates", presence="PRESENT")
        await rcall("DeviceManagement.listDevices")
    finally:
        await cli.close()
    return answers, len(answers), time.perf_counter() - t0


async def _analytics_routes(gw, spec, t: dict | None) -> tuple:
    """train, scores, detect over REST; with ``t``, each route's ms."""
    out = []
    for name, method, path, body in (
            ("train", "POST", "/api/analytics/train",
             {"batchSize": spec["train_batch"], "steps": 1}),
            ("scores", "GET", "/api/analytics/scores", None),
            ("detect", "POST", "/api/analytics/detect", None)):
        t0 = time.perf_counter()
        out.append((await gw.call("analytics", method, path, body, record=False))[1])
        if t is not None:
            t[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
    return tuple(out)


async def _servers_analytics(inst, gw, spec, t) -> dict:
    """The analytics routes twice: timed, then under torch.profiler (the
    window_features kernel by name; a window whose first kernel is the
    only one can come back without device records, so the window spans all
    three routes). The timed pass's scores are held against the plain
    window_features on the same windows through the same model, taken
    before the profiled pass's train route steps the model on."""
    svc = inst.analytics
    wf.window_features.launches = 0
    train, scores, detect = await _analytics_routes(gw, spec, t)
    # the plain version on the model the scores route ran (detect does not
    # step it; score_all is read-only here)
    with svc._lock:
        wins = svc._windows()
        data = snapshot_windows(wins)
        with torch.no_grad():
            plain = _plain_scores(svc.model, data, wins.filled, svc.min_fill).float().cpu()
    names = []
    if torch.device(inst.engine.device).type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            await _analytics_routes(gw, spec, None)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if "window_features" in e.key})
    launches = wf.window_features.launches
    by_token = {r["device"]: r["score"] for r in scores["results"]}
    from sitewhere_tpu_torch.engine import local_device_info

    got, ref = [], []
    for did in range(plain.shape[0]):
        info = local_device_info(inst.engine, did)
        if info is not None and info.token in by_token:
            got.append(by_token[info.token])
            ref.append(float(plain[did]))
    got, ref = np.array(got), np.array(ref)
    return {"loss": train["loss"], "scored": scores["numResults"],
            "alerts": detect["alertsEmitted"], "launches": launches,
            "kernel_names": names, "shape": list(data.shape),
            "score_err": float(np.max(np.abs(got - ref))) if got.size else None,
            "scores_close": bool(got.size and np.allclose(got, ref, **SCORE_BF16)),
            "compared": int(got.size)}


def servers_leg(device, seed: int, config: dict = SERVERS_CONFIG,
                spec: dict = SERVERS_SPEC, full: bool = True) -> dict:
    """The servers script on ``device`` (see ``phase_servers``)."""
    return asyncio.run(_servers_leg(torch.device(device), seed, config, spec, full))


async def _servers_mesh(device, config: dict) -> dict:
    """tests/test_distributed.py:217 over REST: an instance over a 2-shard
    ``DistributedEngine``."""
    from sitewhere_tpu_torch.instance.instance import InstanceConfig, SiteWhereTpuInstance
    from sitewhere_tpu_torch.web import http
    from sitewhere_tpu_torch.web.rest import start_server

    P = _parity.service_namespace("sitewhere_tpu_torch")
    log, problems = [], []
    with PinnedServers(P):
        deng = _dist_engine(device, **config)
        inst = SiteWhereTpuInstance(InstanceConfig(), engine=deng)
        server = await start_server(inst)
        session = http.ClientSession()
        gw = _Gateway(f"http://127.0.0.1:{server.port}", session, log, problems)
        try:
            basic = base64.b64encode(b"admin:password").decode()
            _, body = await gw.call("mesh", "GET", "/api/authapi/jwt",
                                    headers={"Authorization": f"Basic {basic}"})
            gw.jwt = body["token"]
            await gw.call("mesh", "POST", "/api/devices", {"token": "dr-1"}, expect=201)
            await gw.call("mesh", "POST", "/api/devices/dr-1/events", expect=201, body={
                "deviceToken": "dr-1", "type": "DeviceMeasurement",
                "request": {"name": "temp", "value": 21.0}})
            deng.flush()
            _, st = await gw.call("mesh", "GET", "/api/devices/dr-1/state")
            if st["measurements"]["temp"]["value"] != 21.0:
                problems.append(f"mesh: state {st}")
            await gw.call("mesh", "GET", "/api/events")
            await gw.call("mesh", "PUT", "/api/devices/dr-1",
                          {"deviceType": "default", "metadata": {"k": "v"}})
            await gw.call("mesh", "POST", "/api/assignments", expect=201,
                          body={"deviceToken": "dr-1", "token": "dr-1:x"})
            await gw.call("mesh", "PUT", "/api/assignments/dr-1:x", {"assetToken": "pump"})
            await gw.call("mesh", "POST", "/api/assignments/dr-1:x/missing")
            await gw.call("mesh", "DELETE", "/api/assignments/dr-1:x")
            evs = deng.make_feed_consumer("rest-ev").poll()
            await gw.call("mesh", "GET", f"/api/events/id/{evs[0].event_id}")
            deng.flush()
        finally:
            await session.close()
            await server.cleanup()
    return {"log": log, "problems": problems, "state": _leaf_digests(deng.state),
            "mirrors": _digest(_service_mirrors(deng)),
            "devices": sorted({str(s.device_state.presence.device) for s in deng.shards})}


def servers_mesh_leg(device, config: dict = SERVICES_MESH) -> dict:
    return asyncio.run(_servers_mesh(torch.device(device), config))


def servers_cpu_legs(seed: int, config: dict, spec: dict, mesh: dict) -> dict:
    """The CPU legs, in a process of their own: the script through the
    checkpoint and the mesh case."""
    torch.set_num_threads(4)
    logging.getLogger("sitewhere_tpu_torch.commands.service").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    main = servers_leg("cpu", seed, config, spec, full=False)
    t1 = time.perf_counter()
    mesh_out = servers_mesh_leg("cpu", mesh)
    return {"checkpoint": main["checkpoint"], "problems": main["problems"],
            "mesh": mesh_out, "main_s": t1 - t0, "mesh_s": time.perf_counter() - t1}


def phase_servers(device, log, fails, seed: int, config: dict = SERVERS_CONFIG,
                  spec: dict = SERVERS_SPEC, mesh: dict = SERVICES_MESH) -> dict:
    """The servers: ``SiteWhereTpuInstance`` on the card at the slice
    engine's sizes with its REST gateway (``web/rest.start_server`` over the
    port's own HTTP layer) and its RPC server on loopback, driven with the
    port's stdlib client by one seeded request script: the JWT flow; a
    tenant with the construction dataset and the "default" configuration
    template; areas, customers, device types; ``spec["devices"]`` devices
    over ``POST /api/devices``; a tenant config with a socket event source
    and an in-memory connector, applied, hot-reloaded and a bad one refused;
    ``spec["batch_rounds"]`` rounds of ``POST /api/events/batch`` of
    ``spec["batch_rows"]`` rows of 8 channels (bodies under the gateway's
    1 MiB limit); command invocations delivered by the server's pump loop;
    event, state and device-state-search reads; the read phase's 64 zones
    and ``zone_contains`` at two points each; search; the version, the
    exposition, the memory ledger, the conservation document and the debug
    bundle; the RPC mix; then ``run_rest_load`` at ``spec["loads"]`` (5 x 100
    and 32 x 64: each single-event POST is one engine step) and the
    analytics routes (train, scores, detect: window_features at
    [8192, 128, 100]). (a) A CPU instance runs the script through round
    ``spec["checkpoint"]`` of the batch ingest in a process of its own;
    every status and masked body (``SERVERS_MASK``) until there, every
    state leaf and the mirrors must be identical; the analytics scores are
    held to the plain window_features on the same windows (``SCORE_BF16``).
    (b) The engine and its state on the card, ``zone_contains`` on the card,
    window_features launched on the analytics routes (by profiler name),
    ``/api/system/version`` saying "gpu". (c) An instance over a 2-shard
    ``DistributedEngine`` on the card answers tests/test_distributed.py:217
    as its CPU twin does. (d) REST requests a second with p50/p99 for both
    loads, batch-ingest events a second, ms a ``POST /api/devices``, RPC
    calls a second, ms a ``zone_contains``, ms of the analytics routes."""
    import concurrent.futures
    import multiprocessing

    logging.getLogger("sitewhere_tpu_torch.commands.service").setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    threads = sorted(t.name for t in threading.enumerate())   # left by earlier phases
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        host = pool.submit(servers_cpu_legs, seed, config, spec, mesh)
        t0 = time.perf_counter()
        card = servers_leg(str(device), seed, config, spec)
        card_s = time.perf_counter() - t0
        card_mesh = servers_mesh_leg(str(device), mesh)
        cpu = host.result(timeout=SERVERS_TIMEOUT_S)
    wait_s = time.perf_counter() - t0 - card_s
    dev = str(device)
    fails.extend(f"servers: {p}" for p in card["problems"] + card_mesh["problems"])
    fails.extend(f"servers (CPU leg): {p}" for p in cpu["problems"] + cpu["mesh"]["problems"])
    # (a) the card against the CPU at the checkpoint
    a, b = cpu["checkpoint"], card["checkpoint"]
    first = next((i for i, (x, y) in enumerate(zip(a["log"], b["log"])) if x != y), None)
    fails.check(first is None and len(a["log"]) == len(b["log"]),
                f"servers: (a) answer {first} differs from the CPU's: card "
                f"{str(b['log'][first])[:300] if first is not None else len(b['log'])} / "
                f"CPU {str(a['log'][first])[:300] if first is not None else len(a['log'])}")
    differ = _differing({k: a[k] for k in ("state", "mirrors", "delivered")},
                        {k: b[k] for k in ("state", "mirrors", "delivered")})
    fails.check(not differ, f"servers: (a) the card's engine differs from the CPU's at "
                            f"the checkpoint: {differ[:12]}")
    an = card["analytics"]
    fails.check(an["scores_close"] and an["compared"] > 0,
                f"servers: (a) {an['compared']} REST scores against the plain "
                f"window_features: max abs {an['score_err']}")
    fails.check(an["loss"] is not None and an["scored"] > 0,
                f"servers: train loss {an['loss']}, {an['scored']} scored")
    # (b) placement
    fails.check(card["placement"]["engine"] == dev and card["placement"]["state"] == [dev],
                f"servers: (b) engine on {card['placement']}, not {dev}")
    zc = card["zone_calls"]
    fails.check(len(zc) == card["timings"]["zone_calls"]
                and all(c == (dev, dev, dev) for c in zc),
                f"servers: (b) zone_contains evaluated on {sorted(set(zc))[:3]} "
                f"({len(zc)} calls), not {dev}")
    fails.check(card["timings"]["version"]["backend"]
                == ("gpu" if device.type == "cuda" else "cpu"),
                f"servers: (b) /api/system/version says {card['timings']['version']}")
    if device.type == "cuda":
        fails.check(an["launches"] >= 3 and bool(an["kernel_names"]),
                    f"servers: (b) {an['launches']} window_features launches on the "
                    f"analytics routes, profiler names {an['kernel_names']}")
    # (c) the mesh engine
    mesh_differ = _differing({k: cpu["mesh"][k] for k in ("log", "state", "mirrors")},
                             {k: card_mesh[k] for k in ("log", "state", "mirrors")})
    fails.check(not mesh_differ, f"servers: (c) the mesh instance on the card differs "
                                 f"from the CPU's: {mesh_differ[:12]}")
    fails.check(card_mesh["devices"] == [dev],
                f"servers: (c) mesh shards on {card_mesh['devices']}, not {dev}")
    t = card["timings"]
    loads = {f"{x['workers']}x{x['msgs']}": {
        "requests_per_s": x["events_per_s"], "p50_ms": x["latency_p50_ms"],
        "p99_ms": x["latency_p99_ms"], "failed": x["events_failed"]} for x in card["loads"]}
    out = {"phase": "servers", "config": {k: v for k, v in config.items()}, "spec": spec,
           "cpu_cut": f"the CPU leg ran the script through batch round {spec['checkpoint']} "
                      f"of {spec['batch_rounds']} (every step before it whole; no REST load, "
                      f"no analytics routes); card and CPU compared there",
           "answers_compared": len(b["log"]), "identical_at_checkpoint": first is None
           and not differ, "mesh_identical": not mesh_differ,
           "version": card["timings"]["version"],
           "rest_load": loads,
           "batch_events_per_s": t["batch_rows"] / t["batch_s"],
           "batch_posts_a_round": t["batch_posts"],
           "create_device_ms": t["create_s"] * 1e3 / spec["devices"],
           "rpc_calls_per_s": t["rpc_calls"] / t["rpc_s"], "rpc_calls": t["rpc_calls"],
           "zone_contains_ms": t["zone_s"] * 1e3 / t["zone_calls"],
           "search_ms": t["search_s"] * 1e3,
           "invocations_delivered": t["delivered"],
           "invocations_per_s": t["delivered"] / t["command_s"],
           "analytics": {"train_ms": t["train_ms"], "scores_ms": t["scores_ms"],
                         "detect_ms": t["detect_ms"], **an},
           "sink_events": card["sink"],
           "card_leg_s": card_s, "cpu_leg_s": cpu["main_s"] + cpu["mesh_s"],
           "cpu_wait_s": max(0.0, wait_s), "threads_at_start": threads,
           "seconds": time.perf_counter() - t_phase}
    if device.type == "cuda":
        out["card"] = card_line()
    emit(out, log)
    load_text = ", ".join(f"{k} {v['requests_per_s']:.0f} req/s (p50 {v['p50_ms']:.2f} / "
                          f"p99 {v['p99_ms']:.2f} ms)" for k, v in loads.items())
    print(f"servers: REST load {load_text}, batch {out['batch_events_per_s']:.0f} events/s, {out['create_device_ms']:.2f} ms "
          f"a device, {out['rpc_calls_per_s']:.0f} RPC calls/s, zone_contains "
          f"{out['zone_contains_ms']:.2f} ms, scores {t['scores_ms']:.1f} ms; card = CPU at "
          f"round {spec['checkpoint']}; mesh card = CPU; {out['seconds']:.1f} s", flush=True)
    return out


# ------------------------------------------------------------------ cluster
# the full-width leg: bench.py's cluster leg (bench.py:888-1300) at its
# hardware settings — 2 ranks with forwarding and RF = 2 replication, every
# engine at DistributedConfig()'s per-shard capacities with 2 shards, the
# leg's 4 channels and a group-commit WAL
CLUSTER_MESH = dict(n_shards=2, channels=4, wal_group_commit=True)
CLUSTER_FR = 2048               # events a frame
CLUSTER_CAL = 64                # frames of the closed-loop calibration
# events of the leg in all (topped up last): cut from 1,000,000 so the
# script stays inside its time limit (the top-up took 54 s of a slow run)
CLUSTER_TARGET = 500_000
CLUSTER_OL_GOAL = 200_000       # the open loop's goal in events
CLUSTER_CHAOS_FRAMES = 4
CLUSTER_TOKENS = 512            # the leg's devices, hash-spread over the ranks
# the parity, placement, entity and reshard legs: a small mesh each
CLUSTER_SMALL = dict(n_shards=2, device_capacity_per_shard=512,
                     token_capacity_per_shard=1024, assignment_capacity_per_shard=1024,
                     store_capacity_per_shard=1 << 13, channels=4,
                     batch_capacity_per_shard=256)
CLUSTER_PARITY = dict(rounds=8, frame=512, devices=300)
CLUSTER_BASE_S = 1_750_000_000.0    # the parity leg's epoch base, both processes
CLUSTER_NOW_MS = 60_000             # and its pinned clock
CLUSTER_TIMEOUT_S = 600.0           # the CPU leg's process
CLUSTER_DEMO_TIMEOUT_S = 300.0
CLUSTER_DETECT_S = 5.0              # a standby's failure-detection window
# answer keys that differ run to run (trace ids, the age of a standby read)
CLUSTER_MASKED = frozenset({"trace_id", "traceId", "stale_ms"})


class ClusterRig:
    """``n_ranks`` loopback ranks of the port's ``ClusterEngine`` on
    ``device``, built on this thread; their cluster RPC servers on a loop
    thread of their own (deployment rule 1 of ``parallel/cluster.py``).
    Optional: durable forwarding (``ForwardQueue`` + ``SpillRegistry``;
    their pumps left off: ``drain_queues`` redelivers on this thread, as
    bench.py's leg does), RF replication (feeds started), a pinned clock
    (``now_ms``), placement settings. ``close`` stops every plane and
    closes every WAL, so no engine thread outlives the rig."""

    SECRET = "chip-cluster"

    def __init__(self, device, root, mesh: dict, n_ranks: int = 2, forwarding: bool = True,
                 rf: int = 1, base_s: float | None = None, now_ms: int | None = None,
                 slots_per_rank: int = 8, initial_ranks=None, retry_s: float = 0.2,
                 wal: bool = True, archive: bool = False, locals_=None):
        from sitewhere_tpu_torch.parallel.cluster import ClusterConfig, ClusterEngine
        from sitewhere_tpu_torch.parallel.cluster_demo import free_ports
        from sitewhere_tpu_torch.parallel.distributed import DistributedConfig
        from sitewhere_tpu_torch.parallel.forward import ForwardQueue, SpillRegistry
        from sitewhere_tpu_torch.parallel.replication import ReplicaApplier, ReplicaFeed

        self.root = pathlib.Path(root)
        self.base_s = float(int(time.time())) if base_s is None else base_s
        self.ports = free_ports(n_ranks)
        peers = [f"127.0.0.1:{p}" for p in self.ports]
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True,
                                       name="chip-cluster-rpc")
        self.thread.start()
        self.clusters, self.queues, self.regs = [], [], []
        self.feeds, self.appliers, self.servers = [], [], []
        for r in range(n_ranks):
            cfg = DistributedConfig(
                **mesh, device=str(device),
                wal_dir=str(self.root / f"wal-r{r}") if wal else None,
                archive_dir=str(self.root / f"arch-r{r}") if archive else None)
            c = ClusterEngine(ClusterConfig(
                rank=r, n_ranks=n_ranks, peers=peers, secret=self.SECRET,
                epoch_base_unix_s=self.base_s, engine=cfg, connect_timeout_s=5.0,
                slots_per_rank=slots_per_rank, initial_ranks=initial_ranks),
                local=locals_[r] if locals_ else None)
            if now_ms is not None:
                c.local.epoch = c.epoch = PinnedEpoch(self.base_s, now_ms)
            if forwarding:
                q = ForwardQueue(c, self.root / f"fwd-r{r}", retry_interval_s=retry_s)
                reg = SpillRegistry(self.root / f"fwd-r{r}" / "registry")
                c.attach_forwarding(q, reg)
                self.queues.append(q)
                self.regs.append(reg)
            if rf > 1:
                feed = ReplicaFeed(c, self.root / f"replica-r{r}", rf=rf, heartbeat_s=0.5)
                applier = ReplicaApplier(c, rf=rf, detect_s=CLUSTER_DETECT_S)
                c.attach_replication(feed, applier)
                self.feeds.append(feed)
                self.appliers.append(applier)
            self.clusters.append(c)
            self.servers.append(None)
            self.start_server(r)
        for f in self.feeds:
            f.start()

    def run(self, coro, timeout_s: float = 30.0):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(timeout_s)

    def start_server(self, r: int) -> None:
        """Rank ``r``'s cluster RPC server, with the replication handlers
        where the rig replicates. Its handlers run under the CUDA streams
        current on this thread (``build_cluster_rpc``)."""
        from sitewhere_tpu_torch.parallel.cluster import build_cluster_rpc
        from sitewhere_tpu_torch.parallel.replication import register_replication_rpc

        srv = build_cluster_rpc(self.clusters[r].local, self.SECRET)
        if self.appliers:
            register_replication_rpc(srv, self.appliers[r])
        self.run(srv.start(port=self.ports[r]))
        self.servers[r] = srv

    def stop_server(self, r: int) -> None:
        if self.servers[r] is not None:
            self.run(self.servers[r].stop())
            self.servers[r] = None

    def drain_feeds(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while not all(f.drained() for f in self.feeds):
            if time.monotonic() > deadline:
                return False
            time.sleep(0.02)
        return True

    def drain_queues(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while any(q.metrics()["forward_queue_depth"] for q in self.queues):
            if time.monotonic() > deadline:
                return False
            for q in self.queues:
                q.retry_once()
        return True

    def standbys(self) -> list:
        """``(follower, leader, standby engine)`` of every standby store."""
        return [(a.rank, leader, st.engine) for a in self.appliers
                for leader, st in sorted(a._standbys.items())]

    def devices(self) -> list[str]:
        """Where every engine of the rig lives: each rank's shards, then
        each standby's."""
        out = [str(d) for c in self.clusters for d in c.local.mesh]
        out += [str(d) for _, _, e in self.standbys() for d in e.mesh]
        return out

    def close(self) -> None:
        for f in self.feeds:
            f.stop()
        for q in self.queues:
            q.stop()
        for reg in self.regs:
            reg.close()
        for a in self.appliers:
            a.close()
        for r in range(len(self.servers)):
            try:
                self.stop_server(r)
            except Exception:
                pass
        for c in self.clusters:
            c.close()
            if c.local.wal is not None:
                c.local.wal.close()
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=10)


def _launch_counts() -> dict:
    """Every kernel wrapper's launch count."""
    return {"window_features": wf.window_features.launches,
            "flash_attention": fa.flash_attention.launches,
            "flash_attention_backward": fa.flash_attention_backward.launches}


def _engine_census() -> dict:
    """The engines alive in this process (``Engine`` and the mesh engines)
    and its threads by name (numbered names grouped)."""
    import gc

    from sitewhere_tpu_torch.parallel.distributed import DistributedEngine
    from sitewhere_tpu_torch.parallel.sharded import SpmdEngine

    import warnings

    gc.collect()
    engines: dict = {}
    with warnings.catch_warnings():     # isinstance on deprecated torch aliases
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            if isinstance(o, (Engine, DistributedEngine, SpmdEngine)):
                engines[type(o).__name__] = engines.get(type(o).__name__, 0) + 1
    threads: dict = {}
    for t in threading.enumerate():
        name = re.sub(r"[_-]\d+$", "", t.name)
        threads[name] = threads.get(name, 0) + 1
    return {"engines": engines, "threads": dict(sorted(threads.items())),
            "n_threads": threading.active_count()}


def _cluster_payload(token: str, kind: int, i: int, base_ms: int) -> bytes:
    """One event of the parity stream: a measurement of two or three
    channels, a location or an alert, its date relative to the base."""
    ts = base_ms + 1_000 + i
    if kind == 0:
        req = {"measurements": {"temp": float(i % 97), "hum": 0.5 * (i % 13)},
               "eventDate": ts}
        if i % 3 == 0:
            req["measurements"]["psi"] = float(i % 5)
        return json.dumps({"deviceToken": token, "type": "DeviceMeasurements",
                           "request": req}).encode()
    if kind == 1:
        return json.dumps({"deviceToken": token, "type": "DeviceLocation",
                           "request": {"latitude": 40.0 + (i % 50) * 0.01,
                                       "longitude": -75.0 - (i % 40) * 0.01,
                                       "elevation": 3.0, "eventDate": ts}}).encode()
    return json.dumps({"deviceToken": token, "type": "DeviceAlert",
                       "request": {"type": "overheat" if i % 2 else "lowbatt",
                                   "level": 2, "message": "m", "eventDate": ts}}).encode()


def cluster_parity_stream(seed: int, rounds: int, frame: int, n_devices: int) -> list:
    """``rounds`` x 2 frames of ``frame`` payloads (a frame for rank 0,
    then one for rank 1, each naming devices of both ranks): 85 %
    measurements, 10 % locations, 5 % alerts."""
    rng = np.random.default_rng(seed)
    base_ms = int(CLUSTER_BASE_S * 1000)
    out, i = [], 0
    for _ in range(2 * rounds):
        devs = rng.integers(0, n_devices, frame)
        kinds = rng.choice(3, frame, p=[0.85, 0.10, 0.05])
        batch = []
        for d, k in zip(devs, kinds):
            batch.append(_cluster_payload(f"cp-{int(d)}", int(k), i, base_ms))
            i += 1
        out.append(batch)
    return out


def masked(x, keys=CLUSTER_MASKED):
    """``x`` with the value of every key in ``keys`` replaced, at any
    depth (tuples become lists)."""
    if isinstance(x, dict):
        return {k: ("<masked>" if k in keys else masked(v, keys)) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [masked(v, keys) for v in x]
    return x


def cluster_parity_leg(device: str, seed: int, spec: dict = CLUSTER_PARITY) -> dict:
    """(a)'s leg on ``device``: a 2-rank cluster (forwarding, RF = 2,
    both clocks pinned to one instant over one base) with an instance a
    rank (the search index behind its connector), the seeded mixed-owner
    stream accepted at both ranks, the feeds drained and the partitions
    indexed; then the answers — query pages, device states and by-id
    lookups from either rank, searches — and the digest of every store
    leaf of both ranks and both standbys. Also checks, per package's own
    rule, that each standby store equals its leader's byte for byte."""
    from sitewhere_tpu_torch.instance.instance import InstanceConfig, SiteWhereTpuInstance

    root = tempfile.mkdtemp(prefix="chip-cluster-parity-")
    rig = ClusterRig(device, root, CLUSTER_SMALL, rf=2, base_s=CLUSTER_BASE_S,
                     now_ms=CLUSTER_NOW_MS)
    try:
        c0, c1 = rig.clusters
        insts = [SiteWhereTpuInstance(InstanceConfig(engine=EngineConfig()), engine=c)
                 for c in rig.clusters]
        feeds = [c.make_feed_consumer("chip-cluster-ids") for c in rig.clusters]
        stream = cluster_parity_stream(seed, spec["rounds"], spec["frame"], spec["devices"])
        summaries = []
        t0 = time.perf_counter()
        for k, batch in enumerate(stream):
            summaries.append(untraced(rig.clusters[k % 2].ingest_json_batch(batch)))
        for c in rig.clusters:
            c.flush()
        ingest_s = time.perf_counter() - t0
        drained = rig.drain_feeds()
        for inst in insts:
            asyncio.run(inst.pump_outbound())
        toks = [f"cp-{i}" for i in range(0, spec["devices"], 7)]
        answers: dict = {"summaries": summaries}
        for r, c in enumerate(rig.clusters):
            page = c.query_events(limit=200)
            answers[f"page_{r}"] = masked(page)
            answers[f"since_{r}"] = masked(c.query_events(since_ms=1_000 + 2 * spec["frame"],
                                                           limit=100))
            answers[f"loc_{r}"] = masked(c.query_events(etype=int(EventType.LOCATION),
                                                         limit=100))
            answers[f"dev_{r}"] = [masked(c.query_events(device_token=t, limit=20))
                                   for t in toks]
            answers[f"state_{r}"] = [masked(c.get_device_state(t)) for t in toks]
            answers[f"search_{r}"] = [masked(c.search_events(q, max_results=100))
                                      for q in ("*:*", "type:LOCATION", "type:ALERT")]
            answers[f"rows_{r}"] = len(c.search_device_states())
        ids = []
        for feed in feeds:          # cluster-global ids of either rank's events
            while recs := feed.poll():
                ids += [rec.event_id for rec in recs]
                feed.commit(recs)
        answers["feed_ids"] = len(ids)
        answers["by_id"] = [[masked(c.get_event(i)) for c in rig.clusters]
                            for i in sorted(ids)[::9]]
        stores = {f"rank{r}": _leaf_digests(c.local.state.store)
                  for r, c in enumerate(rig.clusters)}
        standby_equal = []
        for follower, leader, eng in rig.standbys():
            eng.flush()
            stores[f"standby{follower}_of_{leader}"] = _leaf_digests(eng.state.store)
            standby_equal.append(_leaf_digests(eng.state.store)
                                 == stores[f"rank{leader}"])
        return {"answers": answers, "stores": stores, "standby_equal": standby_equal,
                "drained": drained, "devices": rig.devices(), "ingest_s": ingest_s,
                "events": sum(len(b) for b in stream)}
    finally:
        rig.close()
        shutil.rmtree(root, ignore_errors=True)


def cluster_cpu_leg(seed: int, spec: dict) -> dict:
    """(a)'s CPU leg, in a process of its own."""
    torch.set_num_threads(4)
    logging.getLogger("sitewhere_tpu_torch.parallel").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    out = cluster_parity_leg("cpu", seed, spec)
    out["seconds"] = time.perf_counter() - t0
    return out


def _kframes(toks: list[str], tag: int, n: int, fr: int) -> list[list[bytes]]:
    """bench.py's ``kframes``: ``n`` frames of ``fr`` measurements over
    ``toks``, seeded by ``tag``."""
    rng = np.random.default_rng(1000 + tag)
    return [[generate_measurements_message(toks[int(x)], tag * 1_000_000 + fi * fr + i)
             for i, x in enumerate(rng.integers(0, len(toks), fr))] for fi in range(n)]


def cluster_full_leg(device, fails, fr: int = CLUSTER_FR, cal: int = CLUSTER_CAL,
                     target: int = CLUSTER_TARGET, ol_goal: int = CLUSTER_OL_GOAL,
                     mesh: dict = CLUSTER_MESH, n_tokens: int = CLUSTER_TOKENS,
                     chaos_frames: int = CLUSTER_CHAOS_FRAMES) -> dict:
    """(b): bench.py's cluster leg. Calibration (closed loop), the seeded
    open loop at 40 % of it (three tenants, queries and mutations), the
    federated scrape (forward-hop p99), replication lag and staleness, the
    chaos slice (every forward 0 -> 1 dropped, spilled, redelivered: no
    loss), the top-up to ``target`` events, every rank's conservation
    ledger, then rank 1's server stops and rank 0 reads rank 1's partition
    from its standby (the failover read's ``stale_ms``)."""
    from sitewhere_tpu_torch.loadgen import (OpenLoopSpec, TenantLoad, run_open_loop,
                                             schedule_fingerprint)
    from sitewhere_tpu_torch.parallel.cluster import owner_rank
    from sitewhere_tpu_torch.utils import faults
    from sitewhere_tpu_torch.utils.metrics import cluster_metrics_instruments

    root = tempfile.mkdtemp(prefix="chip-cluster-full-")
    rig = ClusterRig(device, root, mesh, rf=2)
    out: dict = {}
    try:
        kc0 = rig.clusters[0]
        toks = [f"cl-{i}" for i in range(n_tokens)]
        events = 0
        t0 = time.perf_counter()
        for b in _kframes(toks, 0, 6, fr):         # warm both ranks and the standbys
            kc0.ingest_json_batch(b)
        kc0.flush()
        out["warm_s"] = time.perf_counter() - t0
        # the hop histogram is process-wide and the other legs forward into
        # it too: this leg reads its own window of the 0 -> 1 series (every
        # frame enters at rank 0)
        hop = cluster_metrics_instruments(METRICS_REGISTRY)["forward_hop"]
        hop0 = hop.snapshot(dst="1")
        frames = _kframes(toks, 1, cal, fr)
        t1 = time.perf_counter()
        for b in frames:
            kc0.ingest_json_batch(b)
        kc0.flush()
        cal_s = time.perf_counter() - t1
        out["calibration_events_per_s"] = cal * fr / cal_s
        events += cal * fr
        warm_spec = OpenLoopSpec(
            tenants=tuple(TenantLoad(t, 220.0, n_devices=64, device_prefix=f"{t}-warm",
                                     query_every=1, mutate_every=1)
                          for t in ("alpha", "bravo", "charlie")),
            duration_s=1.2, frame_size=64, seed=43)
        run_open_loop(kc0, build_open_loop_schedule(warm_spec), checkpoint_frames=2)
        rig.drain_feeds()
        target_eps = max(1500.0, 0.4 * out["calibration_events_per_s"])
        ol_duration = min(10.0, max(2.0, ol_goal / target_eps))
        spec = OpenLoopSpec(
            tenants=tuple(TenantLoad(t, target_eps * w, n_devices=64, query_every=4,
                                     mutate_every=6)
                          for t, w in (("alpha", 0.5), ("bravo", 0.3), ("charlie", 0.2))),
            duration_s=ol_duration, frame_size=256, seed=42)
        sched = build_open_loop_schedule(spec)
        olr = run_open_loop(kc0, sched, checkpoint_frames=4)
        events += olr.events
        out["open_loop"] = {
            "offered_events_per_s": olr.offered_eps, "events_per_s": olr.events_per_s,
            "events": olr.events, "wall_s": olr.wall_s, "queries": olr.queries,
            "query_p99_ms": olr.query_p99_ms, "mutations": olr.mutations,
            "fingerprint": schedule_fingerprint(sched),
            "per_tenant": {t: {k: d[k] for k in ("events", "e2e_p50_ms", "e2e_p99_ms",
                                                  "e2e_p999_ms", "service_p99_ms")}
                           for t, d in olr.per_tenant.items()}}
        t2 = time.perf_counter()
        fed = kc0.cluster_metrics()
        out["scrape_ms"] = (time.perf_counter() - t2) * 1e3
        out["scrape_ranks"] = sum(f'rank="{r}"' in fed for r in (0, 1))
        p99 = hop.quantile_since(0.99, hop0, dst="1")
        out["forward_hop_p99_ms"] = p99 * 1e3 if p99 is not None else None
        out["forward_hops"] = hop.snapshot(dst="1")[1] - hop0[1]
        out["feeds_drained"] = rig.drain_feeds()
        out["replication_lag_batches"] = max(f.metrics()["replica_feed_max_lag_batches"]
                                             for f in rig.feeds)
        stales = [ms for a in rig.appliers for ms in a.stale_by_leader().values()]
        out["replication_stale_ms"] = max(stales) if stales else None
        # the chaos slice: every forward 0 -> 1 drops, spills, redelivers
        chtoks = [t for t in (f"ch-{i}" for i in range(400)) if owner_rank(t, 2) == 1][:32]
        chframes = [[generate_measurements_message(chtoks[(fi * fr + i) % len(chtoks)],
                                                   9_000_000 + fi * fr + i)
                     for i in range(fr)] for fi in range(chaos_frames)]
        faults.install(faults.FaultPlan(seed=7).drop(src=0, dst=1, prob=1.0,
                                                     method_prefix="Cluster.ingestForward"))
        spilled = 0
        try:
            for b in chframes:
                spilled += kc0.ingest_json_batch(b, tenant="chaos").get("spilled", 0)
        finally:
            faults.clear()
        events += chaos_frames * fr
        rig.drain_queues()
        kc0.flush()
        got = sum(kc0.query_events(device_token=t, limit=1)["total"] for t in chtoks)
        out["chaos"] = {"spilled": spilled, "visible": got, "sent": chaos_frames * fr,
                        "no_loss": got == chaos_frames * fr}
        fails.check(spilled > 0 and got == chaos_frames * fr,
                    f"cluster: (b) chaos slice spilled {spilled}, {got} of "
                    f"{chaos_frames * fr} visible after redelivery")
        # the top-up to the leg's event count
        t3 = time.perf_counter()
        topped, tag = 0, 3
        while events < target:
            n = min(8, -(-(target - events) // fr))
            for b in _kframes(toks, tag, n, fr):
                kc0.ingest_json_batch(b)
            events += n * fr
            topped += n * fr
            tag += 1
        kc0.flush()
        top_s = time.perf_counter() - t3
        out["topup"] = {"events": topped, "seconds": top_s,
                        "events_per_s": topped / top_s if top_s > 0 else None}
        out["events"] = events
        out["feeds_drained_at_end"] = rig.drain_feeds()
        out["devices"] = rig.devices()      # the standbys exist by now
        violations = [v.to_dict() for c in rig.clusters
                      for v in check_conservation(build_ledger(c))]
        out["conservation_violations"] = violations
        fails.check(not violations, f"cluster: (b) conservation violations {violations[:4]}")
        persisted = sum(c.local.metrics()["persisted"] for c in rig.clusters)
        out["persisted"] = persisted
        # failover: rank 1's server stops, rank 0 reads rank 1's partition
        # from its standby
        rig.stop_server(1)
        tok1 = next(t for t in toks if owner_rank(t, 2) == 1)
        t4 = time.perf_counter()
        fo = kc0.query_events(device_token=tok1, limit=5)
        out["failover"] = {"read_ms": (time.perf_counter() - t4) * 1e3,
                           "total": fo.get("total"), "stale_ms": fo.get("stale_ms")}
        fails.check(fo.get("stale_ms") is not None and fo.get("total", 0) > 0,
                    f"cluster: (b) the failover read after rank 1 stopped: "
                    f"{ {k: v for k, v in fo.items() if k != 'events'} }")
        return out
    finally:
        faults.clear()
        rig.close()
        shutil.rmtree(root, ignore_errors=True)


# (c)'s mesh: CLUSTER_SMALL with rings of 65536 rows a shard, so that a
# slow move's events stay in the stores (the check counts every acked
# event: a 37.4 s move on one H100 machine acked 40,656 events, more than
# rings of 8192 rows held), and the pause of its ingest pump between
# rounds of 48 events (~800 events/s at most on that machine)
CLUSTER_PLACEMENT = dict(CLUSTER_SMALL, store_capacity_per_shard=1 << 16)
PLACEMENT_PAUSE_S = 0.02


def cluster_placement_leg(device, fails) -> dict:
    """(c): three provisioned ranks, ranks 0 and 1 active (4 slots a
    rank). ``move_slots`` of half of rank 0's slots to rank 1 while a
    thread keeps ingesting at rank 0, then ``drain_rank(1)`` and
    ``join_rank(2)``. Every acked event is visible exactly once from every
    active rank's facade, and every rank's map is on the new epoch. The
    pump runs for the whole move, PLACEMENT_PAUSE_S between rounds, into
    rings sized for a slow move's events (CLUSTER_PLACEMENT)."""
    from sitewhere_tpu_torch.parallel.placement import drain_rank, join_rank, move_slots

    root = tempfile.mkdtemp(prefix="chip-cluster-placement-")
    rig = ClusterRig(device, root, CLUSTER_PLACEMENT, n_ranks=3, initial_ranks=[0, 1],
                     slots_per_rank=4, retry_s=0.1)
    out: dict = {"devices": rig.devices()}
    n_tokens, frame = 96, 48
    try:
        c0 = rig.clusters[0]
        toks = [f"pl-{i}" for i in range(n_tokens)]
        base_ms = int(rig.base_s * 1000)
        acked = {t: 0 for t in toks}
        seq = itertools.count()
        stop = threading.Event()
        errors: list = []

        def ingest_round() -> None:
            i0 = next(seq)
            batch = [(toks[(i0 * frame + j) % n_tokens], i0 * frame + j)
                     for j in range(frame)]
            s = c0.ingest_json_batch([_cluster_payload(t, 0, k, base_ms)
                                      for t, k in batch])
            if s.get("failed"):
                errors.append(s)
                return
            for t, _ in batch:
                acked[t] += 1

        pumped = [0]

        def pump() -> None:
            try:
                while not stop.is_set():
                    ingest_round()
                    pumped[0] += 1
                    time.sleep(PLACEMENT_PAUSE_S)
            except Exception as e:   # surfaced as a failed check
                errors.append(repr(e))

        for _ in range(4):
            ingest_round()
        c0.flush()
        epochs = [c0.placement.epoch]
        mine = c0.placement.map().slots_of(0)
        th = threading.Thread(target=pump, name="chip-cluster-ingest", daemon=True)
        th.start()
        t0 = time.perf_counter()
        try:
            moved = move_slots(c0, mine[: len(mine) // 2], 1)
        finally:
            stop.set()
            th.join(timeout=60)
        out["move_s"] = time.perf_counter() - t0
        # the rounds pumped during the move, and what each move shipped in
        # its catch-up rounds and fence
        out["move_rounds"] = pumped[0]
        out["shipped"] = [(m.get("shippedBatches"), m.get("shippedPayloads"))
                          for m in moved["moves"]]
        out["ring_rows_a_shard"] = CLUSTER_PLACEMENT["store_capacity_per_shard"]
        epochs.append(c0.placement.epoch)
        t1 = time.perf_counter()
        drained = drain_rank(c0, 1)
        out["drain_s"] = time.perf_counter() - t1
        epochs.append(c0.placement.epoch)
        t2 = time.perf_counter()
        joined = join_rank(c0, 2)
        out["join_s"] = time.perf_counter() - t2
        epochs.append(c0.placement.epoch)
        rig.drain_queues()
        for c in rig.clusters:
            c.flush()
        active = c0.placement.map().active_ranks()
        seen = {r: {t: rig.clusters[r].query_events(device_token=t, limit=1)["total"]
                    for t in toks} for r in active}
        lost = {r: [t for t in toks if seen[r][t] != acked[t]] for r in active}
        same_epoch = len({c.placement.epoch for c in rig.clusters}) == 1
        same_owner = all(c.owner(t) == c0.owner(t) for c in rig.clusters for t in toks)
        violations = [v.to_dict() for r in active
                      for v in check_conservation(build_ledger(rig.clusters[r]))]
        out.update(epochs=epochs, active=active, acked=sum(acked.values()),
                   moves=[m["state"] for m in moved["moves"]],
                   drained=bool(drained.get("drained")), joined=bool(joined.get("joined")),
                   mismatched=sum(map(len, lost.values())), same_epoch=same_epoch,
                   same_owner=same_owner, errors=errors[:4],
                   conservation_violations=violations)
        fails.check(out["moves"] == ["done"] and out["drained"] and out["joined"]
                    and active == [0, 2],
                    f"cluster: (c) move {out['moves']}, drained {out['drained']}, joined "
                    f"{out['joined']}, active {active}")
        fails.check(not errors and not out["mismatched"] and out["acked"] > 0,
                    f"cluster: (c) {out['mismatched']} token totals differ from the "
                    f"{out['acked']} acked events ({errors[:2]})")
        fails.check(same_epoch and same_owner and epochs == sorted(set(epochs)),
                    f"cluster: (c) epochs {[c.placement.epoch for c in rig.clusters]} "
                    f"(steps {epochs}), one owner map {same_owner}")
        fails.check(not violations, f"cluster: (c) conservation {violations[:3]}")
        return out
    finally:
        rig.close()
        shutil.rmtree(root, ignore_errors=True)


def cluster_entity_leg(device, fails) -> dict:
    """(d): two ranks with an instance and an ``EntityReplicator`` each.
    Rank 0 creates device types, commands and a user; after the pushes
    drain, rank 1 reads each back identically (``to_state``), the user
    logs in there, and a device of a replicated type is created at rank 1
    and routed to its owner."""
    from sitewhere_tpu_torch.commands.model import DeviceCommand
    from sitewhere_tpu_torch.instance.instance import InstanceConfig, SiteWhereTpuInstance
    from sitewhere_tpu_torch.parallel.entity_sync import EntityReplicator, to_state

    root = tempfile.mkdtemp(prefix="chip-cluster-entity-")
    rig = ClusterRig(device, root, CLUSTER_SMALL, forwarding=False)
    reps = []
    try:
        insts = [SiteWhereTpuInstance(InstanceConfig(engine=EngineConfig()), engine=c)
                 for c in rig.clusters]
        for r, (c, inst) in enumerate(zip(rig.clusters, insts)):
            rep = EntityReplicator(c, inst, log_dir=str(rig.root / f"elog-r{r}"))
            rep.attach()
            rep.register_rpc(rig.servers[r])
            reps.append(rep)
        dm0, dm1 = insts[0].device_management, insts[1].device_management
        t0 = time.perf_counter()
        types_ = [f"chip-type-{i}" for i in range(4)]
        for i, t in enumerate(types_):
            dm0.create_device_type(t, f"Chip type {i}")
            insts[0].command_registry.create(DeviceCommand(
                token=f"chip-cmd-{i}", device_type=t, name=f"cmd {i}"))
        insts[0].users.create_user("chip-operator", "s3cret", roles=["user"])
        reps[0].drain_pushes()
        out = {"replicate_s": time.perf_counter() - t0}
        same = [to_state(dm0.device_types.get(t)) == to_state(dm1.device_types.get(t))
                for t in types_]
        same += [to_state(insts[0].command_registry.get(f"chip-cmd-{i}"))
                 == to_state(insts[1].command_registry.get(f"chip-cmd-{i}"))
                 for i in range(len(types_))]
        user = insts[1].users.authenticate("chip-operator", "s3cret")
        dev = next(t for t in (f"ent-{i}" for i in range(64)) if rig.clusters[1].owner(t) == 0)
        dm1.create_device(dev, types_[0])
        info = rig.clusters[0].get_device(dev)
        out.update(identical=all(same), entities=len(same),
                   user=getattr(user, "username", None),
                   routed_type=getattr(info, "device_type", None), devices=rig.devices())
        fails.check(all(same) and len(same) == 8 and out["user"] == "chip-operator"
                    and out["routed_type"] == types_[0],
                    f"cluster: (d) entity sync identical {same}, login {out['user']}, "
                    f"routed type {out['routed_type']}")
        return out
    finally:
        for rep in reps:
            rep.close()
        rig.close()
        shutil.rmtree(root, ignore_errors=True)


def _reshard_norm(events: list) -> list:
    """Topology-independent event identity (ids are rank-local)."""
    return [(e["deviceToken"], e["type"], e["eventDateMs"], e.get("measurements"),
             e.get("latitude"), e.get("longitude"), e.get("alertType"), e.get("level"))
            for e in events]


def cluster_reshard_leg(device, fails) -> dict:
    """(e): a 2-rank cluster on the card with WALs and archives (rings
    small enough to spill), history ingested, each rank snapshotted and
    its WAL rotated and pruned, then a live tail. ``migrate_cluster_snapshots``
    2 -> 3 off the snapshots and archives, three ranks recovered on the
    card, ``replay_wal_tails``: every new rank answers the old cluster's
    queries."""
    from sitewhere_tpu_torch.parallel.cluster import owner_rank
    from sitewhere_tpu_torch.parallel.cluster_reshard import (migrate_cluster_snapshots,
                                                              replay_wal_tails)
    from sitewhere_tpu_torch.parallel.distributed import recover_distributed

    mesh = dict(n_shards=2, device_capacity_per_shard=64, token_capacity_per_shard=128,
                assignment_capacity_per_shard=128, store_capacity_per_shard=64,
                channels=4, batch_capacity_per_shard=8, archive_segment_rows=8)
    root = pathlib.Path(tempfile.mkdtemp(prefix="chip-cluster-reshard-"))
    old = rig = None
    out: dict = {}
    try:
        old = ClusterRig(device, root / "old", mesh, forwarding=False, archive=True)
        base_ms = int(old.base_s * 1000)
        toks, i = [], 0
        while len([t for t in toks if owner_rank(t, 2) == 0]) < 4 or len(toks) < 8:
            toks.append(f"mig-{i}")
            i += 1
        names = ("temp", "hum", "psi")
        batch = []
        for k in range(40):
            for j, t in enumerate(toks):
                ts = base_ms + 10 + k * len(toks) + j
                if k % 7 == 3:
                    batch.append(json.dumps({"deviceToken": t, "type": "DeviceLocation",
                                             "request": {"latitude": 45.0 + k,
                                                         "longitude": -122.0 - j,
                                                         "eventDate": ts}}).encode())
                else:
                    batch.append(json.dumps({
                        "deviceToken": t, "type": "DeviceMeasurements",
                        "request": {"measurements": {names[(k + j) % 3]: float(k)},
                                    "eventDate": ts}}).encode())
        old.clusters[0].ingest_json_batch(batch)
        old.clusters[0].flush()
        snaps = []
        for r, c in enumerate(old.clusters):
            d = root / f"snap-r{r}"
            c.local.save(d)
            snaps.append(d)
            c.local.wal._seg_index += 1
            c.local.wal._open_segment()
            c.local.wal.prune(keep_segments=1)
        tail = [json.dumps({"deviceToken": t, "type": "DeviceMeasurements",
                            "request": {"measurements": {"temp": 99.5},
                                        "eventDate": base_ms + 5000 + j}}).encode()
                for j, t in enumerate(toks)]
        old.clusters[1].ingest_json_batch(tail)
        old.clusters[0].flush()
        ref_all = old.clusters[0].query_events(limit=500)
        ref_dev = {t: old.clusters[0].query_events(device_token=t, limit=500) for t in toks}
        ref_state = {t: old.clusters[0].get_device_state(t) for t in toks}
        for c in old.clusters:
            c.local.wal.flush()
        t0 = time.perf_counter()
        stats = migrate_cluster_snapshots(snaps, 3, root / "new",
                                          old_archive_dirs=[root / "old" / "arch-r0",
                                                            root / "old" / "arch-r1"])
        locals_ = [recover_distributed(root / "new" / f"rank-{t}" / "snapshot",
                                       root / f"new-wal-r{t}", device=str(device))
                   for t in range(3)]
        rig = ClusterRig(device, root / "newrig", mesh, n_ranks=3, forwarding=False,
                         wal=False, base_s=old.base_s, locals_=locals_)
        replayed = replay_wal_tails(rig.clusters[0], snaps,
                                    [root / "old" / "wal-r0", root / "old" / "wal-r1"])
        for c in rig.clusters:
            c.flush()
        out["migrate_s"] = time.perf_counter() - t0
        same_all = all(
            (g := c.query_events(limit=500))["total"] == ref_all["total"]
            and _reshard_norm(g["events"]) == _reshard_norm(ref_all["events"])
            for c in rig.clusters)
        same_dev = all(
            _reshard_norm(rig.clusters[1].query_events(device_token=t, limit=500)["events"])
            == _reshard_norm(ref_dev[t]["events"]) for t in toks)
        same_state = all(
            {k: (rig.clusters[2].get_device_state(t) or {}).get(k) for k in
             ("measurements", "presence")}
            == {k: ref_state[t].get(k) for k in ("measurements", "presence")} for t in toks)
        out.update(replayed=replayed, events=ref_all["total"],
                   targets=[s["devices"] for s in stats["targets"]],
                   archive_rows=sum(s["archive_rows"] for s in stats["targets"]),
                   same_pages=same_all, same_device_pages=same_dev, same_states=same_state,
                   devices=rig.devices())
        fails.check(replayed == len(toks) and same_all and same_dev and same_state
                    and all(out["targets"]) and out["archive_rows"] > 0,
                    f"cluster: (e) reshard 2 -> 3: replayed {replayed} of {len(toks)}, "
                    f"pages {same_all}, device pages {same_dev}, states {same_state}, "
                    f"targets {out['targets']}, archive rows {out['archive_rows']}")
        return out
    finally:
        for x in (rig, old):
            if x is not None:
                x.close()
        shutil.rmtree(root, ignore_errors=True)


def phase_cluster(device, log, fails, seed: int, full: dict | None = None,
                  parity: dict = CLUSTER_PARITY) -> dict:
    """The cluster planes on the card (``parallel/cluster.py``, ``forward``,
    ``replication``, ``placement``, ``entity_sync``, ``cluster_reshard``,
    ``rank_runtime``, ``cluster_demo``); every engine and standby on
    ``device``. (a) Parity: a seeded mixed-owner stream into a 2-rank
    cluster (forwarding, RF = 2, pinned clocks), accepted at both ranks;
    the same cluster on CPU engines runs in a spawned process meanwhile;
    query pages, device states, by-id lookups from either rank, searches
    and every store and standby leaf must agree. (b) The full-width leg
    (``cluster_full_leg``). (c) Placement under ingest
    (``cluster_placement_leg``). (d) Entity sync (``cluster_entity_leg``).
    (e) Offline reshard 2 -> 3 (``cluster_reshard_leg``). (f) The
    two-process job (``spawn_cluster_demo``) with its ranks on the card:
    ``CLUSTER_OK`` x 3 and ``CLUSTER_RECOVERED``. (f) and (a)'s CPU leg run
    beside (a) and (c)-(e); (b) runs alone, last."""
    import concurrent.futures
    import multiprocessing

    from sitewhere_tpu_torch.parallel.cluster_demo import spawn_cluster_demo

    logging.getLogger("sitewhere_tpu_torch.parallel").setLevel(logging.ERROR)
    t_phase = time.perf_counter()
    census0 = _engine_census()
    dev = str(device)
    counts0 = _launch_counts()
    out: dict = {"phase": "cluster", "census_at_start": census0}
    demo_box: dict = {}

    def run_demo() -> None:
        t0 = time.perf_counter()
        try:
            demo_box["lines"] = spawn_cluster_demo(2, CLUSTER_DEMO_TIMEOUT_S, device=dev)
        except Exception as e:
            demo_box["error"] = repr(e)[-2000:]
        demo_box["seconds"] = time.perf_counter() - t0

    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=ctx) as pool:
        host = pool.submit(cluster_cpu_leg, seed, parity)
        demo_thread = threading.Thread(target=run_demo, name="chip-cluster-demo", daemon=True)
        demo_thread.start()
        t0 = time.perf_counter()
        card = cluster_parity_leg(dev, seed, parity)
        out["parity_card_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        out["placement"] = cluster_placement_leg(device, fails)
        out["entity"] = cluster_entity_leg(device, fails)
        out["reshard"] = cluster_reshard_leg(device, fails)
        out["legs_c_to_e_s"] = time.perf_counter() - t1
        t2 = time.perf_counter()
        cpu = host.result(timeout=CLUSTER_TIMEOUT_S)
        demo_thread.join(timeout=CLUSTER_DEMO_TIMEOUT_S + 60)
        out["wait_s"] = time.perf_counter() - t2
    # (a) the card against the CPU
    differ = _differing(cpu["answers"], card["answers"])
    store_differ = [k for k in sorted(set(cpu["stores"]) | set(card["stores"]))
                    if cpu["stores"].get(k) != card["stores"].get(k)]
    fails.check(not differ and not store_differ,
                f"cluster: (a) the card cluster differs from the CPU's: answers {differ[:8]}, "
                f"stores {store_differ[:8]}")
    fails.check(card["drained"] and len(card["standby_equal"]) == 2
                and all(card["standby_equal"]),
                f"cluster: (a) standby stores equal to their leaders' {card['standby_equal']}, "
                f"feeds drained {card['drained']}")
    out["parity"] = {"events": card["events"], "identical": not differ,
                     "stores_identical": not store_differ,
                     "answers_compared": len(card["answers"]),
                     "ingest_s": card["ingest_s"], "cpu_leg_s": cpu["seconds"],
                     "standby_equal": card["standby_equal"]}
    # (f) the two-process job
    lines = demo_box.get("lines") or []
    ok_lines = [ln for ln in lines if ln.startswith("CLUSTER_OK")]
    rec_lines = [ln for ln in lines if ln.startswith("CLUSTER_RECOVERED")]
    out["demo"] = {"lines": lines, "seconds": demo_box.get("seconds"),
                   "error": demo_box.get("error")}
    fails.check(len(ok_lines) == 3 and len(rec_lines) == 1,
                f"cluster: (f) spawn_cluster_demo printed {lines} ({demo_box.get('error')})")
    # (b) alone
    t3 = time.perf_counter()
    out["full"] = cluster_full_leg(device, fails, **(full or {}))
    out["full_s"] = time.perf_counter() - t3
    # where every engine lived
    where = (card["devices"] + out["full"]["devices"] + out["placement"]["devices"]
             + out["entity"]["devices"] + out["reshard"]["devices"])
    fails.check(all(d == dev for d in where),
                f"cluster: engines on {sorted(set(where))}, not all on {dev}")
    out["engines_checked"] = len(where)
    out["kernel_launches"] = {k: n - counts0[k] for k, n in _launch_counts().items()}
    out["census_at_end"] = _engine_census()
    out["seconds"] = time.perf_counter() - t_phase
    if device.type == "cuda":
        out["card"] = card_line()
    emit(out, log)
    f = out["full"]
    tenants = ", ".join(f"{t} p50 {d['e2e_p50_ms']} / p99 {d['e2e_p99_ms']} ms"
                        for t, d in f["open_loop"]["per_tenant"].items())
    print(f"cluster: calibration {f['calibration_events_per_s']:.0f} events/s, open loop "
          f"{f['open_loop']['events_per_s']:.0f} events/s ({tenants}), forward hop p99 "
          f"{f['forward_hop_p99_ms']} ms ({f['forward_hops']} hops 0 -> 1), replication lag "
          f"{f['replication_lag_batches']} batches (stale {f['replication_stale_ms']} ms), failover read stale_ms "
          f"{f['failover']['stale_ms']}, chaos no loss {f['chaos']['no_loss']}, "
          f"{f['events']} events; card = CPU ({len(card['answers'])} answers); "
          f"{out['seconds']:.1f} s", flush=True)
    return out


# the transformer configurations of fault C6 (head dims 128, 8, 48 and 64,
# and float16 at D = 32, 64 and 128) and of head dims past 128 (256, and
# 192 padded to it; float16 at 256), each scored and trained one step on
# the card
TF_C6_CONFIGS = {"d128": TransformerConfig(d_model=256, heads=2),
                 "d8": TransformerConfig(heads=32),
                 "d48": TransformerConfig(d_model=384, heads=8),
                 "d64": TransformerConfig(heads=4),
                 "f16": TransformerConfig(dtype=torch.float16),
                 "f16_d64": TransformerConfig(heads=4, dtype=torch.float16),
                 "f16_d128": TransformerConfig(d_model=256, heads=2, dtype=torch.float16),
                 # head dims past 128: D = 256, and 192 padded to it
                 "d256": TransformerConfig(d_model=256, heads=1),
                 "d192": TransformerConfig(d_model=384, heads=2),
                 "f16_d256": TransformerConfig(d_model=256, heads=1, dtype=torch.float16)}
TF_C6_SHAPE = (2, 4096)
# the full-width legs of transformer_c6: the head-dim-128, 64 and 256
# models on the transformer phase's 8 windows of 16384 steps
TF_C6_FULL = (("d128", (TF_WINDOWS, TF_STEPS)), ("d64", (TF_WINDOWS, TF_STEPS)),
              ("d256", (TF_WINDOWS, TF_STEPS)))
# the attention kernels a config must take on the card, by profiler name:
# (kernel, its type argument, its head dim or None); and the names none may
# take. Both 16-bit types run the one-pass wgmma/TMA backward at every D
# and the wgmma/TMA forward at D = 64, 128 and 256 (the mma.sync forward at
# 16 and 32); none may run the mma.sync backward pair
_MMA_BWD = ("flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel")
TF_C6_TAKES = {
    "d128": (("flash_attention_wgmma_kernel", "__nv_bfloat16", 128),
             ("flash_bwd_wgmma_kernel", "__nv_bfloat16", 128)),
    "d48": (("flash_attention_wgmma_kernel", "__nv_bfloat16", 64),
            ("flash_bwd_wgmma_kernel", "__nv_bfloat16", 64)),
    "d64": (("flash_attention_wgmma_kernel", "__nv_bfloat16", 64),
            ("flash_bwd_wgmma_kernel", "__nv_bfloat16", 64)),
    "f16": (("flash_attention_bf16_kernel", "__half", 32),
            ("flash_bwd_wgmma_kernel", "__half", 32)),
    "f16_d64": (("flash_attention_wgmma_kernel", "__half", 64),
                ("flash_bwd_wgmma_kernel", "__half", 64)),
    "f16_d128": (("flash_attention_wgmma_kernel", "__half", 128),
                 ("flash_bwd_wgmma_kernel", "__half", 128)),
    "d256": (("flash_attention_wgmma_kernel", "__nv_bfloat16", 256),
             ("flash_bwd_wgmma_kernel", "__nv_bfloat16", 256)),
    "d192": (("flash_attention_wgmma_kernel", "__nv_bfloat16", 256),
             ("flash_bwd_wgmma_kernel", "__nv_bfloat16", 256)),
    "f16_d256": (("flash_attention_wgmma_kernel", "__half", 256),
                 ("flash_bwd_wgmma_kernel", "__half", 256)),
}
TF_C6_NOT = {"f16": _MMA_BWD} | {name: ("flash_attention_bf16_kernel", *_MMA_BWD)
                                 for name in ("d128", "d48", "d64", "f16_d64", "f16_d128",
                                              "d256", "d192", "f16_d256")}


def _kernel_name(key: str) -> str | None:
    """The attention kernel a profiler key names, with its template
    arguments as the demangler writes them (``flash_bwd_wgmma_kernel<__half,
    32>``; a mangled name is read into that form), or None."""
    m = re.search(r"(flash\w*?_kernel)(<[^>]*>)?", key)
    if m is None:
        return None
    base = m.group(1)[m.group(1).rfind("flash"):]   # past a mangled namespace's name
    if m.group(2) or not key[m.end():].startswith("I"):
        return base + (m.group(2) or "")
    rest = key[m.end():]
    t = ("__half" if rest.startswith("I6__half") else "__nv_bfloat16"
         if rest.startswith("I13__nv_bfloat16") else "float" if rest.startswith("If") else "")
    d = re.match(r"I\w*?Li(\d+)E", rest)
    return f"{base}<{', '.join(x for x in (t, d and d.group(1)) if x)}>"


def _profiled_attention(fn) -> dict:
    """torch.profiler over one call of ``fn``: wall ms, device ms, the
    device's busy share, and each attention kernel that ran (by its name
    in the source with its template arguments, e.g.
    ``flash_bwd_wgmma_kernel<__half, 32>``) with its calls and device ms."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _, busy_ms = _device_time(prof)
    kernels: dict[str, dict] = {}
    for e in prof.key_averages():
        name = _kernel_name(e.key)
        if (name and e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            k = kernels.setdefault(name, {"calls": 0, "device_ms": 0.0})
            k["calls"] += e.count
            k["device_ms"] += e.self_device_time_total / 1e3
    return {"profiled_wall_ms": wall_ms, "device_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms, "attention_kernels": kernels}


def _takes(ran, name: str) -> tuple[bool, list]:
    """Whether the attention kernels ``ran`` (profiler names) hold every
    kernel ``TF_C6_TAKES[name]`` wants and none of ``TF_C6_NOT[name]``;
    and what was missing or should not have run."""
    parsed = [re.match(r"(\w+)(?:<(.*)>)?$", k).groups() for k in ran]
    bad = [want for want in TF_C6_TAKES[name]
           if not any(base == want[0] and want[1] in (args or "")
                      and (want[2] is None or str(want[2]) in re.split(r"[ ,]+", args or ""))
                      for base, args in parsed)]
    bad += [base for base, _ in parsed if base in TF_C6_NOT[name]]
    return not bad, bad


def _c6_full_width(device, fails, seed: int, name: str, cfg: TransformerConfig,
                   shape: tuple) -> dict:
    """The full-width leg: ``forecast_scores`` and one ``make_train_step``
    step of ``cfg`` on ``shape`` windows, each timed after a warm-up at the
    same shape, the launch counts reset just before the scoring call and
    read just after the step (2 x layers forward, layers backward), then
    one profiled call of each: busy share and the attention kernels by
    name, which must be those of ``TF_C6_TAKES`` and none of
    ``TF_C6_NOT``."""
    from sitewhere_tpu_torch.models.anomaly import adamw
    from sitewhere_tpu_torch.models.transformer import make_train_step

    model = TelemetryTransformer(cfg, device=device,
                                 generator=torch.Generator().manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    x = torch.randn((*shape, cfg.sensors), device=device, generator=gen)
    step = make_train_step(model, adamw(model.parameters(), TT_LR))
    forecast_scores(model, x)                                  # warm-up
    step(x)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
    t0 = time.perf_counter()
    scores = forecast_scores(model, x)
    _sync(device)
    score_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    loss = step(x).item()
    _sync(device)
    step_ms = (time.perf_counter() - t0) * 1e3
    got = {"flash_attention": fa.flash_attention.launches,
           "flash_attention_backward": fa.flash_attention_backward.launches}
    want = {"flash_attention": 2 * cfg.layers, "flash_attention_backward": cfg.layers}
    fails.check(got == want, f"transformer C6 {name} at {shape}: launches {got}, want {want}")
    fails.check(scores.shape == (shape[0],) and bool(torch.isfinite(scores).all())
                and math.isfinite(loss),
                f"transformer C6 {name} at {shape}: scores {scores}, loss {loss}")
    rec = {"config": name, "shape": list(shape), "head_dim": cfg.d_model // cfg.heads,
           "score_ms": score_ms, "train_step_ms": step_ms, "loss": loss, "launches": got,
           "score_mean": scores.mean().item(),
           "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                           if device.type == "cuda" else None)}
    if device.type == "cuda":
        rec["score_profile"] = _profiled_attention(lambda: forecast_scores(model, x))
        rec["step_profile"] = _profiled_attention(lambda: step(x))
        ran = set(rec["score_profile"]["attention_kernels"]) | set(
            rec["step_profile"]["attention_kernels"])
        ok, bad = _takes(ran, name)
        fails.check(ok, f"transformer C6 {name} at {shape}: attention kernels {sorted(ran)}, "
                        f"wrong: {bad}")
    del model, step, x
    return rec


def phase_transformer_c6(device, log, fails, seed: int, configs=None,
                         shape=TF_C6_SHAPE, full=TF_C6_FULL) -> dict:
    """``forecast_scores`` and one ``make_train_step`` step (AdamW) at each
    C6 configuration on [2, 4096] windows, seeded weights and data: every
    layer's attention and its gradient through the kernels (launch counts
    reset just before and read just after: layers each), scores finite and
    the first window's within TF_SCORE_RTOL of the same model with the
    plain attention, the loss finite and every parameter finite after the
    step; for the configs of ``TF_C6_TAKES`` one profiled scoring call and
    train step more, whose attention kernels by profiler name must be those
    of ``TF_C6_TAKES`` (the one-pass wgmma/TMA backward, at D = 64 and 128
    the wgmma/TMA forward) and none of ``TF_C6_NOT``. Then ``full`` ((config
    name, shape) pairs): each config timed at full width
    (``_c6_full_width``)."""
    from sitewhere_tpu_torch.models.anomaly import adamw
    from sitewhere_tpu_torch.models.transformer import make_train_step

    configs = configs or TF_C6_CONFIGS
    out, launches = {}, {"flash_attention": 0, "flash_attention_backward": 0}
    for name, cfg in configs.items():
        model = TelemetryTransformer(cfg, device=device,
                                     generator=torch.Generator().manual_seed(seed))
        gen = torch.Generator(device=device).manual_seed(seed + 7)
        x = torch.randn((*shape, cfg.sensors), device=device, generator=gen)
        forecast_scores(model, x[:1, :64])                     # warm-up: scoring,
        step = make_train_step(model, adamw(model.parameters(), TT_LR))
        step(x[:1, :64])                                       # a step, Adam's state
        _sync(device)
        fa.flash_attention.launches = fa.flash_attention_backward.launches = 0
        t0 = time.perf_counter()
        scores = forecast_scores(model, x)
        _sync(device)
        score_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loss = step(x).item()
        _sync(device)
        step_ms = (time.perf_counter() - t0) * 1e3
        got = {"flash_attention": fa.flash_attention.launches,
               "flash_attention_backward": fa.flash_attention_backward.launches}
        for k in launches:
            launches[k] += got[k]
        want = {"flash_attention": 2 * cfg.layers, "flash_attention_backward": cfg.layers}
        fails.check(got == want, f"transformer C6 {name}: launches {got}, want {want}")
        plain = forecast_scores(model, x[:1], attention_fn=functools.partial(
            fa.mha_reference, causal=True))
        finite_params = all(bool(torch.isfinite(p).all()) for p in model.parameters())
        fails.check(scores.shape == (shape[0],) and bool(torch.isfinite(scores).all())
                    and math.isfinite(loss) and finite_params,
                    f"transformer C6 {name}: scores {scores}, loss {loss}, "
                    f"finite parameters {finite_params}")
        # the first window scored through the kernel and through the plain
        # attention, both with the weights the step left
        again = forecast_scores(model, x[:1])
        rec = {"config": dataclasses.asdict(cfg) | {"dtype": str(cfg.dtype)},
               "head_dim": cfg.d_model // cfg.heads, "score_ms": score_ms,
               "train_step_ms": step_ms, "loss": loss, "launches": got,
               "score_mean": scores.mean().item(),
               "score_first_window_after_step": again[0].item(),
               "plain_score_first_window_after_step": plain[0].item(),
               "score_rel_err_vs_plain": abs(again[0].item() - plain[0].item())
               / abs(plain[0].item())}
        fails.check(rec["score_rel_err_vs_plain"] <= TF_SCORE_RTOL,
                    f"transformer C6 {name}: kernel score {again[0].item()} vs plain "
                    f"{plain[0].item()}")
        if name in TF_C6_TAKES and device.type == "cuda":
            ran = set(_profiled_attention(lambda: forecast_scores(model, x))["attention_kernels"])
            ran |= set(_profiled_attention(lambda: step(x))["attention_kernels"])
            ok, bad = _takes(ran, name)
            rec["attention_kernels"] = sorted(ran)
            fails.check(ok, f"transformer C6 {name}: attention kernels {sorted(ran)}, "
                            f"wrong: {bad}")
        out[name] = rec
        del model, step, x
    full_recs = {}
    for name, full_shape in full:
        full_recs[name] = _c6_full_width(device, fails, seed, name, TF_C6_CONFIGS[name],
                                         full_shape)
        for k in launches:
            launches[k] += full_recs[name]["launches"][k]
    emit({"phase": "transformer_c6", "shape": list(shape), "configs": out,
          "full_width": full_recs, "launches": launches, "score_rtol": TF_SCORE_RTOL}, log)
    return launches


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "--id=0"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=pathlib.Path, default=None,
                    help="also write every phase record to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="after the checks, profile a few steps (without and with zones "
                         "and rules), one scoring call, one train_on_live call, one "
                         "transformer call, one transformer train step, three "
                         "wire-ingest dispatches, one spool and one scoring batch of an "
                         "archive job, and three dispatches with the recorder on")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False      # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    log: list = []
    fails = Failures()
    card = card_line()
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                             "--format=csv,noheader", "--id=0"],
                            capture_output=True, text=True, timeout=60).stdout.strip()
    walls: dict = {}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            walls[name] = time.perf_counter() - t0

    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0), "nvidia_smi": card,
          "sm_clock_max_and_now": clocks}, log)
    timed("build", phase_build, log, fails)
    timing = {"window_features": timed("kernel_window_features",
                                       phase_kernel_window_features, device, log, fails),
              "flash_attention": timed("kernel_flash", phase_kernel_flash, device, log, fails),
              "flash_attention_backward": timed("kernel_flash_backward",
                                                phase_kernel_flash_backward, device, log, fails)}
    c6 = timed("kernel_flash_c6", phase_kernel_flash_c6, device, log, fails)
    for name, part in (("flash_attention", "forward"), ("flash_attention_backward", "backward")):
        timing[name]["at_head_dim_128_bf16"] = c6["timings"]["main_d128_bf16"][part]
        timing[name]["float16"] = c6["timings"]["main_f16"][part]
        timing[name]["float16_at_head_dim_128"] = c6["timings"]["main_d128_f16"][part]
        timing[name]["at_head_dim_16_bf16"] = c6["timings"]["d16_bf16"][part]
        timing[name]["at_head_dim_64_bf16"] = c6["timings"]["main_d64_bf16"][part]
        timing[name]["float16_at_head_dim_64"] = c6["timings"]["main_d64_f16"][part]
        timing[name]["at_head_dim_48_bf16"] = c6["timings"]["main_d48_bf16"][part]
        timing[name]["at_head_dim_256_bf16"] = c6["timings"]["main_d256_bf16"][part]
        timing[name]["float16_at_head_dim_256"] = c6["timings"]["main_d256_f16"][part]
        timing[name]["float32_at_head_dim_256"] = c6["timings"]["d256_f32"][part]
    timing["flash_attention_backward"]["c6_errors_by_dtype"] = c6["by_dtype"]
    timing["flash_attention_backward"]["ptxas_wgmma_f16"] = {
        k: v for k, v in c6["ptxas"].items() if k.startswith("flash_bwd")}
    timing["flash_attention"]["ptxas_wgmma_f16"] = {
        k: v for k, v in c6["ptxas"].items() if k.startswith("flash_attention")}
    timed("entry", phase_entry, device, log, fails)
    launches, slice_step_ms, slice_eng = timed("slice", phase_slice, device, log, fails,
                                               args.seed, SLICE_BATCHES, profile=args.profile)
    train = timed("train", phase_train, device, log, fails, args.seed, slice_eng,
                  profile=args.profile)
    del slice_eng
    launches = launches | timed("transformer", phase_transformer, device, log, fails,
                                args.seed, profile=args.profile)
    tt = timed("transformer_train", phase_transformer_train, device, log, fails, args.seed,
               profile=args.profile)
    tc6 = timed("transformer_c6", phase_transformer_c6, device, log, fails, args.seed)
    timed("read", phase_read, device, log, fails, args.seed, slice_step_ms,
          profile=args.profile)
    timed("wire", phase_wire, device, log, fails, args.seed, profile=args.profile)
    timed("sharded", phase_sharded, device, log, fails, args.seed)
    timed("distributed", phase_distributed, device, log, fails, args.seed)
    archive = timed("archive", phase_archive, device, log, fails, args.seed,
                    profile=args.profile)
    timed("hostplane", phase_hostplane, device, log, fails, args.seed, profile=args.profile)
    timed("anomaly_tp", phase_anomaly_tp, device, log, fails, args.seed)
    timed("multihost", phase_multihost, device, log, fails)
    timed("sources", phase_sources, device, log, fails, args.seed)
    timed("edge", phase_edge, device, log, fails, args.seed)
    timed("services", phase_services, device, log, fails, args.seed)
    servers = timed("servers", phase_servers, device, log, fails, args.seed)
    timed("cluster", phase_cluster, device, log, fails, args.seed)
    # window_features runs on four paths: the live scoring of the slice,
    # training on the live windows, the archive's analytics job and the
    # REST gateway's analytics routes
    by_path = {"window_features": {"slice": launches["window_features"],
                                   "train": train["window_features"],
                                   "archive": archive["launches"],
                                   "servers": servers["analytics"]["launches"]},
               "flash_attention": {"transformer": launches["flash_attention"],
                                   "transformer_train": tt["flash_attention"],
                                   "transformer_c6": tc6["flash_attention"]},
               "flash_attention_backward": {
                   "transformer_train": tt["flash_attention_backward"],
                   "transformer_c6": tc6["flash_attention_backward"]}}
    timing["window_features"]["at_archive_job_shape"] = {
        k: archive[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by")}
    emit({"phase": "walls", "seconds": walls, "phases_s": sum(walls.values())}, log)
    kernels = [dict(k, launches=sum(by_path[k["name"]].values()),
                    launches_by_path=by_path[k["name"]], **timing[k["name"]])
               for k in KERNELS]
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"phases": log, "kernels": kernels,
                                        "failures": fails, "card": card}, indent=1))
    if fails:
        print("chip_smoke FAILED:\n  " + "\n  ".join(fails), file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
